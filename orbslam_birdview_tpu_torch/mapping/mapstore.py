"""Fixed-capacity SLAM map store.

The map is a set of flat fixed-capacity arrays with validity masks — no
pointers, no locks — instead of a mutex-guarded object graph of keyframes
and map points. The store lives on the host (numpy) because map
bookkeeping is control-flow heavy and cheap; every hot computation
(matching, pose optimization, BA) extracts padded device tensors from it.
This is the port's own copy of the JAX package's store: same fields, same
operations, same file format, so a map saved by either package loads in
the other.

Design choices:
- Observations are stored as the keypoint→landmark index map per keyframe
  (`kf_kp_mp`) — O(1) scatter/gather, and exactly what BA edge extraction
  needs.
- Keyframes store their BEV descriptors.
- Covisibility weights are maintained incrementally as a dense (kf,kf)
  count matrix instead of per-object sorted neighbor lists.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

INVALID = -1


def _popcount_u8(x):
    # vectorized popcount via lookup table
    return _POP_LUT[x]


_POP_LUT = np.array([bin(i).count("1") for i in range(256)], dtype=np.int32)


def hamming_np(a_u8, b_u8):
    """(Na,32) x (Nb,32) -> (Na,Nb) hamming distances, numpy host path."""
    x = np.bitwise_xor(a_u8[:, None, :], b_u8[None, :, :])
    return _popcount_u8(x).sum(-1)


@dataclass
class MapStore:
    max_kf: int = 256
    max_mp: int = 40000
    max_bmp: int = 20000
    kp_cap: int = 1024       # keypoint capacity per keyframe
    bird_cap: int = 1024

    def __post_init__(self):
        K, P, B, C, CB = self.max_kf, self.max_mp, self.max_bmp, self.kp_cap, self.bird_cap
        # keyframes
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_valid = np.zeros(K, bool)
        self.kf_frame_id = np.full(K, INVALID, np.int64)
        self.kf_timestamp = np.zeros(K, np.float64)
        # per-KF front features
        self.kf_kp_xy = np.zeros((K, C, 2), np.float32)
        self.kf_kp_octave = np.zeros((K, C), np.int32)
        self.kf_kp_angle = np.zeros((K, C), np.float32)
        self.kf_kp_valid = np.zeros((K, C), bool)
        self.kf_desc = np.zeros((K, C, 32), np.uint8)
        self.kf_kp_mp = np.full((K, C), INVALID, np.int64)
        self.kf_kp_depth = np.full((K, C), -1.0, np.float32)   # stereo/RGBD
        self.kf_kp_ur = np.full((K, C), -1.0, np.float32)      # right-cam u
        # per-KF BEV features
        self.kf_bird_xy = np.zeros((K, CB, 2), np.float32)     # BEV pixels
        self.kf_bird_base = np.zeros((K, CB, 3), np.float32)   # base-frame XY0
        self.kf_bird_valid = np.zeros((K, CB), bool)
        self.kf_bird_desc = np.zeros((K, CB, 32), np.uint8)
        self.kf_bird_mp = np.full((K, CB), INVALID, np.int64)
        # map points (front)
        self.mp_pos = np.zeros((P, 3), np.float32)
        self.mp_valid = np.zeros(P, bool)
        self.mp_desc = np.zeros((P, 32), np.uint8)
        self.mp_normal = np.zeros((P, 3), np.float32)
        self.mp_min_dist = np.zeros(P, np.float32)
        self.mp_max_dist = np.zeros(P, np.float32)
        self.mp_ref_kf = np.full(P, INVALID, np.int64)
        self.mp_first_kf_id = np.full(P, INVALID, np.int64)
        self.mp_n_obs = np.zeros(P, np.int32)
        self.mp_visible = np.zeros(P, np.int32)
        self.mp_found = np.zeros(P, np.int32)
        # bird map points
        self.bmp_pos = np.zeros((B, 3), np.float32)
        self.bmp_valid = np.zeros(B, bool)
        self.bmp_desc = np.zeros((B, 32), np.uint8)
        self.bmp_n_obs = np.zeros(B, np.int32)
        self.bmp_first_kf_id = np.full(B, INVALID, np.int64)
        # first observing keyframe — anchors post-GBA propagation of bird
        # landmarks created while a GBA was in flight (mirrors mp_ref_kf)
        self.bmp_ref_kf = np.full(B, INVALID, np.int64)
        # covisibility counts (shared map points between KF pairs)
        self.covis = np.zeros((K, K), np.int32)
        # spanning tree: parent kf
        self.kf_parent = np.full(K, INVALID, np.int64)
        # loop edges
        self.loop_edges: list[tuple[int, int]] = []
        self.n_kf = 0
        self.n_mp = 0
        self.n_bmp = 0
        self.big_change_idx = 0
        # bumped only on LARGE coordinate-frame corrections (loop closure /
        # post-loop GBA), not on incremental local BA — lag-1 tracking uses
        # it to invalidate frames dispatched against the pre-correction map
        self.correction_epoch = 0

    # ------------------------------------------------------------------
    # capacity growth — KITTI-scale sequences blow past any fixed cap;
    # arrays double geometrically (amortized O(1) per alloc)
    # ------------------------------------------------------------------
    @staticmethod
    def _grow(arr: np.ndarray, new_n: int, fill=0) -> np.ndarray:
        shape = (new_n,) + arr.shape[1:]
        out = np.full(shape, fill, arr.dtype) if fill != 0 else np.zeros(
            shape, arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    def _ensure_kf_capacity(self, need: int):
        if need <= self.max_kf:
            return
        new = max(self.max_kf * 2, need)
        g = self._grow
        for name in ("kf_t", "kf_kp_xy", "kf_kp_octave", "kf_kp_angle",
                     "kf_kp_valid", "kf_desc", "kf_bird_xy", "kf_bird_base",
                     "kf_bird_valid", "kf_bird_desc", "kf_valid",
                     "kf_timestamp"):
            setattr(self, name, g(getattr(self, name), new))
        for name in ("kf_frame_id", "kf_kp_mp", "kf_bird_mp", "kf_parent"):
            setattr(self, name, g(getattr(self, name), new, fill=INVALID))
        self.kf_kp_depth = g(self.kf_kp_depth, new, fill=-1.0)
        self.kf_kp_ur = g(self.kf_kp_ur, new, fill=-1.0)
        kf_R = np.tile(np.eye(3, dtype=np.float32), (new, 1, 1))
        kf_R[: self.max_kf] = self.kf_R
        self.kf_R = kf_R
        covis = np.zeros((new, new), np.int32)
        covis[: self.max_kf, : self.max_kf] = self.covis
        self.covis = covis
        self.max_kf = new

    def _ensure_mp_capacity(self, need: int):
        if need <= self.max_mp:
            return
        new = max(self.max_mp * 2, need)
        g = self._grow
        for name in ("mp_pos", "mp_valid", "mp_desc", "mp_normal",
                     "mp_min_dist", "mp_max_dist", "mp_n_obs", "mp_visible",
                     "mp_found"):
            setattr(self, name, g(getattr(self, name), new))
        for name in ("mp_ref_kf", "mp_first_kf_id"):
            setattr(self, name, g(getattr(self, name), new, fill=INVALID))
        self.max_mp = new

    def _ensure_bmp_capacity(self, need: int):
        if need <= self.max_bmp:
            return
        new = max(self.max_bmp * 2, need)
        g = self._grow
        for name in ("bmp_pos", "bmp_valid", "bmp_desc", "bmp_n_obs"):
            setattr(self, name, g(getattr(self, name), new))
        self.bmp_first_kf_id = g(self.bmp_first_kf_id, new, fill=INVALID)
        self.bmp_ref_kf = g(self.bmp_ref_kf, new, fill=INVALID)
        self.max_bmp = new

    # ------------------------------------------------------------------
    # allocation
    # ------------------------------------------------------------------
    def alloc_keyframe(self, R, t, frame_id, timestamp, kp, bird=None,
                       kp_depth=None, kp_ur=None) -> int:
        """kp: frontend Keypoints with host (numpy) fields — see
        `frontend.keypoints.to_host`. Returns kf index."""
        i = self.n_kf
        self._ensure_kf_capacity(i + 1)
        self.n_kf += 1
        self.kf_valid[i] = True
        self.kf_R[i] = np.asarray(R)
        self.kf_t[i] = np.asarray(t)
        self.kf_frame_id[i] = frame_id
        self.kf_timestamp[i] = timestamp
        n = kp.xy.shape[0]
        if n > self.kp_cap:
            # out-of-cap writes must fail loudly, not silently truncate:
            # a store sized below the extractor capacity drops features AND
            # later crashes on raw keypoint indices
            raise ValueError(
                f"keyframe has {n} keypoint slots but store kp_cap="
                f"{self.kp_cap}; size MapStore from "
                f"ORBConfig.padded_capacity()")
        self.kf_kp_xy[i, :n] = np.asarray(kp.xy)[:n]
        self.kf_kp_octave[i, :n] = np.asarray(kp.octave)[:n]
        self.kf_kp_angle[i, :n] = np.asarray(kp.angle)[:n]
        self.kf_kp_valid[i, :n] = np.asarray(kp.valid)[:n]
        self.kf_desc[i, :n] = np.asarray(kp.desc_u8)[:n]
        if kp_depth is not None:
            self.kf_kp_depth[i, :n] = np.asarray(kp_depth)[:n]
        if kp_ur is not None:
            self.kf_kp_ur[i, :n] = np.asarray(kp_ur)[:n]
        if bird is not None:
            bkp, base_xyz = bird
            m = bkp.xy.shape[0]
            if m > self.bird_cap:
                raise ValueError(
                    f"keyframe has {m} BEV keypoint slots but store "
                    f"bird_cap={self.bird_cap}; size MapStore from "
                    f"ORBConfig.padded_capacity()")
            self.kf_bird_xy[i, :m] = np.asarray(bkp.xy)[:m]
            self.kf_bird_valid[i, :m] = np.asarray(bkp.valid)[:m]
            self.kf_bird_desc[i, :m] = np.asarray(bkp.desc_u8)[:m]
            self.kf_bird_base[i, :m] = np.asarray(base_xyz)[:m]
        return i

    def alloc_points(self, positions, descriptors, ref_kf: int, first_kf_id: int):
        """Allocate len(positions) map points; returns their indices."""
        k = len(positions)
        ids = np.arange(self.n_mp, self.n_mp + k)
        self._ensure_mp_capacity(self.n_mp + k)
        self.n_mp += k
        self.mp_pos[ids] = positions
        self.mp_valid[ids] = True
        self.mp_desc[ids] = descriptors
        self.mp_ref_kf[ids] = ref_kf
        self.mp_first_kf_id[ids] = first_kf_id
        return ids

    def alloc_bird_points(self, positions, descriptors, first_kf_id: int):
        k = len(positions)
        ids = np.arange(self.n_bmp, self.n_bmp + k)
        self._ensure_bmp_capacity(self.n_bmp + k)
        self.n_bmp += k
        self.bmp_pos[ids] = positions
        self.bmp_valid[ids] = True
        self.bmp_desc[ids] = descriptors
        self.bmp_first_kf_id[ids] = first_kf_id
        return ids

    # ------------------------------------------------------------------
    # observations + covisibility
    # ------------------------------------------------------------------
    def add_observations(self, kf: int, kp_idx, mp_ids):
        """Associate keypoints of keyframe kf with map points (arrays)."""
        kp_idx = np.asarray(kp_idx)
        mp_ids = np.asarray(mp_ids)
        if kp_idx.size == 0:
            return
        if int(kp_idx.max()) >= self.kp_cap:
            raise IndexError(
                f"keypoint index {int(kp_idx.max())} >= kp_cap={self.kp_cap}")
        old = self.kf_kp_mp[kf, kp_idx]
        self.kf_kp_mp[kf, kp_idx] = mp_ids
        # update obs counts
        np.add.at(self.mp_n_obs, mp_ids, 1)
        dec = old[old >= 0]
        np.add.at(self.mp_n_obs, dec, -1)

    def add_bird_observations(self, kf: int, kp_idx, bmp_ids):
        kp_idx = np.asarray(kp_idx)
        bmp_ids = np.asarray(bmp_ids)
        if kp_idx.size == 0:
            return
        if int(kp_idx.max()) >= self.bird_cap:
            raise IndexError(
                f"BEV keypoint index {int(kp_idx.max())} >= "
                f"bird_cap={self.bird_cap}")
        old = self.kf_bird_mp[kf, kp_idx]
        self.kf_bird_mp[kf, kp_idx] = bmp_ids
        np.add.at(self.bmp_n_obs, bmp_ids, 1)
        dec = old[old >= 0]
        np.add.at(self.bmp_n_obs, dec, -1)
        unref = self.bmp_ref_kf[bmp_ids] == INVALID
        self.bmp_ref_kf[bmp_ids[unref]] = kf

    def remove_observation(self, kf: int, kp_idx):
        mp = self.kf_kp_mp[kf, kp_idx]
        ok = mp >= 0
        np.add.at(self.mp_n_obs, mp[ok], -1)
        self.kf_kp_mp[kf, kp_idx] = INVALID

    def update_covisibility(self, kf: int):
        """Recompute covisibility counts between kf and all other KFs
        (`KeyFrame::UpdateConnections`) and the spanning-tree parent."""
        mp = self.kf_kp_mp[kf]
        mp = mp[mp >= 0]
        if mp.size == 0:
            return
        member = np.zeros(self.max_mp, bool)
        member[mp] = True
        shared = (member[self.kf_kp_mp[: self.n_kf].clip(0)]
                  & (self.kf_kp_mp[: self.n_kf] >= 0)).sum(axis=1)
        shared[kf] = 0
        self.covis[kf, : self.n_kf] = shared
        self.covis[: self.n_kf, kf] = shared
        if self.kf_parent[kf] == INVALID and shared.max(initial=0) > 0:
            self.kf_parent[kf] = int(np.argmax(shared))

    def covisible_kfs(self, kf: int, min_weight: int = 15, top_n: Optional[int] = None):
        w = self.covis[kf, : self.n_kf].copy()
        w[~self.kf_valid[: self.n_kf]] = 0
        ids = np.nonzero(w >= min_weight)[0]
        if len(ids) == 0 and w.max(initial=0) > 0:
            # `KeyFrame::UpdateConnections` keeps at least the single best
            # neighbor when nothing reaches the threshold — without this a
            # weakly-attached keyframe has NO triangulation/fuse/BA
            # neighbors and the local map around it can never grow
            ids = np.array([int(np.argmax(w))], np.int64)
        order = np.argsort(-w[ids], kind="stable")
        ids = ids[order]
        if top_n is not None:
            ids = ids[:top_n]
        return ids

    # ------------------------------------------------------------------
    # landmark statistics (distinctive descriptor, normal, scale band)
    # ------------------------------------------------------------------
    def observations_of(self, mp_id: int):
        """Return (kf_ids, kp_idx) observing map point mp_id."""
        kfs, kps = np.nonzero(self.kf_kp_mp[: self.n_kf] == mp_id)
        return kfs, kps

    # max observations considered per point for the distinctive-descriptor
    # median (covisibility-window points rarely exceed this; capping keeps
    # the batch tensor rectangular)
    _STATS_OBS_CAP = 16

    def update_point_stats(self, mp_ids, scale_factors):
        """Distinctive descriptor (min-median hamming,
        `MapPoint::ComputeDistinctiveDescriptors`)
        + viewing normal and scale-invariance band
        (`MapPoint::UpdateNormalAndDepth`).

        Fully vectorized over the batch: one pass over the observation map,
        then rectangular (n_pts, OBS_CAP) gathers — the per-point python
        loop cost ~15 ms per keyframe on the frame path."""
        mp_ids = np.atleast_1d(np.asarray(mp_ids))
        if mp_ids.size == 0:
            return
        obs_map = self.kf_kp_mp[: self.n_kf]
        member = np.zeros(self.max_mp + 1, bool)
        member[mp_ids] = True
        kfs_all, kps_all = np.nonzero(member[obs_map.clip(0)] & (obs_map >= 0))
        if kfs_all.size == 0:
            return
        target = obs_map[kfs_all, kps_all]
        order = np.argsort(target, kind="stable")
        kfs_all, kps_all, target = kfs_all[order], kps_all[order], target[order]
        lo, hi = np.searchsorted(target, [mp_ids, mp_ids + 1])
        n_obs = hi - lo
        live = n_obs > 0
        ids, lo, hi, n_obs = mp_ids[live], lo[live], hi[live], n_obs[live]
        C = self._STATS_OBS_CAP
        take = np.minimum(n_obs, C)
        gi = lo[:, None] + np.arange(C)[None, :]         # (N, C)
        gmask = np.arange(C)[None, :] < take[:, None]
        gi = np.minimum(gi, len(target) - 1)
        kfs_g = kfs_all[gi]
        kps_g = kps_all[gi]
        # ---- distinctive descriptor: min median pairwise hamming --------
        descs = self.kf_desc[kfs_g, kps_g]               # (N, C, 32) u8
        bits = np.unpackbits(descs, axis=-1)             # (N, C, 256)
        pair = bits[:, :, None, :] != bits[:, None, :, :]
        d = pair.sum(-1).astype(np.float32)              # (N, C, C)
        d[~gmask[:, :, None] | ~gmask[:, None, :]] = np.inf
        # middle element of the sorted distances over the k valid peers —
        # exactly ORB-SLAM2's vDists[0.5*(N-1)]
        d.sort(axis=2)
        mid = (take - 1) // 2
        med = d[np.arange(len(ids))[:, None], np.arange(C)[None, :],
                mid[:, None]]                            # (N, C)
        med[~gmask] = np.inf
        best = np.argmin(med, axis=1)
        self.mp_desc[ids] = descs[np.arange(len(ids)), best]
        # ---- viewing normal ---------------------------------------------
        centers = -np.einsum("ncji,ncj->nci", self.kf_R[kfs_g],
                             self.kf_t[kfs_g])
        v = self.mp_pos[ids][:, None, :] - centers
        v /= np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        v[~gmask] = 0.0
        vm = v.sum(1) / np.maximum(take[:, None], 1)
        self.mp_normal[ids] = (
            vm / np.maximum(np.linalg.norm(vm, axis=-1, keepdims=True), 1e-9)
        ).astype(np.float32)
        # ---- scale band from the reference-KF observation ---------------
        ref = self.mp_ref_kf[ids]
        is_ref = (kfs_g == ref[:, None]) & gmask
        has_ref = is_ref.any(1)
        j = np.where(has_ref, np.argmax(is_ref, axis=1), 0)
        rows = np.arange(len(ids))
        ref_kf = kfs_g[rows, j]
        ref_kp = kps_g[rows, j]
        Xc = np.einsum("nij,nj->ni", self.kf_R[ref_kf], self.mp_pos[ids]) \
            + self.kf_t[ref_kf]
        dist = np.linalg.norm(Xc, axis=-1)
        octave = self.kf_kp_octave[ref_kf, ref_kp]
        sf = scale_factors[np.clip(octave, 0, len(scale_factors) - 1)]
        self.mp_max_dist[ids] = dist * sf
        self.mp_min_dist[ids] = dist * sf / scale_factors[-1]

    def update_bird_point_desc(self, bmp_ids):
        obs_map = self.kf_bird_mp[: self.n_kf]
        for b in np.atleast_1d(bmp_ids):
            kfs, kps = np.nonzero(obs_map == b)
            if kfs.size == 0:
                continue
            descs = self.kf_bird_desc[kfs, kps]
            if descs.shape[0] > 1:
                d = hamming_np(descs, descs)
                self.bmp_desc[b] = descs[np.argmin(np.median(d, axis=1))]
            else:
                self.bmp_desc[b] = descs[0]

    # ------------------------------------------------------------------
    # culling / deletion
    # ------------------------------------------------------------------
    def erase_point(self, mp_id: int):
        self.mp_valid[mp_id] = False
        kfs, kps = self.observations_of(mp_id)
        self.kf_kp_mp[kfs, kps] = INVALID
        self.mp_n_obs[mp_id] = 0

    def erase_points(self, mp_ids):
        """Batched erase: ONE scan of the observation map for the whole
        batch (per-point erase_point scans (n_kf × kp_cap) each — O(n·K·C)
        for a culling pass that only needs O(K·C))."""
        mp_ids = np.asarray(mp_ids)
        if mp_ids.size == 0:
            return
        self.mp_valid[mp_ids] = False
        self.mp_n_obs[mp_ids] = 0
        member = np.zeros(self.max_mp, bool)
        member[mp_ids] = True
        obs = self.kf_kp_mp[: self.n_kf]
        obs[(obs >= 0) & member[obs.clip(0)]] = INVALID

    def erase_bird_point(self, b: int):
        self.bmp_valid[b] = False
        kfs, kps = np.nonzero(self.kf_bird_mp[: self.n_kf] == b)
        self.kf_bird_mp[kfs, kps] = INVALID
        self.bmp_n_obs[b] = 0

    def replace_point(self, old_id: int, new_id: int):
        """MapPoint::Replace — forward observations of old to new."""
        kfs, kps = self.observations_of(old_id)
        for kf, kp in zip(kfs, kps):
            if new_id in self.kf_kp_mp[kf]:
                self.kf_kp_mp[kf, kp] = INVALID
            else:
                self.kf_kp_mp[kf, kp] = new_id
                self.mp_n_obs[new_id] += 1
        self.mp_found[new_id] += self.mp_found[old_id]
        self.mp_visible[new_id] += self.mp_visible[old_id]
        self.mp_valid[old_id] = False
        self.mp_n_obs[old_id] = 0

    def erase_keyframe(self, kf: int):
        """KeyFrame::SetBadFlag — drop observations, reparent children."""
        kp_idx = np.nonzero(self.kf_kp_mp[kf] >= 0)[0]
        self.remove_observation(kf, kp_idx)
        bidx = np.nonzero(self.kf_bird_mp[kf] >= 0)[0]
        bmp = self.kf_bird_mp[kf, bidx]
        np.add.at(self.bmp_n_obs, bmp, -1)
        self.kf_bird_mp[kf, bidx] = INVALID
        self.kf_valid[kf] = False
        self.covis[kf, :] = 0
        self.covis[:, kf] = 0
        children = np.nonzero(self.kf_parent[: self.n_kf] == kf)[0]
        self.kf_parent[children] = self.kf_parent[kf]

    # ------------------------------------------------------------------
    # checkpoint / resume — flat arrays make it trivial
    # ------------------------------------------------------------------
    _SCALARS = ("n_kf", "n_mp", "n_bmp", "big_change_idx",
                "correction_epoch")

    def save(self, path: str):
        arrays = {
            k: v for k, v in self.__dict__.items()
            if isinstance(v, np.ndarray)
        }
        meta = {k: getattr(self, k) for k in self._SCALARS}
        meta["max_kf"] = self.max_kf
        meta["max_mp"] = self.max_mp
        meta["max_bmp"] = self.max_bmp
        meta["kp_cap"] = self.kp_cap
        meta["bird_cap"] = self.bird_cap
        meta["loop_edges"] = np.array(self.loop_edges or np.zeros((0, 2)),
                                      np.int64).reshape(-1, 2)
        np.savez_compressed(path, __meta_keys__=np.array(list(meta.keys())),
                            **{f"meta_{k}": np.asarray(v) for k, v in meta.items()},
                            **arrays)

    @staticmethod
    def load(path: str) -> "MapStore":
        z = np.load(path, allow_pickle=False)
        store = MapStore(
            max_kf=int(z["meta_max_kf"]), max_mp=int(z["meta_max_mp"]),
            max_bmp=int(z["meta_max_bmp"]), kp_cap=int(z["meta_kp_cap"]),
            bird_cap=int(z["meta_bird_cap"]))
        for k in z.files:
            if k.startswith("meta_") or k == "__meta_keys__":
                continue
            setattr(store, k, z[k])
        for k in MapStore._SCALARS:
            setattr(store, k, int(z[f"meta_{k}"]))
        store.loop_edges = [tuple(int(x) for x in row)
                            for row in z["meta_loop_edges"]]
        return store

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def kf_center(self, kf):
        return -np.einsum("ji,j->i", self.kf_R[kf], self.kf_t[kf])

    def valid_kf_ids(self):
        return np.nonzero(self.kf_valid[: self.n_kf])[0]

    def valid_mp_ids(self):
        return np.nonzero(self.mp_valid[: self.n_mp])[0]

    def valid_bmp_ids(self):
        return np.nonzero(self.bmp_valid[: self.n_bmp])[0]
