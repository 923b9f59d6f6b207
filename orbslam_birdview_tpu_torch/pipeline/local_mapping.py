"""Local mapping: the part that initialization needs — the extraction of a
padded BA problem from the map store and the two-keyframe global BA that
follows `CreateInitialMapMonocular`.

Keyframe processing, map-point culling, triangulation of new points,
fusing, the local and the full-map BA with their landing ticks, and
keyframe culling follow with the rest of the tracker (ROADMAP Queue 1
item 10); until then those methods raise.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..api.config import SlamConfig
from ..core.camera import camera_to_base_extrinsics
from ..graph import ba
from ..mapping.mapstore import MapStore

# the reference's public methods that wait for ROADMAP Queue 1 item 10
_UNPORTED = ("register_kf_device", "drain_background", "process_keyframe",
             "drain_kf_stages", "mapping_idle", "prewarm", "local_ba",
             "finalize_ba", "global_ba", "finalize_gba")


def pow2_bucket(n, lo, hi):
    """Pad to the next power of two >= n (floor lo, ceiling hi): small
    problems keep small device shapes (a 10-KF map must not pay the full
    KITTI-scale cap), while the bucket ladder bounds the number of distinct
    shapes to log2(hi/lo)."""
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


class LocalMapper:
    def __init__(self, cfg: SlamConfig, store: MapStore, device=None):
        self.cfg = cfg
        self.store = store
        self.device = resolve_device(device)
        self.level_sigma2 = np.array(
            [cfg.orb.scale_factor ** (2 * l) for l in range(cfg.orb.n_levels)],
            np.float32,
        )
        self.scale_factors = np.array(
            [cfg.orb.scale_factor ** l for l in range(cfg.orb.n_levels)],
            np.float32,
        )
        # deterministic-schedule tick, incremented once per tracked frame
        self._frame_tick = 0
        # bumped on LARGE pose rewrites (GBA writeback): the tracker's
        # device pose chain is valid while it is unchanged
        self.pose_epoch = 0

    def poll_background(self) -> bool:
        """Called once per tracked frame: advances the frame tick. No
        overlapped work can be in flight yet (nothing here dispatches any),
        so no pose moves and the answer is False."""
        self._frame_tick += 1
        return False

    # ------------------------------------------------------------------
    def _gather_ba_problem(self, kf_window, fixed_window, pad_to=None,
                           point_cap=None, edge_cap=None,
                           stereo_cap=None, bird_cap=None):
        """Extract padded BA tensors for the given keyframe window. pad_to
        fixes the camera count; point/edge caps default to the local-BA
        buckets. The gathering is host numpy; the result is on the
        mapper's device."""
        store = self.store
        cfg = self.cfg.mapping
        dev = self.device
        point_cap = point_cap or cfg.local_ba_point_cap
        edge_cap = edge_cap or cfg.local_ba_edge_cap

        all_kfs = np.concatenate([kf_window, fixed_window]).astype(np.int64)
        n_real = len(all_kfs)
        C = pad_to or n_real
        kf_slot = {int(k): i for i, k in enumerate(all_kfs)}
        # landmarks observed by the window
        mp = store.kf_kp_mp[kf_window]
        mp_ids = np.unique(mp[mp >= 0])
        mp_ids = mp_ids[store.mp_valid[mp_ids]]
        if len(mp_ids) > point_cap:
            # over-cap: uniform stride, NOT a prefix cut — ids are
            # allocation-ordered, so a prefix keeps only the OLDEST
            # landmarks and the window's fresh triangulations would never
            # be optimized once the map saturates the cap
            mp_ids = mp_ids[np.linspace(0, len(mp_ids) - 1,
                                        point_cap).astype(np.int64)]
        n_mp = len(mp_ids)
        # bird landmarks
        bmp = store.kf_bird_mp[kf_window]
        bmp_ids = np.unique(bmp[bmp >= 0])
        bmp_ids = bmp_ids[store.bmp_valid[bmp_ids]]
        bird_budget = max(point_cap - n_mp, 0)
        if len(bmp_ids) > bird_budget:
            # over-budget: uniform stride like the mono points above
            bmp_ids = (bmp_ids[np.linspace(0, len(bmp_ids) - 1,
                                           bird_budget).astype(np.int64)]
                       if bird_budget else bmp_ids[:0])
        n_bmp = len(bmp_ids)
        P = pow2_bucket(n_mp + n_bmp, 1024, point_cap)
        points = np.zeros((P, 3), np.float32)
        points[:n_mp] = store.mp_pos[mp_ids]
        points[n_mp: n_mp + n_bmp] = store.bmp_pos[bmp_ids]
        pvalid = np.zeros(P, bool)
        pvalid[: n_mp + n_bmp] = True
        mp_slot = np.full(store.max_mp, -1, np.int64)
        mp_slot[mp_ids] = np.arange(n_mp)
        bmp_slot = np.full(store.max_bmp, -1, np.int64)
        bmp_slot[bmp_ids] = np.arange(n_bmp) + n_mp

        # mono edges (+ stereo where depth available) — one vectorized
        # sweep over the whole window
        obs_win = store.kf_kp_mp[all_kfs]                        # (W, C)
        hit = ((obs_win >= 0) & (mp_slot[obs_win.clip(0)] >= 0)
               & store.kf_kp_valid[all_kfs])
        wi, ki = np.nonzero(hit)
        cam_slot = np.array([kf_slot[int(k)] for k in all_kfs], np.int64)
        oct_ = store.kf_kp_octave[all_kfs[wi], ki]
        info_all = 1.0 / self.level_sigma2[
            np.clip(oct_, 0, len(self.level_sigma2) - 1)]
        ur = store.kf_kp_ur[all_kfs[wi], ki]
        st = ur > 0
        mono = ~st
        e_cam = [cam_slot[wi[mono]]]
        e_pt = [mp_slot[obs_win[wi[mono], ki[mono]]]]
        e_obs = [store.kf_kp_xy[all_kfs[wi[mono]], ki[mono]]]
        e_info = [info_all[mono]]
        s_cam, s_pt, s_obs, s_info = [], [], [], []
        if st.any():
            s_cam = [cam_slot[wi[st]]]
            s_pt = [mp_slot[obs_win[wi[st], ki[st]]]]
            s_obs = [np.concatenate(
                [store.kf_kp_xy[all_kfs[wi[st]], ki[st]],
                 ur[st][:, None]], 1)]
            s_info = [info_all[st]]
        # bird edges
        b_cam, b_pt, b_obs, b_info = [], [], [], []
        if n_bmp:
            R_bc, t_bc = camera_to_base_extrinsics(
                self.cfg.tbc_quat, self.cfg.tbc_t)
            R_cb = R_bc.numpy().T
            t_cb = -R_cb @ t_bc.numpy()
            sig = self.cfg.tracking.bird_sigma_m
            w = self.cfg.tracking.bird_info_scale_ba / sig ** 2
            kb_win = store.kf_bird_mp[all_kfs]                   # (W, Cb)
            bhit = ((kb_win >= 0) & (bmp_slot[kb_win.clip(0)] >= 0)
                    & store.kf_bird_valid[all_kfs])
            bwi, bki = np.nonzero(bhit)
            if len(bwi):
                obs_pc = (store.kf_bird_base[all_kfs[bwi], bki] @ R_cb.T
                          + t_cb)
                b_cam = [cam_slot[bwi]]
                b_pt = [bmp_slot[kb_win[bwi, bki]]]
                b_obs = [obs_pc]
                b_info = [np.full(len(bwi), w)]

        def mk_edges(cams, pts, obss, infos, obs_dim, cap, pad_target):
            if cams:
                cams = np.concatenate(cams).astype(np.int32)
                pts = np.concatenate(pts).astype(np.int32)
                obss = np.concatenate(obss).astype(np.float32)
                infos = np.concatenate(infos).astype(np.float32)
            else:
                cams = np.zeros(0, np.int32)
                pts = np.zeros(0, np.int32)
                obss = np.zeros((0, obs_dim), np.float32)
                infos = np.zeros(0, np.float32)
            if len(cams) > cap:
                # over-cap: uniform-stride subsample — a prefix cut would
                # keep only the earliest keyframes' edges (systematic bias)
                sel = np.linspace(0, len(cams) - 1, cap).astype(np.int64)
                cams, pts, obss, infos = cams[sel], pts[sel], obss[sel], infos[sel]
            n = min(len(cams), cap)
            # floor at pad_target, pow2 ladder above it (rare overflow)
            pad = pow2_bucket(n, pad_target, max(cap, pad_target)) - n
            return ba.EdgeSet(
                torch.as_tensor(np.pad(cams[:n], (0, pad)), device=dev),
                torch.as_tensor(np.pad(pts[:n], (0, pad)), device=dev),
                torch.as_tensor(np.pad(obss[:n], ((0, pad), (0, 0))),
                                device=dev),
                torch.as_tensor(np.pad(infos[:n], (0, pad)), device=dev),
                torch.as_tensor(np.pad(np.ones(n, bool), (0, pad)),
                                device=dev),
            ), n

        # ONE shape per (point, mono-edge) bucket regardless of sensor mix:
        # stereo/bird sets are ALWAYS present, padded (masked invalid) to a
        # fixed fraction of the mono bucket.
        cap = edge_cap
        n_mono_raw = sum(len(c) for c in e_cam)
        B_m = pow2_bucket(min(n_mono_raw, cap), 1024, cap)
        # aux types HARD-subsample to the pad size so the shape is a pure
        # function of (P, B_m) — a bird-heavy window must not mint a new
        # bucket of its own
        aux_pad = max(B_m // 4, min(4096, cap))
        if stereo_cap is not None or bird_cap is not None:
            # caller-specified caps (global BA) keep their own buckets
            aux_s, aux_b = stereo_cap or cap // 4, bird_cap or cap // 4
            mono_es, n_mono = mk_edges(e_cam, e_pt, e_obs, e_info, 2, cap,
                                       B_m)
            stereo_es, _ = mk_edges(s_cam, s_pt, s_obs, s_info, 3,
                                    aux_s, min(aux_pad, aux_s))
            bird_es, _ = mk_edges(b_cam, b_pt, b_obs, b_info, 3,
                                  aux_b, min(aux_pad, aux_b))
        else:
            mono_es, n_mono = mk_edges(e_cam, e_pt, e_obs, e_info, 2, cap,
                                       B_m)
            stereo_es, _ = mk_edges(s_cam, s_pt, s_obs, s_info, 3,
                                    aux_pad, aux_pad)
            bird_es, _ = mk_edges(b_cam, b_pt, b_obs, b_info, 3,
                                  aux_pad, aux_pad)
        # empty stereo/bird sets stay as all-invalid masked EdgeSets (NOT
        # None), so the BA always runs all three edge branches
        camR_np = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        camt_np = np.zeros((C, 3), np.float32)
        camR_np[:n_real] = store.kf_R[all_kfs]
        camt_np[:n_real] = store.kf_t[all_kfs]
        fixed = np.ones(C, bool)   # padding slots are fixed
        fixed[: len(kf_window)] = False
        # always anchor the first keyframe
        for i, k in enumerate(all_kfs):
            if int(k) == 0:
                fixed[i] = True
        cam_valid = np.zeros(C, bool)
        cam_valid[:n_real] = True

        def on(x):
            return torch.as_tensor(x, device=dev)

        return (all_kfs, on(camR_np), on(camt_np), on(fixed), on(cam_valid),
                on(points), on(pvalid), mono_es, stereo_es, bird_es, mp_ids,
                bmp_ids, n_mp, n_bmp, n_mono)

    # ------------------------------------------------------------------
    def initial_global_ba(self, kf1: int, kf2: int, iters: int = 20):
        """The global BA (20 iterations) that ends
        `CreateInitialMapMonocular`: two keyframes, the first fixed."""
        store = self.store
        cam = self.cfg.camera
        window = np.array([kf1, kf2], np.int64)
        (_, cam_R, cam_t, _, cam_valid, points, pvalid,
         mono_es, stereo_es, bird_es, mp_ids, bmp_ids, n_mp, n_bmp,
         _) = self._gather_ba_problem(window, np.zeros(0, np.int64))
        fixed = torch.tensor([True, False], device=self.device)
        res = ba.bundle_adjust(
            cam_R, cam_t, fixed, cam_valid, points, pvalid,
            mono_es, stereo_es, bird_es,
            cam.fx, cam.fy, cam.cx, cam.cy, bf=cam.bf,
            iters_phase1=iters // 2, iters_phase2=iters - iters // 2,
            device=self.device,
        )
        # one transfer: both poses and all points ride one flat buffer
        flat = torch.cat([res.cam_R[:2].reshape(-1), res.cam_t[:2].reshape(-1),
                          res.points.reshape(-1)]).cpu().numpy()
        store.kf_R[window] = flat[:18].reshape(2, 3, 3)
        store.kf_t[window] = flat[18:24].reshape(2, 3)
        pts_out = flat[24:].reshape(-1, 3)
        store.mp_pos[mp_ids] = pts_out[:n_mp]
        if n_bmp:
            store.bmp_pos[bmp_ids] = pts_out[n_mp: n_mp + n_bmp]


def _unported(name):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"LocalMapper.{name} is not ported yet: local mapping follows "
            "with tracking after initialization (ROADMAP Queue 1 item 10)")
    method.__name__ = name
    return method


for _name in _UNPORTED:
    setattr(LocalMapper, _name, _unported(_name))
