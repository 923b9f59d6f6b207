"""Local mapping: keyframe processing, triangulation, fusing, culling, the
local BA and the full-map BA, as a pipeline stage driven by the tracker's
frames.

- `process_keyframe` queues a minted keyframe; its stages then advance one
  transition per tracked frame at fixed landing ticks (`poll_background`):
  map-point culling → triangulation against the best covisible neighbours
  (one batched device op for all of them) → the bidirectional fuse (one
  call, a row per neighbour) → the local BA dispatch → keyframe culling →
  loop closing (`loop_closer.process_keyframe`, stage `map.loop`);
- the local BA (`graph/ba.py`) lands `BA_LAG_FRAMES` frames after its
  dispatch: poses and points are written back and outlier observations
  removed;
- the full-map BA that a loop correction dispatches (`global_ba`) lands
  `GBA_LAG_FRAMES` frames later (`finalize_gba`), keyframes and points
  made meanwhile corrected through the spanning tree; a second round is
  chained on landing. On a mesh of more than one shard it is the sharded
  solve of `parallel/sharded_ba.py`;
- `_gather_ba_problem` extracts a padded BA problem from the map store;
  `initial_global_ba` is the two-keyframe BA that ends initialization.

Every device result is fetched in one transfer per stage
(`utils/async_fetch.BackgroundFetch`), started at dispatch and folded in
only at the stage's landing tick, so the map is a function of the frame
index alone.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..api.config import SlamConfig
from ..core.camera import camera_to_base_extrinsics
from ..graph import ba, ba_large
from ..mapping.mapstore import MapStore
from ..parallel import runtime
from ..parallel import sharded_ba as sba
from ..utils.async_fetch import BackgroundFetch
from ..utils.profiling import StageTimer
from . import device_ops

# Deterministic-schedule landing offsets (in tracked frames): a result
# dispatched at tick k is folded in EXACTLY at tick k+LAG (waiting for its
# transfer if it has not landed), never earlier, so the map is a function
# of the frame index on any host.
STAGE_LAG_FRAMES = 2   # keyframe stage (triangulate / fuse) advance
BA_LAG_FRAMES = 6      # local-BA writeback
GBA_LAG_FRAMES = 12    # global-BA writeback (full-map solve)
# fuse batch row layout, shared by _dispatch_fuse and _apply_fuse: the
# reverse-pass row id is FUSE_ROW_PAD-1, so both sides MUST agree
FUSE_FWD_ROWS = 10
FUSE_ROW_PAD = FUSE_FWD_ROWS + 1

# the dense-W BA's (C, 6, P, 3) coupling tensor above this size switches
# the full-map BA to the matrix-free solver (`ba_large`)
DENSE_W_MAX_BYTES = 128 << 20


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
    def __init__(self, cfg: SlamConfig, store: MapStore, device=None,
                 mesh: runtime.Mesh = None,
                 timer: Optional[StageTimer] = None):
        self.cfg = cfg
        self.store = store
        self.device = resolve_device(device)
        # the System's span record (a mapper of its own without one)
        self.timer = timer if timer is not None else StageTimer()
        # the shards of the full-map BA and the essential graph: the one
        # device unless the caller gives a mesh of more shards
        self.mesh = (mesh if mesh is not None
                     else runtime.Mesh([self.device]))
        if self.mesh.world > 1:
            raise ValueError("the mapper's mesh is one process's: it lands "
                             "every point of the full-map BA")
        self.recent_mp: list[tuple[int, int]] = []  # (mp_id, birth kf index)
        self.level_sigma2 = np.array(
            [cfg.orb.scale_factor ** (2 * l) for l in range(cfg.orb.n_levels)],
            np.float32,
        )
        self.scale_factors = np.array(
            [cfg.orb.scale_factor ** l for l in range(cfg.orb.n_levels)],
            np.float32,
        )
        self.loop_closer = None   # attached by System
        self._kf_queue: deque = deque()  # minted, stages not started
        self._ba_pending = None   # in-flight local BA (finalize_ba)
        self._gba_pending = None  # in-flight global BA (finalize_gba)
        self._gba_rounds_left = 0  # GBA rounds still to chain on landing
        self._gba_tick = 0        # tick when the pending GBA dispatched
        self._kf_stage = None     # keyframe mapping pipeline stage
        # deterministic-schedule ticks (see STAGE/BA_LAG_FRAMES above)
        self._frame_tick = 0      # incremented once per tracked frame
        # device-compacted stage results that overflowed their shipping
        # cap (dropped candidates): observability, never silent
        self.compact_overflows = 0
        self._stage_tick = 0      # tick when the current stage dispatched
        self._ba_tick = 0         # tick when the pending BA dispatched
        # what the mapper did, for logs and checks
        self.stats = dict(tri_applied=0, fuse_applied=0, ba_dispatched=0,
                          ba_landed=0, ba_dropped=0, kf_culled=0,
                          points_culled=0, gba_dispatched=0, gba_landed=0,
                          gba_dropped=0, ba_stereo_edges=0)
        # the valid edges of each type in the last BA problem gathered, and
        # the last full-map BA's problem: C, P, edges, solver
        self.last_ba_edges: dict = {}
        self.last_gba: dict = {}
        # device-resident per-keyframe keypoint arrays (xy, octave, valid,
        # desc_u8), registered at mint time from the fused frame's own
        # device outputs: the triangulate / fuse calls stack them instead
        # of uploading every neighbour's keypoints from the host
        self._kf_dev: dict[int, tuple] = {}
        # bumped on LARGE pose rewrites (a GBA writeback; loop corrections
        # bump store.correction_epoch): the tracker's device pose chain is
        # valid while both are unchanged. Local-BA landings do not bump it.
        self.pose_epoch = 0

    def register_kf_device(self, kf: int, xy, octave, valid, desc_u8):
        """Cache a minted keyframe's keypoint tensors (the fused step's own
        outputs, no transfer). Each must hold one row per keypoint slot of
        the store, or the stacked neighbour batch would not line up with
        the store's arrays. Entries of culled keyframes are pruned."""
        cap = self.store.kp_cap
        for name, x in (("xy", xy), ("octave", octave), ("valid", valid),
                        ("desc_u8", desc_u8)):
            if x.shape[0] != cap:
                raise ValueError(
                    f"register_kf_device: {name} of keyframe {kf} has "
                    f"{x.shape[0]} rows, the store holds {cap} keypoint "
                    "slots per keyframe")
        self._kf_dev[kf] = (xy, octave, valid, desc_u8)
        if len(self._kf_dev) > 16:
            store = self.store
            dead = [k for k in self._kf_dev
                    if k < store.n_kf and not store.kf_valid[k]]
            for k in dead:
                del self._kf_dev[k]

    def _kf_dev_stack(self, nbs):
        """Stacked device keypoint tensors for a neighbour batch, or None
        if any neighbour was minted through a host path (then the caller
        uploads the same arrays from the store)."""
        entries = []
        for k in nbs:
            e = self._kf_dev.get(int(k))
            if e is None:
                return None
            entries.append(e)
        return tuple(torch.stack([e[i] for e in entries]) for i in range(4))

    def _kf_host_stack(self, nbs):
        """The same four arrays as `_kf_dev_stack`, uploaded from the
        store."""
        store, dev = self.store, self.device
        return tuple(torch.as_tensor(a, device=dev) for a in (
            store.kf_kp_xy[nbs], store.kf_kp_octave[nbs],
            store.kf_kp_valid[nbs], store.kf_desc[nbs]))

    def poll_background(self) -> bool:
        """Called once per tracked frame: advance the keyframe stages (one
        transition at its landing tick), land the local BA and the global
        BA at their ticks, and chain the next GBA round when one lands.
        Returns True only when POSES moved: a BA landed, or a loop
        correction (which can run inside the keyframe stage) rewrote them."""
        epoch0 = self.store.correction_epoch
        self._frame_tick += 1
        if self._kf_stage is None:
            if self._kf_queue:
                # starting the next keyframe's stages is dispatch-only
                self._advance_kf_stage(budget=1)
        elif self._frame_tick - self._stage_tick >= STAGE_LAG_FRAMES:
            # the current stage's landing tick: fold it in and advance ONE
            # transition
            self._advance_kf_stage(block=True, budget=1)
        poses_moved = False
        if self._ba_pending is not None:
            if self._frame_tick - self._ba_tick >= BA_LAG_FRAMES:
                poses_moved = self.finalize_ba(block=True)
            else:
                self.finalize_ba(start_fetch_only=True)
        poses_moved |= self.store.correction_epoch != epoch0
        if self._gba_pending is not None:
            due = self._frame_tick - self._gba_tick >= GBA_LAG_FRAMES
            if due and self.finalize_gba(block=True):
                poses_moved = True
                self._chain_gba()
            elif not due:
                self.finalize_gba(start_fetch_only=True)
        return poses_moved

    def _chain_gba(self):
        if self._gba_rounds_left > 0:
            self._gba_rounds_left -= 1
            self.global_ba(iters=self._gba_iters, async_dispatch=True)

    def drain_background(self):
        """Blocking drain: finish the keyframe stage pipeline (queued
        keyframes included), land the local BA, install a finished
        vocabulary, then land every remaining GBA round."""
        self.drain_kf_stages()
        self.finalize_ba(block=True)
        if self.loop_closer is not None:
            # a trained vocabulary must land even when the run ends before
            # its fixed keyframe tick
            self.loop_closer.flush_vocab()
        while self._gba_pending is not None:
            self.finalize_gba(block=True)
            self._chain_gba()

    _gba_iters = (5, 5)

    # ------------------------------------------------------------------
    # keyframe processing as an overlapped stage pipeline: each stage
    # launches its device work and starts the fetch of its result; the
    # per-frame poll advances to the next stage at the landing tick. A
    # keyframe event itself pays for host bookkeeping and one dispatch.
    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int):
        # ENQUEUE and return; stages of consecutive keyframes
        # coexist the way the reference's mapping thread consumes its queue
        self._kf_queue.append(kf)
        if self._kf_stage is None:
            self._advance_kf_stage(budget=1)  # start now: dispatch-only

    def drain_kf_stages(self):
        """Blocking: run every queued keyframe's stages to completion."""
        while self._kf_stage is not None or self._kf_queue:
            self._advance_kf_stage(block=True)

    @property
    def mapping_idle(self) -> bool:
        """`LocalMapping::AcceptKeyFrames` for the keyframe policy: no stage
        in flight and nothing queued."""
        return self._kf_stage is None and not self._kf_queue

    def _advance_kf_stage(self, block: bool = False, budget=None) -> bool:
        """Advance the keyframe mapping pipeline: triangulate -> fuse ->
        {local BA dispatch, keyframe culling, loop closing}; when the slot
        frees up, start the next queued keyframe's stages.

        A stage's result is folded in ONLY by a `block=True` call at its
        landing tick (poll_background) or a drain. `budget` caps the number
        of stage TRANSITIONS. Returns True if the map changed."""
        T = self.timer
        changed = False
        while self._kf_stage is not None or self._kf_queue:
            if budget is not None and budget <= 0:
                return changed
            if self._kf_stage is None:
                nxt = self._kf_queue.popleft()
                if not self.store.kf_valid[nxt]:
                    continue
                # land a pending local BA before triangulating the next
                # keyframe: refined poses under the new points
                if self._ba_pending is not None:
                    if self.finalize_ba(block=True):
                        changed = True
                with T.stage("map.cull_points"):
                    self._cull_recent_points(nxt)
                with T.stage("map.tri_dispatch"):
                    self._kf_stage = ("triangulate", nxt,
                                      self._dispatch_triangulate(nxt))
                self._stage_tick = self._frame_tick
                if budget is not None:
                    budget -= 1
                continue
            if not block:
                return changed
            kind, kf, payload = self._kf_stage
            if not self.store.kf_valid[kf]:
                self._kf_stage = None
                continue
            if budget is not None:
                budget -= 1
            if kind == "triangulate":
                if payload is not None:
                    meta, fetch = payload
                    with T.stage("map.tri_apply"):
                        self._apply_triangulate(kf, meta, fetch.get())
                        changed = True
                self.stats["tri_applied"] += 1
                self.store.update_covisibility(kf)
                with T.stage("map.fuse_dispatch"):
                    self._kf_stage = ("fuse", kf, self._dispatch_fuse(kf))
                self._stage_tick = self._frame_tick
            elif kind == "fuse":
                if payload is not None:
                    meta, fetch = payload
                    with T.stage("map.fuse_apply"):
                        self._apply_fuse(kf, meta, fetch.get())
                        changed = True
                self.stats["fuse_applied"] += 1
                store = self.store
                if store.kf_valid[: store.n_kf].sum() > 2:
                    with T.stage("map.ba_dispatch"):
                        # a previous BA still in flight is dropped by the
                        # new dispatch, as the reference aborts the running
                        # local BA when a fresh keyframe arrives: the new
                        # window subsumes the stale result
                        self.finalize_ba(block=False)
                        self.local_ba(kf, async_dispatch=True)
                with T.stage("map.kf_cull"):
                    self._cull_keyframes(kf)
                if self.loop_closer is not None:
                    with T.stage("map.loop"):
                        self.loop_closer.process_keyframe(kf)
                        changed = True
                self._kf_stage = None
        return changed

    # ------------------------------------------------------------------
    def prewarm(self):
        """Run the local-BA bucket ladder once on dummy problems, so the
        first keyframes of a run do not pay the libraries' set-up (cuBLAS
        and cuSOLVER handles, the caching allocator's first blocks) nor, on
        the card, the capture of each bucket's CUDA graph inside the frame
        stream. Returns the number of problems run."""
        cam = self.cfg.camera
        cfg = self.cfg.mapping
        dev = self.device
        C = cfg.local_ba_window + cfg.local_ba_fixed
        ladder = []
        P = 1024
        while P <= cfg.local_ba_point_cap:
            for E in (P, 2 * P, 4 * P, 8 * P):
                if 1024 <= E <= cfg.local_ba_edge_cap:
                    ladder.append((C, P, E))
            P *= 2
        outs = []
        for C, P, E in ladder:
            R = torch.eye(3, device=dev).expand(C, 3, 3).contiguous()
            t = torch.zeros((C, 3), device=dev)
            fixed = torch.zeros(C, dtype=torch.bool, device=dev)
            fixed[0] = True
            pts = torch.cat([torch.zeros((P, 2), device=dev),
                             torch.full((P, 1), 8.0, device=dev)], 1)
            es = ba.EdgeSet(torch.zeros(E, dtype=torch.int32, device=dev),
                            torch.zeros(E, dtype=torch.int32, device=dev),
                            torch.full((E, 2), 300.0, device=dev),
                            torch.ones(E, device=dev),
                            torch.ones(E, dtype=torch.bool, device=dev))
            Eb = max(E // 4, min(4096, cfg.local_ba_edge_cap))
            aux = ba.EdgeSet(
                torch.zeros(Eb, dtype=torch.int32, device=dev),
                torch.zeros(Eb, dtype=torch.int32, device=dev),
                torch.full((Eb, 3), 1.0, device=dev),
                torch.zeros(Eb, device=dev),
                torch.zeros(Eb, dtype=torch.bool, device=dev))
            res = self._bundle_adjust(
                R, t, fixed, torch.ones(C, dtype=torch.bool, device=dev), pts,
                torch.ones(P, dtype=torch.bool, device=dev), es, aux, aux,
                cam.fx, cam.fy, cam.cx, cam.cy, bf=cam.bf,
                iters_phase1=5, iters_phase2=10, device=dev)
            outs.append(res.cam_R)
        if outs:
            torch.stack([o[0] for o in outs]).cpu()
        return len(ladder)

    # ------------------------------------------------------------------
    def _cull_recent_points(self, kf: int):
        """MapPointCulling: drop low-found-ratio / under-observed points,
        in one batched erase."""
        store = self.store
        cfg = self.cfg.mapping
        if not self.recent_mp:
            return
        arr = np.asarray(self.recent_mp, np.int64).reshape(-1, 2)
        ids, births = arr[:, 0], arr[:, 1]
        valid = store.mp_valid[ids]
        found = store.mp_found[ids].astype(np.float32)
        visible = np.maximum(store.mp_visible[ids], 1).astype(np.float32)
        age = kf - births
        kill = valid & (store.mp_visible[ids] >= 3) \
            & (found / visible < cfg.found_ratio_cull)
        if self.cfg.sensor == "mono":
            kill |= valid & (age >= 2) & (store.mp_n_obs[ids] <= 2)
        store.erase_points(ids[kill])
        self.stats["points_culled"] += int(kill.sum())
        keep = valid & ~kill & (age < 3)   # age>=3 graduates
        self.recent_mp = list(zip(ids[keep].tolist(),
                                  births[keep].tolist()))

    # ------------------------------------------------------------------
    def _dispatch_triangulate(self, kf: int):
        """CreateNewMapPoints, dispatch half: one batched device op over
        every triangulation neighbour, and the start of its fetch."""
        store = self.store
        cfg = self.cfg
        dev = self.device
        n_pad = cfg.mapping.triangulation_neighbors
        neighbors = store.covisible_kfs(kf, min_weight=15, top_n=n_pad)
        if len(neighbors) == 0:
            return None
        c1 = store.kf_center(kf)
        # host-side baseline-vs-depth gate (LocalMapping.cc:254-270)
        good = [nb for nb in neighbors
                if (md := self._median_depth(nb)) > 0
                and np.linalg.norm(store.kf_center(nb) - c1) / md >= 0.01]
        if not good:
            return None
        free1 = store.kf_kp_valid[kf] & (store.kf_kp_mp[kf] < 0)
        # all neighbours in ONE batched op: the neighbour axis padded to the
        # config bucket, the padding masked
        nbs = np.asarray(good + [good[-1]] * (n_pad - len(good)), np.int64)
        nb_ok = np.zeros(n_pad, bool)
        nb_ok[: len(good)] = True
        free2 = (store.kf_kp_valid[nbs] & (store.kf_kp_mp[nbs] < 0))
        dev1 = self._kf_dev.get(int(kf))
        if dev1 is not None:
            xy1, oct1, _, desc1 = dev1
        else:
            xy1, oct1, _, desc1 = (x[0] for x in self._kf_host_stack([kf]))
        xy2, oct2, _, desc2 = (self._kf_dev_stack(nbs)
                               or self._kf_host_stack(nbs))

        def on(x):
            return torch.as_tensor(x, device=dev)

        out = device_ops.epipolar_triangulate_batch(
            on(store.kf_R[kf]), on(store.kf_t[kf]), on(store.kf_R[nbs]),
            on(store.kf_t[nbs]), on(nb_ok), cfg.camera.K.to(dev),
            xy1, oct1, on(free1), desc1, xy2, oct2, on(free2), desc2,
            on(self.level_sigma2))
        return (good, free1), BackgroundFetch(out, self.timer)

    def _apply_triangulate(self, kf: int, meta, fetched):
        """CreateNewMapPoints, apply half: allocate the accepted points from
        the device-COMPACTED candidate list (sel_n, sel_k1, idx2, X, valid:
        at most TRI_COMPACT_CAP rows). The first (best-covisible) neighbour
        accepting a keypoint wins, the reference's serial visit order: the
        compaction emits candidates in neighbour-major order, so the first
        occurrence per keypoint is exactly that rule."""
        store = self.store
        good, free1 = meta
        sel_n, sel_k1, sel_idx2, sel_X, sel_valid, n_acc = fetched
        if int(n_acc) > len(sel_k1):
            self.compact_overflows += 1
        nbs = np.asarray(good, np.int64)
        m = (sel_valid & (sel_n < len(nbs)) & free1[sel_k1]
             & store.kf_valid[nbs[np.clip(sel_n, 0, len(nbs) - 1)]])
        sn, sk = sel_n[m], sel_k1[m]
        si, sX = sel_idx2[m], sel_X[m]
        if len(sk) == 0:
            return
        # dedupe per keypoint, keeping the first in neighbour-major order
        order = np.argsort(sk, kind="stable")
        sn, sk, si, sX = sn[order], sk[order], si[order], sX[order]
        k1, first = np.unique(sk, return_index=True)
        sn, si, sX = sn[first], si[first], sX[first]
        ids = store.alloc_points(
            sX.astype(np.float32), store.kf_desc[kf][k1], kf,
            int(store.kf_frame_id[kf]))
        store.add_observations(kf, k1, ids)
        # neighbour-side observations grouped per neighbour
        for j in np.unique(sn):
            sel = sn == j
            store.add_observations(int(nbs[j]), si[sel], ids[sel])
        free1[k1] = False
        self.recent_mp.extend(zip(ids.tolist(), [kf] * len(ids)))
        store.update_point_stats(ids, self.scale_factors)
        # fresh landmarks enter the tracker's candidate bundle on the next
        # frame, not only when the local BA lands
        store.big_change_idx += 1

    def _median_depth(self, kf: int) -> float:
        store = self.store
        mp = store.kf_kp_mp[kf]
        ids = mp[mp >= 0]
        ids = ids[store.mp_valid[ids]] if len(ids) else ids
        if len(ids) == 0:
            return -1.0
        Xc = store.mp_pos[ids] @ store.kf_R[kf].T + store.kf_t[kf]
        return float(np.median(Xc[:, 2]))

    # ------------------------------------------------------------------
    def _dispatch_fuse(self, kf: int):
        """SearchInNeighbors, dispatch half. BOTH directions of the
        reference pass: kf's points into all fuse neighbours, and the union
        of the neighbours' points into kf (the reverse half attaches a new
        keyframe to its predecessors' fresh landmarks). One call, matching
        row by row, and one fetch for everything."""
        store = self.store
        cam = self.cfg.camera
        dev = self.device
        neighbors = store.covisible_kfs(kf, min_weight=15, top_n=10)
        if len(neighbors) == 0:
            return None
        P = self.cfg.mapping.fuse_point_cap

        def bundle(ids):
            ids = ids[store.mp_valid[ids]]
            if len(ids) > P:
                order = np.argsort(-store.mp_n_obs[ids], kind="stable")
                ids = np.sort(ids[order[:P]])
            ids_p = np.pad(ids, (0, P - len(ids)))
            pvalid = np.zeros(P, bool)
            pvalid[: len(ids)] = True
            return ids, ids_p, pvalid

        mp = store.kf_kp_mp[kf]
        ids_f, ids_fp, pval_f = bundle(np.unique(mp[mp >= 0]))
        nmp = store.kf_kp_mp[neighbors]
        ids_r, ids_rp, pval_r = bundle(np.unique(nmp[nmp >= 0]))
        if len(ids_f) == 0 and len(ids_r) == 0:
            return None
        # forward rows: kf's points into each neighbour; final row: the
        # neighbour union into kf
        n_fwd = FUSE_FWD_ROWS
        n_pad = FUSE_ROW_PAD
        nbs = np.asarray(
            list(neighbors) + [neighbors[-1]] * (n_fwd - len(neighbors))
            + [kf], np.int64)
        nb_ok = np.zeros(n_pad, bool)
        nb_ok[: len(neighbors)] = True
        nb_ok[-1] = len(ids_r) > 0
        fwd_pos = np.where(pval_f[:, None], store.mp_pos[ids_fp],
                           1e9).astype(np.float32)
        rev_pos = np.where(pval_r[:, None], store.mp_pos[ids_rp],
                           1e9).astype(np.float32)
        kxy, koct, kval, kdesc = (self._kf_dev_stack(nbs)
                                  or self._kf_host_stack(nbs))

        def on(x):
            return torch.as_tensor(x, device=dev)

        out = device_ops.fuse_project_batch2_fr(
            on(store.kf_R[nbs]), on(store.kf_t[nbs]), on(nb_ok),
            on(fwd_pos), on(pval_f), on(store.mp_desc[ids_fp]),
            on(rev_pos), on(pval_r), on(store.mp_desc[ids_rp]),
            kxy, koct, kval, kdesc,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
            torch.full((P,), 3.0, device=dev))
        meta = (list(neighbors) + [kf], ids_f, pval_f, ids_r, pval_r,
                ids_fp, ids_rp)
        return meta, BackgroundFetch(out, self.timer)

    def _apply_fuse(self, kf: int, meta, fetched):
        """SearchInNeighbors, apply half: merge duplicate landmarks (keep
        the better-observed one) from the device-COMPACTED match list of
        (row, landmark slot, target keypoint) triples. The common outcome,
        a target keypoint without a landmark, is one vectorized
        observation write per row; only true merges take the per-pair
        path. The last row is the REVERSE pass (neighbour union into kf)."""
        store = self.store
        rows, ids_f, pval_f, ids_r, pval_r, ids_fp, ids_rp = meta
        sel_row, sel_p, sel_tgt, sel_ok, n_acc = fetched
        if int(n_acc) > len(sel_p):
            self.compact_overflows += 1
        n_pad = FUSE_ROW_PAD   # same row-axis padding as _dispatch_fuse
        for j, nb in enumerate(rows):
            if not store.kf_valid[nb]:
                continue  # culled while the fuse batch was in flight
            reverse = j == len(rows) - 1
            ids_p = ids_rp if reverse else ids_fp
            pvalid = pval_r if reverse else pval_f
            row_id = j if not reverse else n_pad - 1
            keep = (sel_ok & (sel_row == row_id)
                    & pvalid[np.clip(sel_p, 0, len(pvalid) - 1)])
            fi = sel_p[keep]
            if len(fi) == 0:
                continue
            mp_id = ids_p[fi]
            tgt = sel_tgt[keep].astype(np.int64)
            alive = store.mp_valid[mp_id]   # may have merged away already
            existing = store.kf_kp_mp[nb, tgt]
            ex_dead = (existing < 0) | ~store.mp_valid[existing.clip(0)]
            add = alive & ex_dead
            store.add_observations(nb, tgt[add], mp_id[add])
            merge = np.nonzero(alive & ~ex_dead & (existing != mp_id))[0]
            for m in merge:
                a, b = int(mp_id[m]), int(existing[m])
                if not (store.mp_valid[a] and store.mp_valid[b]):
                    continue
                if store.mp_n_obs[b] >= store.mp_n_obs[a]:
                    store.replace_point(a, b)
                else:
                    store.replace_point(b, a)
        # the reverse pass changed kf's own observation set
        store.update_covisibility(kf)

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
            stereo_es, n_stereo = mk_edges(s_cam, s_pt, s_obs, s_info, 3,
                                           aux_s, min(aux_pad, aux_s))
            bird_es, n_bird = mk_edges(b_cam, b_pt, b_obs, b_info, 3,
                                       aux_b, min(aux_pad, aux_b))
        else:
            mono_es, n_mono = mk_edges(e_cam, e_pt, e_obs, e_info, 2, cap,
                                       B_m)
            stereo_es, n_stereo = mk_edges(s_cam, s_pt, s_obs, s_info, 3,
                                           aux_pad, aux_pad)
            bird_es, n_bird = mk_edges(b_cam, b_pt, b_obs, b_info, 3,
                                       aux_pad, aux_pad)
        # the valid edges of each type, counted on the host
        self.last_ba_edges = dict(mono=n_mono, stereo=n_stereo, bird=n_bird)
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

    def _bundle_adjust(self, *args, **kwargs):
        """`ba.bundle_adjust`, looked up in its module at each call (the
        benchmark's check wraps it there), with the CUDA graphs it captured
        and replayed counted in the span record (`map.ba_graph_capture`,
        `map.ba_graph_replay`)."""
        before = dict(ba.GRAPH_COUNTS)
        res = ba.bundle_adjust(*args, **kwargs)
        for what, n in ba.GRAPH_COUNTS.items():
            if n > before[what]:
                self.timer.count(f"map.ba_graph_{what}", n - before[what])
        return res

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
        res = self._bundle_adjust(
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


    # ------------------------------------------------------------------
    def local_ba(self, kf: int, iters=(5, 10), async_dispatch: bool = False):
        """Dispatch the local BA: the keyframe, its covisible window and a
        fixed frontier. With `async_dispatch` the BA's kernels are queued
        and its fetch started, and `finalize_ba` lands the result at its
        tick; tracking frames run meanwhile. (In eager PyTorch the host
        issues every kernel of the BA before this returns.)"""
        store = self.store
        cfg = self.cfg.mapping
        cam = self.cfg.camera
        window = store.covisible_kfs(kf, min_weight=15,
                                     top_n=cfg.local_ba_window - 1)
        window = np.concatenate([[kf], window]).astype(np.int64)
        # fixed frontier: KFs observing window landmarks but not in window
        mp = store.kf_kp_mp[window]
        mp_ids = np.unique(mp[mp >= 0])
        obs = store.kf_kp_mp[: store.n_kf]
        member = np.zeros(store.max_mp, bool)
        member[mp_ids] = True
        sees = (member[obs.clip(0)] & (obs >= 0)).any(1)
        sees &= store.kf_valid[: store.n_kf]
        frontier = np.setdiff1d(np.nonzero(sees)[0], window)[: cfg.local_ba_fixed]
        # camera axis padded to the cap ALWAYS (a 288×288 Schur system), so
        # the problem's shape depends on the point and edge buckets alone
        pad_to = cfg.local_ba_window + cfg.local_ba_fixed
        (all_kfs, cam_R, cam_t, fixed, cam_valid, points, pvalid,
         mono_es, stereo_es, bird_es, mp_ids, bmp_ids, n_mp, n_bmp,
         n_mono) = \
            self._gather_ba_problem(window, frontier, pad_to=pad_to)
        with self.timer.device_span("map.local_ba", self.device):
            res = self._bundle_adjust(
                cam_R, cam_t, fixed, cam_valid, points, pvalid,
                mono_es, stereo_es, bird_es,
                cam.fx, cam.fy, cam.cx, cam.cy, bf=cam.bf,
                iters_phase1=iters[0], iters_phase2=iters[1],
                device=self.device,
            )
        if self._ba_pending is not None:
            self.stats["ba_dropped"] += 1
        self.stats["ba_dispatched"] += 1
        self.stats["ba_stereo_edges"] += self.last_ba_edges["stereo"]
        self._ba_pending = dict(
            res=res, window=window, all_kfs=all_kfs, mono_es=mono_es,
            mp_ids=mp_ids, bmp_ids=bmp_ids, n_mp=n_mp, n_bmp=n_bmp,
            n_mono=n_mono, epoch=store.correction_epoch)
        self._ba_tick = self._frame_tick
        if not async_dispatch:
            self.finalize_ba(block=True)

    def finalize_ba(self, block: bool = False,
                    start_fetch_only: bool = False) -> bool:
        """Land an in-flight local BA: write poses and points back to the
        store and erase outlier observations.

        The writeback happens ONLY on a `block=True` call (poll_background
        at the BA's landing tick, or a drain). Otherwise the call only
        starts the fetch of the result, sliced to the real problem size,
        with the mono edges' (cam, pt) columns in the same transfer.
        Returns True when a writeback happened."""
        pend = self._ba_pending
        if pend is None:
            return False
        res = pend["res"]
        fetch = pend.get("fetch")
        if fetch is None:
            n_real = len(pend["all_kfs"])
            n_pts = pend["n_mp"] + pend["n_bmp"]
            n_mono = pend["n_mono"]
            mono_es = pend["mono_es"]
            fetch = pend["fetch"] = BackgroundFetch(
                (res.cam_R[:n_real], res.cam_t[:n_real],
                 res.points[:n_pts], res.inl_mono[:n_mono],
                 mono_es.cam[:n_mono], mono_es.pt[:n_mono]), self.timer)
        if not block or start_fetch_only:
            return False
        arrays = fetch.get()
        # the BA's device span has finished: read it into the record
        self.timer.poll()
        self._ba_pending = None
        store = self.store
        if store.correction_epoch != pend["epoch"]:
            # the map was corrected while this BA was in flight: stale
            self.stats["ba_dropped"] += 1
            return False
        self.stats["ba_landed"] += 1
        window, all_kfs = pend["window"], pend["all_kfs"]
        mp_ids, bmp_ids = pend["mp_ids"], pend["bmp_ids"]
        n_mp, n_bmp = pend["n_mp"], pend["n_bmp"]
        camR_np, camt_np, pts_out, inl, ecam, ept = arrays
        nw = len(window)
        live = store.kf_valid[window]   # culled while BA was in flight
        store.kf_R[window[live]] = camR_np[:nw][live]
        store.kf_t[window[live]] = camt_np[:nw][live]
        mp_live = store.mp_valid[mp_ids]
        store.mp_pos[mp_ids[mp_live]] = pts_out[:n_mp][mp_live]
        if n_bmp:
            b_live = store.bmp_valid[bmp_ids]
            store.bmp_pos[bmp_ids[b_live]] = \
                pts_out[n_mp: n_mp + n_bmp][b_live]
        # erase outlier observations (mono edges only, like the reference),
        # grouped per keyframe. The first n_mono edges are exactly the
        # valid ones.
        bad = np.nonzero(~inl & (ept < n_mp))[0]
        if len(bad):
            bad_k = all_kfs[ecam[bad]]
            bad_mp = mp_ids[ept[bad]]
            keep = store.mp_valid[bad_mp] & store.kf_valid[bad_k]
            bad_k, bad_mp = bad_k[keep], bad_mp[keep]
            for k in np.unique(bad_k):
                member = np.zeros(store.max_mp, bool)
                member[bad_mp[bad_k == k]] = True
                row = store.kf_kp_mp[k]
                kps = np.nonzero((row >= 0) & member[row.clip(0)])[0]
                if len(kps):
                    store.remove_observation(int(k), kps)
        store.big_change_idx += 1
        return True

    # ------------------------------------------------------------------
    def global_ba(self, iters=(5, 5), async_dispatch: bool = False):
        """Full-map BA: ALL keyframes and landmarks, only keyframe 0 fixed
        (`GlobalBundleAdjustemntWithBirdview`). Cameras, points and each
        edge type are bucketed to powers of two. The solver: on a mesh of
        more than one shard, `parallel/sharded_ba.sharded_global_ba` (the
        points and edges partitioned into the mesh's blocks, the matrix-free
        step with 48 CG steps, as the JAX package's `jax.device_count() > 1`
        branch); on one device the dense-W `ba.bundle_adjust` while its
        (C,6,P,3) coupling tensor fits DENSE_W_MAX_BYTES, else the
        matrix-free `ba_large`.

        With `async_dispatch` the solve is queued and `finalize_gba` lands
        it at its tick; tracking frames run meanwhile, and keyframes and
        points created meanwhile are corrected by spanning-tree propagation
        at landing."""
        store = self.store
        cam = self.cfg.camera
        valid = store.valid_kf_ids()
        if len(valid) < 2:
            return
        C = 1 << max(int(np.ceil(np.log2(len(valid)))), 2)
        n_pts = int(store.mp_valid.sum() + store.bmp_valid.sum())
        point_cap = 1 << max(int(np.ceil(np.log2(max(n_pts, 1)))), 8)

        def bucket(n):
            # per-type edge buckets from the actual counts
            return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 10)

        n_front = int((store.kf_kp_mp[: store.n_kf] >= 0).sum())
        n_bird_e = int((store.kf_bird_mp[: store.n_kf] >= 0).sum())
        window = valid
        (all_kfs, cam_R, cam_t, fixed, cam_valid, points, pvalid,
         mono_es, stereo_es, bird_es, mp_ids, bmp_ids, n_mp, n_bmp,
         _) = self._gather_ba_problem(window, np.zeros(0, np.int64),
                                      pad_to=C, point_cap=point_cap,
                                      edge_cap=bucket(n_front),
                                      stereo_cap=bucket(n_front),
                                      bird_cap=bucket(n_bird_e))
        # only keyframe 0 is anchored (padding slots stay fixed)
        fixed_np = np.ones(C, bool)
        fixed_np[: len(window)] = False
        fixed_np[: len(all_kfs)][all_kfs == 0] = True
        with self.timer.stage("map.gba_dispatch"):
            if self.mesh.n_shards > 1:
                res = self._sharded_global_ba(
                    cam_R, cam_t, fixed_np, cam_valid, points, pvalid,
                    mono_es, stereo_es, bird_es, iters)
                solver = "sharded-implicit"
            else:
                dense_w_bytes = C * 6 * point_cap * 3 * 4
                large = dense_w_bytes > DENSE_W_MAX_BYTES
                solver = "large" if large else "dense-W"
                res = (ba_large.bundle_adjust_large if large
                       else self._bundle_adjust)(
                    cam_R, cam_t,
                    torch.as_tensor(fixed_np, device=self.device),
                    cam_valid, points, pvalid, mono_es, stereo_es, bird_es,
                    cam.fx, cam.fy, cam.cx, cam.cy, bf=cam.bf,
                    iters_phase1=iters[0], iters_phase2=iters[1],
                    device=self.device)
        self.last_gba = dict(
            C=C, P=int(points.shape[0]), n_kf=len(window),
            n_points=n_mp + n_bmp,
            edges=int(sum(int(es.cam.shape[0]) for es in
                          (mono_es, stereo_es, bird_es) if es is not None)),
            solver=solver, shards=self.mesh.n_shards)
        if self._gba_pending is not None:
            self.stats["gba_dropped"] += 1
        self.stats["gba_dispatched"] += 1
        self._gba_pending = dict(
            res=res, window=window, mp_ids=mp_ids, bmp_ids=bmp_ids,
            n_mp=n_mp, n_bmp=n_bmp, n_kf_snap=store.n_kf,
            n_mp_snap=store.n_mp, n_bmp_snap=store.n_bmp,
            epoch=store.correction_epoch)
        self._gba_tick = self._frame_tick
        if not async_dispatch:
            self.finalize_gba(block=True)

    def _sharded_global_ba(self, cam_R, cam_t, fixed_np, cam_valid, points,
                           pvalid, mono_es, stereo_es, bird_es, iters):
        """The full-map BA over the mapper's mesh: the points padded and
        split into contiguous blocks, each edge set regrouped by block
        (`partition_gba_problem`), then `sharded_global_ba` with 48 CG
        steps. Its points come back in the partition's global order (the
        blocks in order, padding at the end), so they land as a one-device
        result's do. Returns a `BAResult` (masks in partition order)."""
        cam = self.cfg.camera
        mesh = self.mesh
        pts_p, ptv_p, part, _ = sba.partition_gba_problem(
            mesh.n_shards, points, pvalid,
            [("mono", mono_es), ("stereo", stereo_es), ("bird", bird_es)])
        cR, ct, cf, cv, pts, ptv, edges = sba.place_gba_problem(
            mesh, cam_R, cam_t, fixed_np, cam_valid, pts_p, ptv_p, part)
        R, t, X, masks, cost = sba.sharded_global_ba(
            mesh, cR, ct, cf, cv, pts, ptv, edges["mono"][0],
            edges["stereo"][0], edges["bird"][0], cam.fx, cam.fy, cam.cx,
            cam.cy, bf=cam.bf, iters_phase1=iters[0], iters_phase2=iters[1],
            cg_iters=48)
        empty = torch.zeros((0,), dtype=torch.bool, device=X.device)
        return ba.BAResult(R, t, X, masks.get("mono", empty),
                           masks.get("stereo", empty),
                           masks.get("bird", empty), cost)

    def finalize_gba(self, block: bool = False,
                     start_fetch_only: bool = False) -> bool:
        """Land an in-flight global BA (only on a `block=True` call;
        otherwise start its fetch). Keyframes and landmarks created while
        it ran are not in the solve: they are moved with their spanning-
        tree parent / reference keyframe (`RunGlobalBundleAdjustment`'s
        tail). A GBA dispatched before a newer loop correction is dropped.
        Returns True when a writeback happened."""
        pend = self._gba_pending
        if pend is None:
            return False
        fetch = pend.get("fetch")
        if fetch is None:
            res = pend["res"]
            n_pts = pend["n_mp"] + pend["n_bmp"]
            nw = len(pend["window"])
            fetch = pend["fetch"] = BackgroundFetch(
                (res.cam_R[:nw], res.cam_t[:nw], res.points[:n_pts]),
                self.timer)
        if not block or start_fetch_only:
            return False
        with self.timer.stage("map.gba_apply"):
            arrays = fetch.get()
            self._gba_pending = None
            store = self.store
            if store.correction_epoch != pend["epoch"]:
                self.stats["gba_dropped"] += 1
                return False
            self._apply_gba(pend, *arrays)
        self.stats["gba_landed"] += 1
        return True

    def _apply_gba(self, pend, camR_out, camt_out, pts_out):
        store = self.store
        window, mp_ids, bmp_ids = \
            pend["window"], pend["mp_ids"], pend["bmp_ids"]
        n_mp, n_bmp = pend["n_mp"], pend["n_bmp"]
        # old poses of every keyframe alive now, for the propagation
        old_R = store.kf_R[: store.n_kf].copy()
        old_t = store.kf_t[: store.n_kf].copy()
        in_gba = np.zeros(store.n_kf, bool)
        in_gba[window[window < store.n_kf]] = True
        nw = len(window)
        live = store.kf_valid[window]
        store.kf_R[window[live]] = camR_out[:nw][live]
        store.kf_t[window[live]] = camt_out[:nw][live]
        mp_live = store.mp_valid[mp_ids]
        store.mp_pos[mp_ids[mp_live]] = pts_out[:n_mp][mp_live]
        if n_bmp:
            b_live = store.bmp_valid[bmp_ids]
            store.bmp_pos[bmp_ids[b_live]] = \
                pts_out[n_mp: n_mp + n_bmp][b_live]
        # keyframes created after the dispatch, in id order (each one's
        # spanning-tree parent is corrected before it)
        corrected = in_gba.copy()
        for k in range(pend["n_kf_snap"], store.n_kf):
            if not store.kf_valid[k]:
                continue
            p = int(store.kf_parent[k])
            if p < 0 or p >= store.n_kf or not corrected[p]:
                continue
            # T_new(k) = T_old(k) · T_old(p)⁻¹ · T_new(p)
            R_rel = old_R[k] @ old_R[p].T
            t_rel = old_t[k] - R_rel @ old_t[p]
            store.kf_R[k] = (R_rel @ store.kf_R[p]).astype(np.float32)
            store.kf_t[k] = (R_rel @ store.kf_t[p] + t_rel).astype(np.float32)
            corrected[k] = True
        # points created after the dispatch, through their reference KF
        for ids_new, pos, valid, ref in (
            (np.arange(pend["n_mp_snap"], store.n_mp), store.mp_pos,
             store.mp_valid, store.mp_ref_kf),
            (np.arange(pend["n_bmp_snap"], store.n_bmp), store.bmp_pos,
             store.bmp_valid, store.bmp_ref_kf),
        ):
            if len(ids_new) == 0:
                continue
            ids_new = ids_new[valid[ids_new]]
            refs = ref[ids_new]
            ok = (refs >= 0) & (refs < store.n_kf) & corrected[refs.clip(0)]
            for i, r in zip(ids_new[ok], refs[ok]):
                r = int(r)
                Xc = old_R[r] @ pos[i] + old_t[r]
                pos[i] = (store.kf_R[r].T @ (Xc - store.kf_t[r])
                          ).astype(np.float32)
        self.pose_epoch += 1
        store.big_change_idx += 1

    # ------------------------------------------------------------------
    def _cull_keyframes(self, kf: int):
        """KeyFrameCulling: a local KF is redundant if >= 90 % of its
        landmarks are observed by >= 3 OTHER keyframes at the same or finer
        scale (octave <= own octave + 1)."""
        store = self.store
        for cand in store.covisible_kfs(kf, min_weight=15):
            cand = int(cand)
            if cand == 0 or cand == kf:
                continue
            mp = store.kf_kp_mp[cand]
            kp_idx = np.nonzero(mp >= 0)[0]
            kp_idx = kp_idx[store.mp_valid[mp[kp_idx]]]
            ids = mp[kp_idx]
            if len(ids) < 10:
                continue
            own_oct = store.kf_kp_octave[cand][kp_idx]
            # other observers: the candidate's covisible keyframes
            others = np.nonzero((store.covis[cand, : store.n_kf] > 0)
                                & store.kf_valid[: store.n_kf])[0]
            others = others[others != cand]
            if len(others) == 0:
                continue
            slot = np.full(store.max_mp, -1, np.int64)
            slot[ids] = np.arange(len(ids))
            omp = store.kf_kp_mp[others]                 # (O, C)
            s = slot[omp.clip(0)]
            hit = (omp >= 0) & (s >= 0)
            fine = store.kf_kp_octave[others] <= own_oct[s.clip(0)] + 1
            counts = np.bincount(s[hit & fine], minlength=len(ids))
            redundant = int((counts >= 3).sum())
            if redundant > self.cfg.mapping.kf_cull_redundancy * len(ids):
                store.erase_keyframe(cand)
                self.stats["kf_culled"] += 1

