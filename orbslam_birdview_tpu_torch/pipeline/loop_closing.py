"""Loop closing: detection, Sim3, loop correction, essential graph, global
BA — the reference's `LoopClosing` as a pipeline stage of local mapping.

- detection: BoW candidates above the least covisible score, with the
  3-consecutive consistent-group check;
- Sim3: mutual Hamming match → batched RANSAC Horn (`solvers/sim3.py`) →
  two-frame refinement (`graph/sim3_opt.py`) → the loop neighbourhood's
  projection gate;
- correction: the corrected Sim3 over the covisible group, landmark
  correction, loop-point fusion, the Sim3 essential graph
  (`graph/pose_graph.py`, or `parallel/sharded_pose_graph.py` on a mesh of
  more than one shard), then two chained rounds of the full-map BA;
- the vocabulary: the packaged one, or (without one) a 10⁴-word
  vocabulary trained from the map's own descriptors on a worker thread,
  landing at a fixed keyframe tick.

The host does the bookkeeping in numpy; matching, RANSAC, refinement and
the pose graph run on the mapper's device. Hypothesis draws come from a
`torch.Generator` seeded 42 (CPU), the same sets on any device.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from ..api.config import SlamConfig
from ..frontend import matcher
from ..frontend.keypoints import Keypoints, unpack_bits_to_pm1
from ..graph import pose_graph
from ..graph.sim3_opt import optimize_sim3_two_frame
from ..mapping import vocab as vocab_mod
from ..mapping.kfdb import KeyFrameDatabase
from ..mapping.mapstore import MapStore
from ..parallel import sharded_pose_graph as spg
from ..solvers import sim3 as sim3_mod
from . import device_ops


def _sim3_inv(R, t, s):
    Rt = R.T
    return Rt, -(Rt @ t) / s, 1.0 / s


def _sim3_mul(Ra, ta, sa, Rb, tb, sb):
    return Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb


def _b2(n):
    """Power-of-two bucket, at least 64."""
    b = 64
    while b < n:
        b *= 2
    return b


class LoopCloser:
    def __init__(self, cfg: SlamConfig, store: MapStore, mapper,
                 vocabulary: Optional[vocab_mod.Vocabulary] = None,
                 min_consistency: int = 3):
        self.cfg = cfg
        self.store = store
        self.mapper = mapper
        self.device = mapper.device
        self.timer = mapper.timer   # the System's span record
        self.voc = vocabulary
        self.kfdb: Optional[KeyFrameDatabase] = None
        if vocabulary is not None:
            self.kfdb = KeyFrameDatabase(vocabulary, store)
        self.min_consistency = min_consistency
        self.consistent_groups: list[tuple[set, int]] = []
        self.last_loop_kf = -(10 ** 9)
        self.rng = torch.Generator().manual_seed(42)
        self.n_loops_closed = 0
        # every raw candidate set the database returned, with the loop
        # count at detection time (after a closure the true revisits are
        # covisible and excluded, so candidate audits need this log)
        self.detection_log: list[tuple[int, tuple, int]] = []
        # one record per loop corrected: pair, Sim3, pose graph, timings
        self.loop_log: list[dict] = []
        # the last Sim3 `_compute_sim3` accepted: matches, inliers, scale
        self._last_sim3: dict = {}
        self._voc_thread = None
        self._voc_result = None
        self._voc_started_kf = 0

    # ------------------------------------------------------------------
    def _next_key(self):
        """The RANSAC's hypothesis source: the generator (each call draws
        the next sets)."""
        return self.rng

    def _kp_of(self, kf: int) -> Keypoints:
        """A keyframe's keypoints as host arrays: BoW registration never
        touches the device."""
        store = self.store
        u8 = store.kf_desc[kf]
        return Keypoints(
            xy=store.kf_kp_xy[kf],
            response=np.zeros(u8.shape[0], np.float32),
            angle=store.kf_kp_angle[kf],
            octave=store.kf_kp_octave[kf],
            valid=store.kf_kp_valid[kf],
            desc_u8=u8,
            desc_pm1=(np.unpackbits(u8, axis=-1, bitorder="little")
                      .astype(np.int8) * 2 - 1),
        )

    def _install_vocab(self, voc):
        self.voc = voc
        self.kfdb = KeyFrameDatabase(voc, self.store)
        for kf in self.store.valid_kf_ids():
            self.kfdb.add_keyframe(int(kf), self._kp_of(int(kf)))

    def _maybe_bootstrap_vocab(self):
        """Without a vocabulary: train one from the young map's own
        descriptors on a worker thread (numpy k-majority), started at the
        fifth keyframe and folded in at the fixed keyframe tick start + 6
        (joining the worker if it is slower), so a run is a function of
        its frames and not of the host's load."""
        store = self.store
        if self.voc is not None or store.n_kf < 5:
            return
        if self._voc_thread is not None:
            if store.n_kf < self._voc_started_kf + 6:
                return
            self._voc_thread.join()
            self._voc_thread = None
            if self._voc_result is not None:
                voc, self._voc_result = self._voc_result, None
                self._install_vocab(voc)
            return
        descs = [store.kf_desc[kf][store.kf_kp_valid[kf]]
                 for kf in store.valid_kf_ids()]
        pm1 = (np.unpackbits(np.concatenate(descs), axis=-1,
                             bitorder="little").astype(np.int8) * 2 - 1)

        def train():
            # 10k words (b=10, d=4): on a self-similar scene a smaller
            # vocabulary inflates every pairwise score and the covisible
            # min-score gate then cuts the true revisit
            self._voc_result = vocab_mod.train_vocabulary(
                pm1, branching=10, depth=4, seed=0, max_train=16000,
                iters=3)

        self._voc_started_kf = store.n_kf
        self._voc_thread = threading.Thread(target=train, daemon=False)
        self._voc_thread.start()

    def flush_vocab(self):
        """Install a trained (or training) vocabulary regardless of the
        landing tick: on a drain the run may end before the tick, and the
        vocabulary would be lost with loop closing and BoW relocalization."""
        if self.voc is not None or self._voc_thread is None:
            return
        self._voc_thread.join()
        self._voc_thread = None
        if self._voc_result is not None:
            voc, self._voc_result = self._voc_result, None
            self._install_vocab(voc)

    # ------------------------------------------------------------------
    def process_keyframe(self, kf: int) -> bool:
        """Register the keyframe and look for a loop. Returns True if a
        loop was closed."""
        self._maybe_bootstrap_vocab()
        if self.kfdb is None:
            return False
        # register first, so the keyframe's own BoW vector exists for the
        # queries (which exclude itself and its covisible keyframes)
        self.kfdb.add_keyframe(kf, self._kp_of(kf))
        if kf - self.last_loop_kf < 10 or self.store.n_kf < 12:
            return False
        with self.timer.stage("loop.detect"):
            cands = self._detect_loop(kf)
        for cand in cands:
            with self.timer.stage("loop.sim3"):
                res = self._compute_sim3(kf, int(cand))
            if res is not None:
                S, loop_points = res
                with self.timer.stage("loop.correct"):
                    self._correct_loop(kf, int(cand), S, loop_points)
                return True
        return False

    # ------------------------------------------------------------------
    def _detect_loop(self, kf: int):
        min_score = self.kfdb.min_covisible_score(kf)
        cands = self.kfdb.detect_loop_candidates(kf, min_score)
        if len(cands) == 0:
            self.consistent_groups = []
            return []
        self.detection_log.append(
            (kf, tuple(int(c) for c in cands), self.n_loops_closed))
        # 3-consecutive-detection consistency
        store = self.store
        enough = []
        new_groups: list[tuple[set, int]] = []
        for c in cands:
            group = set(int(x) for x in
                        store.covisible_kfs(int(c), top_n=30)) | {int(c)}
            best = 0
            for prev_set, count in self.consistent_groups:
                if group & prev_set:
                    best = max(best, count + 1)
            new_groups.append((group, best))
            if best >= self.min_consistency:
                enough.append(int(c))
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------
    def _sigma2_of(self, kf: int, kp_idx):
        lvl = self.store.kf_kp_octave[kf][kp_idx]
        s2 = np.array([self.cfg.orb.scale_factor ** (2 * l)
                       for l in range(self.cfg.orb.n_levels)], np.float32)
        return s2[np.clip(lvl, 0, len(s2) - 1)]

    def _pm1(self, kf: int):
        return unpack_bits_to_pm1(torch.as_tensor(self.store.kf_desc[kf],
                                                  device=self.device))

    def _compute_sim3(self, kf: int, cand: int):
        """The Sim3 from the candidate's camera into the current one, and
        the loop neighbourhood's points, or None if a gate fails."""
        store = self.store
        dev = self.device
        cam = self.cfg.camera

        def on(x, dtype=None):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        # descriptor match restricted to keypoints with landmarks
        has_cur = (store.kf_kp_mp[kf] >= 0) & store.kf_kp_valid[kf]
        has_cnd = (store.kf_kp_mp[cand] >= 0) & store.kf_kp_valid[cand]
        cur_pm1 = self._pm1(kf)
        dist = matcher.hamming_matrix(cur_pm1, self._pm1(cand), on(has_cur),
                                      on(has_cnd))
        idx, _ = matcher.match_mutual(dist, max_dist=matcher.TH_LOW,
                                      ratio=0.75)
        idx = idx.cpu().numpy()
        m = idx >= 0
        if m.sum() < 20:
            return None
        ki = np.nonzero(m)[0]
        mp_cur = store.kf_kp_mp[kf][ki]
        mp_cnd = store.kf_kp_mp[cand][idx[ki]]
        ok = store.mp_valid[mp_cur] & store.mp_valid[mp_cnd]
        ki, mp_cur, mp_cnd = ki[ok], mp_cur[ok], mp_cnd[ok]
        n = len(ki)
        if n < 20:
            return None
        p_cur = store.mp_pos[mp_cur] @ store.kf_R[kf].T + store.kf_t[kf]
        p_cnd = store.mp_pos[mp_cnd] @ store.kf_R[cand].T + store.kf_t[cand]
        sig2_cur = self._sigma2_of(kf, ki)
        sig2_cnd = self._sigma2_of(cand, idx[ki])
        cap = 512
        npts = min(n, cap)
        pad = cap - npts

        def padp(x):
            x = x[:npts]
            return np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))

        valid = np.pad(np.ones(npts, bool), (0, pad))
        fix_scale = self.cfg.sensor in ("stereo", "rgbd")
        intr = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
        res = sim3_mod.sim3_ransac(
            self._next_key(), padp(p_cur), padp(p_cnd), valid,
            np.pad(9.21 * sig2_cur[:npts], (0, pad)).astype(np.float32),
            np.pad(9.21 * sig2_cnd[:npts], (0, pad)).astype(np.float32),
            *intr, *intr, fix_scale=fix_scale, min_inliers=20, device=dev)
        if not sim3_mod.fetch_result(res).ok:
            return None
        # reprojection refinement: the RANSAC Horn scale is too loose to
        # drive a loop correction
        uv1 = store.kf_kp_xy[kf][ki]
        uv2 = store.kf_kp_xy[cand][idx[ki]]
        Rr, tr, sr, _, n_inl = optimize_sim3_two_frame(
            res.R, res.t, res.s, padp(p_cur), padp(p_cnd), padp(uv1),
            padp(uv2),
            np.pad(1.0 / sig2_cur[:npts], (0, pad)).astype(np.float32),
            np.pad(1.0 / sig2_cnd[:npts], (0, pad)).astype(np.float32),
            valid, *intr, fix_scale=fix_scale, iters=12, device=dev)
        flat = torch.cat([Rr.reshape(-1), tr, sr.reshape(1),
                          n_inl.reshape(1).to(torch.float32)]).cpu().numpy()
        n_refined = int(flat[13])
        if n_refined < 20:
            return None
        S = (flat[:9].reshape(3, 3).copy(), flat[9:12].copy(), float(flat[12]))
        # the loop neighbourhood's projection gate
        loop_kfs = np.concatenate(
            [[cand], store.covisible_kfs(cand, top_n=10)])
        mp = store.kf_kp_mp[loop_kfs]
        loop_points = np.unique(mp[mp >= 0])
        loop_points = loop_points[store.mp_valid[loop_points]]
        if len(loop_points) < 40:
            return None
        # project through the corrected Scw into the current keyframe
        Rl, tl, sl = S
        Scw_R, Scw_t, Scw_s = _sim3_mul(Rl, tl, sl, store.kf_R[cand],
                                        store.kf_t[cand], 1.0)
        pc = Scw_s * store.mp_pos[loop_points] @ Scw_R.T + Scw_t
        pc = pc / Scw_s  # SE3-equivalent camera coordinates
        z = pc[:, 2]
        u = cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx
        v = cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy
        vis = ((z > 0.05) & (u >= 0) & (u < cam.width) & (v >= 0)
               & (v < cam.height))
        n_cap = 4096
        sel = np.nonzero(vis)[0][:n_cap]
        if len(sel) == 0:
            return None
        uv = np.zeros((n_cap, 2), np.float32)
        uv[: len(sel)] = np.stack([u[sel], v[sel]], 1)
        val = np.zeros(n_cap, bool)
        val[: len(sel)] = True
        ids_p = np.zeros(n_cap, np.int64)
        ids_p[: len(sel)] = loop_points[sel]
        idx2, _ = device_ops.match_projected(
            on(uv), on(val), on(store.mp_desc[ids_p]),
            on(store.kf_kp_xy[kf]), on(store.kf_kp_octave[kf]),
            on(store.kf_kp_valid[kf]), cur_pm1,
            torch.full((n_cap,), 10.0, device=dev), None,
            max_dist_th=matcher.TH_LOW)
        if int((idx2 >= 0).sum()) < 40:
            return None
        self._last_sim3 = dict(n_matches=n, n_inliers=n_refined,
                               scale=S[2])
        return S, loop_points

    # ------------------------------------------------------------------
    def _correct_loop(self, kf: int, cand: int, S, loop_points):
        t0 = time.perf_counter()
        store = self.store
        # drop the optimizations computed against the pre-loop map (the
        # epoch bump below would discard them at landing anyway)
        self.mapper._ba_pending = None
        self.mapper._gba_pending = None
        self.mapper._gba_rounds_left = 0
        Rl, tl, sl = S  # S_cur_cand: cand camera into cur camera (Sim3)
        # the corrected Sim3 world→cur
        Scw = _sim3_mul(Rl, tl, sl, store.kf_R[cand], store.kf_t[cand], 1.0)

        group = np.concatenate([[kf], store.covisible_kfs(kf, top_n=30)])
        group = group.astype(np.int64)
        old_poses = {int(i): (store.kf_R[i].copy(), store.kf_t[i].copy())
                     for i in store.valid_kf_ids()}
        corrected: dict[int, tuple] = {}
        R_kf, t_kf = old_poses[kf]
        for i in group:
            Ri, ti = old_poses[int(i)]
            # T_i_cur = T_iw · T_wc (uncorrected)
            R_ic = Ri @ R_kf.T
            t_ic = ti - R_ic @ t_kf
            corrected[int(i)] = _sim3_mul(R_ic, t_ic, 1.0, *Scw)

        # correct the landmarks the group observes through their owner's Sim3
        for obs, pos, valid, n in ((store.kf_kp_mp, store.mp_pos,
                                    store.mp_valid, store.max_mp),
                                   (store.kf_bird_mp, store.bmp_pos,
                                    store.bmp_valid, store.max_bmp)):
            done = np.zeros(n, bool)
            for i in group:
                row = obs[i]
                ids = np.unique(row[row >= 0])
                if len(ids):
                    ids = ids[valid[ids] & ~done[ids]]
                if len(ids) == 0:
                    continue
                done[ids] = True
                Rc, tc, sc = corrected[int(i)]
                Ro, to = old_poses[int(i)]
                p_cam = pos[ids] @ Ro.T + to
                Rinv, tinv, sinv = _sim3_inv(Rc, tc, sc)
                pos[ids] = (sinv * (p_cam @ Rinv.T) + tinv).astype(np.float32)

        # the corrected SE3 poses (R, t/s)
        for i, (Rc, tc, sc) in corrected.items():
            store.kf_R[i] = Rc.astype(np.float32)
            store.kf_t[i] = (tc / sc).astype(np.float32)

        # fuse the loop points into EVERY keyframe of the corrected group:
        # the merged observations are the cross-seam constraints the global
        # BA reconciles the two map sections with
        for gk in group:
            self._fuse_loop_points(int(gk), loop_points)
        for gk in group:
            store.update_covisibility(int(gk))

        rec = dict(kf=int(kf), cand=int(cand), **self._last_sim3)
        self._optimize_essential_graph(kf, cand, S, corrected, old_poses, rec)
        store.loop_edges.append((cand, kf))
        self.last_loop_kf = kf
        self.n_loops_closed += 1
        store.big_change_idx += 1
        store.correction_epoch += 1
        rec["correct_ms"] = (time.perf_counter() - t0) * 1e3
        self.loop_log.append(rec)

        # the global BA: dispatched now, landing while tracking goes on
        self._global_ba(kf)

    def _essential_edges(self, kf, cand, S, old_poses, valid, slot_arr):
        """Spanning-tree, strong-covisibility (weight >= 100) and earlier
        loop edges, deduplicated, measured from the PRE-correction poses,
        plus the new loop edge with the measured Sim3 (cand -> kf)."""
        store = self.store
        K = len(valid)
        oR = np.stack([old_poses[int(i)][0] for i in valid])
        ot = np.stack([old_poses[int(i)][1] for i in valid])
        par = store.kf_parent[valid]
        pok = (par >= 0) & (par < store.max_kf)
        pok[pok] &= store.kf_valid[par[pok]] & (slot_arr[par[pok]] >= 0)
        st_a = slot_arr[par[pok]]
        st_b = slot_arr[valid[pok]]
        W = store.covis[np.ix_(valid, valid)]
        ca, cb = np.nonzero(np.triu(W >= 100, k=1))
        la, lb = [], []
        for a, b in store.loop_edges:
            if slot_arr[a] >= 0 and slot_arr[b] >= 0:
                la.append(slot_arr[a])
                lb.append(slot_arr[b])
        e_a = np.concatenate([st_a, ca, np.asarray(la, np.int64)])
        e_b = np.concatenate([st_b, cb, np.asarray(lb, np.int64)])
        lo = np.minimum(e_a, e_b)
        hi = np.maximum(e_a, e_b)
        _, first = np.unique(lo * K + hi, return_index=True)
        e_a, e_b = e_a[first], e_b[first]
        # S_ba = T_b · T_a⁻¹
        mR = np.einsum("nij,nkj->nik", oR[e_b], oR[e_a])
        mt = ot[e_b] - np.einsum("nij,nj->ni", mR, ot[e_a])
        Rl, tl, sl = S
        e_i = np.append(e_a, slot_arr[cand]).astype(np.int64)
        e_j = np.append(e_b, slot_arr[kf]).astype(np.int64)
        mR = np.concatenate([mR, Rl[None]]).astype(np.float32)
        mt = np.concatenate([mt, tl[None]]).astype(np.float32)
        ms = np.append(np.ones(len(e_a), np.float32), sl).astype(np.float32)
        return e_i, e_j, mR, mt, ms, np.ones(len(e_i), np.float32)

    def _one_device_graph(self, vR, vt, vs, cand_slot, e_i, e_j, mR, mt,
                          ms, ew, rec):
        """The one-device essential graph on power-of-two buckets: the
        dense solver up to 256 vertices, the banded one above."""
        K, E = len(vR), len(e_i)
        Kp = _b2(K)
        vR_p = np.tile(np.eye(3, dtype=np.float32), (Kp, 1, 1))
        vR_p[:K] = vR
        vt_p = np.zeros((Kp, 3), np.float32)
        vt_p[:K] = vt
        vs_p = np.ones(Kp, np.float32)
        vs_p[:K] = vs
        fx_p = np.ones(Kp, bool)
        fx_p[:K] = False
        fx_p[cand_slot] = True
        if Kp <= 256:
            Ep = _b2(E)

            def padE(x, fill):
                out = np.full((Ep,) + x.shape[1:], fill, x.dtype)
                out[:E] = x
                return out

            mR_p = np.tile(np.eye(3, dtype=np.float32), (Ep, 1, 1))
            mR_p[:E] = mR
            args = (vR_p, vt_p, vs_p, fx_p, padE(e_i, 0), padE(e_j, 0),
                    mR_p, padE(mt, 0.0), padE(ms, 1.0), padE(ew, 0.0),
                    padE(np.ones(E, bool), False))
            rec["solver"] = "dense"
            return pose_graph.optimize_sim3_graph(*args, n_iters=20,
                                                  device=self.device)
        band_grp, long_grp = self._banded_groups(e_i, e_j, mR, mt, ms, ew)
        rec["solver"] = "banded"
        return pose_graph.optimize_sim3_graph_banded(
            vR_p, vt_p, vs_p, fx_p, *band_grp, *long_grp, g=8, n_iters=20,
            device=self.device)

    def _optimize_essential_graph(self, kf, cand, S, corrected, old_poses,
                                  rec):
        """Optimize the Sim3 essential graph and move every keyframe and
        landmark with it. On a mapper's mesh of more than one shard, the JAX
        package's `jax.device_count() > 1` branch: the edges split over the
        shards (`shard_edges`, no power-of-two padding), the dense sharded
        solver up to 256 vertices, the sharded PCG above. On one device the
        dense solver up to 256 vertices, the banded one above, on vertex
        and edge axes padded to power-of-two buckets (fixed identity
        vertices, invalid edges)."""
        store = self.store
        valid = store.valid_kf_ids()
        K = len(valid)
        slot_arr = np.full(store.max_kf, -1, np.int64)
        slot_arr[valid] = np.arange(K)
        vR = store.kf_R[valid].copy()
        vt = store.kf_t[valid].copy()
        vs = np.ones(K, np.float32)
        for i, (Rc, tc, sc) in corrected.items():
            if slot_arr[i] >= 0:
                vR[slot_arr[i]] = Rc
                vt[slot_arr[i]] = tc
                vs[slot_arr[i]] = sc
        e_i, e_j, mR, mt, ms, ew = self._essential_edges(
            kf, cand, S, old_poses, valid, slot_arr)
        E = len(e_i)
        rec.update(K=K, E=E)
        mesh = self.mapper.mesh
        if mesh.n_shards > 1:
            fixed = np.zeros(K, bool)
            fixed[slot_arr[cand]] = True
            sharded = spg.shard_edges(mesh, e_i, e_j, mR, mt, ms, ew,
                                      np.ones(E, bool))
            dense = K <= 256
            rec["solver"] = "sharded-dense" if dense else "sharded-pcg"
            solver = (spg.sharded_optimize_sim3_graph if dense
                      else spg.sharded_optimize_sim3_graph_pcg)
            R_out, t_out, s_out, cost, cost0 = solver(
                mesh, vR, vt, vs, fixed, *sharded, n_iters=20)
        else:
            R_out, t_out, s_out, cost, cost0 = self._one_device_graph(
                vR, vt, vs, slot_arr[cand], e_i, e_j, mR, mt, ms, ew, rec)
        flat = torch.cat([R_out[:K].reshape(-1), t_out[:K].reshape(-1),
                          s_out[:K], cost0.reshape(1),
                          cost.reshape(1)]).cpu().numpy()
        R_out = flat[: 9 * K].reshape(K, 3, 3)
        t_out = flat[9 * K: 12 * K].reshape(K, 3)
        s_out = flat[12 * K: 13 * K]
        rec["cost_before"], rec["cost_after"] = float(flat[-2]), float(
            flat[-1])
        # every landmark through its first observing keyframe's graph delta
        obs = store.kf_kp_mp[valid]                      # (K, C)
        wi, ki = np.nonzero(obs >= 0)
        ids_all = obs[wi, ki]
        keep = store.mp_valid[ids_all]
        wi, ids_all = wi[keep], ids_all[keep]
        order = np.argsort(ids_all, kind="stable")       # stable: first
        ids_s, wi_s = ids_all[order], wi[order]          # observer wins
        ids_u, first = np.unique(ids_s, return_index=True)
        owner = wi_s[first]
        pos = store.mp_pos[ids_u]
        p_cam = (vs[owner, None] * np.einsum("nij,nj->ni", vR[owner], pos)
                 + vt[owner])
        s_inv = 1.0 / s_out[owner]
        p_new = s_inv[:, None] * np.einsum(
            "nji,nj->ni", R_out[owner], p_cam - t_out[owner])
        store.mp_pos[ids_u] = p_new.astype(np.float32)
        store.kf_R[valid] = R_out.astype(np.float32)
        store.kf_t[valid] = (t_out / s_out[:, None]).astype(np.float32)

    @staticmethod
    def _banded_groups(e_i, e_j, mR, mt, ms, ew, g_sn: int = 8):
        """Orient every edge i<j (inverting the swapped measurements) and
        split by slot distance into the band (d <= g) and the long-range
        set, each padded to a bucket; the long set is capped at rank 256
        by a uniform stride."""
        swap = e_i > e_j
        ei2 = np.where(swap, e_j, e_i).astype(np.int32)
        ej2 = np.where(swap, e_i, e_j).astype(np.int32)
        inv_s = 1.0 / ms
        Rt = np.swapaxes(mR, 1, 2)
        mt_inv = -inv_s[:, None] * np.einsum("nij,nj->ni", Rt, mt)
        mR2 = np.where(swap[:, None, None], Rt, mR)
        mt2 = np.where(swap[:, None], mt_inv, mt)
        ms2 = np.where(swap, inv_s, ms)
        in_band = (ej2 - ei2) <= g_sn
        ew2 = ew
        if int((~in_band).sum()) > 256:
            keep = in_band.copy()
            li = np.nonzero(~in_band)[0]
            keep[li[np.linspace(0, len(li) - 1, 256).astype(np.int64)]] = True
            ei2, ej2 = ei2[keep], ej2[keep]
            mR2, mt2, ms2, ew2 = mR2[keep], mt2[keep], ms2[keep], ew[keep]
            in_band = (ej2 - ei2) <= g_sn

        def padgrp(mask, lo):
            n = int(mask.sum())
            cap = _b2(max(n, 1)) if max(n, 1) > lo else lo
            out_i = np.zeros(cap, np.int32)
            out_j = np.ones(cap, np.int32)  # padding: j-i in [1, g]
            oR = np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1))
            ot = np.zeros((cap, 3), np.float32)
            os_ = np.ones(cap, np.float32)
            ow = np.zeros(cap, np.float32)
            ov = np.zeros(cap, bool)
            out_i[:n], out_j[:n] = ei2[mask], ej2[mask]
            oR[:n], ot[:n], os_[:n] = mR2[mask], mt2[mask], ms2[mask]
            ow[:n] = ew2[mask]
            ov[:n] = True
            return out_i, out_j, oR, ot, os_, ow, ov

        return padgrp(in_band, 64), padgrp(~in_band, 16)

    def _fuse_loop_points(self, kf: int, loop_points):
        store = self.store
        cam = self.cfg.camera
        dev = self.device
        cap = 4096
        ids = loop_points[:cap]
        n = len(ids)
        ids_p = np.pad(ids, (0, cap - n), constant_values=0)
        pval = np.zeros(cap, bool)
        pval[:n] = store.mp_valid[ids]

        def on(x):
            return torch.as_tensor(x, device=dev)

        uv, _, ok = device_ops.project_points(
            on(store.kf_R[kf]), on(store.kf_t[kf]), on(store.mp_pos[ids_p]),
            cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height)
        idx, _ = device_ops.match_projected(
            uv, ok & on(pval), on(store.mp_desc[ids_p]),
            on(store.kf_kp_xy[kf]), on(store.kf_kp_octave[kf]),
            on(store.kf_kp_valid[kf]), self._pm1(kf),
            torch.full((cap,), 4.0, device=dev), None,
            max_dist_th=matcher.TH_LOW)
        idx = idx.cpu().numpy()
        fi = np.nonzero(idx >= 0)[0]
        if len(fi) == 0:
            return
        mp_new = ids_p[fi]
        tgt = idx[fi].astype(np.int64)
        alive = store.mp_valid[mp_new]
        existing = store.kf_kp_mp[kf, tgt]
        ex_dead = (existing < 0) | ~store.mp_valid[existing.clip(0)]
        add = alive & ex_dead
        store.add_observations(kf, tgt[add], mp_new[add])
        for m in np.nonzero(alive & ~ex_dead & (existing != mp_new))[0]:
            a, b = int(existing[m]), int(mp_new[m])
            if store.mp_valid[a] and store.mp_valid[b]:
                store.replace_point(a, b)

    def _global_ba(self, loop_kf: int, iters: int = 10):
        """The full-map BA after a loop: two chained rounds. The BA
        re-classifies outliers between its phases and re-qualifies edges
        at exit, so the second round starts with the cross-seam
        observations the first round's early iterations rejected while the
        seam residuals were still large."""
        half = (iters // 2, iters - iters // 2)
        self.mapper._gba_iters = half
        self.mapper._gba_rounds_left = 1      # the second, chained on landing
        self.mapper.global_ba(iters=half, async_dispatch=True)
