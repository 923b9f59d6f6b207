"""Tracking front-end: the per-frame state machine, up to and including
initialization.

A host-side state machine driving fixed-shape device ops:

- states {NOT_INITIALIZED, OK, LOST};
- `process` in state NOT_INITIALIZED: `make_frame` (ORB on the front image
  and on the BEV image, BEV pixels to base-frame metres) →
  `_try_initialize` (frame-to-frame matching on both streams, two-view
  initialization with the BEV ICP's metric scale) → `_create_initial_map`
  (two keyframes, map points, bird landmarks) → the mapper's two-keyframe
  BA;
- `_refresh_local_map` turns the store into the `LocalMapDevice` /
  `BirdMapDevice` bundles the fused step (`fused_track.track_step_mono`)
  tracks from.

Tracking after initialization (motion model, reference keyframe,
relocalization, local map, keyframe policy, the lag-N retirement queue of
fused frames) follows with ROADMAP Queue 1 item 10; `process` raises in
states OK and LOST until then.

Host reads on the path, as in the reference package: the match indices of
each stream, the whole `InitResult` in one transfer, and both frames'
keypoints in one transfer each.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..api.config import SlamConfig
from ..core.camera import camera_to_base_extrinsics
from ..frontend import keypoints, orb
from ..mapping.mapstore import INVALID, MapStore
from ..solvers import initializer
from ..utils.profiling import StageTimer
from . import device_ops, fused_track
from .frame import FrameData

NOT_INITIALIZED = 0
OK = 1
LOST = 2

# Landing offset (in dispatched frames) of the visible/found accumulators:
# a bundle epoch's counters are folded into the map-point statistics
# EXACTLY this many frames after they were harvested, never earlier, so the
# map does not depend on host scheduling.
ACC_LAG = 2


@dataclass
class TrajectoryEntry:
    timestamp: float
    ref_kf: int
    T_rel: np.ndarray  # Tcw_frame * Twc_refkf (4x4)
    lost: bool
    frame_id: int = -1


class Tracker:
    def __init__(self, cfg: SlamConfig, store: MapStore, mapper=None,
                 device=None):
        self.cfg = cfg
        self.store = store
        self.mapper = mapper
        self.device = resolve_device(device)
        self.state = NOT_INITIALIZED
        self.last_frame: Optional[FrameData] = None
        self.init_ref: Optional[FrameData] = None
        self.velocity: Optional[np.ndarray] = None  # 4x4 relative Tcl
        self.ref_kf: int = INVALID
        self.last_kf_frame_id = -(10 ** 9)
        self.last_reloc_frame_id = -(10 ** 9)
        self.frame_id = 0
        self.trajectory: list[TrajectoryEntry] = []
        # hypothesis sets are drawn from this generator, one attempt after
        # the other. It lives on the CPU whatever the device, so a run
        # draws the same sets on the CPU and on the GPU.
        self.generator = torch.Generator().manual_seed(0)
        self.only_tracking = False
        self.reset_requested = False
        self.timer = StageTimer()
        # what the last initialization attempt saw (matches, ICP inliers,
        # flags), for logs and checks
        self.init_stats: dict = {}

        n_lv = cfg.orb.n_levels
        self.level_sigma2 = np.array(
            [cfg.orb.scale_factor ** (2 * l) for l in range(n_lv)], np.float32)
        self.scale_factors = np.array(
            [cfg.orb.scale_factor ** l for l in range(n_lv)], np.float32)
        self.log_scale = float(np.log(cfg.orb.scale_factor))
        # camera→base extrinsics for the BEV stream
        R_bc, t_bc = camera_to_base_extrinsics(cfg.tbc_quat, cfg.tbc_t)
        self.R_bc = R_bc.numpy()
        self.t_bc = t_bc.numpy()
        self.R_cb = self.R_bc.T
        self.t_cb = -self.R_bc.T @ self.t_bc
        dev = self.device
        self._R_bc_dev = R_bc.to(dev)
        self._t_bc_dev = t_bc.to(dev)
        self._sf_dev = torch.as_tensor(self.scale_factors, device=dev)
        self._isig_dev = torch.as_tensor(1.0 / self.level_sigma2, device=dev)
        self._K_dev = cfg.camera.K.to(dev)
        # fused one-dispatch tracking state (device-resident local map)
        self._lm_bundle: Optional[fused_track.LocalMapDevice] = None
        self._lm_ids: Optional[np.ndarray] = None
        self._lm_n = 0
        self._lm_ref_kf = INVALID
        self._lm_change_idx = -1
        # fused birdview state: ground-landmark bundle
        self._bird_bundle: Optional[fused_track.BirdMapDevice] = None
        self._bird_ids: Optional[np.ndarray] = None
        self._bird_n = 0
        # device-resident visible/found accumulators for the current
        # candidate bundle (fetched+applied at bundle refresh, not per frame)
        self._acc = None
        self._acc_pending: list = []   # [((vis, found), ids, n, tick), ...]

    # ------------------------------------------------------------------
    def make_frame(self, img, timestamp, bird_img=None, bird_mask=None,
                   depth_img=None) -> FrameData:
        if depth_img is not None:
            raise NotImplementedError(
                "depth frames are ported with slice 4 (the depth modes); "
                "this port runs mono and mono+bird")
        dev = self.device
        kp = orb.extract_orb(img, self.cfg.orb, device=dev)
        cam = self.cfg.camera
        if any(abs(k) > 1e-12 for k in (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)):
            # undistort keypoints (`Frame::UndistortKeyPoints`); geometry
            # downstream assumes pinhole
            kp = kp._replace(xy=cam.undistort_points(kp.xy))
        K = kp.capacity
        fd = FrameData(
            frame_id=self.frame_id,
            timestamp=timestamp,
            kp=kp,
            R=np.eye(3, dtype=np.float32),
            t=np.zeros(3, np.float32),
            kp_mp=np.full(K, INVALID, np.int64),
        )
        if bird_img is not None:
            bcfg = self.cfg.effective_bird_orb()
            bkp = orb.extract_orb(bird_img, bcfg, mask=bird_mask, device=dev)
            base_xy = self.cfg.birdview.pixel_to_base_xy(bkp.xy).cpu().numpy()
            base_xyz = np.concatenate(
                [base_xy, np.zeros((base_xy.shape[0], 1), np.float32)], 1)
            fd.bird_kp = bkp
            fd.bird_base_xyz = base_xyz
            fd.bird_mp = np.full(bkp.capacity, INVALID, np.int64)
        self.frame_id += 1
        return fd

    # ------------------------------------------------------------------
    # main entry
    # ------------------------------------------------------------------
    def process(self, img, timestamp, bird_img=None, bird_mask=None,
                depth_img=None, right_img=None) -> FrameData:
        if self.state != NOT_INITIALIZED:
            raise NotImplementedError(
                "Tracker.process tracks nothing after initialization yet: "
                "motion-model / reference-keyframe / local-map tracking, the "
                "keyframe policy and relocalization are ROADMAP Queue 1 item "
                "10; until then drive fused_track.track_step_mono from the "
                "bundles of _refresh_local_map")
        if right_img is not None:
            raise NotImplementedError(
                "stereo frames are ported with slice 4 (the depth modes)")
        with self.timer.stage("proc.landed_acc"):
            self._apply_landed_acc(block=self.cfg.tracking.synchronous)
        if self.mapper is not None:
            with self.timer.stage("proc.poll_bg"):
                self.mapper.poll_background()
        fd = self.make_frame(img, timestamp, bird_img, bird_mask, depth_img)
        self._try_initialize(fd)
        self._record_trajectory(fd)
        self.last_frame = fd
        return fd

    # ------------------------------------------------------------------
    # the candidate bundles of the fused step
    # ------------------------------------------------------------------
    def _refresh_local_map(self):
        """Snapshot the local-map candidate set to the device. Runs on
        keyframe events / loop corrections, NOT per frame — the local map
        between keyframes is nearly constant."""
        self._harvest_acc()
        if self.ref_kf == INVALID or not self.store.kf_valid[self.ref_kf]:
            self._lm_bundle = None
            return
        store = self.store
        dev = self.device
        cap = self.cfg.tracking.fused_point_cap
        kfs = store.covisible_kfs(self.ref_kf, min_weight=1,
                                  top_n=self.cfg.tracking.local_map_max_kfs)
        kfs = np.concatenate([[self.ref_kf], kfs]).astype(np.int64)
        mp = store.kf_kp_mp[kfs]
        ids = np.unique(mp[mp >= 0])
        ids = ids[store.mp_valid[ids]]
        if len(ids) > cap:
            # over capacity: prefer candidates IN FRONT of the current
            # camera, then the best-established. Ranking by observation
            # count alone keeps the oldest landmarks — on a matured map
            # those sit BEHIND the camera and the frontier points get
            # dropped.
            front = np.ones(len(ids), bool)
            last = self.last_frame
            # raw field, NOT the pose_ok property — the property drains
            # the retirement queue as a side effect
            if last is not None and last._pose_ok:
                cam = self.cfg.camera
                Xc = store.mp_pos[ids] @ last.R.T + last.t
                z = np.maximum(Xc[:, 2], 1e-6)
                u = cam.fx * Xc[:, 0] / z + cam.cx
                v = cam.fy * Xc[:, 1] / z + cam.cy
                m = 0.5  # half-image margin: tolerate motion until refresh
                front = ((Xc[:, 2] > 0.05)
                         & (u >= -m * cam.width) & (u < (1 + m) * cam.width)
                         & (v >= -m * cam.height)
                         & (v < (1 + m) * cam.height))
            order = np.lexsort((-store.mp_n_obs[ids], ~front))
            ids = np.sort(ids[order[:cap]])
        n = len(ids)
        ids_p = np.pad(ids, (0, cap - n))
        valid = np.zeros(cap, bool)
        valid[:n] = True

        def on(x):
            return torch.as_tensor(x, device=dev)

        self._lm_bundle = fused_track.LocalMapDevice(
            pos=on(store.mp_pos[ids_p]),
            normal=on(store.mp_normal[ids_p]),
            min_dist=on(store.mp_min_dist[ids_p]),
            max_dist=on(store.mp_max_dist[ids_p]),
            valid=on(valid),
            desc_u8=on(store.mp_desc[ids_p]),
        )
        self._lm_ids = ids_p
        self._lm_n = n
        self._lm_ref_kf = self.ref_kf
        self._lm_change_idx = store.big_change_idx
        # fresh accumulators for the new bundle epoch
        self._acc = (torch.zeros(cap, dtype=torch.int32, device=dev),
                     torch.zeros(cap, dtype=torch.int32, device=dev))
        # BEV ground-landmark bundle for the fused bird stream: landmarks
        # observed by the same local keyframe set
        if self.cfg.sensor == "mono_bird":
            bcap = self.cfg.tracking.fused_bird_cap
            bmp = store.kf_bird_mp[kfs]
            bids = np.unique(bmp[bmp >= 0])
            bids = bids[store.bmp_valid[bids]] if len(bids) else bids
            bids = bids[:bcap]
            bn = len(bids)
            if bn:
                bids_p = np.pad(bids, (0, bcap - bn))
                bvalid = np.zeros(bcap, bool)
                bvalid[:bn] = True
                self._bird_bundle = fused_track.BirdMapDevice(
                    pos=on(store.bmp_pos[bids_p]),
                    valid=on(bvalid),
                    desc_u8=on(store.bmp_desc[bids_p]),
                )
                self._bird_ids = bids_p
                self._bird_n = bn
            else:
                self._bird_bundle = None
                self._bird_ids = None
                self._bird_n = 0

    def _harvest_acc(self):
        """Retire the current bundle's visible/found accumulators;
        `_apply_landed_acc` folds them into the map-point statistics at
        their landing tick (`MapPoint::IncreaseVisible/Found`, batched per
        bundle epoch)."""
        if self._acc is None or self._lm_ids is None or self._lm_n == 0:
            return
        self._acc_pending.append(
            (self._acc, self._lm_ids, self._lm_n, self.frame_id))
        self._acc = None

    def _apply_landed_acc(self, block: bool = False):
        """Fold accumulators that are >= ACC_LAG frames old (deterministic
        landing tick; `block` folds everything)."""
        store = self.store
        keep = []
        for acc, ids, n, tick in self._acc_pending:
            if block or self.frame_id - tick >= ACC_LAG:
                vis, found = torch.stack(acc).cpu().numpy()
                np.add.at(store.mp_visible, ids[:n], vis[:n])
                np.add.at(store.mp_found, ids[:n], found[:n])
            else:
                keep.append((acc, ids, n, tick))
        self._acc_pending = keep

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _try_initialize(self, fd: FrameData, draws=None):
        """One initialization attempt of `fd` against the reference frame.
        `draws` (`initializer.InitDraws`) replaces the tracker's generator
        for this attempt."""
        cfg = self.cfg.tracking
        dev = self.device
        stats = self.init_stats = dict(frame_id=fd.frame_id, attempted=False)
        if self.cfg.sensor in ("stereo", "rgbd"):
            self._initialize_with_depth(fd)
            return
        if fd.n_kp < cfg.min_init_kps:
            self.init_ref = None
            return
        if self.init_ref is None:
            self.init_ref = fd
            return
        ref = self.init_ref
        with self.timer.stage("init.match"):
            idx, _ = device_ops.match_frames_window_rot(
                ref.kp.xy, ref.kp.angle, ref.kp.desc_pm1, ref.kp.valid,
                fd.kp.xy, fd.kp.angle, fd.kp.desc_pm1, fd.kp.valid,
                torch.tensor(cfg.init_search_radius, dtype=torch.float32,
                             device=dev))
            idx_h = idx.cpu().numpy()
        matched = idx_h >= 0
        stats["n_matches"] = int(matched.sum())
        if stats["n_matches"] < cfg.min_init_matches:
            self.init_ref = fd
            return

        x1 = ref.kp.xy
        x2 = fd.kp.xy[idx.clamp(min=0).long()]
        have_bird = fd.bird_kp is not None and ref.bird_kp is not None
        bkw = {}
        bird_idx_h = None
        if have_bird:
            with self.timer.stage("init.match"):
                bird_idx, _ = device_ops.match_frames_window_rot(
                    ref.bird_kp.xy, ref.bird_kp.angle, ref.bird_kp.desc_pm1,
                    ref.bird_kp.valid,
                    fd.bird_kp.xy, fd.bird_kp.angle, fd.bird_kp.desc_pm1,
                    fd.bird_kp.valid,
                    torch.tensor(cfg.bird_search_radius, dtype=torch.float32,
                                 device=dev))
                bird_idx_h = bird_idx.cpu().numpy()
            bmatched = bird_idx_h >= 0
            stats["n_bird_matches"] = int(bmatched.sum())
            if bmatched.sum() < cfg.min_init_bird_matches:
                self.init_ref = fd
                return
            b1 = torch.as_tensor(ref.bird_base_xyz, device=dev)
            b2 = torch.as_tensor(fd.bird_base_xyz, device=dev)[
                bird_idx.clamp(min=0).long()]
            bkw = dict(
                bird_xy1=b1, bird_xy2=b2, bird_valid=bird_idx >= 0,
                bird_sigma=cfg.bird_sigma_m,
                R_bc=self._R_bc_dev, t_bc=self._t_bc_dev,
                min_icp_translation=cfg.min_icp_translation,
            )

        stats["attempted"] = True
        with self.timer.stage("init.two_view"):
            res = initializer.initialize_two_view(
                self.generator if draws is None else draws,
                x1, x2, idx >= 0, self._K_dev, sigma=1.0, device=dev, **bkw)
            # land the WHOLE result in one transfer
            res = initializer.fetch_result(res)
        stats.update(ok=bool(res.ok),
                     used_homography=bool(res.used_homography),
                     icp_ok=bool(res.icp_ok),
                     n_triangulated=int(res.good.sum()),
                     n_icp_inliers=int(res.bird_inliers.sum()))
        if not bool(res.ok):
            return
        # success: land both frames' keypoints for map construction, one
        # transfer per keypoint set
        with self.timer.stage("init.map"):
            for f in (ref, fd):
                if f.kp_host is None:
                    f.kp_host = keypoints.to_host(f.kp)
                if f.bird_kp is not None and f.bird_kp_host is None:
                    f.bird_kp_host = keypoints.to_host(f.bird_kp)
            self._create_initial_map(fd, res, idx_h, bird_idx_h)

    def _create_initial_map(self, fd, res, idx, bird_idx):
        """`res` is an `InitResult` of numpy fields (see
        `initializer.fetch_result`); idx / bird_idx the host match indices."""
        store = self.store
        ref = self.init_ref
        R21 = np.asarray(res.R21)
        t21 = np.asarray(res.t21)
        good = np.asarray(res.good)
        pts = np.asarray(res.points3d)
        have_bird = bird_idx is not None and bool(res.icp_ok)

        if not have_bird:
            # rescale so median depth = 1 (`CreateInitialMapMonocular`;
            # skipped in birdview mode — metric)
            med = np.median(pts[good][:, 2]) if good.any() else 1.0
            if med <= 0:
                return
            pts = pts / med
            t21 = t21 / med

        kf1 = store.alloc_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            ref.frame_id, ref.timestamp, ref.kp_host,
            bird=(ref.bird_kp_host, ref.bird_base_xyz)
            if ref.bird_kp is not None else None)
        kf2 = store.alloc_keyframe(
            R21, t21, fd.frame_id, fd.timestamp, fd.kp_host,
            bird=(fd.bird_kp_host, fd.bird_base_xyz)
            if fd.bird_kp is not None else None)
        k1_idx = np.nonzero(good)[0]
        k2_idx = np.asarray(idx)[k1_idx]
        descs = fd.kp_host.desc_u8[k2_idx]
        ids = store.alloc_points(pts[k1_idx], descs, kf2, fd.frame_id)
        store.add_observations(kf1, k1_idx, ids)
        store.add_observations(kf2, k2_idx, ids)
        store.update_covisibility(kf1)
        store.update_covisibility(kf2)
        store.update_point_stats(ids, self.scale_factors)

        if have_bird:
            binl = np.asarray(res.bird_inliers)
            b1_idx = np.nonzero(binl)[0]
            b2_idx = np.asarray(bird_idx)[b1_idx]
            # world == cam1 frame: landmark pos = Tcb · base_xyz(frame1)
            base1 = ref.bird_base_xyz[b1_idx]
            wpos = base1 @ self.R_cb.T + self.t_cb
            bdesc = fd.bird_kp_host.desc_u8[b2_idx]
            bids = store.alloc_bird_points(wpos, bdesc, ref.frame_id)
            store.add_bird_observations(kf1, b1_idx, bids)
            store.add_bird_observations(kf2, b2_idx, bids)
            fd.bird_mp[b2_idx] = bids

        fd.R, fd.t = R21, t21
        fd.kp_mp[k2_idx] = ids
        fd.pose_ok = True
        self.ref_kf = kf2
        self.last_kf_frame_id = fd.frame_id
        self.state = OK
        self.velocity = None
        if self.mapper is not None:
            with self.timer.stage("init.ba"):
                self.mapper.initial_global_ba(kf1, kf2)
            # poses may have been refined by the BA
            fd.R = store.kf_R[kf2].copy()
            fd.t = store.kf_t[kf2].copy()

    def _initialize_with_depth(self, fd: FrameData):
        raise NotImplementedError(
            "stereo / RGB-D initialization is ported with slice 4 (the "
            "depth modes); this port initializes mono and mono+bird")

    # ------------------------------------------------------------------
    def _record_trajectory(self, fd: FrameData):
        # pose-available wall time
        fd._finalized_wall = time.perf_counter()
        if self.ref_kf == INVALID:
            return
        store = self.store
        T_ref = np.eye(4, dtype=np.float32)
        T_ref[:3, :3] = store.kf_R[self.ref_kf]
        T_ref[:3, 3] = store.kf_t[self.ref_kf]
        T_rel = fd.Tcw() @ np.linalg.inv(T_ref)
        self.trajectory.append(
            TrajectoryEntry(fd.timestamp, self.ref_kf, T_rel,
                            not fd.pose_ok, fd.frame_id))
