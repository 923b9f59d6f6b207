"""Tracking front-end: the per-frame state machine.

A host-side state machine driving fixed-shape device ops:

- states {NOT_INITIALIZED, OK, LOST};
- initialization: `make_frame` (ORB on the front image and on the BEV
  image, BEV pixels to base-frame metres) → `_try_initialize`
  (frame-to-frame matching on both streams, two-view initialization with
  the BEV ICP's metric scale) → `_create_initial_map` → the mapper's
  two-keyframe BA;
- in state OK with a velocity: the fused one-call step
  (`fused_track.track_step_mono`) on the device pose chain, its 16-float
  summaries fetched in batches and retired through a lag-N queue
  (`_process_fused`, `_finalize_pending`); a frame whose inliers fall short
  retires through the slow path instead;
- the slow path: motion model → reference keyframe → local map
  (`_track_motion_model`, `_track_reference_kf`, `_track_local_map`), and
  in state LOST relocalization by EPnP-RANSAC against the keyframe
  database's candidates, or the last keyframes (`_relocalize`);
- the keyframe policy (`_need_new_keyframe`) and the keyframe mint, now or
  deferred by `KF_MINT_LAG` frames while its keypoints ride home
  (`_create_keyframe`, `_complete_pending_keyframe`), which hands every
  keyframe to `LocalMapper.process_keyframe`.

Every overlapped result lands at a FIXED frame offset from its dispatch
(`KF_MINT_LAG`, `ACC_LAG`, `fused_max_lag`, the mapper's stage and BA
lags), waiting for its transfer if need be, never as soon as it happens to
be ready: the map and the trajectory are a function of the frame index
alone.

Stereo and RGB-D frames carry a per-keypoint depth and right-image u
(`kp_depth`, `kp_ur`): on the fused path they are computed in the step and
stay on the device until a keyframe's batched fetch; on the slow path they
are sampled on the host from the depth image, or from the depth map that
`frontend.stereo.stereo_depth_for_frame` splats from the right image. Such
a sensor initializes from one frame (`_initialize_with_depth`) and every
keyframe seeds close points from depth (`_seed_depth_points`).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..api.config import SlamConfig
from ..core.camera import camera_to_base_extrinsics
from ..frontend import keypoints, matcher, orb, stereo
from ..frontend.keypoints import Keypoints, unpack_bits_to_pm1
from ..graph import pose_opt
from ..mapping.mapstore import INVALID, MapStore
from ..solvers import initializer, pnp
from ..utils.async_fetch import BackgroundFetch, fetch, to_numpy
from ..utils.profiling import StageTimer
from . import device_ops, fused_track
from .frame import FrameData

NOT_INITIALIZED = 0
OK = 1
LOST = 2


class _SummaryBlock:
    """Batches several frames' 16-float summaries into ONE device-to-host
    transfer: the rows are stacked on the device when the block is sealed,
    and the fetch of the stack starts then. The block seals after
    `fused_max_lag` rows, or at once (one row) whenever tracking is not
    demonstrably healthy (see `_process_fused`)."""

    def __init__(self, stats: Optional[list] = None, timer=None):
        self.rows: list = []          # per-frame (16,) device tensors
        self.fetch: Optional[BackgroundFetch] = None
        self._stats = stats           # realized-batch-size telemetry
        self._timer = timer

    def append(self, summary) -> "_SummaryRef":
        ref = _SummaryRef(self, len(self.rows))
        self.rows.append(summary)
        return ref

    def seal(self):
        if self.fetch is None:
            if self._stats is not None:
                self._stats.append(len(self.rows))
            self.fetch = BackgroundFetch(torch.stack(self.rows),
                                         self._timer)
            self.rows = []


class _SummaryRef:
    """One frame's row of a (possibly not yet sealed) summary block."""

    def __init__(self, block: _SummaryBlock, row: int):
        self._block = block
        self._row = row

    def done(self) -> bool:
        f = self._block.fetch
        return f is not None and f.done()

    def get(self) -> np.ndarray:
        self._block.seal()   # a forced retirement seals a partial block
        return self._block.fetch.get()[self._row]


# Deterministic-schedule landing offsets (in dispatched frames): a result
# dispatched at frame k is folded in EXACTLY at frame k+LAG (waiting for its
# transfer if it has not landed), never earlier.
KF_MINT_LAG = 2   # deferred keyframe mint completion
ACC_LAG = 2       # visible/found accumulator fold-in


@dataclass
class TrajectoryEntry:
    timestamp: float
    ref_kf: int
    T_rel: np.ndarray  # Tcw_frame * Twc_refkf (4x4)
    lost: bool
    frame_id: int = -1


def _to_pm1(u8):
    return np.unpackbits(u8, axis=-1, bitorder="little").astype(np.int8) * 2 - 1


class Tracker:
    def __init__(self, cfg: SlamConfig, store: MapStore, mapper=None,
                 device=None, timer: Optional[StageTimer] = None):
        self.cfg = cfg
        self.store = store
        self.mapper = mapper
        self.loop_closer = None  # attached by System
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
        # hypothesis sets (initialization, relocalization) are drawn from
        # this generator, one attempt after the other. It lives on the CPU
        # whatever the device, so a run draws the same sets on the CPU and
        # on the GPU.
        self.generator = torch.Generator().manual_seed(0)
        # localization-only mode (`Tracking::InformOnlyTracking`): track
        # against the frozen map, never insert keyframes
        self.only_tracking = False
        # mbVO: in localization mode, true when the last frame tracked
        # mostly temporal VO points (few map inliers)
        self.vo_mode = False
        self.reset_requested = False
        # the System's span record (a tracker of its own without one)
        self.timer = timer if timer is not None else StageTimer()
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
        self._n_last_inliers = 0
        dev = self.device
        self._R_bc_dev = R_bc.to(dev)
        self._t_bc_dev = t_bc.to(dev)
        self._sf_dev = torch.as_tensor(self.scale_factors, device=dev)
        self._isig_dev = torch.as_tensor(1.0 / self.level_sigma2, device=dev)
        self._K_dev = cfg.camera.K.to(dev)
        # fused one-call tracking state (device-resident local map)
        self._lm_bundle: Optional[fused_track.LocalMapDevice] = None
        self._lm_ids: Optional[np.ndarray] = None
        self._lm_n = 0
        self._lm_ref_kf = INVALID
        self._lm_change_idx = -1
        # fused birdview state: ground-landmark bundle + cached mask upload
        self._bird_bundle: Optional[fused_track.BirdMapDevice] = None
        self._bird_ids: Optional[np.ndarray] = None
        self._bird_n = 0
        self._bird_mask_dev = None
        # lag-N pipeline state: in-flight fused frames (FIFO) and the
        # device pose chain. Frames retire at a fixed depth of the queue.
        self._pending_q: deque = deque()
        # telemetry: realized summary-batch sizes
        self.batch_stats: list[int] = []
        self._sum_block: Optional[_SummaryBlock] = None
        self._chain = None
        # device-resident visible/found accumulators for the current
        # candidate bundle (fetched and applied per bundle epoch)
        self._acc = None
        self._acc_pending: list = []   # [(BackgroundFetch, ids, n, tick)]
        # keyframe-policy suppression: frames dispatched before this id
        # were matched against a pre-keyframe candidate bundle
        self._kf_suppress_before = 0
        # deferred keyframe creation: (fd, BackgroundFetch, frame_id) while
        # the keypoint arrays and associations ride home
        self._kf_pending = None

    # ------------------------------------------------------------------
    def make_frame(self, img, timestamp, bird_img=None, bird_mask=None,
                   depth_img=None) -> FrameData:
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
            call=self.timer.frame,
            timestamp=timestamp,
            kp=kp,
            R=np.eye(3, dtype=np.float32),
            t=np.zeros(3, np.float32),
            kp_mp=np.full(K, INVALID, np.int64),
        )
        if depth_img is not None:
            # nearest sample at the keypoint, truncated to whole pixels
            # (`Frame::ComputeStereoFromRGBD`)
            kph = self._kp_host(fd)
            xy = kph.xy
            xi = np.clip(xy[:, 0].astype(int), 0, depth_img.shape[1] - 1)
            yi = np.clip(xy[:, 1].astype(int), 0, depth_img.shape[0] - 1)
            d = depth_img[yi, xi].astype(np.float32)
            d[~kph.valid] = -1.0
            d[d <= 0] = -1.0
            fd.kp_depth = d
            with np.errstate(divide="ignore"):
                ur = np.where(d > 0, xy[:, 0] - cam.bf / np.maximum(d, 1e-9),
                              -1.0)
            fd.kp_ur = ur.astype(np.float32)
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

    def _kp_host(self, fd: FrameData) -> Keypoints:
        """fd's front keypoints as numpy, landed in one transfer the first
        time they are asked for."""
        if fd.kp_host is None:
            fd.kp_host = keypoints.to_host(fd.kp)
        return fd.kp_host

    # ------------------------------------------------------------------
    # main entry
    # ------------------------------------------------------------------
    def process(self, img, timestamp, bird_img=None, bird_mask=None,
                depth_img=None, right_img=None) -> FrameData:
        with self.timer.stage("proc.landed_acc"):
            self._apply_landed_acc()
        if (self._kf_pending is not None
                and self.frame_id - self._kf_pending[2] >= KF_MINT_LAG):
            with self.timer.stage("proc.kf_complete"):
                self._complete_pending_keyframe(block=True)
        if self.mapper is not None:
            epoch0 = (self.mapper.pose_epoch, self.store.correction_epoch)
            with self.timer.stage("proc.poll_bg"):
                self.mapper.poll_background()
            if epoch0 != (self.mapper.pose_epoch,
                          self.store.correction_epoch):
                # a LARGE pose rewrite landed: the device pose chain
                # predates it. Local-BA landings keep the chain.
                self._chain = None
        sensor = self.cfg.sensor
        mode_ok = ((bird_img is None and depth_img is None
                    and right_img is None and sensor == "mono")
                   or (bird_img is not None and sensor == "mono_bird")
                   or (depth_img is not None and sensor == "rgbd")
                   or (right_img is not None and sensor == "stereo"))
        fused_ok = (self.state == OK and self.velocity is not None
                    and not self.only_tracking and mode_ok)
        if fused_ok:
            if (self._lm_bundle is None
                    or self._lm_ref_kf != self.ref_kf
                    or self._lm_change_idx != self.store.big_change_idx):
                with self.timer.stage("proc.refresh_lm"):
                    self._refresh_local_map()
            if self._lm_bundle is not None and (
                    bird_img is None or self._bird_bundle is not None):
                return self._process_fused(img, timestamp, bird_img=bird_img,
                                           bird_mask=bird_mask,
                                           depth_img=depth_img,
                                           right_img=right_img)
        self.flush()
        self.timer.count("track.slow")
        if right_img is not None and depth_img is None:
            # the slow path's stereo: a splatted depth map, sampled at the
            # frame's keypoints (fused frames match the right image in the
            # step)
            with self.timer.stage("slow.stereo_depth"):
                depth_img = stereo.stereo_depth_for_frame(
                    img, right_img, self.cfg, device=self.device)
        fd = self.make_frame(img, timestamp, bird_img, bird_mask, depth_img)
        if self.state == NOT_INITIALIZED:
            self._try_initialize(fd)
        else:
            if self.only_tracking:
                ok = self._track_localization_only(fd)
            else:
                ok = False
                if self.velocity is not None and self.state == OK:
                    ok = self._track_motion_model(fd)
                if not ok and self.state == OK:
                    ok = self._track_reference_kf(fd)
                if not ok and self.state == LOST:
                    ok = self._relocalize(fd)
            if ok and not (self.only_tracking and self.vo_mode):
                # with mbVO set there are too few map matches to retrieve
                # a local map
                ok = self._track_local_map(fd)
            if ok:
                self.state = OK
                fd.pose_ok = True
                self._update_velocity(fd)
                if not self.only_tracking and self._need_new_keyframe(fd):
                    self._create_keyframe(fd)
            else:
                if self.state == OK and self.store.kf_valid.sum() <= 5:
                    # lost soon after initialization: the map is unusable,
                    # request a full system reset
                    self.reset_requested = True
                self.state = LOST
                self.velocity = None
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
        """Start the fetch of the current bundle's visible/found
        accumulators; `_apply_landed_acc` folds them into the map-point
        statistics at their landing tick (`MapPoint::IncreaseVisible/
        Found`, batched per bundle epoch)."""
        if self._acc is None or self._lm_ids is None or self._lm_n == 0:
            return
        self._acc_pending.append(
            (BackgroundFetch(self._acc, self.timer), self._lm_ids, self._lm_n,
             self.frame_id))
        self._acc = None

    def _apply_landed_acc(self, block: bool = False):
        """Fold accumulators that are >= ACC_LAG frames old (deterministic
        landing tick; `block` folds everything)."""
        store = self.store
        keep = []
        for acc_fetch, ids, n, tick in self._acc_pending:
            if block or self.frame_id - tick >= ACC_LAG:
                vis, found = acc_fetch.get()
                np.add.at(store.mp_visible, ids[:n], vis[:n])
                np.add.at(store.mp_found, ids[:n], found[:n])
            else:
                keep.append((acc_fetch, ids, n, tick))
        self._acc_pending = keep

    # ------------------------------------------------------------------
    # fused one-call tracking (pipeline/fused_track.py)
    # ------------------------------------------------------------------
    def _process_fused(self, img, timestamp, bird_img=None,
                       bird_mask=None, depth_img=None,
                       right_img=None) -> FrameData:
        """Lag-N pipelined fused tracking: dispatch frame t on the device
        pose chain, then retire in-flight frames once more than
        `fused_max_lag` are in flight. A frame's summary rides home in a
        batched block fetch; its pose, inlier gate, fallback and keyframe
        decision are made when it retires."""
        cfgt = self.cfg.tracking
        cam = self.cfg.camera
        dev = self.device
        if self._chain is None:
            self._update_last_frame()
            T_last = self.last_frame.Tcw()
            # the last FINALIZED frame may be several frames old (newer ones
            # still in flight): advance its pose by one velocity step per
            # unfinalized frame so the device-side motion model spans ONE
            # frame
            for _ in range(self.frame_id - self.last_frame.frame_id - 1):
                T_last = self.velocity @ T_last
            T_pred = self.velocity @ T_last

            def on(x):
                return torch.as_tensor(np.ascontiguousarray(x), device=dev)

            R_pred, t_pred = on(T_pred[:3, :3]), on(T_pred[:3, 3])
            R_last, t_last = on(T_last[:3, :3]), on(T_last[:3, 3])
        else:
            R_last, t_last, R_pred, t_pred = self._chain
        if self._acc is None:
            P = self._lm_bundle.capacity
            self._acc = (torch.zeros(P, dtype=torch.int32, device=dev),
                         torch.zeros(P, dtype=torch.int32, device=dev))
        bird_kw = {}
        if bird_img is not None:
            if bird_mask is not None and self._bird_mask_dev is None:
                # dataset-constant vehicle-footprint mask: upload once
                self._bird_mask_dev = torch.as_tensor(
                    np.asarray(bird_mask), dtype=torch.float32, device=dev)
            bird_kw = dict(
                bird_img=bird_img,
                bird_mask=(self._bird_mask_dev
                           if bird_mask is not None else None),
                bird_lm=self._bird_bundle,
                bird_cfg=self.cfg.effective_bird_orb(),
                bv=self.cfg.birdview,
                R_bc=self._R_bc_dev, t_bc=self._t_bc_dev,
                bird_radius=float(cfgt.bird_search_radius),
                bird_info=float(cfgt.bird_info_scale_pose
                                / cfgt.bird_sigma_m ** 2),
            )
        depth_kw = {}
        if depth_img is not None:
            depth_kw = dict(depth_map=depth_img, bf=float(cam.bf))
        elif right_img is not None:
            if right_img.dtype != np.uint8:
                right_img = np.asarray(right_img, np.float32)
            depth_kw = dict(img_right=right_img, bf=float(cam.bf))
        self.timer.count("track.fused")
        with self.timer.stage("fused.dispatch"), \
                self.timer.device_span("step", dev) as step_span:
            out = fused_track.track_step_mono(
                img, R_pred, t_pred,
                self._lm_bundle, self._sf_dev, self._isig_dev, self.cfg.orb,
                float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                int(cam.width), int(cam.height),
                radius_mult_motion=cfgt.motion_search_radius / 2.5,
                radius_mult_local=cfgt.local_search_radius / 2.5,
                R_last=R_last, t_last=t_last,
                vis_acc=self._acc[0], found_acc=self._acc[1], device=dev,
                record=self.timer, **bird_kw, **depth_kw,
            )
        self.timer.mark("dispatched", self.timer.frame)
        self._acc = (out.vis_acc, out.found_acc)
        # the frame's summary rides home in a BATCHED block fetch: exactly
        # `fused_max_lag` rows per block, sealed at once (one row) whenever
        # tracking is not demonstrably healthy, so LOST detection and the
        # keyframe policy never lag a struggling tracker
        if self._sum_block is None or self._sum_block.fetch is not None:
            # (fetch set = a forced retirement sealed the block early)
            self._sum_block = _SummaryBlock(stats=self.batch_stats,
                                            timer=self.timer)
        summary = self._sum_block.append(out.summary)
        healthy = self.state == OK and self._n_last_inliers >= 90
        if (not healthy
                or len(self._sum_block.rows) >= cfgt.fused_max_lag):
            self._sum_block.seal()
            self._sum_block = None
        fd = FrameData(frame_id=self.frame_id, call=self.timer.frame,
                       timestamp=timestamp,
                       kp=out.kp, R=np.eye(3, dtype=np.float32),
                       t=np.zeros(3, np.float32),
                       kp_mp=np.full(out.kp.capacity, INVALID, np.int64))
        fd._step_span = step_span
        fd._kp_slot_dev = out.kp_slot
        fd._lm_ids_snapshot = (self._lm_ids, self._lm_n)
        if out.bird_kp is not None:
            fd.bird_kp = out.bird_kp
            fd.bird_base_xyz = out.bird_base_xyz   # device until a mint
            fd.bird_mp = np.full(out.bird_kp.capacity, INVALID, np.int64)
            fd._bird_slot_dev = out.bird_slot
            fd._bird_ids_snapshot = (self._bird_ids, self._bird_n)
        if out.kp_depth is not None:
            # device-resident per-keypoint depth; it rides home with the
            # keyframe batch if this frame is minted
            fd.kp_depth = out.kp_depth
            fd.kp_ur = out.kp_ur
        fd._finalize_cb = self._flush_through(fd)
        self.frame_id += 1
        snapshot = (self._lm_ids, self._lm_n, self._lm_bundle.capacity,
                    self.store.correction_epoch)
        self._pending_q.append((fd, out, summary, snapshot))
        self._chain = (out.R, out.t, out.R_pred_next, out.t_pred_next)
        # DETERMINISTIC retirement: every frame finalizes EXACTLY when the
        # queue exceeds `fused_max_lag`, at a fixed frame offset from its
        # dispatch
        disruption = False
        if len(self._pending_q) > cfgt.fused_max_lag:
            with self.timer.stage("fused.retire"):
                while len(self._pending_q) > cfgt.fused_max_lag:
                    disruption |= self._finalize_pending()
        if disruption:
            # frames still in flight were dispatched against the old state;
            # their matches stay valid, but the NEXT prediction re-syncs
            # from the host
            self._chain = None
        return fd

    def _flush_through(self, fd):
        """Finalizer callback for FrameData.pose_ok: drain the retirement
        queue up to and including `fd` (the per-frame API contract: the
        reference's TrackMonocular returns the pose)."""

        def cb():
            while any(e[0] is fd for e in self._pending_q):
                self._finalize_pending()
        return cb

    def _finalize_pending(self) -> bool:
        """Finalize the oldest in-flight fused frame: read its summary, run
        the state machine (fallbacks, keyframe policy), record the
        trajectory. Returns True on any disruption that invalidates the
        device pose chain."""
        if not self._pending_q:
            return False
        fd, out, summary, (lm_ids, lm_n, P, epoch) = \
            self._pending_q.popleft()
        fd._finalize_cb = None
        self.timer.mark("retire", fd.call)
        cfgt = self.cfg.tracking
        store = self.store
        disruption = False
        stale = store.correction_epoch != epoch
        ok = False
        if self.state == LOST:
            # a previous frame got lost after this one was dispatched:
            # ignore the dispatch and relocalize
            ok = self._relocalize(fd)
            if ok:
                ok = self._track_local_map(fd)
            disruption = True
        elif not stale:
            with self.timer.stage("fused.finalize_fetch"):
                s = summary.get()
            info = fused_track.unpack_summary(s)
            fd.R, fd.t = info["R"], info["t"]
            n_inl = info["n_inliers"]
            # front + bird inliers gate the frame; the ref-ratio keyframe
            # policy compares front counts only
            fd._n_tracked = n_inl
            self._n_last_inliers = n_inl + info["n_inliers_bird"]
            thresh = (cfgt.min_localmap_inliers_after_reloc
                      if fd.frame_id - self.last_reloc_frame_id < 30
                      else cfgt.min_localmap_inliers)
            ok = (self._n_last_inliers >= thresh
                  and np.all(np.isfinite(fd.R)) and np.all(np.isfinite(fd.t)))
        if not ok and self.state != LOST:
            # starved or stale: the classic fallback for this frame
            # (`TrackReferenceKeyFrame`, then the local map)
            self.timer.count("track.fallback")
            self._update_last_frame()
            fd.kp_mp[:] = INVALID
            fd._kp_slot_dev = None
            fd._bird_slot_dev = None
            fd._n_tracked = None
            ok = self._track_reference_kf(fd)
            if ok:
                ok = self._track_local_map(fd)
            disruption = True
        if ok:
            self.state = OK
            fd.pose_ok = True
            self._update_velocity(fd)
            if (not self.only_tracking
                    and self._kf_pending is None
                    and self._need_new_keyframe(fd)):
                if fd._kp_slot_dev is None or self._starving(fd):
                    # starving: every frame of mint latency costs map
                    # coverage: create NOW (blocking fetch) so the new
                    # keyframe's triangulation starts this frame
                    if fd._kp_slot_dev is not None:
                        self._kf_apply_fetched(
                            fd, fetch(self._kf_fetch_items(fd), self.timer))
                    # a mint only ADDS landmarks: the device pose chain
                    # stays valid unless mapping moved poses meanwhile
                    disruption |= self._mint_keyframe_tracked(fd)
                else:
                    # healthy: ship the keypoint arrays and associations
                    # home in the background; creation completes
                    # KF_MINT_LAG frames later
                    self._kf_pending = (fd, BackgroundFetch(
                        self._kf_fetch_items(fd), self.timer), self.frame_id)
        else:
            if self.store.kf_valid.sum() <= 5:
                self.reset_requested = True
            self.state = LOST
            self.velocity = None
            disruption = True
        self._record_trajectory(fd)
        self.last_frame = fd
        if disruption:
            self._chain = None
        return disruption

    def resolve_associations(self, fd: FrameData):
        """Materialize fd.kp_mp from the device kp_slot tensor (fused frames
        defer this: associations are needed only for keyframes and API
        queries)."""
        slot_dev = fd._kp_slot_dev
        if slot_dev is None:
            return
        lm_ids, lm_n = fd._lm_ids_snapshot
        slot = to_numpy(slot_dev)
        P = len(lm_ids)
        fd.kp_mp = np.where((slot >= 0) & (slot < lm_n),
                            lm_ids[np.clip(slot, 0, P - 1)],
                            INVALID).astype(np.int64)
        # points culled / merged since this frame was dispatched
        culled = ~self.store.mp_valid[fd.kp_mp.clip(0)]
        fd.kp_mp[culled] = INVALID
        fd._kp_slot_dev = None

    def _kf_fetch_items(self, fd):
        """Device tensors a keyframe mint needs, as one batched transfer."""
        kp = fd.kp
        items = [kp.xy, kp.response, kp.angle, kp.octave, kp.valid,
                 kp.desc_u8, fd._kp_slot_dev]
        if fd._bird_slot_dev is not None:
            b = fd.bird_kp
            items += [b.xy, b.response, b.angle, b.octave, b.valid,
                      b.desc_u8, fd.bird_base_xyz, fd._bird_slot_dev]
        if isinstance(fd.kp_depth, torch.Tensor):
            items += [fd.kp_depth, fd.kp_ur]
        return tuple(items)

    def _kf_apply_fetched(self, fd, landed):
        """Materialize host keypoints and associations from the landed
        batch. The device keypoint tensors stay on fd.kp, and are kept for
        the mapper's triangulate / fuse calls (register_kf_device)."""
        store = self.store
        fd._kp_dev_arrays = (fd.kp.xy, fd.kp.octave, fd.kp.valid,
                             fd.kp.desc_u8)
        landed = list(landed)
        if isinstance(fd.kp_depth, torch.Tensor):
            fd.kp_ur = landed.pop()
            fd.kp_depth = landed.pop()
        xy, resp, ang, octv, val, u8, slot = landed[:7]
        lm_ids, lm_n = fd._lm_ids_snapshot
        P = len(lm_ids)
        fd.kp_mp = np.where((slot >= 0) & (slot < lm_n),
                            lm_ids[np.clip(slot, 0, P - 1)],
                            INVALID).astype(np.int64)
        fd.kp_mp[~store.mp_valid[fd.kp_mp.clip(0)]] = INVALID
        fd._kp_slot_dev = None
        fd.kp_host = Keypoints(xy, resp, ang, octv, val, u8, _to_pm1(u8))
        if fd._bird_slot_dev is not None:
            bxy, bresp, bang, boct, bval, bu8, base, bslot = landed[7:]
            bird_ids, bird_n = fd._bird_ids_snapshot
            if bird_ids is None:
                bird_ids = np.zeros(1, np.int64)
                bird_n = 0
            Pb = len(bird_ids)
            fd.bird_mp = np.where((bslot >= 0) & (bslot < bird_n),
                                  bird_ids[np.clip(bslot, 0, Pb - 1)],
                                  INVALID).astype(np.int64)
            fd.bird_mp[~store.bmp_valid[fd.bird_mp.clip(0)]] = INVALID
            fd.bird_kp_host = Keypoints(bxy, bresp, bang, boct, bval, bu8,
                                        _to_pm1(bu8))
            fd.bird_base_xyz = base
            fd._bird_slot_dev = None
            fd._mint_bird = True

    def _complete_pending_keyframe(self, block: bool = False):
        """Finish a deferred keyframe creation once its fetch landed."""
        if self._kf_pending is None:
            return
        fd, kf_fetch = self._kf_pending[:2]
        if not block and not kf_fetch.done():
            return
        self._kf_pending = None
        if self.state != OK:
            return  # lost in the meantime: stale frame, drop the mint
        self._kf_apply_fetched(fd, kf_fetch.get())
        if self._mint_keyframe_tracked(fd):
            self._chain = None

    def _mint_keyframe_tracked(self, fd) -> bool:
        """Create the keyframe; returns True iff keyframe POSES moved in the
        process (a drained local BA landing), the only case that
        invalidates the device pose chain."""
        epoch0 = (self.mapper.pose_epoch if self.mapper is not None else 0,
                  self.store.correction_epoch)
        self._create_keyframe(fd)
        epoch1 = (self.mapper.pose_epoch if self.mapper is not None else 0,
                  self.store.correction_epoch)
        return epoch0 != epoch1

    def flush(self):
        """Drain the retirement queue: finalize every in-flight frame. Call
        before reading trajectories or state that must include every
        frame."""
        while self._pending_q:
            self._finalize_pending()
        self._complete_pending_keyframe(block=True)
        self._chain = None

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
        """Stereo / RGB-D initialization (`Tracking::StereoInitialization`):
        the first frame with >= 500 depth-valid keypoints becomes a keyframe
        at the identity, its landmarks unprojected from depth."""
        if fd.kp_depth is None or (fd.kp_depth > 0).sum() < 500:
            return
        store = self.store
        kph = self._kp_host(fd)
        kf = store.alloc_keyframe(fd.R, fd.t, fd.frame_id, fd.timestamp, kph,
                                  kp_depth=fd.kp_depth, kp_ur=fd.kp_ur)
        cam = self.cfg.camera
        ki = np.nonzero((fd.kp_depth > 0) & kph.valid)[0]
        z = fd.kp_depth[ki]
        X = np.stack([(kph.xy[ki, 0] - cam.cx) / cam.fx * z,
                      (kph.xy[ki, 1] - cam.cy) / cam.fy * z, z], 1)
        ids = store.alloc_points(X.astype(np.float32), kph.desc_u8[ki], kf,
                                 fd.frame_id)
        store.add_observations(kf, ki, ids)
        store.update_covisibility(kf)
        store.update_point_stats(ids, self.scale_factors)
        fd.kp_mp[ki] = ids
        fd.pose_ok = True
        self.ref_kf = kf
        self.last_kf_frame_id = fd.frame_id
        self.state = OK
        self.velocity = None

    # ------------------------------------------------------------------
    # per-frame tracking, the slow path
    # ------------------------------------------------------------------
    def _on(self, x):
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _pose_opt_with_matches(self, fd: FrameData, R0, t0):
        """Run the motion-only LM over fd's current matches (+ bird edges +
        localization-mode temporal VO points). Returns (n_map_inliers,
        n_bird_inliers); the VO inlier count is left on fd.n_vo_inliers.
        The pose and both inlier masks land in one transfer."""
        store = self.store
        cam = self.cfg.camera
        on = self._on
        m_map = fd.kp_mp >= 0
        Xw = store.mp_pos[np.where(m_map, fd.kp_mp, 0)]
        m_vo = np.zeros_like(m_map)
        if fd.kp_vo is not None:
            m_vo = fd.kp_vo & ~m_map
            Xw = np.where(m_map[:, None], Xw, fd.kp_vo_xyz).astype(np.float32)
        m = m_map | m_vo
        info = self._isig_dev[fd.kp.octave.clamp(
            0, len(self.level_sigma2) - 1).long()]
        bird_args = {}
        if fd.bird_kp is not None:
            bm = fd.bird_mp >= 0
            Xb = store.bmp_pos[np.where(bm, fd.bird_mp, 0)]
            obs_pc = to_numpy(fd.bird_base_xyz) @ self.R_cb.T + self.t_cb
            sig = self.cfg.tracking.bird_sigma_m
            binfo = np.full(len(Xb),
                            self.cfg.tracking.bird_info_scale_pose / sig ** 2,
                            np.float32)
            bird_args = dict(Xw_bird=on(Xb),
                             obs_pc_bird=on(obs_pc.astype(np.float32)),
                             info_bird=on(binfo), valid_bird=on(bm))
        res = pose_opt.optimize_pose(
            on(np.ascontiguousarray(R0, np.float32)),
            on(np.ascontiguousarray(t0, np.float32)),
            on(Xw), fd.kp.xy, info, on(m), cam.fx, cam.fy, cam.cx, cam.cy,
            **bird_args)
        flat = fetch(torch.cat([res.R.reshape(-1), res.t,
                                res.inliers_mono.to(torch.float32),
                                res.inliers_bird.to(torch.float32)]),
                     self.timer)
        K = len(m)
        fd.R = flat[:9].reshape(3, 3).copy()
        fd.t = flat[9:12].copy()
        inl = flat[12:12 + K] > 0.5
        fd.kp_mp[m_map & ~inl] = INVALID
        fd.n_vo_inliers = 0
        if m_vo.any():
            fd.kp_vo[m_vo & ~inl] = False
            fd.n_vo_inliers = int((inl & m_vo).sum())
        n_map = int((inl & m_map).sum())
        if fd.bird_kp is not None:
            binl = flat[12 + K:] > 0.5
            fd.bird_mp[(fd.bird_mp >= 0) & ~binl] = INVALID
            return n_map, int(binl.sum())
        return n_map, 0

    def _project_and_match(self, fd: FrameData, mp_ids, radius_mult,
                           exclude_mp=None, max_dist=matcher.TH_HIGH):
        """Project map points into fd and associate them with keypoints.
        The visibility mask and the matches land in one transfer."""
        store = self.store
        cam = self.cfg.camera
        on = self._on
        cap = self.cfg.mapping.local_ba_point_cap
        mp_ids = np.asarray(mp_ids)[:cap]
        n = len(mp_ids)
        pad = cap - n
        ids_p = np.pad(mp_ids, (0, pad), constant_values=0)
        pvalid = np.zeros(cap, bool)
        pvalid[:n] = store.mp_valid[mp_ids]
        if exclude_mp is not None and len(exclude_mp):
            excl = np.isin(ids_p, exclude_mp)
            pvalid &= ~excl
        uv, pred_oct, rad_f, ok = device_ops.frustum_gate(
            on(np.asarray(fd.R, np.float32)), on(np.asarray(fd.t, np.float32)),
            on(store.mp_pos[ids_p]), on(store.mp_normal[ids_p]),
            on(store.mp_min_dist[ids_p]), on(store.mp_max_dist[ids_p]),
            on(pvalid), cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
            cam.height, self.cfg.orb.n_levels, self.log_scale)
        radius = (rad_f * radius_mult
                  * self._sf_dev[pred_oct.clamp(
                      0, len(self.scale_factors) - 1).long()])
        idx, _ = device_ops.match_projected(
            uv, ok, on(store.mp_desc[ids_p]),
            fd.kp.xy, fd.kp.octave, fd.kp.valid, fd.kp.desc_pm1,
            radius, pred_oct, max_dist_th=max_dist)
        vis, idx = fetch((ok, idx), self.timer)
        # visibility counter
        np.add.at(store.mp_visible, ids_p[vis & pvalid], 1)
        found = idx >= 0
        # don't overwrite existing associations
        tgt = idx[found]
        src = ids_p[found]
        free = fd.kp_mp[tgt] == INVALID
        fd.kp_mp[tgt[free]] = src[free]
        return int(found.sum())

    def _update_last_frame(self):
        """`Tracking::UpdateLastFrame`: refresh the last frame's pose from
        its reference keyframe (which local mapping may have moved), and in
        localization mode seed temporal "visual odometry" points from its
        depth."""
        last = self.last_frame
        if last is None or not self.trajectory:
            return
        entry = self.trajectory[-1]
        if entry.frame_id != last.frame_id:
            return
        if not entry.lost and entry.ref_kf != INVALID \
                and self.store.kf_valid[entry.ref_kf]:
            T_ref = np.eye(4, dtype=np.float32)
            T_ref[:3, :3] = self.store.kf_R[entry.ref_kf]
            T_ref[:3, 3] = self.store.kf_t[entry.ref_kf]
            T = entry.T_rel @ T_ref
            last.R, last.t = T[:3, :3].copy(), T[:3, 3].copy()
        if (not self.only_tracking or last.kp_depth is None
                or last.frame_id == self.last_kf_frame_id):
            return
        self._land_depth(last)
        # create VO points: all close ones (depth < threshold); if fewer
        # than 100 close, the 100 closest
        if last.kp_vo is None:
            last.kp_vo = np.zeros(len(last.kp_mp), bool)
            last.kp_vo_xyz = np.zeros((len(last.kp_mp), 3), np.float32)
        kph = self._kp_host(last)
        free = ((last.kp_mp < 0) & ~last.kp_vo & (last.kp_depth > 0)
                & kph.valid)
        ki = np.nonzero(free)[0]
        if len(ki) == 0:
            return
        z = last.kp_depth[ki]
        order = np.argsort(z, kind="stable")
        n_close = int((z < self.cfg.depth_threshold).sum())
        ki = ki[order[: max(n_close, min(100, len(ki)))]]
        cam = self.cfg.camera
        xy = kph.xy[ki]
        z = last.kp_depth[ki]
        Xc = np.stack([(xy[:, 0] - cam.cx) / cam.fx * z,
                       (xy[:, 1] - cam.cy) / cam.fy * z, z], 1)
        Xw = (Xc - last.t) @ last.R  # R^T (Xc − t)
        last.kp_vo[ki] = True
        last.kp_vo_xyz[ki] = Xw.astype(np.float32)

    def _project_and_match_vo(self, fd: FrameData, last: FrameData) -> int:
        """Project the last frame's temporal VO points into fd (the VO part
        of `SearchByProjection(cur, last)`)."""
        if last.kp_vo is None or not last.kp_vo.any():
            return 0
        cam = self.cfg.camera
        Xc = last.kp_vo_xyz @ fd.R.T + fd.t
        z = Xc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = np.stack([cam.fx * Xc[:, 0] / z + cam.cx,
                           cam.fy * Xc[:, 1] / z + cam.cy], 1)
        ok = (last.kp_vo & (z > 0.05)
              & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
              & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
        uv = np.where(ok[:, None], uv, 0.0)
        octv = self._kp_host(last).octave
        radius = (self.cfg.tracking.motion_search_radius
                  * self.scale_factors[np.clip(octv, 0,
                                               len(self.scale_factors) - 1)])
        on = self._on
        idx, _ = device_ops.match_projected(
            on(uv.astype(np.float32)), on(ok), last.kp.desc_u8,
            fd.kp.xy, fd.kp.octave, fd.kp.valid, fd.kp.desc_pm1,
            on(radius.astype(np.float32)), on(octv),
            max_dist_th=matcher.TH_HIGH)
        idx = to_numpy(idx)
        src = np.nonzero(idx >= 0)[0]
        tgt = idx[src]
        if fd.kp_vo is None:
            fd.kp_vo = np.zeros(len(fd.kp_mp), bool)
            fd.kp_vo_xyz = np.zeros((len(fd.kp_mp), 3), np.float32)
        free = (fd.kp_mp[tgt] == INVALID) & ~fd.kp_vo[tgt]
        fd.kp_vo[tgt[free]] = True
        fd.kp_vo_xyz[tgt[free]] = last.kp_vo_xyz[src[free]]
        return int(free.sum())

    def _track_motion_model(self, fd: FrameData) -> bool:
        last = self.last_frame
        # a fused last frame defers its associations on the device; the
        # motion model projects exactly those landmarks
        self.resolve_associations(last)
        self._update_last_frame()
        T_pred = self.velocity @ last.Tcw()
        R0, t0 = T_pred[:3, :3], T_pred[:3, 3]
        fd.R, fd.t = R0.copy(), t0.copy()
        # project the last frame's landmarks
        last_mp = last.kp_mp
        mp_ids = np.unique(last_mp[last_mp >= 0])
        n = 0
        if len(mp_ids):
            n = self._project_and_match(
                fd, mp_ids, self.cfg.tracking.motion_search_radius / 2.5)
            if n < 20:
                fd.kp_mp[:] = INVALID
                n = self._project_and_match(
                    fd, mp_ids,
                    self.cfg.tracking.motion_search_radius * 2 / 2.5)
        if self.only_tracking:
            n += self._project_and_match_vo(fd, last)
        if n < 20:
            return False
        self._match_bird_from_last(fd)
        n_inl, nb = self._pose_opt_with_matches(fd, R0, t0)
        if self.only_tracking:
            # mbVO: mostly VO points, few real map matches
            self.vo_mode = n_inl < 10
            return (n_inl + fd.n_vo_inliers) > 20
        return n_inl >= self.cfg.tracking.min_track_inliers

    def _track_reference_kf(self, fd: FrameData) -> bool:
        if self.ref_kf == INVALID:
            return False
        store = self.store
        kf = self.ref_kf
        on = self._on
        # dense descriptor match against the ref KF's keypoints with
        # landmarks
        has_mp = store.kf_kp_mp[kf] >= 0
        kp_pm1 = unpack_bits_to_pm1(on(store.kf_desc[kf]))
        dist = matcher.hamming_matrix(
            kp_pm1, fd.kp.desc_pm1, on(store.kf_kp_valid[kf] & has_mp),
            fd.kp.valid)
        idx, _ = matcher.match_mutual(dist, max_dist=matcher.TH_LOW,
                                      ratio=0.7)
        idx = to_numpy(idx)
        m = idx >= 0
        if m.sum() < 15:
            return False
        fd.kp_mp[idx[m]] = store.kf_kp_mp[kf][m]
        last = self.last_frame
        self._match_bird_from_last(fd)
        n_inl, nb = self._pose_opt_with_matches(fd, last.R, last.t)
        return n_inl >= self.cfg.tracking.min_track_inliers

    def _match_bird_from_last(self, fd: FrameData):
        """Propagate BEV landmarks from the last frame and create new ones
        (`SearchByMatchBird` + `MatchAndRetriveBirdMP`)."""
        last = self.last_frame
        if fd.bird_kp is None or last is None or last.bird_kp is None:
            return
        store = self.store
        idx, _ = device_ops.match_frames_window(
            last.bird_kp.xy, last.bird_kp.desc_pm1, last.bird_kp.valid,
            fd.bird_kp.xy, fd.bird_kp.desc_pm1, fd.bird_kp.valid,
            torch.tensor(self.cfg.tracking.bird_search_radius,
                         dtype=torch.float32, device=self.device))
        idx = to_numpy(idx)
        m = idx >= 0
        # propagate existing landmark ids
        has = m & (last.bird_mp >= 0)
        src = np.nonzero(has)[0]
        if len(src):
            keep = store.bmp_valid[last.bird_mp[src]]
            fd.bird_mp[idx[src[keep]]] = last.bird_mp[src[keep]]
        # create new landmarks from matches without one (needs last pose)
        if last.pose_ok:
            new_src = np.nonzero(m & (last.bird_mp < 0))[0]
            if len(new_src):
                # world pos from the LAST frame's pose: Twc_last·Tcb·base
                Twb_R = last.R.T @ self.R_cb
                Twb_t = last.R.T @ (self.t_cb - last.t)
                base = to_numpy(last.bird_base_xyz)[new_src]
                wpos = base @ Twb_R.T + Twb_t
                descs = to_numpy(fd.bird_kp.desc_u8)[idx[new_src]]
                bids = store.alloc_bird_points(wpos.astype(np.float32), descs,
                                               last.frame_id)
                fd.bird_mp[idx[new_src]] = bids

    def _track_localization_only(self, fd: FrameData) -> bool:
        """Localization-mode tracking: normal motion-model / ref-KF tracking
        while map matches are plentiful; once mbVO is set, run BOTH the
        motion model and relocalization and prefer the relocalized
        solution."""
        store = self.store
        if self.state == LOST:
            return self._relocalize(fd)
        if not self.vo_mode:
            ok = False
            if self.velocity is not None:
                ok = self._track_motion_model(fd)
            if not ok:
                ok = self._track_reference_kf(fd)
            return ok
        ok_mm = False
        saved = None
        if self.velocity is not None:
            ok_mm = self._track_motion_model(fd)
            saved = (fd.R.copy(), fd.t.copy(), fd.kp_mp.copy(),
                     None if fd.kp_vo is None else fd.kp_vo.copy())
        ok_reloc = self._relocalize(fd)
        if ok_reloc:
            self.vo_mode = False
        elif ok_mm:
            fd.R, fd.t, fd.kp_mp, kv = saved
            fd.kp_vo = kv
            # still pure VO: bump the found counters of the map points
            # kept
            m = fd.kp_mp >= 0
            np.add.at(store.mp_found, fd.kp_mp[m], 1)
        return ok_reloc or ok_mm

    def _track_local_map(self, fd: FrameData) -> bool:
        store = self.store
        cfg = self.cfg.tracking
        # local keyframes: vote by current matches
        m = fd.kp_mp >= 0
        if m.sum() == 0:
            return False
        obs = store.kf_kp_mp[: store.n_kf]
        member = np.zeros(store.max_mp, bool)
        member[fd.kp_mp[m]] = True
        votes = (member[obs.clip(0)] & (obs >= 0)).sum(1)
        votes[~store.kf_valid[: store.n_kf]] = 0
        local_kfs = np.nonzero(votes > 0)[0]
        order = np.argsort(-votes[local_kfs], kind="stable")
        local_kfs = local_kfs[order][: cfg.local_map_max_kfs]
        if len(local_kfs) == 0:
            return False
        self.ref_kf = int(local_kfs[0])
        # extend with covisible neighbours
        ext = set(local_kfs.tolist())
        for kf in local_kfs[:10]:
            for n in store.covisible_kfs(kf, top_n=10):
                ext.add(int(n))
                if len(ext) >= cfg.local_map_max_kfs:
                    break
        local_kfs = np.fromiter(ext, dtype=np.int64)
        # local points
        mp = store.kf_kp_mp[local_kfs]
        mp_ids = np.unique(mp[mp >= 0])
        mp_ids = mp_ids[store.mp_valid[mp_ids]]
        already = fd.kp_mp[m]
        self._project_and_match(fd, mp_ids, cfg.local_search_radius / 2.5,
                                exclude_mp=already, max_dist=matcher.TH_HIGH)
        # bird local points
        self._search_bird_local(fd, local_kfs)
        n_inl, nb = self._pose_opt_with_matches(fd, fd.R, fd.t)
        # found counters
        fm = fd.kp_mp >= 0
        np.add.at(store.mp_found, fd.kp_mp[fm], 1)
        thresh = (cfg.min_localmap_inliers_after_reloc
                  if fd.frame_id - self.last_reloc_frame_id < 30
                  else cfg.min_localmap_inliers)
        self._n_last_inliers = n_inl + nb
        return (n_inl + nb) >= thresh

    def _search_bird_local(self, fd: FrameData, local_kfs):
        """`SearchByProjectionBird`: project the bird landmarks of the local
        keyframes into the current BEV image."""
        if fd.bird_kp is None:
            return
        store = self.store
        bmp = store.kf_bird_mp[local_kfs]
        bids = np.unique(bmp[bmp >= 0])
        if len(bids) == 0:
            return
        bids = bids[store.bmp_valid[bids]]
        cap = self.cfg.mapping.local_ba_point_cap
        bids = bids[:cap]
        n = len(bids)
        if n == 0:
            return
        bv = self.cfg.birdview
        # world → base frame of the current pose: Tbc · Tcw
        Rbw = self.R_bc @ fd.R
        tbw = self.R_bc @ fd.t + self.t_bc
        pb = store.bmp_pos[bids] @ Rbw.T + tbw
        # off-plane gate |z| < 0.2 m
        on_plane = np.abs(pb[:, 2]) < 0.2
        uv = bv.base_xy_to_pixel(torch.from_numpy(
            np.ascontiguousarray(pb[:, :2]))).numpy()
        inb = ((uv[:, 0] >= 0) & (uv[:, 0] < bv.width)
               & (uv[:, 1] >= 0) & (uv[:, 1] < bv.height))
        pvalid = on_plane & inb
        pad = cap - n
        uv_p = np.pad(uv, ((0, pad), (0, 0)))
        val_p = np.pad(pvalid, (0, pad))
        ids_p = np.pad(bids, (0, pad), constant_values=0)
        radius = np.full(cap, self.cfg.tracking.bird_search_radius, np.float32)
        on = self._on
        idx, _ = device_ops.match_projected(
            on(uv_p.astype(np.float32)), on(val_p), on(store.bmp_desc[ids_p]),
            fd.bird_kp.xy, fd.bird_kp.octave, fd.bird_kp.valid,
            fd.bird_kp.desc_pm1, on(radius), None,
            max_dist_th=matcher.TH_HIGH)
        idx = to_numpy(idx)
        found = idx >= 0
        tgt = idx[found]
        src = ids_p[found]
        free = fd.bird_mp[tgt] == INVALID
        fd.bird_mp[tgt[free]] = src[free]

    # ------------------------------------------------------------------
    # relocalization
    # ------------------------------------------------------------------
    def _relocalize(self, fd: FrameData, draws=None) -> bool:
        """EPnP-RANSAC relocalization (`Tracking::Relocalization`) against
        the candidate keyframes. `draws`, an iterator of (256, 4) int32
        draws, replaces the tracker's generator for each PnP attempt."""
        store = self.store
        cam = self.cfg.camera
        on = self._on
        candidates = self._reloc_candidates(fd)
        kph = self._kp_host(fd)
        for kf in candidates:
            has_mp = store.kf_kp_mp[kf] >= 0
            kp_pm1 = unpack_bits_to_pm1(on(store.kf_desc[kf]))
            dist = matcher.hamming_matrix(
                kp_pm1, fd.kp.desc_pm1, on(store.kf_kp_valid[kf] & has_mp),
                fd.kp.valid)
            idx, _ = matcher.match_mutual(dist, max_dist=matcher.TH_LOW,
                                          ratio=0.75)
            idx = to_numpy(idx)
            m = idx >= 0
            if m.sum() < 15:
                continue
            mp_ids = store.kf_kp_mp[kf][m]
            Xw = store.mp_pos[mp_ids]
            kp_xy = kph.xy[idx[m]]
            xyn = np.stack([(kp_xy[:, 0] - cam.cx) / cam.fx,
                            (kp_xy[:, 1] - cam.cy) / cam.fy], 1)
            octv = kph.octave[idx[m]]
            sig2 = self.level_sigma2[np.clip(octv, 0,
                                             len(self.level_sigma2) - 1)]
            chi2 = 5.991 * sig2 / (cam.fx * cam.fx)
            K_cap = 512
            npts = min(len(Xw), K_cap)
            padn = K_cap - npts
            self.timer.count("reloc.pnp")
            res = pnp.fetch_result(pnp.pnp_ransac(
                self.generator if draws is None else next(draws),
                np.pad(Xw[:npts], ((0, padn), (0, 0))),
                np.pad(xyn[:npts], ((0, padn), (0, 0))).astype(np.float32),
                np.pad(np.ones(npts, bool), (0, padn)),
                np.pad(chi2[:npts], (0, padn)).astype(np.float32),
                min_inliers=10, device=self.device))
            if not res.ok:
                continue
            fd.R = res.R
            fd.t = res.t
            fd.kp_mp[:] = INVALID
            ki = idx[m]
            fd.kp_mp[ki] = mp_ids
            n_inl, _ = self._pose_opt_with_matches(fd, fd.R, fd.t)
            if n_inl < 10:
                continue
            # widen the search and refine
            self._project_and_match(
                fd, store.valid_mp_ids(),
                self.cfg.tracking.reloc_search_radius / 2.5)
            n_inl, _ = self._pose_opt_with_matches(fd, fd.R, fd.t)
            if n_inl >= 50:
                self.last_reloc_frame_id = fd.frame_id
                self.ref_kf = int(kf)
                self.timer.count("reloc.ok")
                return True
        return False

    def _reloc_candidates(self, fd: FrameData):
        """Relocalization candidates: the BoW keyframe database's when a
        loop closer with a database is attached and it finds any, else the
        last 10 valid keyframes. Counted as `reloc.kfdb_candidates` and
        `reloc.fallback`."""
        lc = self.loop_closer
        kfdb = lc.kfdb if lc is not None else None
        if kfdb is not None:
            cands = kfdb.detect_relocalization_candidates(self._kp_host(fd))
            if len(cands):
                self.timer.count("reloc.kfdb_candidates", len(cands))
                return cands
        self.timer.count("reloc.fallback")
        return self.store.valid_kf_ids()[::-1][:10]

    # ------------------------------------------------------------------
    # keyframe policy
    # ------------------------------------------------------------------
    def _need_new_keyframe(self, fd: FrameData) -> bool:
        cfg = self.cfg.tracking
        store = self.store
        if self.ref_kf == INVALID:
            return False
        since = fd.frame_id - self.last_kf_frame_id
        if since < cfg.min_frames_between_kf:
            return False
        # mapping idle gate (`NeedNewKeyFrame`): "idle" = the reference
        # keyframe's triangulate/fuse stages have landed, so ref_tracked is
        # a complete count. An in-flight local BA does NOT block minting.
        idle = self.mapper is None or self.mapper.mapping_idle
        # nRefMatches counts only WELL-OBSERVED ref-KF points (nMinObs=3)
        min_obs = 3 if store.kf_valid.sum() > 2 else 2
        ref_mp = store.kf_kp_mp[self.ref_kf]
        attached = (ref_mp >= 0) & store.kf_kp_valid[self.ref_kf]
        ref_tracked = int(
            (store.mp_n_obs[ref_mp.clip(0)][attached] >= min_obs).sum())
        tracked = (fd._n_tracked if fd._n_tracked is not None
                   else int((fd.kp_mp >= 0).sum()))
        if tracked <= 15:
            # the reference requires > 15 inliers for ANY insertion
            return False
        if fd.frame_id < self._kf_suppress_before and tracked >= 60:
            # dispatched before the last keyframe's bundle refresh: a
            # HEALTHY count against the stale bundle must not drive the
            # ref-ratio test; a STARVING one still may
            return False
        c1 = since >= cfg.max_frames_between_kf
        c2 = tracked < cfg.ref_ratio * max(ref_tracked, 1)
        if not (c1 or c2):
            return False
        if not idle:
            # InterruptBA analogue: land the in-flight stages NOW so the
            # mint's own triangulation starts immediately
            self.mapper.drain_kf_stages()
        return True

    def _create_keyframe(self, fd: FrameData):
        store = self.store
        if fd._kp_slot_dev is not None:
            # ONE batched transfer for the keypoint arrays and the deferred
            # association readbacks, once per keyframe
            with self.timer.stage("kf.fetch_kp"):
                self._kf_apply_fetched(
                    fd, fetch(self._kf_fetch_items(fd), self.timer))
        elif fd.kp_host is None or (fd.bird_kp is not None
                                    and fd.bird_kp_host is None):
            with self.timer.stage("kf.fetch_kp"):
                self._kp_host(fd)
                if fd.bird_kp is not None:
                    fd.bird_kp_host = keypoints.to_host(fd.bird_kp)
        self._land_depth(fd)
        if fd.bird_kp is not None:
            fd.bird_base_xyz = to_numpy(fd.bird_base_xyz)
        if fd._mint_bird and fd.bird_kp is not None:
            self._mint_bird_points(fd)
        bird = ((fd.bird_kp_host, fd.bird_base_xyz)
                if fd.bird_kp is not None else None)
        kf = store.alloc_keyframe(fd.R, fd.t, fd.frame_id, fd.timestamp,
                                  fd.kp_host, bird=bird,
                                  kp_depth=fd.kp_depth, kp_ur=fd.kp_ur)
        if self.mapper is not None and fd._kp_dev_arrays is not None:
            self.mapper.register_kf_device(kf, *fd._kp_dev_arrays)
        ki = np.nonzero(fd.kp_mp >= 0)[0]
        store.add_observations(kf, ki, fd.kp_mp[ki])
        if fd.bird_kp is not None:
            bi = np.nonzero(fd.bird_mp >= 0)[0]
            keep = store.bmp_valid[fd.bird_mp[bi]]
            store.add_bird_observations(kf, bi[keep], fd.bird_mp[bi[keep]])
            store.update_bird_point_desc(fd.bird_mp[bi[keep]])
        # stereo/RGB-D: seed close landmarks from depth
        if fd.kp_depth is not None:
            self._seed_depth_points(fd, kf)
        store.update_covisibility(kf)
        store.update_point_stats(np.unique(fd.kp_mp[ki]), self.scale_factors)
        self.ref_kf = kf
        self.last_kf_frame_id = fd.frame_id
        # frames already dispatched (ids < self.frame_id) matched against
        # the pre-keyframe bundle; their counts must not drive the policy
        self._kf_suppress_before = self.frame_id
        if self.mapper is not None:
            with self.timer.stage("kf.mapper"):
                self.mapper.process_keyframe(kf)
            if self._starving(fd):
                # tracking is burning through the visible map: land this
                # keyframe's triangulation NOW so the next frame's bundle
                # already holds the new points
                with self.timer.stage("kf.starved_drain"):
                    self.mapper.drain_kf_stages()
            fd.R = store.kf_R[kf].copy()
            fd.t = store.kf_t[kf].copy()
        with self.timer.stage("kf.bundle_refresh"):
            self._refresh_local_map()

    def _starving(self, fd: FrameData) -> bool:
        """Tracking holds barely enough map attachment: prioritize map
        growth over frame-path latency (see _create_keyframe)."""
        tracked = (fd._n_tracked if fd._n_tracked is not None
                   else int((fd.kp_mp >= 0).sum()))
        return tracked < 60

    def _mint_bird_points(self, fd: FrameData):
        """Mint new BEV ground landmarks from the keyframe's unmatched bird
        keypoints (the fused path defers the per-frame minting of
        `MatchAndRetriveBirdMP` to keyframes)."""
        store = self.store
        bkp = fd.bird_kp_host
        free = (fd.bird_mp < 0) & bkp.valid
        ki = np.nonzero(free)[0]
        if len(ki) == 0:
            return
        cap = store.bird_cap
        if len(ki) > cap:
            ki = ki[np.argsort(-bkp.response[ki], kind="stable")[:cap]]
        # world position from this keyframe's pose: Twb = Twc · Tcb
        Twb_R = fd.R.T @ self.R_cb
        Twb_t = fd.R.T @ (self.t_cb - fd.t)
        base = fd.bird_base_xyz[ki]
        wpos = base @ Twb_R.T + Twb_t
        bids = store.alloc_bird_points(wpos.astype(np.float32),
                                       bkp.desc_u8[ki], fd.frame_id)
        fd.bird_mp[ki] = bids

    def _seed_depth_points(self, fd: FrameData, kf: int):
        """`Tracking::CreateNewKeyFrame`'s stereo branch: unproject the
        close (depth < `depth_threshold`), depth-valid, landmark-free
        keypoints as new map points."""
        store = self.store
        cam = self.cfg.camera
        kph = fd.kp_host
        free = (fd.kp_mp < 0) & (fd.kp_depth > 0) & kph.valid
        ki = np.nonzero(free & (fd.kp_depth < self.cfg.depth_threshold))[0]
        if len(ki) == 0:
            return
        xy = kph.xy[ki]
        z = fd.kp_depth[ki]
        Xc = np.stack([(xy[:, 0] - cam.cx) / cam.fx * z,
                       (xy[:, 1] - cam.cy) / cam.fy * z, z], 1)
        Xw = (Xc - fd.t) @ fd.R  # R^T (Xc − t)
        ids = store.alloc_points(Xw.astype(np.float32), kph.desc_u8[ki], kf,
                                 fd.frame_id)
        store.add_observations(kf, ki, ids)
        fd.kp_mp[ki] = ids

    def _land_depth(self, fd: FrameData):
        """A fused frame's device kp_depth / kp_ur as numpy, in one
        transfer, for the frames whose keyframe batch did not carry them
        (a fallback keyframe, the last frame in localization mode)."""
        if isinstance(fd.kp_depth, torch.Tensor):
            fd.kp_depth, fd.kp_ur = fetch((fd.kp_depth, fd.kp_ur),
                                          self.timer)

    # ------------------------------------------------------------------
    def _update_velocity(self, fd: FrameData):
        last = self.last_frame
        if last is None or not last.pose_ok:
            self.velocity = None
            return
        self.velocity = fd.Tcw() @ np.linalg.inv(last.Tcw())

    def _record_trajectory(self, fd: FrameData):
        # pose-available wall time: with lag-N retirement the entry point
        # returns before the pose exists. The frame's device step has
        # finished by now on the fused path (its summary landed).
        fd._finalized_wall = time.perf_counter()
        self.timer.mark("pose", fd.call, fd._finalized_wall)
        self.timer.poll()
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
