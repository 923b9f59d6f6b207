"""System facade: the public API, the reference's `System` class surface —
per-frame entry points for every sensor mode, the localization-mode
switch, reset, map save/load, state queries and trajectory savers in
TUM/KITTI/odometry formats. Single-process and explicitly scheduled: the
tracker drives local mapping, and local mapping drives loop closing, at
fixed frame ticks.

Loop closing is on by default, with the packaged vocabulary
(`cfg.vocab_path = "auto"`). `track_stereo` takes the right image, which
the tracker row-matches against the left one; `track_rgbd` takes a depth
image in metres (<= 0 where there is none).

One span record (`utils.profiling.StageTimer`, `System.timer`) serves the
tracker, the mapper and the loop closer, and outlives `reset`; each
`track_*` call is one frame of it, numbered from 0 in call order.

`mesh` (a `parallel.runtime.Mesh`) shards the full-map BA and the
essential graph over its devices; without one, both run on `device`
alone. Sharding is asked for, never assumed from the GPUs a machine
shows (the JAX package shards whenever it sees more than one device).
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import lie
from ..mapping import vocab as vocab_mod
from ..mapping.mapstore import MapStore
from ..parallel import runtime
from ..pipeline.local_mapping import LocalMapper
from ..pipeline.loop_closing import LoopCloser
from ..pipeline.tracking import LOST, Tracker
from ..utils.profiling import StageTimer
from .config import SlamConfig

DEFAULT_VOCABULARY = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "vocab_100k.npz")


def _load_default_vocabulary(cfg: SlamConfig):
    """The vocabulary loaded up front, as the reference's `System`
    constructor does. cfg.vocab_path: "auto" -> the port's packaged
    100k-word file; a path -> that file (.npz native, DBoW2 .txt / .bin);
    None -> none (the loop closer then trains a 10⁴-word vocabulary from
    the map's descriptors mid-run)."""
    path = cfg.vocab_path
    if path is None:
        return None
    if path == "auto":
        path = DEFAULT_VOCABULARY
        if not os.path.exists(path):
            return None
    return vocab_mod.load_dbow2(path)


class System:
    def __init__(self, cfg: SlamConfig, vocabulary=None,
                 enable_loop_closing: bool = True, device=None,
                 mesh: Optional[runtime.Mesh] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.enable_loop_closing = enable_loop_closing
        t0 = time.perf_counter()
        if enable_loop_closing and vocabulary is None:
            vocabulary = _load_default_vocabulary(cfg)
        self.vocab_load_ms = (time.perf_counter() - t0) * 1e3
        self.timer = StageTimer()
        self.loop_closer = None
        self._build(self._make_store(cfg), vocabulary)
        self.localization_only = False
        # deferred mode-switch requests from other threads (a viewer):
        # applied at the start of the next track_* call
        self._reset_requested = False
        self._loc_mode_requested: Optional[bool] = None

    def _build(self, store: MapStore, vocabulary=None,
               register: bool = False):
        """A fresh mapper and tracker on `store`, and with loop closing a
        fresh loop closer attached to both; `register` adds the store's
        keyframes to its database (a loaded map)."""
        self.store = store
        self.mapper = LocalMapper(self.cfg, store, device=self.device,
                                  mesh=self.mesh, timer=self.timer)
        self.tracker = Tracker(self.cfg, store, self.mapper,
                               device=self.device, timer=self.timer)
        if not self.enable_loop_closing:
            return
        self.loop_closer = LoopCloser(self.cfg, store, self.mapper,
                                      vocabulary=vocabulary)
        self.mapper.loop_closer = self.loop_closer
        self.tracker.loop_closer = self.loop_closer
        if register and self.loop_closer.kfdb is not None:
            for kf in store.valid_kf_ids():
                self.loop_closer.kfdb.add_keyframe(
                    int(kf), self.loop_closer._kp_of(int(kf)))

    def _vocabulary(self):
        return self.loop_closer.voc if self.loop_closer is not None else None

    @staticmethod
    def _make_store(cfg: SlamConfig) -> MapStore:
        """Per-KF feature capacities track the extractor's padded output
        size (the reference runs 2000 features front + BEV)."""
        kp_cap = cfg.orb.padded_capacity()
        bird_cap = cfg.effective_bird_orb().padded_capacity()
        return MapStore(max_kf=cfg.max_keyframes, kp_cap=kp_cap,
                        bird_cap=bird_cap)

    # ------------------------------------------------------------------
    # per-frame entry points (System::Track*)
    # ------------------------------------------------------------------
    def track_monocular(self, img, timestamp: float):
        return self._track(img, timestamp)

    def track_monocular_with_birdview(self, img, bird_img, bird_mask,
                                      timestamp: float):
        return self._track(img, timestamp, bird_img=bird_img,
                           bird_mask=bird_mask)

    def track_rgbd(self, img, depth, timestamp: float):
        return self._track(img, timestamp, depth_img=depth)

    def track_stereo(self, img_left, img_right, timestamp: float):
        return self._track(img_left, timestamp,
                           right_img=np.asarray(img_right))

    def request_reset(self):
        """Deferred reset: takes effect at the next track_* call."""
        self._reset_requested = True

    def request_localization_mode(self, on: bool):
        """Deferred localization-mode switch."""
        self._loc_mode_requested = bool(on)

    def _apply_deferred_requests(self):
        if self._reset_requested:
            self._reset_requested = False
            self._loc_mode_requested = None
            self.reset()
            return
        req = self._loc_mode_requested
        if req is not None:
            self._loc_mode_requested = None
            if req:
                self.activate_localization_mode()
            else:
                self.deactivate_localization_mode()

    def _track(self, img, timestamp, **kw):
        self.timer.begin_frame()
        self._apply_deferred_requests()
        self.tracker.only_tracking = self.localization_only
        fd = self.tracker.process(np.asarray(img), timestamp, **kw)
        if self.tracker.reset_requested and not self.localization_only:
            # lost right after initialization: wipe and start over
            self.reset()
        return fd

    def _flush(self):
        """Drain the tracker's retirement queue and the mapper's stages and
        local BA, so queries and exports see every frame against the
        settled map."""
        self.tracker.flush()
        self.mapper.drain_background()

    # ------------------------------------------------------------------
    # mode switches
    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        self._flush()
        self.localization_only = True

    def deactivate_localization_mode(self):
        self._flush()
        self.localization_only = False
        self.tracker.vo_mode = False

    def reset(self):
        self._flush()
        self._build(self._make_store(self.cfg), self._vocabulary())

    def shutdown(self):
        pass  # no threads to join; kept for API parity

    def prewarm(self) -> int:
        """Run the local-BA bucket ladder once before the first frame, so
        the library set-up it pays lands before the frame stream, and
        anchor the span record's device clock. Returns the number of
        problems run."""
        n = self.mapper.prewarm()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.timer.anchor_device(self.device)
        return n

    # ------------------------------------------------------------------
    # map checkpoint / resume (the store's file format, shared with the
    # JAX package)
    # ------------------------------------------------------------------
    def save_map(self, path: str):
        self._flush()
        self.store.save(path)

    def load_map(self, path: str):
        """Load a saved map and relocalize against it; its keyframes are
        registered in the keyframe database again."""
        self._build(MapStore.load(path), self._vocabulary(), register=True)
        self.tracker.state = LOST

    # ------------------------------------------------------------------
    # state queries
    # ------------------------------------------------------------------
    def get_tracking_state(self) -> int:
        self._flush()
        return self.tracker.state

    def peek_tracking_state(self) -> int:
        """Tracker state WITHOUT draining the lag pipeline or the mapper,
        for progress reports inside the frame loop."""
        return self.tracker.state

    def map_changed(self) -> int:
        return self.store.big_change_idx

    def n_map_points(self) -> int:
        return int(self.store.mp_valid.sum())

    def n_keyframes(self) -> int:
        return int(self.store.kf_valid.sum())

    def get_tracked_map_points(self):
        """Landmark ids associated to the last frame's keypoints; −1 where
        none."""
        self._flush()
        fd = self.tracker.last_frame
        if fd is None:
            return np.zeros(0, np.int64)
        self.tracker.resolve_associations(fd)
        return fd.kp_mp.copy()

    def get_tracked_keypoints(self):
        self._flush()
        fd = self.tracker.last_frame
        if fd is None:
            return None
        kp = self.tracker._kp_host(fd)
        return kp.xy, kp.valid

    # ------------------------------------------------------------------
    # trajectory export
    # ------------------------------------------------------------------
    def _frame_poses(self):
        """Per-frame poses Tcw = T_rel · Tcw_refkf with the *current*
        (optimized) keyframe poses (`SaveTrajectoryTUM`)."""
        self._flush()
        store = self.store
        out = []
        for e in self.tracker.trajectory:
            if e.lost:
                out.append((e.timestamp, None))
                continue
            T_ref = np.eye(4, dtype=np.float32)
            T_ref[:3, :3] = store.kf_R[e.ref_kf]
            T_ref[:3, 3] = store.kf_t[e.ref_kf]
            out.append((e.timestamp, e.T_rel @ T_ref))
        return out

    @staticmethod
    def _tum_line(ts, Twc):
        q = lie.rot_to_quat(torch.as_tensor(
            np.ascontiguousarray(Twc[:3, :3]))).numpy()
        t = Twc[:3, 3]
        # TUM: tx ty tz qx qy qz qw
        return (f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")

    def save_trajectory_tum(self, path: str):
        with open(path, "w") as f:
            for ts, Tcw in self._frame_poses():
                if Tcw is None:
                    continue
                f.write(self._tum_line(ts, np.linalg.inv(Tcw)) + "\n")

    def _kf_Tcw(self, kf):
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, :3] = self.store.kf_R[kf]
        Tcw[:3, 3] = self.store.kf_t[kf]
        return Tcw

    def save_keyframe_trajectory_tum(self, path: str):
        self._flush()
        store = self.store
        with open(path, "w") as f:
            for kf in store.valid_kf_ids():
                f.write(self._tum_line(store.kf_timestamp[kf],
                                       np.linalg.inv(self._kf_Tcw(kf)))
                        + "\n")

    def save_keyframe_trajectory_odom_tum(self, path: str):
        """The fork's saver of keyframe poses in the vehicle base frame:
        Twb = Twc · Tcb (`SaveKeyFrameTrajectoryOdomTUM`)."""
        self._flush()
        store = self.store
        tr = self.tracker
        Tcb = np.eye(4, dtype=np.float32)
        Tcb[:3, :3] = tr.R_cb
        Tcb[:3, 3] = tr.t_cb
        with open(path, "w") as f:
            for kf in store.valid_kf_ids():
                Twb = np.linalg.inv(self._kf_Tcw(kf)) @ Tcb
                f.write(self._tum_line(store.kf_timestamp[kf], Twb) + "\n")

    def save_trajectory_kitti(self, path: str):
        with open(path, "w") as f:
            for ts, Tcw in self._frame_poses():
                if Tcw is None:
                    continue
                row = np.linalg.inv(Tcw)[:3, :4].reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in row) + "\n")
