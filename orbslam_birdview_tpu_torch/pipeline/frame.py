"""Per-frame working record (host side), the analogue of ORB-SLAM2's
`Frame` minus the heavy compute (which lives in frontend/ on the device)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..frontend.keypoints import Keypoints


@dataclass
class FrameData:
    frame_id: int
    timestamp: float
    kp: Keypoints                    # device tensors (padded)
    R: np.ndarray                    # Tcw rotation (3,3)
    t: np.ndarray                    # Tcw translation (3,)
    kp_mp: np.ndarray                # (K,) int64 map-point id per keypoint or -1
    # stereo / RGB-D: numpy, or device tensors on a fused frame until they
    # ride home with its keyframe batch
    kp_depth: Optional[np.ndarray] = None   # (K,) depth or -1
    kp_ur: Optional[np.ndarray] = None      # (K,) right-image u or -1
    # birdview stream
    bird_kp: Optional[Keypoints] = None
    bird_base_xyz: Optional[np.ndarray] = None  # (Kb,3) vehicle-base-frame pts
    bird_mp: Optional[np.ndarray] = None        # (Kb,) bird landmark ids
    # localization-mode temporal "visual odometry" points: depth-seeded
    # world points NOT in the map, keyed by keypoint index
    kp_vo: Optional[np.ndarray] = None          # (K,) bool: has a VO point
    kp_vo_xyz: Optional[np.ndarray] = None      # (K,3) VO world positions
    n_vo_inliers: int = 0
    _pose_ok: bool = False
    # host (numpy) copies of kp / bird_kp, landed once when the frame
    # becomes a keyframe (`frontend.keypoints.to_host`); the device tensors
    # stay in kp / bird_kp for the matchers
    kp_host: Optional[Keypoints] = None
    bird_kp_host: Optional[Keypoints] = None
    # fused frames defer their keypoint→landmark association readback: the
    # (K,) slot tensor stays on the device until the frame becomes a
    # keyframe or an API consumer asks
    _kp_slot_dev: Optional[object] = None
    _lm_ids_snapshot: Optional[tuple] = None
    _bird_slot_dev: Optional[object] = None
    _bird_ids_snapshot: Optional[tuple] = None
    # a fused keyframe's device keypoint tensors (xy, octave, valid,
    # desc_u8), kept for the mapper's triangulate / fuse calls
    _kp_dev_arrays: Optional[tuple] = None
    # fused frames mint new bird landmarks at keyframe creation
    _mint_bird: bool = False
    # tracked-landmark count from the device summary (fused frames have no
    # host kp_mp to count until resolved)
    _n_tracked: Optional[int] = None
    # lag-1 pipelining: while this frame is in flight, reading pose_ok
    # synchronizes (finalizes the frame), so a caller that reads the pose
    # per frame gets it; callers that ignore it keep full pipelining
    _finalize_cb: Optional[object] = None

    @property
    def pose_ok(self) -> bool:
        if self._finalize_cb is not None:
            cb = self._finalize_cb
            self._finalize_cb = None
            cb()
        return self._pose_ok

    @pose_ok.setter
    def pose_ok(self, v: bool):
        self._pose_ok = v

    @property
    def n_kp(self) -> int:
        return int(self.kp.valid.sum())

    def Tcw(self):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.R
        T[:3, 3] = self.t
        return T
