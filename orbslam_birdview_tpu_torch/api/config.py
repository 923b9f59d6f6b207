"""Configuration for the SLAM system: one explicit place for the YAML
values ORB-SLAM2 parses in its tracker and viewer, and for the vehicle/BEV
calibration the fork hardcodes. Field for field the JAX package's
`api/config.py`, on the port's camera and ORB types.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.camera import (
    DEFAULT_BIRDVIEW_TBC_QUAT,
    DEFAULT_BIRDVIEW_TBC_T,
    BirdviewCamera,
    PinholeCamera,
)
from ..frontend.orb import ORBConfig


@dataclass
class TrackingConfig:
    # search radii (px at level 0), mirroring ORBmatcher call sites
    motion_search_radius: float = 15.0
    local_search_radius: float = 3.0
    reloc_search_radius: float = 10.0
    init_search_radius: float = 100.0
    bird_search_radius: float = 15.0
    # gates (reference values, BASELINE.md)
    min_init_kps: int = 100
    min_init_matches: int = 100
    min_init_bird_matches: int = 50
    min_track_inliers: int = 10
    min_localmap_inliers: int = 30
    min_localmap_inliers_after_reloc: int = 50
    # keyframe policy (`Tracking::NeedNewKeyFrame`)
    max_frames_between_kf: int = 30
    min_frames_between_kf: int = 0
    ref_ratio: float = 0.9
    # local map window
    local_map_max_kfs: int = 80
    # fused one-dispatch tracking (pipeline/fused_track.py): device-side
    # motion-model + local-map tracking with a single readback per frame
    fused_tracking: bool = True
    fused_point_cap: int = 6144
    fused_bird_cap: int = 2048   # BEV ground-landmark bundle capacity
    # lag-N pipelining: retire in-flight frames as their summary fetches
    # land, blocking only past `fused_max_lag` frames in flight.
    # fused_lag1=False forces synchronous finalization of every frame.
    fused_lag1: bool = True
    # Max in-flight (unretired) frames. This bounds the SEMANTIC lag of
    # every decision made at retirement (mints, fallbacks, LOST) — when
    # input outruns the link the queue fills to this depth and stays
    # there, so each extra slot directly inflates decision latency. At
    # real camera rates the queue drains between frames and the bound
    # never engages.
    fused_max_lag: int = 4
    # Frames per batched summary transfer. Blocks seal after exactly this
    # many rows (amortizing the fetch latency over the block); unhealthy
    # tracking seals per-frame so LOST detection never lags. Must be
    # <= fused_max_lag — a block larger than the queue bound would be
    # sealed early by forced retirement anyway.
    summary_batch: int = 4
    # deterministic scheduling: no retirement lag, no deferred keyframe
    # mints, mapping stages drained per keyframe. The overlapped pipeline's
    # decisions otherwise depend on wall-clock fetch timing — fine in
    # production, but load-sensitive tests (shared CI cores) need
    # reproducible dynamics.
    synchronous: bool = False
    # birdview
    bird_info_scale_pose: float = 1.0
    bird_info_scale_ba: float = 1.0
    bird_sigma_m: float = 0.05   # BEV ground-point noise in meters
    min_icp_translation: float = 0.3


@dataclass
class MappingConfig:
    triangulation_neighbors: int = 10
    min_obs_for_cull: int = 3
    found_ratio_cull: float = 0.25
    kf_cull_redundancy: float = 0.9
    # Local BA window: ORB-SLAM2 optimizes ALL first-order covisible KFs
    # (`Optimizer::LocalBundleAdjustment`); a fixed-shape device program
    # needs a cap, but it must span enough trajectory arc for monocular
    # scale drift to stay bounded before loop closure.
    local_ba_window: int = 32       # covisible KFs in local BA
    local_ba_fixed: int = 16        # fixed frontier KFs
    local_ba_point_cap: int = 8192
    local_ba_edge_cap: int = 32768
    fuse_point_cap: int = 4096      # landmark bucket for the batched fuse op
    async_local_ba: bool = True     # overlap local BA with tracking frames


@dataclass
class SlamConfig:
    camera: PinholeCamera = field(default_factory=lambda: PinholeCamera(
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        width=640, height=480))
    orb: ORBConfig = field(default_factory=ORBConfig)
    bird_orb: Optional[ORBConfig] = None
    birdview: Optional[BirdviewCamera] = None
    tbc_quat: tuple = DEFAULT_BIRDVIEW_TBC_QUAT
    tbc_t: tuple = DEFAULT_BIRDVIEW_TBC_T
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    max_keyframes: int = 256
    sensor: str = "mono"     # mono | stereo | rgbd | mono_bird
    # vocabulary source: "auto" loads the package's own 100k-word file
    # (data/vocab_100k.npz) at System construction; a path loads that file
    # (.npz native, or DBoW2 .txt/.bin); None disables the up-front load
    # and falls back to the in-run 10^4-word bootstrap
    vocab_path: Optional[str] = "auto"
    fps: float = 30.0
    depth_threshold: float = 40.0  # ThDepth * baseline, stereo/RGBD
    depth_map_factor: float = 5000.0  # TUM RGB-D

    def effective_bird_orb(self) -> ORBConfig:
        """The BEV extractor config actually used by the tracker: explicit
        `bird_orb` if set, else the front budget at 4 pyramid levels (the
        BEV image is metric-scaled so deep pyramids buy nothing)."""
        return self.bird_orb or ORBConfig(
            n_features=self.orb.n_features, n_levels=4)

    @staticmethod
    def from_yaml(path: str, sensor: str = "mono") -> "SlamConfig":
        """Parse an ORB-SLAM2-style YAML (e.g. `Examples/Monocular/TUM1.yaml`)."""
        import re

        vals = {}
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                m = re.match(r"([A-Za-z0-9_.]+)\s*:\s*([-+0-9.eE]+)", line)
                if m:
                    vals[m.group(1)] = float(m.group(2))

        cam = PinholeCamera(
            fx=vals.get("Camera.fx", 500.0),
            fy=vals.get("Camera.fy", 500.0),
            cx=vals.get("Camera.cx", 320.0),
            cy=vals.get("Camera.cy", 240.0),
            k1=vals.get("Camera.k1", 0.0),
            k2=vals.get("Camera.k2", 0.0),
            p1=vals.get("Camera.p1", 0.0),
            p2=vals.get("Camera.p2", 0.0),
            k3=vals.get("Camera.k3", 0.0),
            width=int(vals.get("Camera.width", 640)),
            height=int(vals.get("Camera.height", 480)),
            bf=vals.get("Camera.bf", 0.0),
        )
        orb = ORBConfig(
            n_features=int(vals.get("ORBextractor.nFeatures", 1000)),
            n_levels=int(vals.get("ORBextractor.nLevels", 8)),
            scale_factor=vals.get("ORBextractor.scaleFactor", 1.2),
            fast_threshold=vals.get("ORBextractor.iniThFAST", 20.0),
            min_threshold=vals.get("ORBextractor.minThFAST", 7.0),
        )
        cfg = SlamConfig(camera=cam, orb=orb, sensor=sensor,
                         fps=vals.get("Camera.fps", 30.0))
        if "ThDepth" in vals:
            cfg.depth_threshold = vals["ThDepth"] * cam.bf / max(cam.fx, 1e-9)
        if "DepthMapFactor" in vals:
            cfg.depth_map_factor = vals["DepthMapFactor"]
        return cfg
