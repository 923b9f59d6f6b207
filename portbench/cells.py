"""Find a cell's files by name and turn its configuration into the rig the
street renders and the `SlamConfig` the program runs.

- `BENCHMARK.json` (at the checkout's root) names each cell's
  configuration and traffic;
- `configs/<config>.json`: the configuration, in the flat keys of the
  ORB-SLAM2 YAML files (`Camera.fx`, `ORBextractor.nFeatures`, …), plus
  `Birdview.*` / `BirdORBextractor.*` for a BEV rig, `Tbc.height_m` and
  `Tracking.maxFrames` (ORB-SLAM2's keyframe interval, `mMaxFrames`);
- `traffic/<traffic>.json`: a mix's parameters, with the name of its
  generator (`traffic/<generator>.py`);
- `workloads/<cell>.json`: the run's own settings (warm-up frames, the
  profiled stretch, the samples checked and the limits of the check).
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def module(kind: str, name: str):
    """`<kind>/<name>.py` loaded as a module (names may hold dots)."""
    key = f"portbench.{kind}.{name.replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(
        key, HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def rig(conf: dict) -> dict:
    """The cameras the street renders, in the configuration's units."""
    cam = dict(fx=conf["Camera.fx"], fy=conf["Camera.fy"],
               cx=conf["Camera.cx"], cy=conf["Camera.cy"],
               width=int(conf["Camera.width"]),
               height=int(conf["Camera.height"]))
    out = dict(camera=cam, camera_height_m=conf["Tbc.height_m"])
    if conf["sensor"] == "stereo":
        out["stereo_baseline_m"] = conf["Camera.bf"] / conf["Camera.fx"]
    if conf["sensor"] == "mono_bird":
        out["bev"] = dict(
            pixel2meter=conf["Birdview.pixel2meter"],
            width=int(conf["Birdview.width"]),
            height=int(conf["Birdview.height"]),
            rear_axle_to_center=conf["Birdview.rear_axle_to_center"],
            vehicle_length=conf["Birdview.vehicle_length"],
            vehicle_width=conf["Birdview.vehicle_width"])
    return out


def quat_wxyz(R: np.ndarray) -> tuple:
    """Unit quaternion (w, x, y, z) of a rotation matrix."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    y = np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    z = np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    x = np.copysign(x, R[2, 1] - R[1, 2])
    y = np.copysign(y, R[0, 2] - R[2, 0])
    z = np.copysign(z, R[1, 0] - R[0, 1])
    return tuple(float(v) for v in (w, x, y, z))


def slam_config(conf: dict, R_bc: np.ndarray):
    """The program's `SlamConfig` for a configuration, built through its
    public config types; `R_bc` is the camera's mount on the base."""
    from orbslam_birdview_tpu_torch.api.config import SlamConfig
    from orbslam_birdview_tpu_torch.core.camera import (BirdviewCamera,
                                                        PinholeCamera)
    from orbslam_birdview_tpu_torch.frontend.orb import ORBConfig

    cam = PinholeCamera(
        fx=conf["Camera.fx"], fy=conf["Camera.fy"], cx=conf["Camera.cx"],
        cy=conf["Camera.cy"], k1=conf["Camera.k1"], k2=conf["Camera.k2"],
        p1=conf["Camera.p1"], p2=conf["Camera.p2"],
        width=int(conf["Camera.width"]), height=int(conf["Camera.height"]),
        bf=conf.get("Camera.bf", 0.0))

    def orb(prefix):
        return ORBConfig(
            n_features=int(conf[f"{prefix}.nFeatures"]),
            n_levels=int(conf[f"{prefix}.nLevels"]),
            scale_factor=conf[f"{prefix}.scaleFactor"],
            fast_threshold=conf[f"{prefix}.iniThFAST"],
            min_threshold=conf[f"{prefix}.minThFAST"])

    cfg = SlamConfig(camera=cam, orb=orb("ORBextractor"),
                     sensor=conf["sensor"], fps=conf["Camera.fps"])
    cfg.tracking.max_frames_between_kf = int(conf["Tracking.maxFrames"])
    if "ThDepth" in conf:
        cfg.depth_threshold = conf["ThDepth"] * cam.bf / cam.fx
    if conf["sensor"] == "mono_bird":
        b = rig(conf)["bev"]
        cfg.birdview = BirdviewCamera(
            pixel2meter=b["pixel2meter"],
            rear_axle_to_center=b["rear_axle_to_center"],
            width=b["width"], height=b["height"],
            vehicle_length=b["vehicle_length"],
            vehicle_width=b["vehicle_width"])
        cfg.bird_orb = orb("BirdORBextractor")
    cfg.tbc_quat = quat_wxyz(R_bc)
    cfg.tbc_t = (0.0, 0.0, float(conf["Tbc.height_m"]))
    return cfg
