"""A cell cut down for the CPU: the configuration's images, intrinsics and
BEV scaled by `scale` and the feature budgets cut, so a whole run of the
harness fits a test."""
from __future__ import annotations

from portbench import cells


def scaled(config: str, scale: float = 0.5, features: int = 1000) -> dict:
    conf = dict(cells.load("configs", config))
    for k in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy"):
        conf[k] = conf[k] * scale
    for k in ("Camera.width", "Camera.height"):
        conf[k] = round(conf[k] * scale)
    if "Camera.bf" in conf:
        conf["Camera.bf"] = conf["Camera.bf"] * scale
    for k in ("ORBextractor.nFeatures", "BirdORBextractor.nFeatures"):
        if k in conf:
            conf[k] = features
    if "Birdview.pixel2meter" in conf:
        conf["Birdview.pixel2meter"] = conf["Birdview.pixel2meter"] / scale
        conf["Birdview.width"] = round(conf["Birdview.width"] * scale)
        conf["Birdview.height"] = round(conf["Birdview.height"] * scale)
    return conf
