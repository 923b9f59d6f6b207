"""What the window's calls produce, kept for the check after it closes,
and turned into the plain reference's arguments.

While installed, the tracking step (`fused_track.track_step_mono`) and
the bundle adjustment (`ba.bundle_adjust`) are wrapped where the tracker
and the mapper look them up. Each call's arguments, by name, and result
join a reservoir sample drawn from the run's seed, so the sample is
uniform over the window's calls and what is held stays bounded; a step
also keeps the index of the frame being handed in. Nothing is copied on
the device; numpy arguments are copied on the host, since the mapper
reuses its buffers.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch

from .reference import ba as ref_ba
from .reference import orb as ref_orb
from .reference import track as ref_track


class Reservoir:
    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng = size, rng
        self.items: list = []
        self.seen = 0

    def offer(self, make):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
            return
        j = int(self.rng.integers(self.seen))
        if j < self.size:
            self.items[j] = make()


def _host_copy(x):
    return x.copy() if isinstance(x, np.ndarray) else x


class Capture:
    def __init__(self, seed: int, n_steps: int, n_bas: int):
        rng = np.random.default_rng([seed, 7])
        self.steps = Reservoir(n_steps, rng)
        self.bas = Reservoir(n_bas, rng)
        self.frame = None       # the drive's frame being handed in
        self._undo = []

    def _wrap(self, mod, name, reservoir):
        orig = getattr(mod, name)
        sig = inspect.signature(orig)

        def wrapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            frame = self.frame

            def make():
                b = sig.bind(*args, **kwargs)
                b.apply_defaults()
                return frame, {k: _host_copy(v)
                               for k, v in b.arguments.items()}, out

            reservoir.offer(make)
            return out

        setattr(mod, name, wrapped)
        self._undo.append((mod, name, orig))

    def install(self):
        from orbslam_birdview_tpu_torch.graph import ba
        from orbslam_birdview_tpu_torch.pipeline import fused_track

        self._wrap(fused_track, "track_step_mono", self.steps)
        self._wrap(ba, "bundle_adjust", self.bas)

    def remove(self):
        while self._undo:
            mod, name, orig = self._undo.pop()
            setattr(mod, name, orig)

    def frames(self) -> list[int]:
        return sorted({f for f, _, _ in self.steps.items})


def _on(x, dev, dtype=None):
    x = torch.as_tensor(x).to(dev)
    return x if dtype is None else x.to(dtype)


def extractor(conf: dict, prefix: str) -> ref_orb.Extractor:
    return ref_orb.Extractor(
        n_features=int(conf[f"{prefix}.nFeatures"]),
        n_levels=int(conf[f"{prefix}.nLevels"]),
        scale_factor=float(conf[f"{prefix}.scaleFactor"]),
        min_threshold=float(conf[f"{prefix}.minThFAST"]))


def step_args(conf: dict, images: dict, R_bc, t_bc, bev_mask, a: dict,
              out, dev) -> dict:
    """The reference's arguments for one captured step: the frame's images
    and the configuration's numbers from the benchmark, the prediction and
    the local map (the state the frame was tracked from) and the search
    factors from the call."""
    rig = ref_track.Rig(
        fx=conf["Camera.fx"], fy=conf["Camera.fy"], cx=conf["Camera.cx"],
        cy=conf["Camera.cy"], width=int(conf["Camera.width"]),
        height=int(conf["Camera.height"]),
        n_levels=int(conf["ORBextractor.nLevels"]),
        scale_factor=float(conf["ORBextractor.scaleFactor"]))
    lm = {k: _on(getattr(a["lm"], k), dev) for k in
          ("pos", "normal", "min_dist", "max_dist", "valid", "desc_u8")}
    out_args = dict(
        front_img=_on(images["front"], dev), lm=lm,
        R_pred=_on(a["R_pred"], dev, torch.float64),
        t_pred=_on(a["t_pred"], dev, torch.float64), rig=rig,
        ex=extractor(conf, "ORBextractor"),
        search=dict(motion=a["radius_mult_motion"],
                    local=a["radius_mult_local"], min_widen=a["min_widen"],
                    bird_radius=a["bird_radius"], bird_info=a["bird_info"]),
        out=out)
    if "right" in images:
        out_args["right_img"] = _on(images["right"], dev)
    if "bev" in images and a.get("bird_lm") is not None:
        out_args.update(
            bev_img=_on(images["bev"], dev),
            bev_mask=None if bev_mask is None else _on(bev_mask, dev),
            blm={k: _on(getattr(a["bird_lm"], k), dev)
                 for k in ("pos", "valid", "desc_u8")},
            bev_ex=extractor(conf, "BirdORBextractor"),
            bev=ref_track.Bev(
                pixel2meter=conf["Birdview.pixel2meter"],
                rear_axle_to_center=conf["Birdview.rear_axle_to_center"],
                width=int(conf["Birdview.width"]),
                height=int(conf["Birdview.height"])),
            R_bc=_on(R_bc, dev, torch.float64),
            t_bc=_on(t_bc, dev, torch.float64))
    return out_args


def ba_args(conf: dict, a: dict, res, dev):
    """(the reference's problem, the program's (R, t, X)) of one BA."""
    f64 = torch.float64
    edges = {}
    n_refs = torch.zeros(len(a["points"]), dtype=torch.long, device=dev)
    for kind in ("mono", "stereo", "bird"):
        es = a.get(kind)
        if es is None:
            continue
        cam, pt = _on(es.cam, dev).long(), _on(es.pt, dev).long()
        valid = _on(es.valid, dev).bool()
        edges[kind] = (cam, pt, _on(es.obs, dev, f64), _on(es.info, dev, f64),
                       valid)
        n_refs.index_add_(0, pt, valid.long())
    p = ref_ba.Problem(
        R=_on(a["cam_R"], dev, f64), t=_on(a["cam_t"], dev, f64),
        cam_free=_on(a["cam_valid"], dev).bool()
        & ~_on(a["cam_fixed"], dev).bool(),
        X=_on(a["points"], dev, f64),
        pt_free=_on(a["point_valid"], dev).bool() & (n_refs > 0),
        edges=edges, fx=conf["Camera.fx"], fy=conf["Camera.fy"],
        cx=conf["Camera.cx"], cy=conf["Camera.cy"],
        bf=conf.get("Camera.bf", 0.0))
    if not a["reclassify"] or (a["iters_phase1"], a["iters_phase2"]) != (5,
                                                                       10):
        raise SystemExit("a BA with another schedule than 5 + 10 "
                         "iterations and reclassification")
    return p, (res.cam_R, res.cam_t, res.points)
