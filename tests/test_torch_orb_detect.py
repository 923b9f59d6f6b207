"""The ORB detection kernels' arithmetic and layout on the CPU.

The stages that `csrc/orb_detect.cu` runs on the card live in
`csrc/orb_detect.cuh`; `csrc/orb_detect_host.cpp` runs them on the host,
one thread a block, built with the host C++ compiler at first use. Here
that build, fed the argument block `detect_kernel.Plan` makes, is held
against `orb.detect_levels_plain` bit for bit on every slot (valid or not)
and every level image, on the cases of `orb_detect_cases.py`; and the plan
refuses what the kernels do not take. The card tests hold the kernels
themselves to the same cases.
"""
import ctypes

import numpy as np
import pytest
import torch

import orb_detect_cases as odc
from orbslam_birdview_tpu_torch.frontend import detect_kernel, orb
from orbslam_birdview_tpu_torch.utils import build

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def host_detect():
    """The host build's detection: (img, mask, cfg) -> orb.Detection."""
    lib = build.load_library("orb_detect_host", ["orb_detect_host.cpp"],
                             ["orb_detect.cuh"])
    fn = lib.orb_detect_levels_host
    fn.argtypes = [ctypes.POINTER(detect_kernel._Args)]
    fn.restype = ctypes.c_int

    def detect(img, mask, cfg):
        plan = orb._detect_plan(img.shape[0], img.shape[1],
                                None if mask is None else tuple(mask.shape),
                                cfg, CPU)
        cap = plan.capacity
        # NaN and garbage where nothing is written: the build must write
        # every slot and every padded pixel
        padded = torch.full((plan.n_padded,), np.nan)
        cand = torch.full((5, plan.n_cand), -7, dtype=torch.int32)
        yx = torch.full((2, plan.k_total), -7, dtype=torch.int32)
        xy = torch.full((cap, 2), np.nan)
        response = torch.full((cap,), np.nan)
        octave = torch.full((cap,), -7, dtype=torch.int32)
        valid = torch.ones(cap, dtype=torch.bool)
        args = plan.args(img, mask, padded, cand, yx, xy, response, octave,
                         valid)
        assert fn(ctypes.byref(args)) == 0
        levels = [p.view(s) for p, s in zip(
            padded.split([h * w for h, w in plan.padded_shapes]),
            plan.padded_shapes)]
        return orb.Detection(levels, yx[0], yx[1], xy, response, octave,
                             valid)
    return detect


@pytest.mark.parametrize("name", odc.CASES)
def test_host_build_matches_plain(host_detect, name):
    img, mask, cfg = odc.case(name)
    img = torch.from_numpy(img)
    mask = None if mask is None else torch.from_numpy(mask)
    ref = orb.detect_levels_plain(img, mask, cfg)
    out = host_detect(img, mask, cfg)
    for field in ("ys", "xs", "xy", "response", "octave", "valid"):
        r, o = getattr(ref, field), getattr(out, field)
        assert o.dtype == r.dtype and o.shape == r.shape, field
        assert torch.equal(o, r), (field, int((o != r).sum()))
    for l, (r, o) in enumerate(zip(ref.padded, out.padded)):
        assert torch.equal(o, r), ("padded level", l, int((o != r).sum()))
    assert int(ref.valid.sum()) >= odc.min_valid(name)


@pytest.mark.parametrize("shape,cfg", [
    ((200, 300), orb.ORBConfig(n_features=500, n_levels=3, cell=33)),
    ((200, 300), orb.ORBConfig(n_features=500, n_levels=3, per_cell=9)),
    ((200, 300), orb.ORBConfig(n_features=500, n_levels=3, cell=2,
                               per_cell=5)),
    ((200, 300), orb.ORBConfig(n_features=500, n_levels=17,
                               scale_factor=1.05)),
    ((48, 48), orb.ORBConfig(n_features=500, n_levels=3)),      # slots
    ((1100, 1100), orb.ORBConfig(n_features=500, n_levels=2)),  # candidates
], ids=["cell", "per_cell", "per_cell_over_lanes", "levels", "slots",
        "candidates"])
def test_plan_rejects_what_the_kernels_do_not_take(shape, cfg):
    with pytest.raises(ValueError):
        orb._detect_plan(*shape, None, cfg, CPU)


def test_plan_lays_out_the_plain_slots():
    img, mask, cfg = odc.case("bird_bev")
    plan = orb._detect_plan(*img.shape, mask.shape, cfg, CPU)
    ref = orb.detect_levels_plain(torch.from_numpy(img),
                                  torch.from_numpy(mask), cfg)
    assert plan.k_total == ref.ys.shape[0]
    assert plan.capacity == ref.valid.shape[0] == cfg.padded_capacity()
    assert plan.padded_shapes == [tuple(p.shape) for p in ref.padded]
    assert plan.n_padded == sum(p.numel() for p in ref.padded)


def test_detect_takes_only_cuda_tensors():
    img, _, cfg = odc.case("flat")
    plan = orb._detect_plan(*img.shape, None, cfg, CPU)
    before = build.LAUNCHES[detect_kernel.DETECT.name]
    with pytest.raises(ValueError):
        detect_kernel.detect(torch.from_numpy(img), None, plan)
    assert build.LAUNCHES[detect_kernel.DETECT.name] == before
