"""The check against faults planted in the timed path, on the CPU.

Each case drives a whole run of a cut-down cell through the harness (its
look for a card skipped: the program runs on the CPU, at half the width
with 500 features, 36 window frames), with one function of the timed path
broken underneath the window, and sees `correct` come out false; the sound
run sees it true. The faults a closed-loop tracking cell can have: a step that returns
its state unchanged, an answer altered where it is produced, half of a
batch left out (half the frame's keypoints; half the BA's edges), and a BA
that returns its state unchanged. One chip, so no exchange between chips.
"""
import functools
import time

import pytest
import torch

from portbench import cells, harness
from portbench.tests import smallcell

CELL = "bird_street"
SEED = 2 ** 31 + 4242


def _step_unchanged(orig):
    @functools.wraps(orig)
    def step(*args, **kwargs):
        out = orig(*args, **kwargs)
        R, t = args[1], args[2]
        summary = out.summary.clone()
        summary[0:9], summary[9:12] = R.reshape(-1), t
        return out._replace(R=R, t=t, summary=summary)
    return step


def _step_altered(orig):
    @functools.wraps(orig)
    def step(*args, **kwargs):
        out = orig(*args, **kwargs)
        t = out.t + torch.tensor([0.01, 0.0, 0.0], device=out.t.device)
        summary = out.summary.clone()
        summary[9:12] = t
        return out._replace(t=t, summary=summary)
    return step


def _step_half_keypoints(orig):
    @functools.wraps(orig)
    def step(*args, **kwargs):
        out = orig(*args, **kwargs)
        valid = out.kp.valid.clone()
        valid[::2] = False
        return out._replace(kp=out.kp._replace(valid=valid))
    return step


def _ba_unchanged(orig):
    @functools.wraps(orig)
    def ba(*args, **kwargs):
        res = orig(*args, **kwargs)
        return res._replace(cam_R=torch.as_tensor(args[0]).clone(),
                            cam_t=torch.as_tensor(args[1]).clone(),
                            points=torch.as_tensor(args[4]).clone())
    return ba


def _ba_half_edges(orig):
    @functools.wraps(orig)
    def ba(*args, **kwargs):
        args = list(args)
        mono = args[6]
        valid = mono.valid.clone()
        valid[::2] = False
        args[6] = mono._replace(valid=valid)
        return orig(*args, **kwargs)
    return ba


FAULTS = {
    "step_state_unchanged": ("fused_track", "track_step_mono",
                             _step_unchanged),
    "step_answer_altered": ("fused_track", "track_step_mono", _step_altered),
    "step_half_keypoints": ("fused_track", "track_step_mono",
                            _step_half_keypoints),
    "ba_state_unchanged": ("ba", "bundle_adjust", _ba_unchanged),
    "ba_half_edges": ("ba", "bundle_adjust", _ba_half_edges),
}


def _run(fault=None):
    from orbslam_birdview_tpu_torch.graph import ba
    from orbslam_birdview_tpu_torch.pipeline import fused_track

    bench = cells.benchmark()
    cell = cells.cell(bench, CELL)
    conf = smallcell.scaled(cell["config"], 0.5, 500)
    traffic = dict(cells.load("traffic", cell["traffic"]), supersample=1)
    # 36 window frames give the drift 11 pairs a second apart
    wl = dict(cells.load("workloads", CELL), warmup_frames=8,
              window_frames=36)
    mods = {"fused_track": fused_track, "ba": ba}
    undo = None
    if fault is not None:
        mod_name, attr, breaker = FAULTS[fault]
        mod = mods[mod_name]
        undo = (mod, attr, getattr(mod, attr))
        setattr(mod, attr, breaker(getattr(mod, attr)))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result, checked, _ = harness.run_cell(
            cell, [], SEED, 300.0, False, time.perf_counter(), device="cpu",
            conf=conf, traffic=traffic, wl=wl)
    finally:
        torch.set_num_threads(threads)
        if undo is not None:
            setattr(*undo)
    return result, checked


def test_sound_run_is_correct():
    result, checked = _run()
    assert checked["steps_checked"]["value"] >= 1
    assert checked["bas_checked"]["value"] >= 1
    assert result["correct"], checked


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault):
    result, checked = _run(fault)
    assert not result["correct"], checked
