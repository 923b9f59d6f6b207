"""The readers of the System's span record and the reduction that lays
the record over a device profile (`spanclock.py`), on hand-made records
and a synthetic profile, on the CPU."""
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from orbslam_birdview_tpu_torch.utils.profiling import StageTimer
from portbench import cells, harness, spanclock


def _run(window, timers, t_end=10.0):
    return harness.Run(t0=0.0, t_end=t_end, window=window, setup_s=1.0,
                       timers=timers)


def _rec(i, t_call, done=None, step_end=None):
    fd = SimpleNamespace(_pose_ok=True)
    if done is not None:
        fd._finalized_wall = done
    if step_end is not None:
        fd._step_span = SimpleNamespace(t1=step_end)
    return harness.FrameRecord(i, t_call, t_call + 0.1, fd)


def read(name, run):
    return cells.module("metrics", name).read(run)


def test_host_span_readers():
    window = [_rec(i, float(i)) for i in range(4)]
    timers = {"step.extract": [0.01, 0.02] * 4,           # two a frame
              "step.pose_lm": [0.1, 0.3] * 4,
              "wait": [0.001] * 6,
              "map.local_ba": [0.15, 0.25]}
    run = _run(window, timers)
    assert read("frontend.host_ms", run) == pytest.approx(30.0)
    assert read("pose_lm.host_ms", run) == pytest.approx(400.0)
    assert read("device.host_wait_ms", run) == pytest.approx(1.5)
    assert read("mapping.ba_device_ms", run) == pytest.approx(200.0)
    # a program without the record's spans (the parent) reports nothing
    empty = _run(window, {"fused.dispatch": [0.5] * 4})
    for name in ("frontend.host_ms", "pose_lm.host_ms",
                 "device.host_wait_ms", "mapping.ba_device_ms",
                 "tracker.pose_wait_ms"):
        assert read(name, empty) is None


def test_pose_wait_reader():
    # step done on the device 50 ms after the call; pose 2 s after the
    # call; frame 8 lands after the window's end, frame 9 never, frame 3
    # has no device span (the slow path, or no anchor)
    window = [_rec(i, float(i), done=float(i) + 2.0,
                   step_end=float(i) + 0.05) for i in range(9)]
    window[3] = _rec(3, 3.0, done=5.0)
    window.append(_rec(9, 9.0, step_end=9.05))
    # frames 0-2 and 4-8 wait 1.95 s (8 lands at 10.0 s); two of them
    # wait through a stall of the host
    window[1] = _rec(1, 1.0, done=9.0, step_end=1.05)
    window[2] = _rec(2, 2.0, done=6.5, step_end=2.05)
    run = _run(window, {})
    waits = [7.95e3, 4.45e3] + [1.95e3] * 6
    assert read("tracker.pose_wait_ms", run) == pytest.approx(
        np.percentile(waits, 50)) == pytest.approx(1.95e3)
    # the parent's frames carry no step span
    bare = [_rec(i, float(i), done=float(i) + 2.0) for i in range(4)]
    assert read("tracker.pose_wait_ms", _run(bare, {})) is None


def test_interval_arithmetic():
    dev = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert spanclock.busy_within(dev, 0.0, 10.0) == pytest.approx(4.0)
    assert spanclock.busy_within(dev, 1.5, 5.5) == pytest.approx(2.0)
    assert spanclock.idle_within(dev, 1.5, 5.5) == pytest.approx(2.0)
    assert spanclock.gaps(dev, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]
    spans = [("a", 0, 0.0, 10.0), ("b", 0, 4.0, 6.0)]
    assert spanclock.innermost(spans, 5.0) == "b"
    assert spanclock.innermost(spans, 2.0) == "a"
    assert spanclock.innermost(spans, 11.0) == "outside every span"
    assert spanclock.pair_offsets([(1.0, 2.0), (5.0, 6.5)],
                                  [(4.9, 6.0), (1.05, 2.0)]) == \
        pytest.approx((0.1, 0.5))


class _Range:
    def __init__(self, start_us, end_us):
        self.start, self.end = start_us, end_us


def _event(name, start_us, end_us, device=False):
    return SimpleNamespace(
        name=name, time_range=_Range(start_us, end_us),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


class _Profile:
    """What `spanclock` reads of a stopped `torch.profiler.profile`."""

    def __init__(self, start_ns, events):
        self._events = events
        results = SimpleNamespace(trace_start_ns=lambda: start_ns)
        self.profiler = SimpleNamespace(kineto_results=results)

    def events(self):
        return self._events


def test_profile_placement_and_the_overlay():
    """A frame's record and its profile, made from one timeline: the
    program clock runs 1000 s behind the wall clock, the profile starts
    at wall 5000 s. The record's spans land on the profile's ranges, the
    device span on its kernels, and the idle time under `step.pose_lm` is
    the stretch with no kernel."""
    start_ns = 5000e9
    off = 1000.0                    # wall s − program s

    def prog(us):                   # a profile µs on the program clock
        return (start_ns / 1e9 + us * 1e-6) - off

    rec = StageTimer()
    rec.frame = 7
    rec._clock.extend([(prog(0.0), start_ns), (prog(1e6), start_ns + 1e9)])
    ring = [("fused.dispatch", 7, prog(100.0), prog(900.0)),
            ("step.extract", 7, prog(110.0), prog(300.0)),
            ("step.match", 7, prog(300.0), prog(400.0)),
            ("step.pose_lm", 7, prog(400.0), prog(600.0)),
            ("step.match", 7, prog(600.0), prog(650.0)),
            ("step.pose_lm", 7, prog(650.0), prog(850.0)),
            ("dispatched", 7, prog(900.0), prog(900.0)),
            ("step", 7, prog(105.0), prog(880.0)),
            ("pose", 7, prog(2000.0), prog(2000.0))]
    rec._ring.extend(ring)
    rec.device_names.add("step")
    k1 = _event("k1", 120.0, 300.0, device=True)
    k2 = _event("k2", 420.0, 500.0, device=True)
    k3 = _event("k3", 680.0, 870.0, device=True)
    twin = _event("portbench.pose_lm", 400.0, 600.0, device=True)
    op = _event("aten::add", 110.0, 115.0)
    pose1 = _event("portbench.pose_lm", 400.02, 600.0)
    pose2 = _event("portbench.pose_lm", 650.0, 849.95)
    step = _event("portbench.tracker.step", 104.0, 890.0)
    prof = _Profile(start_ns, [step, op, pose1, pose2, k1, k2, k3, twin])

    host, device = spanclock.profile_ns(prof)
    assert [h[0] for h in host] == ["tracker.step", "pose_lm", "pose_lm"]
    assert device == [(start_ns + 120e3, start_ns + 300e3),
                      (start_ns + 420e3, start_ns + 500e3),
                      (start_ns + 680e3, start_ns + 870e3)]
    assert rec.wall_ns(prog(400.0)) == pytest.approx(start_ns + 400e3,
                                                     abs=1.0)

    out = spanclock.analyse(rec, prof, {7}, {7, 8})
    assert out["clock_pose_lm_ms"] == pytest.approx([2e-5, 5e-5], abs=1e-6)
    # idle under the two pose spans: (200 − 80) + (200 − 170) µs
    assert out["pose_lm_idle_ms"] == pytest.approx(0.15, abs=1e-6)
    assert out["step_end_ms"]["after_dispatch"] == \
        pytest.approx([-0.02, -0.02], abs=1e-6)
    assert out["step_end_ms"]["before_pose"] == \
        pytest.approx([1.12, 1.12], abs=1e-6)
    assert out["step_by_frame"] == [[7, pytest.approx(0.005, abs=1e-6),
                                     pytest.approx(-0.02, abs=1e-6),
                                     pytest.approx(1.12, abs=1e-6)]]
    assert out["coverage"] == pytest.approx(740.0 / 800.0)
    # a window frame that never ran (a cut window) is no frame
    assert out["host_ms_per_window_frame"]["fused.dispatch"] == \
        pytest.approx(0.8)
    # the stretch's gaps, each under its innermost span
    idle = dict(out["idle_by_span"])
    assert idle == {"step.match": pytest.approx(0.12, abs=1e-6),
                    "step.pose_lm": pytest.approx(0.18, abs=1e-6)}
    assert [g[0] for g in out["longest_gaps"]] == ["step.pose_lm",
                                                   "step.match"]
    # the record's cost counts the entries of the frames that ran
    cost = spanclock.record_cost_us(rec, {7, 8}, "cpu")
    assert cost["entries_per_frame"] == {"host": 6.0, "mark": 2.0,
                                         "device": 1.0}
    assert cost["us_per_frame"] > 0
