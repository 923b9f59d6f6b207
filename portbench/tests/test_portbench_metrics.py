"""The yardstick's arithmetic and the metric readers on hand-made
fixtures, on the CPU."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import arith, cells, harness, trace
from portbench.traffic import street


def test_percentile_is_numpys_linear():
    xs = list(range(1, 11))
    assert arith.percentile(xs, 90) == pytest.approx(9.1)
    assert arith.percentile([5.0], 90) == 5.0


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert arith.union_length(iv) == pytest.approx(4.0)
    assert arith.gaps(iv, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]
    assert arith.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_drift_of_a_scaled_trajectory():
    traffic = cells.load("traffic", "street_3mps")
    base = street.base_poses(traffic, 25.0, 80)
    exact = street.camera_poses(base, 1.2)
    # every estimated pose 1 % too far from the start, in its own frame
    est = {}
    for i, T in enumerate(exact):
        E = T.copy()
        c = -T[:3, :3].T @ T[:3, 3]
        E[:3, 3] = -T[:3, :3] @ (c * 1.01)
        est[i] = E
    d = arith.drift_pct(est, exact, 25)
    assert d == pytest.approx(1.0, rel=0.02)
    assert arith.drift_pct({i: exact[i] for i in range(80)}, exact,
                           25) == pytest.approx(0.0, abs=1e-9)
    assert arith.drift_pct({0: exact[0]}, exact, 25) is None


def test_gather_bytes_of_a_bird_frame():
    levels = (arith.orb_gather_levels(400, 950, 2000, 8, 1.2)
              + arith.orb_gather_levels(384, 384, 2000, 4, 1.2))
    assert arith.gather_bytes(levels) == 44_845_900


def _run(window, t0=0.0, t_end=10.0, tr=None, timers=None):
    return harness.Run(t0=t0, t_end=t_end, window=window, setup_s=12.5,
                       timers=timers or {}, trace=tr)


def _rec(i, t_call, done=None, ok=True):
    fd = SimpleNamespace(_pose_ok=ok, R=np.eye(3), t=np.zeros(3))
    if done is not None:
        fd._finalized_wall = done
    return harness.FrameRecord(i, t_call, t_call + 0.1, fd)


def test_rate_and_latency_readers():
    # ten frames handed in a second apart; each pose lands 2 s later,
    # the last two after the window's end (10 s)
    window = [_rec(i, float(i), done=float(i) + 2.0) for i in range(10)]
    run = _run(window)
    fps = cells.module("metrics", "frames_per_s").read(run)
    assert fps == pytest.approx(9 / 10.0)
    p90 = cells.module("metrics", "pose_latency_p90_ms").read(run)
    # waits: 2 s for frames 0-8 (frame 8 lands at exactly 10 s), 1 s for
    # frame 9, still in flight
    waits = [2.0] * 9 + [1.0]
    assert p90 == pytest.approx(1e3 * np.percentile(waits, 90))
    window[-1] = _rec(9, 9.0)          # never finalized
    assert cells.module("metrics", "pose_latency_p90_ms").read(
        _run(window)) == pytest.approx(1e3 * np.percentile(waits, 90))
    assert cells.module("metrics", "setup_s").read(run) == 12.5


def test_span_readers():
    window = [_rec(i, float(i), done=float(i)) for i in range(4)]
    timers = {"fused.dispatch": [0.1, 0.2, 0.3, 0.4], "map.loop": [0.05],
              "map.ba_dispatch": [0.2, 0.3]}
    run = _run(window, timers=timers)
    read = lambda n: cells.module("metrics", n).read(run)  # noqa: E731
    assert read("tracker.dispatch_ms") == pytest.approx(250.0)
    assert read("tracker.retire_ms") is None
    assert read("placerec.query_ms") == pytest.approx(50.0)
    assert read("mapping.ba_dispatch_ms") == pytest.approx(250.0)


def test_trace_readers():
    tr = trace.TraceResult(
        frames=2, window_s=1.0, busy_s=0.08, kernels=56_000,
        ranges={"frontend": [3000, 0.01], "pose_lm": [49_000, 0.06]},
        gather_s=40e-6, gather_launches=4,
        gather_bytes=2 * 44_845_900)
    run = _run([], tr=tr)
    read = lambda n: cells.module("metrics", n).read(run)  # noqa: E731
    assert read("device.idle_share") == pytest.approx(92.0)
    assert read("device.kernels_per_frame") == 28_000
    assert read("pose_lm.kernels") == 24_500
    assert read("pose_lm.device_ms") == pytest.approx(30.0)
    assert read("frontend.device_ms") == pytest.approx(5.0)
    bound_s = 2 * 44_845_900 / arith.HBM_BYTES_PER_S
    assert read("patch_gather_roofline") == pytest.approx(
        100 * bound_s / 40e-6)
    # nothing to read: nothing reported, never a 0 share
    empty = _run([], tr=trace.TraceResult(frames=2, window_s=1.0,
                                          busy_s=0.0, kernels=0,
                                          ranges={"frontend": [0, 0.0],
                                                  "pose_lm": [0, 0.0]}))
    for name in ("patch_gather_roofline", "pose_lm.kernels",
                 "frontend.device_ms", "device.kernels_per_frame"):
        assert cells.module("metrics", name).read(empty) is None
    assert cells.module("metrics", "device.idle_share").read(
        _run([])) is None


def test_every_metric_has_a_reader():
    bench = cells.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.module("metrics", m["name"]).read)
    for c in bench["configs"]:
        conf = cells.load("configs", c["name"])
        assert set(c["reduced"]) <= set(conf["reduced"]) | set(
            conf.get("published", {})) | {"Tbc"}
    for w in bench["workloads"]:
        wl = cells.load("workloads", w["name"])
        assert wl["warmup_frames"] > 0 and wl["limits"]
        assert wl["window_frames"] >= 80   # a p90 with 8 frames beyond it
        assert cells.load("traffic", w["traffic"])["generator"] == "street"
        assert math.isfinite(wl["profile"]["frames"])
