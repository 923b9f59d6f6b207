"""The program's span record laid over a device profile, on the
profiler's clock, and a traced run of one cell that reports what the two
show together.

The profiler stamps its events on the host's wall clock: an event's
`time_range`, in µs, counts from `kineto_results.trace_start_ns()`. The
System's span record (`orbslam_birdview_tpu_torch.utils.profiling`) stamps
its spans on the program clock, pairs that clock with the wall clock once
a frame (`StageTimer.wall_ns`), and puts its device spans on the program
clock through an anchor event recorded at set-up. So its spans can be
placed among the profile's events, and the device's idle time read under
each of them.

    python3 portbench/spanclock.py --workload bird_street --seed 7

runs the cell's traced run as `run.py --trace 1` does (the same harness,
the same profiled stretch) and prints, beside the run's result line:
- `pose_lm_idle_ms`: device-idle ms a traced frame while the host is in
  the program's `step.pose_lm` spans;
- `clock_pose_lm_ms`: the largest distance between a `step.pose_lm` span
  placed on the profiler's clock and the matching `portbench.pose_lm`
  range of the profile, at either end;
- `step_end_ms`: over the window's fused frames, the device end of the
  step less the frame's dispatch end, and the frame's pose-available time
  less the device end (clock check: the first at least -0.1 ms, the
  second at least 0);
- `coverage`: the window's `step.extract` + `step.match` +
  `step.pose_lm` host ms over its `fused.dispatch` host ms;
- `idle_by_span`: the stretch's device-idle ms under each innermost
  program span, and its 20 longest gaps; every gap is logged on standard
  error, labelled by its innermost program span;
- `record_us`: the record's own cost on this device, µs a window frame
  (each kind of entry timed alone, times its count a window frame).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PREFIX = "portbench."   # the benchmark's own profiler ranges (trace.py)


# ---- the reduction ---------------------------------------------------------
def profile_ns(prof) -> tuple[list, list]:
    """(host ranges, device intervals) of a stopped
    `torch.profiler.profile`, on the wall clock in ns. Host ranges are the
    benchmark's own ranges, (label, start, end); device intervals every
    kernel, copy and fill, without the ranges' device-side twins."""
    from torch.autograd import DeviceType

    t0 = float(prof.profiler.kineto_results.trace_start_ns())
    host, device = [], []
    for ev in prof.events():
        s = t0 + 1e3 * ev.time_range.start
        e = t0 + 1e3 * ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            if not ev.name.startswith(PREFIX):
                device.append((s, e))
        elif ev.name.startswith(PREFIX):
            host.append((ev.name[len(PREFIX):], s, e))
    host.sort(key=lambda r: r[1])
    device.sort()
    return host, device


def placed(record, spans) -> list:
    """The record's (name, frame, t0, t1) on the wall clock in ns."""
    return [(n, f, record.wall_ns(a), record.wall_ns(b))
            for n, f, a, b in spans]


def busy_within(device, lo: float, hi: float) -> float:
    """Length of the union of the device intervals clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, e in device:
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
        if end >= hi:
            break
    return total


def idle_within(device, lo: float, hi: float) -> float:
    return (hi - lo) - busy_within(device, lo, hi)


def gaps(device, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] with no device interval, (start, end)."""
    out, end = [], lo
    for s, e in device:
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [g for g in out if g[1] > g[0]]


def innermost(spans, t: float) -> str:
    """Name of the shortest span (name, frame, t0, t1) holding `t`."""
    inside = [s for s in spans if s[2] <= t <= s[3]]
    return (min(inside, key=lambda s: s[3] - s[2])[0] if inside
            else "outside every span")


def pair_offsets(program, profiled) -> tuple[float, float]:
    """Largest |start| and |end| differences between each (start, end) of
    `program` and the one of `profiled` that starts nearest to it."""
    if not program or not profiled:
        raise ValueError("nothing to pair")
    d_start = d_end = 0.0
    for a in program:
        b = min(profiled, key=lambda r: abs(r[0] - a[0]))
        d_start = max(d_start, abs(a[0] - b[0]))
        d_end = max(d_end, abs(a[1] - b[1]))
    return d_start, d_end


def analyse(record, prof, traced, window) -> dict:
    """What the record and the profile show together; `traced` and
    `window` are sets of the record's frames (the window's that ran)."""
    window = ran(record, window)
    host, device = profile_ns(prof)
    mine = [s for s in record.spans(frames=traced)
            if s[2] is not None and s[3] > s[2]
            and s[0] not in record.device_names]
    mine_ns = placed(record, mine)
    pose = [(a, b) for n, _, a, b in mine_ns if n == "step.pose_lm"]
    theirs = [(s, e) for label, s, e in host if label == "pose_lm"]
    d_start, d_end = pair_offsets(pose, theirs)
    idle_pose = sum(idle_within(device, a, b) for a, b in pose)

    # the window's steps: device end against dispatch end and the pose
    at = {(n, f): (a, b) for n, f, a, b in record.spans(
        frames=window, names={"fused.dispatch", "dispatched", "pose",
                              "step"})}
    per_frame = []
    for (n, f), (start, end) in sorted(at.items(), key=lambda kv: kv[0][1]):
        if n == "step" and end is not None:
            per_frame.append([
                f, 1e3 * (start - at[("fused.dispatch", f)][0]),
                1e3 * (end - at[("dispatched", f)][0]),
                1e3 * (at[("pose", f)][0] - end)])
    after_disp = [r[2] for r in per_frame]
    before_pose = [r[3] for r in per_frame]

    host_ms = {}
    for n, _, a, b in record.spans(frames=window, names={
            "step.extract", "step.match", "step.pose_lm", "fused.dispatch"}):
        host_ms[n] = host_ms.get(n, 0.0) + 1e3 * (b - a)

    lo = min(s for s, _ in device)
    hi = max(e for _, e in device)
    labelled = [(innermost(mine_ns, 0.5 * (s + e)), (e - s) / 1e6, s)
                for s, e in gaps(device, lo, hi)]
    by_span: dict = {}
    for label, ms, _ in labelled:
        by_span[label] = by_span.get(label, 0.0) + ms
    return dict(
        traced_frames=len(traced),
        pose_lm_idle_ms=idle_pose / 1e6 / len(traced),
        clock_pose_lm_ms=[d_start / 1e6, d_end / 1e6],
        pose_lm_spans=[len(pose), len(theirs)],
        step_end_ms=dict(
            after_dispatch=[min(after_disp), max(after_disp)],
            before_pose=[min(before_pose), max(before_pose)],
            frames=len(after_disp)),
        # frame, device start less host start of `fused.dispatch`, device
        # end less `dispatched`, `pose` less device end (ms)
        step_by_frame=per_frame,
        host_ms_per_window_frame={k: v / len(window)
                                  for k, v in host_ms.items()},
        coverage=(host_ms.get("step.extract", 0.0)
                  + host_ms.get("step.match", 0.0)
                  + host_ms.get("step.pose_lm", 0.0))
        / host_ms["fused.dispatch"],
        idle_by_span=sorted(by_span.items(), key=lambda kv: -kv[1]),
        longest_gaps=[g[:2] for g in sorted(labelled,
                                            key=lambda g: -g[1])[:20]],
        gaps=labelled)


# ---- the record's own cost -------------------------------------------------
def ran(record, window) -> set:
    """The frames of `window` that ran (a window cut short ran fewer)."""
    return window & {s[1] for s in record.spans(names={"fused.dispatch"})}


def record_cost_us(record, window, device) -> dict:
    """µs a window frame that the record's entries cost, each kind timed
    alone on a fresh record (`n` repeats) and counted in `window`."""
    import torch

    from orbslam_birdview_tpu_torch.utils.profiling import StageTimer

    window = ran(record, window)
    n = 5000
    r = StageTimer()
    r.begin_frame()

    def timed(fn):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e6 * (time.perf_counter() - t) / n

    def host():
        with r.stage("x"):
            pass

    def dev():
        with r.device_span("y", device):
            pass
        r.poll()
    unit = dict(host=timed(host), mark=timed(lambda: r.mark("m", 0)),
                frame=timed(r.begin_frame))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        r.anchor_device(device)
        unit["device"] = timed(dev)
    counts = dict(host=0, mark=0, device=0)
    for name, _, a, b in record.spans(frames=window):
        kind = ("device" if name in record.device_names
                else "mark" if a == b else "host")
        counts[kind] += 1
    per_frame = {k: v / len(window) for k, v in counts.items()}
    us = sum(unit.get(k, 0.0) * per_frame[k] for k in per_frame) \
        + unit["frame"]
    return dict(unit_us=unit, entries_per_frame=per_frame,
                us_per_frame=us)


# ---- a traced run of one cell ----------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    from portbench import run as run_mod

    run_mod.cache_dirs()
    from portbench import cells, harness
    from portbench import trace as trace_mod

    from orbslam_birdview_tpu_torch.api.system import System

    bench = cells.benchmark()
    cell = cells.cell(bench, args.workload)
    wl = cells.load("workloads", cell["name"])
    warm = int(wl["warmup_frames"])
    window = set(range(warm, warm + int(wl["window_frames"])))
    seen: dict = {}
    prewarm, reduce = System.prewarm, trace_mod.reduce

    def keep_system(self):
        seen["system"] = self
        return prewarm(self)

    def reduce_and_lay_over(p):
        rec = seen["system"].timer
        traced = {f for _, f, a, _ in rec.spans(names={"fused.dispatch"})
                  if p.t0 <= a <= p.t1}
        dev = seen["system"].device
        try:
            seen["out"] = analyse(rec, p.prof, traced, window)
            seen["out"]["record_us"] = record_cost_us(rec, window, dev)
        except Exception:   # the run's own result still comes out
            import traceback
            seen["out"] = dict(error=traceback.format_exc(), gaps=[],
                               idle_by_span=[], longest_gaps=[])
        return reduce(p)

    System.prewarm, trace_mod.reduce = keep_system, reduce_and_lay_over
    try:
        result, checked, _ = harness.run_cell(
            cell, run_mod.metrics_of(bench, args.workload, True), args.seed,
            args.seconds, True, t_start)
    finally:
        System.prewarm, trace_mod.reduce = prewarm, reduce
    out = seen["out"]
    for label, ms, at in out.pop("gaps"):
        harness.log(f"gap at {at:.0f} ns under {label}: {ms:.4f} ms")
    for label, ms in out["idle_by_span"]:
        harness.log(f"idle under {label}: {ms:.3f} ms")
    out["result"] = result
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
