"""One run of one cell, closed loop.

Set-up: the program's imports and the CUDA context, the street rendered
on the device and copied to host memory as uint8 frames, `System(cfg)`
with its vocabulary, `System.prewarm()` and the warm-up frames, which go
through the same calls as the window. Then the window: one caller hands
the system the cell's fixed number of frames (`window_frames`), each as
soon as the last call returned; `seconds` only caps it. After the window
the system is flushed, the metrics are read, the program's state is
freed and the window's sampled steps and bundle adjustments are checked
against the plain reference, with the frames lost and the drift against
the drive's exact poses.

Timestamps handed to the system are the drive's clock (frame / fps).
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import arith
from . import capture as capture_mod
from . import cells
from . import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam_birdview_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the port may not load, compared
    whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


@dataclass
class FrameRecord:
    index: int          # frame of the drive
    t_call: float       # host clock at the call's start
    t_ret: float        # host clock at the call's return
    fd: object          # the FrameData the call returned


@dataclass
class Run:
    """What the metric readers read."""
    t0: float                         # the window's start (host clock)
    t_end: float                      # the return of its last call
    window: list                      # FrameRecord of every window frame
    setup_s: float
    timers: dict                      # span -> the window's samples (s)
    trace: Optional[trace_mod.TraceResult] = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    def finalized_at(self, rec: FrameRecord) -> float:
        """When the frame's pose became available, or +inf."""
        return getattr(rec.fd, "_finalized_wall", math.inf)


def _timer_marks(system) -> dict:
    from orbslam_birdview_tpu_torch.utils.profiling import GLOBAL_TIMER
    return {**{k: len(v) for k, v in system.tracker.timer.samples.items()},
            **{k: len(v) for k, v in GLOBAL_TIMER.samples.items()}}


def _timer_window(system, marks: dict) -> dict:
    from orbslam_birdview_tpu_torch.utils.profiling import GLOBAL_TIMER
    out = {}
    for src in (system.tracker.timer.samples, GLOBAL_TIMER.samples):
        for k, v in src.items():
            out[k] = list(v[marks.get(k, 0):])
    return out


def run_cell(cell: dict, metrics_: list, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             conf: dict = None, traffic: dict = None, wl: dict = None,
             control: bool = False) -> tuple[dict, dict, dict]:
    """(result line, the numbers compared with their limits, and with
    `control` the control's and the planted faults' numbers, else {}). `metrics_` are BENCHMARK.json's entries of
    the metrics to report; `conf`, `traffic` and `wl` default to the
    cell's files. With `control` the check also runs the reference in
    the precision below the stated one."""
    conf = conf or cells.load("configs", cell["config"])
    traffic = traffic or cells.load("traffic", cell["traffic"])
    wl = wl or cells.load("workloads", cell["name"])
    parts = {}

    t = time.perf_counter()
    import torch

    from orbslam_birdview_tpu_torch.api.system import System
    parts["imports_s"] = time.perf_counter() - t

    dev = torch.device(device)
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    parts["cuda_init_s"] = time.perf_counter() - t

    # the drive: rendered on the device, handed over as host uint8 frames
    fps = float(conf["Camera.fps"])
    warm = int(wl["warmup_frames"])
    n_frames = warm + int(wl["window_frames"])
    gen = cells.module("traffic", traffic["generator"])
    t = time.perf_counter()
    drive = gen.render(traffic, cells.rig(conf), fps, n_frames, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    parts["render_s"] = time.perf_counter() - t
    log(f"render: {n_frames} frames, {drive.tiles} tiles a surface, "
        f"{drive.step_m:.4f} m a frame, {parts['render_s']:.3f} s")

    cfg = cells.slam_config(conf, gen.R_BC)
    t = time.perf_counter()
    system = System(cfg, device=dev)
    parts["system_s"] = time.perf_counter() - t
    parts["vocab_load_s"] = system.vocab_load_ms / 1e3
    t = time.perf_counter()
    system.prewarm()
    parts["prewarm_s"] = time.perf_counter() - t

    sensor = conf["sensor"]
    if sensor == "mono_bird":
        def call(i):
            return system.track_monocular_with_birdview(
                drive.front[i], drive.bev[i], drive.bev_mask, i / fps)
    elif sensor == "stereo":
        def call(i):
            return system.track_stereo(drive.front[i], drive.right[i], i / fps)
    else:
        raise SystemExit(f"sensor {sensor!r} has no closed loop here")

    t = time.perf_counter()
    for i in range(warm):
        call(i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["warmup_s"] = time.perf_counter() - t

    cap = capture_mod.Capture(seed, int(wl["check"]["steps"]),
                              int(wl["check"]["bas"]))
    prof = trace_mod.Profile(int(wl["profile"]["frames"])) if trace else None
    first_prof = warm + int(wl["profile"]["first"])
    marks = _timer_marks(system)
    counts0 = dict(system.tracker.timer.counters)
    loops0 = (system.loop_closer.n_loops_closed
              if system.loop_closer is not None else 0)
    window = []
    with trace_mod.spans(prof) if trace else contextlib.nullcontext():
        cap.install()
        try:
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            i, resets = warm, 0
            # a profiled stretch, once started, runs to its end (a traced
            # run reports no end-to-end metric)
            while i < n_frames and (time.perf_counter() - t0 < seconds
                                    or (prof is not None and prof.running)):
                if prof is not None and i == first_prof:
                    prof.start()
                tracker = system.tracker
                cap.frame = i
                t_call = time.perf_counter()
                fd = call(i)
                window.append(FrameRecord(i, t_call, time.perf_counter(), fd))
                resets += system.tracker is not tracker
                if prof is not None and prof.running:
                    prof.frames_done += 1
                    if prof.frames_done == prof.frames:
                        prof.stop()
                i += 1
            t_end = time.perf_counter()
        finally:
            cap.remove()
            if prof is not None and prof.running:
                prof.stop()
    cut = i < n_frames
    timers = _timer_window(system, marks)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules loaded that the port may not load: {bad}")
    log("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; setup_s {setup_s:.3f}")
    if cut:
        log(f"the window was cut at {seconds} s after {len(window)} of "
            f"{n_frames - warm} frames")

    system._flush()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    run = Run(t0=t0, t_end=t_end, window=window, setup_s=setup_s,
              timers=timers)
    if prof is not None:
        if prof.prof is None or prof.frames_done < prof.frames:
            raise SystemExit("the window ended before the profiled stretch")
        t = time.perf_counter()
        run.trace = trace_mod.reduce(prof)
        log(f"trace: {run.trace.frames} frames, {run.trace.kernels} kernels, "
            f"reduced in {time.perf_counter() - t:.3f} s")
    attempted = len(window)
    failed = sum(1 for r in window if not r.fd._pose_ok)
    lost = [k for k, r in enumerate(window) if not r.fd._pose_ok]
    counts = {k: v - counts0.get(k, 0)
              for k, v in system.tracker.timer.counters.items()}
    loops = (system.loop_closer.n_loops_closed - loops0
             if system.loop_closer is not None else 0)
    log(f"window: {attempted} frames in {t_end - t0:.3f} s, {failed} not "
        f"tracked (first at window frame {lost[0] if lost else None}), "
        f"{resets} resets, {loops} loops closed, "
        f"{len(system.store.valid_kf_ids())} keyframes at the end; "
        f"tracker counts {counts}")
    est = {}
    for r in window:
        if r.fd._pose_ok:
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = r.fd.R, r.fd.t
            est[r.index] = T
    drift = arith.drift_pct(est, drive.Tcw, int(round(fps)))
    log(f"drift over {int(round(fps))} frames (1 s of camera time), "
        f"no scale alignment: {drift} %")
    breakdown = None
    if run.trace is not None:
        breakdown = dict(device_ops=run.trace.top,
                         idle_gaps=run.trace.idle_gaps)

    metrics = {}
    for m in metrics_:
        value = cells.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s

    # the sampled frames' images (the benchmark's own), then free the
    # program's state before the reference runs
    images = {}
    for f in cap.frames():
        images[f] = dict(front=drive.front[f])
        if sensor == "stereo":
            images[f]["right"] = drive.right[f]
        if sensor == "mono_bird":
            images[f]["bev"] = drive.bev[f]
    bev_mask, R_bc = drive.bev_mask, gen.R_BC
    t_bc = (0.0, 0.0, float(conf["Tbc.height_m"]))
    del system, run, window, drive, call
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from .reference import compare

    t = time.perf_counter()
    steps = [capture_mod.step_args(conf, images[f], R_bc, t_bc, bev_mask, a,
                                   out, dev)
             for f, a, out in cap.steps.items]
    bas = [capture_mod.ba_args(conf, a, out, dev)
           for _, a, out in cap.bas.items]
    numbers, ctl, faults = compare.check(
        steps, bas, float(conf.get("Camera.bf", 0.0)), control=control)
    log(f"check: {numbers['steps_checked']} steps, "
        f"{numbers['bas_checked']} bundle adjustments, "
        f"{time.perf_counter() - t:.3f} s")
    numbers["failed"] = failed
    numbers["drift_pct"] = math.inf if drift is None else drift
    log("numbers: " + json.dumps(numbers))
    limits = wl["limits"]
    checked = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        if name.endswith("_checked"):
            passed = v is not None and v >= limit
            checked[name] = {"value": v, "at_least": limit}
        else:
            passed = v is not None and v <= limit
            checked[name] = {"value": v, "limit": limit}
        ok &= passed
    result = {"correct": bool(ok), "attempted": attempted, "failed": failed,
              "resets": resets, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checked, (dict(control=ctl, faults=faults) if control
                             else {})
