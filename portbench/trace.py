"""The traced run's spans and the reduction of its device profile.

Spans are `torch.profiler.record_function` ranges opened by wrappers
around the calls into each layer, installed where the callers look the
function up (a module attribute, or a method on its class). Nothing is
edited inside the program. `KERNEL_SPANS` are the ranges whose kernels the
per-layer metrics count; `HOST_SPANS` only name what the host was doing
in an idle gap of the device.

`reduce` turns the profiler's events of a fixed stretch of frames into
the device's busy time (the union of its kernel, copy and fill
intervals), the kernels and device time under each range (the kernels
launched by a range's host events and everything they called, as
`chip_smoke.py`'s `launched_under` attributes them), the patch gather's
device time, the kernels that took the most time, and the longest idle
gaps, each labelled by the innermost span in progress on the host.
"""
from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field

from . import arith

# (label, module path, attribute, owning class or None)
KERNEL_SPANS = (
    ("frontend", "orbslam_birdview_tpu_torch.frontend.orb", "extract_orb",
     None),
    ("frontend", "orbslam_birdview_tpu_torch.frontend.stereo",
     "stereo_match", None),
    ("frontend", "orbslam_birdview_tpu_torch.frontend.stereo",
     "refine_stereo_subpixel", None),
    ("frontend", "orbslam_birdview_tpu_torch.frontend.stereo",
     "stereo_depth_for_frame", None),
    ("pose_lm", "orbslam_birdview_tpu_torch.graph.pose_opt",
     "optimize_pose", None),
)
HOST_SPANS = (
    ("tracker.process", "orbslam_birdview_tpu_torch.pipeline.tracking",
     "process", "Tracker"),
    ("tracker.retire", "orbslam_birdview_tpu_torch.pipeline.tracking",
     "_finalize_pending", "Tracker"),
    ("tracker.step", "orbslam_birdview_tpu_torch.pipeline.fused_track",
     "track_step_mono", None),
    ("mapping.poll", "orbslam_birdview_tpu_torch.pipeline.local_mapping",
     "poll_background", "LocalMapper"),
    ("mapping.keyframe", "orbslam_birdview_tpu_torch.pipeline.local_mapping",
     "process_keyframe", "LocalMapper"),
    ("mapping.local_ba", "orbslam_birdview_tpu_torch.pipeline.local_mapping",
     "local_ba", "LocalMapper"),
    ("placerec", "orbslam_birdview_tpu_torch.pipeline.loop_closing",
     "process_keyframe", "LoopCloser"),
)
PREFIX = "portbench."
GATHER_KERNEL = "patch_gather"


def _span(label, fn):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(PREFIX + label):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def spans(profile: "Profile"):
    """Install every span, and record the shapes of each patch-gather
    launch, (Hp, Wp, K) per level, in `profile.gather_calls` while the
    profile is running."""
    import importlib

    from orbslam_birdview_tpu_torch.frontend import patch_kernel

    undo = []
    for label, mod_name, attr, cls in KERNEL_SPANS + HOST_SPANS:
        mod = importlib.import_module(mod_name)
        owner = getattr(mod, cls) if cls else mod
        orig = getattr(owner, attr)
        setattr(owner, attr, _span(label, orig))
        undo.append((owner, attr, orig))
    gather = patch_kernel.gather_patches_levels

    def recording(padded_levels, ys_levels, xs_levels, size):
        if profile.running:
            profile.gather_calls.append(([(p.shape[0], p.shape[1], y.shape[0])
                                  for p, y in zip(padded_levels, ys_levels)],
                                 size))
        return gather(padded_levels, ys_levels, xs_levels, size)

    patch_kernel.gather_patches_levels = recording
    undo.append((patch_kernel, "gather_patches_levels", gather))
    try:
        yield
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)


class Profile:
    """The profiler over a stretch of frames: `start` before the stretch's
    first call, `stop` after its last. The device queue is drained at both
    ends, so the stretch holds its own work and nothing else."""

    def __init__(self, frames: int):
        self.frames = frames
        self.gather_calls: list = []
        self.running = False
        self.frames_done = 0
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.running = True
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.running = False
        self.prof.stop()


@dataclass
class TraceResult:
    frames: int
    window_s: float
    busy_s: float
    kernels: int
    ranges: dict = field(default_factory=dict)   # label -> [kernels, s]
    gather_s: float = 0.0
    gather_launches: int = 0
    gather_bytes: int = 0
    top: list = field(default_factory=list)      # [name, s]
    idle_gaps: list = field(default_factory=list)  # [label, s]


def _launched_under(event):
    """(count, device µs) of the kernels launched by a host event and
    everything it called."""
    n = len(event.kernels)
    us = sum(k.duration for k in event.kernels)
    for child in event.cpu_children:
        cn, cus = _launched_under(child)
        n, us = n + cn, us + cus
    return n, us


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def reduce(p: Profile) -> TraceResult:
    from torch.autograd import DeviceType

    events = p.prof.events()
    device, host = [], []
    for ev in events:
        if ev.device_type == DeviceType.CUDA:
            if ev.name.startswith(PREFIX):
                continue   # a range's device-side twin spans its kernels
            device.append(ev)
        elif ev.device_type == DeviceType.CPU:
            host.append(ev)
    intervals = [(ev.time_range.start, ev.time_range.end) for ev in device]
    kernels = [ev for ev in device if not _is_copy(ev.name)]
    by_name: dict = {}
    for ev in kernels:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    gather = [ev for ev in kernels if GATHER_KERNEL in ev.name]

    ranges = {label: [0, 0.0] for label, *_ in KERNEL_SPANS}
    for ev in host:
        label = ev.name[len(PREFIX):] if ev.name.startswith(PREFIX) else None
        if label in ranges and not _inside_same(ev, label):
            n, us = _launched_under(ev)
            ranges[label][0] += n
            ranges[label][1] += us / 1e6

    # the stretch on the profiler's clock: its first to its last event
    stamps = [ev.time_range.start for ev in host + device] + \
             [ev.time_range.end for ev in host + device]
    lo, hi = min(stamps), max(stamps)
    busy_us = arith.union_length(intervals)
    spans_ = sorted(((ev.time_range.start, ev.time_range.end,
                      ev.name[len(PREFIX):]) for ev in host
                     if ev.name.startswith(PREFIX)), key=lambda s: s[0])
    idle = []
    for s, e in sorted(arith.gaps(intervals, lo, hi),
                       key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (s + e)
        inner = [sp for sp in spans_ if sp[0] <= mid <= sp[1]]
        label = (min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner
                 else "outside every span")
        idle.append([label, (e - s) / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceResult(
        frames=p.frames, window_s=p.t1 - p.t0, busy_s=busy_us / 1e6,
        kernels=len(kernels), ranges=ranges,
        gather_s=sum(ev.time_range.elapsed_us() for ev in gather) / 1e6,
        gather_launches=len(gather),
        gather_bytes=sum(arith.gather_bytes(levels, size)
                         for levels, size in p.gather_calls),
        top=[[name, us / 1e6] for name, us in top], idle_gaps=idle)


def _inside_same(ev, label) -> bool:
    """True when a host range sits inside another range of the same label
    (a stereo match inside a stereo depth call): count it once."""
    parent = ev.cpu_parent
    while parent is not None:
        if parent.name == PREFIX + label:
            return True
        parent = parent.cpu_parent
    return False
