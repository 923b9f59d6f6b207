"""Per-stage timing + counters: named stage timers with summary stats and
counters, and a torch.profiler trace context for device profiling. The
timers read the host clock; a stage that must include its device work
synchronizes inside the stage.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class StageTimer:
    def __init__(self):
        self.samples = defaultdict(list)
        self.counters = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def summary(self) -> str:
        lines = []
        for name, xs in sorted(self.samples.items()):
            a = np.array(xs) * 1e3
            lines.append(
                f"{name:30s} n={len(a):5d} median={np.median(a):8.2f} ms "
                f"mean={a.mean():8.2f} ms p95={np.percentile(a, 95):8.2f} ms")
        for name, c in sorted(self.counters.items()):
            lines.append(f"{name:30s} count={c}")
        return "\n".join(lines)

    def reset(self):
        self.samples.clear()
        self.counters.clear()


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """torch.profiler trace of the enclosed work, CPU and (when a GPU
    exists) CUDA activity, written as a Chrome trace
    (`<log_dir>/trace.json`; open it in chrome://tracing or Perfetto)."""
    import os

    import torch

    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


GLOBAL_TIMER = StageTimer()
