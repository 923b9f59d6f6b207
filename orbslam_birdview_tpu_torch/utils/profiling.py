"""The System's span record: named host stages, device spans, per-frame
marks and counters, each span stamped with the frame it ran in, and a
torch.profiler trace context for device profiling.

One `StageTimer` serves a whole `System`: the System hands it to its
tracker, mapper and loop closer, keeps it across `reset`, and numbers its
frames (`begin_frame`, once a `track_*` call: the System's call number,
so frames run on across resets).

- `stage(name)`: host seconds of the enclosed code, appended to
  `samples[name]`.
- `device_span(name, device)`: on a CUDA device, a timing event on the
  current stream before and after the enclosed launches. A pair is
  resolved by `poll` once both events report done, never by waiting: its
  device seconds are appended to `samples[name]` then. On the CPU it is a
  no-op.
- `mark(name, frame, t)`: an instant of a frame (the tracker's dispatch
  end, retire start, pose available).

Every span and mark is also kept, as (name, frame, t0, t1), in a ring of
the last `RING` entries (`spans`). Stamps are on one monotonic program
clock (`time.perf_counter`). Device stamps reach that clock through one
anchor event recorded behind a device synchronize at set-up
(`anchor_device`); until then a device span has its seconds and no
stamps. The device's timer and the host's clock drift apart by a few
parts per million (an H100 against its host: ~2.3 ppm, 0.1 ms in 40 s),
so the device seconds since the anchor are scaled by a rate (`rate`).
The anchor and each span's start event are stamped on the host as their
record calls return; an idle device runs the event within the same few
µs of that stamp each time, a busy one later. So each span's start
bounds the rate from below (to those few µs), tightly when the device
was idle, and the rate is the highest such bound so far, from spans
`MIN_RATE_BASE_S` or more after the anchor (1 before there is one).
Each frame also pairs the program clock with the wall clock, which is
the profiler's (`wall_ns`), so that a profile and the record can be
laid over each other.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict, deque

import numpy as np
import torch

RING = 1 << 16          # spans and marks kept
CLOCK_PAIRS = 1 << 12   # frames whose program-to-wall clock pair is kept
MIN_RATE_BASE_S = 10.0  # device seconds after the anchor before a span
                        # bounds the clock rate: the anchor's own few µs
                        # of latency are then under 0.5 ppm of it


def cuda_event(device):
    """A timing event recorded now on the device's current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class DeviceSpan:
    """A device span: `seconds` of device time and its stamps `t0`, `t1`
    on the program clock, each None until resolved (stamps also until the
    device clock is anchored); `h0` is the program clock as the record
    call of its start event returned. The events are dropped once
    resolved."""
    __slots__ = ("name", "frame", "h0", "start", "end", "seconds", "t0",
                 "t1")

    def __init__(self, name: str, frame: int, h0: float, start):
        self.name, self.frame, self.h0, self.start = name, frame, h0, start
        self.end = self.seconds = self.t0 = self.t1 = None


class StageTimer:
    def __init__(self, record_event=cuda_event):
        self.samples = defaultdict(list)
        self.counters = defaultdict(int)
        self.frame = -1
        self._ring: deque = deque(maxlen=RING)
        self._clock: deque = deque(maxlen=CLOCK_PAIRS)  # (program s, wall ns)
        self._record_event = record_event
        self._pending: list[DeviceSpan] = []
        self._anchor = None        # (event, program-clock s) at set-up
        self.rate = None           # program s per device s since the anchor
        self.device_names: set = set()

    # ---- frames and the clocks ------------------------------------------
    def begin_frame(self) -> int:
        """Start the next frame: number it, pair the clocks, resolve the
        device spans that have finished."""
        self.frame += 1
        self._clock.append((time.perf_counter(), time.time_ns()))
        self.poll()
        return self.frame

    def anchor_device(self, device):
        """Record the device clock's anchor. Call it right behind a
        synchronize of `device` and outside any frame: the event then runs
        as it is recorded."""
        self._anchor = (self._record_event(device), time.perf_counter())

    def wall_ns(self, t: float) -> float:
        """A program-clock stamp on the wall clock, in ns: interpolated
        between the frames' clock pairs around it (the nearest pair's
        offset outside them)."""
        pairs = list(self._clock)
        if not pairs:
            raise ValueError("no frame has paired the clocks yet")
        i = bisect.bisect_right([p for p, _ in pairs], t)
        if i == 0 or i == len(pairs):
            p, w = pairs[min(i, len(pairs) - 1)]
            return w + (t - p) * 1e9
        (p0, w0), (p1, w1) = pairs[i - 1], pairs[i]
        return w0 + (t - p0) / (p1 - p0) * (w1 - w0)

    # ---- spans ------------------------------------------------------------
    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.samples[name].append(t1 - t0)
            self._ring.append((name, self.frame, t0, t1))

    @contextlib.contextmanager
    def device_span(self, name: str, device):
        """Yields the `DeviceSpan` (None off CUDA), resolved by a later
        `poll`."""
        if torch.device(device).type != "cuda":
            yield None
            return
        start = self._record_event(device)
        span = DeviceSpan(name, self.frame, time.perf_counter(), start)
        try:
            yield span
        finally:
            span.end = self._record_event(device)
            self._pending.append(span)
            self.device_names.add(name)

    def poll(self):
        """Resolve every pending device span whose events are done; one
        that is not stays pending. Never waits."""
        anchor = self._anchor
        if anchor is not None and not anchor[0].query():
            return
        keep = []
        for span in self._pending:
            if not (span.start.query() and span.end.query()):
                keep.append(span)
                continue
            span.seconds = span.start.elapsed_time(span.end) / 1e3
            if anchor is not None:
                since = anchor[0].elapsed_time(span.start) / 1e3
                if since >= MIN_RATE_BASE_S:
                    bound = (span.h0 - anchor[1]) / since
                    self.rate = max(self.rate or bound, bound)
                rate = self.rate or 1.0
                span.t0 = anchor[1] + rate * since
                span.t1 = span.t0 + rate * span.seconds
            span.start = span.end = None
            self.samples[span.name].append(span.seconds)
            self._ring.append((span.name, span.frame, span.t0, span.t1))
        self._pending = keep

    def mark(self, name: str, frame: int, t: float = None):
        t = time.perf_counter() if t is None else t
        self._ring.append((name, frame, t, t))

    def spans(self, frames=None, names=None) -> list:
        """The ring's (name, frame, t0, t1), oldest first; `frames` and
        `names` select."""
        return [s for s in self._ring
                if (frames is None or s[1] in frames)
                and (names is None or s[0] in names)]

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def summary(self) -> str:
        self.poll()
        lines = []
        for name, xs in sorted(self.samples.items()):
            a = np.array(xs) * 1e3
            kind = "device" if name in self.device_names else "host"
            lines.append(
                f"{name:30s} {kind:6s} n={len(a):5d} "
                f"median={np.median(a):8.2f} ms mean={a.mean():8.2f} ms "
                f"p95={np.percentile(a, 95):8.2f} ms")
        for name, c in sorted(self.counters.items()):
            lines.append(f"{name:30s} count={c}")
        return "\n".join(lines)

    def reset(self):
        """Forget the samples, counters and spans; frames keep counting."""
        self.samples.clear()
        self.counters.clear()
        self._ring.clear()


def optional_stage(record, name: str):
    """`record.stage(name)`, or no span without a record."""
    return (record.stage(name) if record is not None
            else contextlib.nullcontext())


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """torch.profiler trace of the enclosed work, CPU and (when a GPU
    exists) CUDA activity, written as a Chrome trace
    (`<log_dir>/trace.json`; open it in chrome://tracing or Perfetto)."""
    import os

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


# The program writes only its Systems' own records; this process-wide
# timer stays for readers that still import it, and holds nothing.
GLOBAL_TIMER = StageTimer()
