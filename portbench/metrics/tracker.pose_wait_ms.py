"""Median over the window's fused frames whose pose was available by the
window's end of the time from the end of the frame's `step` device span
(its tracking step done on the device, on the program's clock) to its
pose being available (`FrameData._finalized_wall`): how long a finished
pose waits in the lag queue. The median, as the traced run's profiled
stretch (two slow calls and the profiler's stop, seconds, inside the
window) lands in the waits of the 6-8 frames then in flight, where a 90th
percentile would sit."""
from portbench import arith


def read(run):
    waits = []
    for r in run.window:
        span = getattr(r.fd, "_step_span", None)
        done = run.finalized_at(r)
        if getattr(span, "t1", None) is not None and done <= run.t_end:
            waits.append(done - span.t1)
    return 1e3 * arith.percentile(waits, 50) if waits else None
