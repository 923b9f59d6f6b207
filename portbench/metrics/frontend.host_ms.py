"""Host ms a window frame in the fused step's `step.extract` spans of the
System's span record: the front and BEV extraction (and the right image's
and the stereo match where there is one)."""


def read(run):
    xs = run.timers.get("step.extract", [])
    return 1e3 * sum(xs) / len(run.window) if run.window and xs else None
