"""Host ms a window frame in the fused step's `step.pose_lm` spans of the
System's span record: both pose optimizations, the launches of their
kernels."""


def read(run):
    xs = run.timers.get("step.pose_lm", [])
    return 1e3 * sum(xs) / len(run.window) if run.window and xs else None
