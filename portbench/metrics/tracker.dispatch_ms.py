"""Host ms a window frame in the tracker's `fused.dispatch` span (the
fused step's host side: the launches of extraction, matching and the pose
LM)."""


def read(run):
    xs = run.timers.get("fused.dispatch", [])
    return 1e3 * sum(xs) / len(run.window) if run.window and xs else None
