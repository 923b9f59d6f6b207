"""Host ms a window frame in the tracker's `fused.retire` span: waiting
for in-flight frames' pose summaries and finalizing them."""


def read(run):
    xs = run.timers.get("fused.retire", [])
    return 1e3 * sum(xs) / len(run.window) if run.window and xs else None
