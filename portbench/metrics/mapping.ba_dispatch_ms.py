"""Host ms per local BA of the window in the mapper's `map.ba_dispatch`
span (issuing the BA's kernels)."""


def read(run):
    xs = run.timers.get("map.ba_dispatch", [])
    return 1e3 * sum(xs) / len(xs) if xs else None
