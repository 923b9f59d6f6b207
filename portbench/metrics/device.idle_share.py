"""The profiled stretch's share, in %, during which no kernel, copy or
fill runs on the device (one minus the union of their intervals over the
stretch's length)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
