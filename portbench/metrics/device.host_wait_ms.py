"""Host ms a window frame in the `wait` spans of the System's span
record: the host blocked on the device in `BackgroundFetch.get` and
`fetch`."""


def read(run):
    xs = run.timers.get("wait", [])
    return 1e3 * sum(xs) / len(run.window) if run.window and xs else None
