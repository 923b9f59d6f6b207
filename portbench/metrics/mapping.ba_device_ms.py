"""Device ms per local BA whose `map.local_ba` device span the System's
span record resolved in the window (timing events around the BA's
launches, read once they are done, at the latest at the BA's landing)."""


def read(run):
    xs = run.timers.get("map.local_ba", [])
    return 1e3 * sum(xs) / len(xs) if xs else None
