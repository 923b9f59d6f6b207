"""Host ms per keyframe of the window in the mapper's `map.loop` span
(the keyframe database's registration and loop query)."""


def read(run):
    xs = run.timers.get("map.loop", [])
    return 1e3 * sum(xs) / len(xs) if xs else None
