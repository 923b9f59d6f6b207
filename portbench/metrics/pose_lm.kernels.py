"""Kernel launches a profiled frame under `optimize_pose`."""


def read(run):
    t = run.trace
    if t is None or t.ranges["pose_lm"][0] == 0:
        return None
    return t.ranges["pose_lm"][0] / t.frames
