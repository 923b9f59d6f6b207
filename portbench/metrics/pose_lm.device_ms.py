"""Device ms a profiled frame of the kernels launched under
`optimize_pose`."""


def read(run):
    t = run.trace
    if t is None or t.ranges["pose_lm"][0] == 0:
        return None
    return 1e3 * t.ranges["pose_lm"][1] / t.frames
