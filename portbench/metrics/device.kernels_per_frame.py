"""Kernel launches on the device a profiled frame."""


def read(run):
    t = run.trace
    if t is None or t.kernels == 0:
        return None
    return t.kernels / t.frames
