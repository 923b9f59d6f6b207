"""Seconds from the process's start to the window's first frame: imports,
the CUDA context, the kernels built or loaded from the checkout's build
cache, the drive rendered, `System(cfg)` with its vocabulary,
`System.prewarm()` and the warm-up frames."""


def read(run):
    return run.setup_s
