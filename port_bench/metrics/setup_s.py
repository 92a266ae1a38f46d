"""Seconds from the process's start to the first timed request: imports,
the kernels' library (built on a checkout's first run), the scene, the
target and one warm-up request."""


def read(run):
    return run.setup_s
