"""The 90th percentile of the gradient steps' walls in the unprofiled
window."""


def read(run):
    return run.p90()
