"""Device kernels launched in the profiled slice per million camera rays."""


def read(run):
    if not run.profile:
        return None
    return run.profile["kernels"] / (run.profile_rays / 1e6)
