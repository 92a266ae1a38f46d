"""The device's idle share of a request (percent): one minus the device's
busy seconds per request in the profiled slice (the union of every device
operation's interval) over the median wall of a request in the
unprofiled window. The profiler slows the host, not the device, so the
slice's own wall would overstate the idle time."""

import statistics


def read(run):
    if not run.profile or not run.walls:
        return None
    k = run.profile_rays / run.rays_per_request
    return 100.0 * (1.0 - run.profile["busy_s"] / k / statistics.median(run.walls))
