"""The closest-hit kernels' share of their roofline (percent): the summed
bound of every K1, K3 and K4 call in the profiled slice (``roofline.py``)
over the summed device time of their kernels."""


def read(run):
    if not run.profile or not run.profile["isect_device_s"]:
        return None
    return 100.0 * run.isect_bound_s / run.profile["isect_device_s"]
