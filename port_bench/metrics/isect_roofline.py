"""The closest-hit kernels' share of their roofline (percent): the summed
bound of every K1, K3 and K4 call in the profiled slice
(``rooflines/k1.py``, ``k3.py``, ``k4.py``) over the summed device time of
their kernels."""


def read(run):
    return run.roofline_share(("k1", "k3", "k4"))
