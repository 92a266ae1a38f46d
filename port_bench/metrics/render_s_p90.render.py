"""The 90th percentile of the renders' walls in the unprofiled window
(the count is the result's ``attempted``)."""


def read(run):
    return run.p90()
