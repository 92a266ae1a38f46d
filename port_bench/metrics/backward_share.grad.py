"""The backward pass's share of the step (percent): host seconds of the
``backward pass`` ranges around ``diff._backward_pass`` over those of the
requests, in the profiled slice (each request ends in a synchronise)."""


def read(run):
    if not run.profile:
        return None
    r = run.profile["range_s"]
    if not r.get("request") or "backward pass" not in r:
        return None
    return 100.0 * r["backward pass"] / r["request"]
