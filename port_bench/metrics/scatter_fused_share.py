"""The share of a request's scatters (``crt.scatter`` spans) that took the
one-launch kernel K9 (``crt.scatter.fused``), percent, in the second
profiled slice."""


def read(run):
    spans = run.spans or {}
    if not spans.get("crt.scatter", {}).get("count"):
        return None
    return 100.0 * spans.get("crt.scatter.fused", {"count": 0})["count"] / spans["crt.scatter"]["count"]
