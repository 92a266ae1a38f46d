"""Device idle seconds a request under the shading spans (``crt.background``,
``crt.mat_rows``, ``crt.emitted`` and ``crt.scatter`` with its children):
each gap between the device's busy intervals goes to the innermost span
open at its midpoint, in the second profiled slice (``tracing.span_table``)."""

SHADING = ("crt.background", "crt.mat_rows", "crt.emitted")


def read(run):
    if not run.spans:
        return None
    rows = [r for name, r in run.spans.items()
            if name in SHADING or name == "crt.scatter" or name.startswith("crt.scatter.")]
    if not rows or rows[0]["idle_s"] is None:
        return None
    return sum(r["idle_s"] for r in rows)
