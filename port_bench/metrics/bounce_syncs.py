"""Host synchronisations a bounce: those counted in ``crt.bounce`` and
every span below it over the bounces, in the second profiled slice
(``tracing.span_table``; PyTorch's synchronisation debug mode)."""


def read(run):
    row = (run.spans or {}).get("crt.bounce")
    if not row or row["tree_syncs"] is None:
        return None
    return row["tree_syncs"] / row["count"]
