"""Peak device memory allocated over the window, GiB
(``torch.cuda.max_memory_allocated``)."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2 ** 30
