"""Host synchronisations PyTorch reports in one request under its
synchronisation debug mode, per million camera rays."""


def read(run):
    if run.syncs is None:
        return None
    return run.syncs / (run.rays_per_request / 1e6)
