"""Camera rays (pixels x spp) of the renders the window completed, over the
window's wall (host clock, each render ending in a synchronise)."""


def read(run):
    return run.rays / run.window_s
