"""Camera rays (pixels x spp, counted once though traced forward and
backward) of the gradient steps the window completed, over its wall."""


def read(run):
    return run.rays / run.window_s
