"""warmup_s: seconds from the bake's end to the last warm-up frame's end: the
hand kernels' loads and the configuration's warm-up frames, which run every
shape the window runs (the harness's clock, synchronised)."""


def read(run):
    return run.warmup_s
