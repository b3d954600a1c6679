"""kernels_per_frame: device kernels in the traced window over its frames."""


def read(run):
    prof = run.profile
    if prof is None or not prof.kernels:
        return None
    return len(prof.kernels) / prof.frames
