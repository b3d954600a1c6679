"""device_idle_pct: the share of a frame in which no operation ran on the
device: 100 x (1 - the device's busy ms per traced frame (kernels, copies and
fills, from the profiler's trace) / the ms per frame of the frames timed right
after the trace without the profiler). The profiler's own host work slows a
traced frame, so its window would read the idle share of a slower host."""


def read(run):
    prof = run.profile
    if prof is None or not prof.device_ops or not run.untraced_frame_ms:
        return None
    busy_ms = prof.busy_us() * 1e-3 / prof.frames
    return 100.0 * (1.0 - busy_ms / run.untraced_frame_ms)
