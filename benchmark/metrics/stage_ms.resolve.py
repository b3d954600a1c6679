"""stage_ms.resolve: device ms per traced frame of the kernels inside the
``frame/resolve`` range of the program's frame,
hand kernels included."""

from benchmark.harness.profile import stage_ms


def read(run):
    return stage_ms(run.profile, "frame/resolve")
