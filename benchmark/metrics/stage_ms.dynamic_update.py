"""stage_ms.dynamic_update: device ms per traced frame of the kernels inside the
harness's own ``frame/dynamic_update`` range, around the transform update and
the BVH refit."""

from benchmark.harness.profile import stage_ms


def read(run):
    return stage_ms(run.profile, "frame/dynamic_update")
