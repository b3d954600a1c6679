"""traverse_roofline: the checked frame's traversal bound (bounds.py, the
plain BVH walk's work over all its traces) over the device time of
csrc/traverse.cu's kernel in that frame, in percent."""

from benchmark.harness.profile import TRAVERSE_KERNELS, roofline_pct


def read(run):
    return roofline_pct(run, TRAVERSE_KERNELS, "traverse_ms")
