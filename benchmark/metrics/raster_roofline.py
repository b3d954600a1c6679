"""raster_roofline: the checked frame's raster bound (bounds.py, the plain
fragment walk's work over all its raster calls) over the device time of
csrc/raster.cu's four kernels in that frame, in percent."""

from benchmark.harness.profile import RASTER_KERNELS, roofline_pct


def read(run):
    return roofline_pct(run, RASTER_KERNELS, "raster_ms")
