# Frozen copy of androidrenderer_tpu_torch/ops/raster/__init__.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed, the names no frame of the
# benchmark uses left out.
"""Rasterization: triangle setup, raster records and the plain rasterizer."""

from benchmark.reference.plain.ops.raster.raster import rasterize
from benchmark.reference.plain.ops.raster.setup import (
    TriangleSetup,
    pack_fused_records,
    triangle_setup_corners,
)

__all__ = ["TriangleSetup", "pack_fused_records", "rasterize", "triangle_setup_corners"]
