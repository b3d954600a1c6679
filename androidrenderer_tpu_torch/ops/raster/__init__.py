"""Rasterization: triangle setup, raster records, and the Hopper rasterizer."""

from androidrenderer_tpu_torch.ops.raster.raster import rasterize, rasterize_reference
from androidrenderer_tpu_torch.ops.raster.setup import (
    TriangleSetup,
    clip_to_pixel_h,
    pack_fused_records,
    transform_to_clip,
    triangle_setup,
    triangle_setup_corners,
)

__all__ = [
    "TriangleSetup",
    "clip_to_pixel_h",
    "pack_fused_records",
    "rasterize",
    "rasterize_reference",
    "transform_to_clip",
    "triangle_setup",
    "triangle_setup_corners",
]
