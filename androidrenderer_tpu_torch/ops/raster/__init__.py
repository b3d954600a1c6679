"""Rasterization: triangle setup, raster records, the Hopper rasterizer, and the
binned reduction rasterizer with its attribute interpolation."""

from androidrenderer_tpu_torch.ops.raster.interpolate import interpolate_attributes
from androidrenderer_tpu_torch.ops.raster.raster import rasterize, rasterize_reference
from androidrenderer_tpu_torch.ops.raster.raster_xla import rasterize_depth, rasterize_visibility
from androidrenderer_tpu_torch.ops.raster.setup import (
    TriangleSetup,
    clip_to_pixel_h,
    gather_corners,
    pack_fused_records,
    transform_to_clip,
    triangle_setup,
    triangle_setup_corners,
)

__all__ = [
    "TriangleSetup",
    "clip_to_pixel_h",
    "gather_corners",
    "interpolate_attributes",
    "pack_fused_records",
    "rasterize",
    "rasterize_depth",
    "rasterize_reference",
    "rasterize_visibility",
    "transform_to_clip",
    "triangle_setup",
    "triangle_setup_corners",
]
