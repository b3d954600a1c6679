"""Render-res -> output-res resample (the JAX package's ops/taa.py::upscale_bilinear).

Temporal anti-aliasing itself is not ported yet (ROADMAP.md); the raster-only
frame renders at native resolution, where this is the identity.
"""

from __future__ import annotations

import torch

from androidrenderer_tpu_torch.ops.bloom import resize_linear


def upscale_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Render-res -> output-res (scene_upsample.frag bilinear contract)."""
    if img.shape[0] == out_h and img.shape[1] == out_w:
        return img
    return resize_linear(img, out_h, out_w)
