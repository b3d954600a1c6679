# Frozen copy of androidrenderer_tpu_torch/ops/post.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed only.
"""Post-processing: tonemap composite + sRGB helpers (scene_upsample.frag:55-73):
bloom add (x bloom_strength), luminance-weighted Reinhard ``c * (L / (L + 1))``,
then gamma 1/2.2. The port of the JAX package's ops/post.py."""

from __future__ import annotations

import torch

LUMA_WEIGHTS = (0.2126, 0.7152, 0.0722)


def luminance(color: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma (scene_upsample.frag:55)."""
    w = torch.tensor(LUMA_WEIGHTS, dtype=torch.float32, device=color.device)
    return (color * w).sum(dim=-1, keepdim=True)


def reinhard_tonemap(color: torch.Tensor) -> torch.Tensor:
    """scene_upsample.frag:63-70: factor = L/(L+1); then gamma 1/2.2."""
    luma = luminance(color)
    factor = luma / (luma + 1.0)
    mapped = color * factor
    return mapped.clamp(0.0, 1.0) ** (1.0 / 2.2)


def composite(
    scene_color: torch.Tensor,  # (H, W, 3) linear HDR
    bloom: torch.Tensor | None = None,  # (H, W, 3) summed bloom chain
    bloom_strength: float = 0.014159,
) -> torch.Tensor:
    """Full UI-phase composite -> display-ready [0,1] RGB."""
    c = scene_color
    if bloom is not None:
        c = c + bloom * bloom_strength
    return reinhard_tonemap(c)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 EOTF; used when decoding SRGB8 textures."""
    c = c.clamp(0.0, 1.0)
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def to_uint8(c: torch.Tensor) -> torch.Tensor:
    """[0,1] float -> u8, round-to-nearest."""
    return (c * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)
