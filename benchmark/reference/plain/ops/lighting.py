# Frozen copy of androidrenderer_tpu_torch/ops/lighting.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed only.
"""Deferred lighting — the LightingPhase (phase/lighting_phase.cpp:34-134): sun
CSM-shadowed direct light -> GI overlay -> additive emissive -> sky where nothing
was drawn; and screen-space AO. The port of the JAX package's ops/lighting.py."""

from __future__ import annotations

import torch

from benchmark.reference.plain.ops.brdf import brdf, normalize
from benchmark.reference.plain.ops.gbuffer import GBuffer


def sun_lighting(
    gbuffer: GBuffer,
    camera_position: torch.Tensor,  # (3,)
    sun_direction: torch.Tensor,  # (3,) direction light travels (sun -> world)
    sun_color: torch.Tensor,  # (3,)
    shadow: torch.Tensor | None,  # (H, W, 1) in [0, 1], None = fully lit
    exposure: float,  # reference default 0.00031415927
) -> torch.Tensor:
    """(H, W, 3) linear HDR direct sun light (directional_light.frag:96-149)."""
    l = normalize(-sun_direction)[None, None, :]
    v = normalize(camera_position[None, None, :] - gbuffer.world_position)
    ndotl = torch.clamp((gbuffer.normal * l).sum(dim=-1, keepdim=True), 0.0, 1.0)
    f = brdf(gbuffer.base_color, gbuffer.normal, gbuffer.metalness, gbuffer.roughness, l, v)
    s = shadow if shadow is not None else 1.0
    direct = ndotl * f * sun_color[None, None, :] * s * exposure
    direct = torch.nan_to_num(direct, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.where(gbuffer.valid[..., None], direct, torch.zeros_like(direct))


def compose_lit_scene(
    gbuffer: GBuffer,
    direct: torch.Tensor,  # (H, W, 3) sun pass
    gi: torch.Tensor | None,  # (H, W, 3) GI overlay, already exposed
    ao: torch.Tensor | None,  # (H, W, 1)
    sky: torch.Tensor,  # (H, W, 3) background radiance
) -> torch.Tensor:
    """lit = (sun + GI*AO) + emissive, sky where nothing was drawn."""
    lit = direct
    if gi is not None:
        lit = lit + gi * (ao if ao is not None else 1.0)
    lit = lit + gbuffer.emission
    return torch.where(gbuffer.valid[..., None], lit, sky)


