"""Deferred lighting — the LightingPhase (phase/lighting_phase.cpp:34-134): sun
CSM-shadowed direct light -> GI overlay -> additive emissive -> sky where nothing
was drawn; and screen-space AO. The port of the JAX package's ops/lighting.py."""

from __future__ import annotations

import torch

from androidrenderer_tpu_torch.ops.brdf import brdf, normalize
from androidrenderer_tpu_torch.ops.gbuffer import GBuffer


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


def ssao(
    gbuffer: GBuffer,
    camera_position: torch.Tensor,
    z_near: float,
    radius: float = 0.5,
    bias: float = 0.02,
    intensity: float = 1.0,
    row0: int = 0,  # the frame row of input row 0 (a band with its halo rows)
    full_height: int | None = None,
) -> torch.Tensor:
    """(H, W, 1) screen-space AO — the CACAO-slot fallback
    (ambient_occlusion_phase.cpp:191-355).

    An Alchemy-style estimator over 24 fixed shifted taps (radii 2, 5, 9 px, 8
    directions each) and a depth-aware separable bilateral blur of +-2 px. A tap
    whose source pixel lies outside the frame is masked out, and the estimate
    renormalizes by the live tap count (no screen-wrap taps). A band of a
    taller frame passes its first row as ``row0`` and the frame's height as
    ``full_height``: taps are masked by frame rows."""
    wp = gbuffer.world_position
    n = gbuffer.normal
    valid = gbuffer.valid
    h, w = wp.shape[:2]
    dev = wp.device
    fh = full_height if full_height is not None else h
    gy = (torch.arange(h, dtype=torch.int32, device=dev) + row0)[:, None]
    gx = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    occ = torch.zeros((h, w), dtype=torch.float32, device=dev)
    live = torch.zeros((h, w), dtype=torch.float32, device=dev)
    r2 = radius * radius
    for r in (2, 5, 9):
        for dy, dx in ((0, r), (0, -r), (r, 0), (-r, 0), (r, r), (-r, r), (r, -r), (-r, -r)):
            q = torch.roll(wp, (dy, dx), dims=(0, 1))
            qv = torch.roll(valid, (dy, dx), dims=(0, 1))
            # De-wrap: the tap's source pixel must be inside the frame.
            inb = (gy - dy >= 0) & (gy - dy < fh) & (gx - dx >= 0) & (gx - dx < w)
            qv = qv & inb
            v = q - wp
            d2 = (v * v).sum(dim=-1)
            vn = (v * n).sum(dim=-1)
            contrib = torch.clamp(vn - bias, min=0.0) / (d2 + 1e-4)
            w_r = torch.clamp(1.0 - d2 / r2, 0.0, 1.0)
            occ = occ + torch.where(qv, contrib * w_r * torch.sqrt(d2), torch.zeros_like(d2))
            live = live + inb.to(torch.float32)
    ao = torch.clamp(1.0 - intensity * occ / torch.clamp(live, min=1.0) * 8.0, 0.0, 1.0)
    one = torch.ones_like(ao)
    ao = torch.where(valid, ao, one)

    # Depth-aware bilateral blur (CACAO's edge-aware reconstruction): two
    # separable passes, +-2 px, weights from reversed-Z depth similarity.
    depth = gbuffer.depth
    for axis in (0, 1):
        num = ao
        den = torch.ones_like(ao)
        for o in (-2, -1, 1, 2):
            a_s = torch.roll(ao, o, dims=axis)
            d_s = torch.roll(depth, o, dims=axis)
            if axis == 0:
                inb = (gy - o >= 0) & (gy - o < fh)
            else:
                inb = ((gx - o >= 0) & (gx - o < w)).expand(h, w)
            rel = torch.abs(d_s - depth) / (torch.abs(depth) + 1e-6)
            wgt = torch.where(
                inb, (0.9 if abs(o) == 1 else 0.6) / (1.0 + 64.0 * rel), torch.zeros_like(rel)
            )
            num = num + a_s * wgt
            den = den + wgt
        ao = num / den
    return torch.where(valid, ao, one)[..., None]
