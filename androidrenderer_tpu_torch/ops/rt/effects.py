"""RT effects over the BVH: sun shadows and ambient occlusion.

Parity targets (the JAX package's ops/rt/effects.py):
- RT sun shadows (directional_light.cpp:372-422, directional_light.rt.slang): one ray
  per pixel toward the sun, jittered within the solar disc (tan size from
  sun_light_constants), origin offset along the normal.
- RTAO (shaders/ao/rtao.comp.slang:55-90): cosine-weighted hemisphere rays, TMin
  0.01, TMax cvar (default 8 m), occlusion decrements the sample count.

Sampling uses the spatio-temporal blue-noise stack frame-indexed like the
reference's STBN textures (ops/noise.py). Like the JAX functions, these trace
every pixel's rays, sky pixels included, and mask the result by ``valid``
afterwards. Not ported here (ROADMAP.md, port queue item 6b): RTGI, closest-hit
shading (``trace_rays_masked``, ``_hit_uv``) and the exact texture-sampled alpha
peel of traced rays (``occlusion_masked(use_bitmap=False)``,
``_hit_alpha_passes``); the band argument ``row_offset`` is item 10's.
"""

from __future__ import annotations

import torch

from androidrenderer_tpu_torch.ops import noise
from androidrenderer_tpu_torch.ops.rt.traverse import DeviceBVH, occlusion, trace_rays

RAY_EPS = 0.01  # TMin (rtao.comp.slang)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]) if x.dim() == 3 else x.reshape(-1)


def occlusion_masked(bvh, origins, directions, tmin, tmax, active=None,
                     use_bitmap: bool = True) -> torch.Tensor:
    """(R,) bool any-hit occlusion with alpha-masked geometry: ONE any-hit trace
    where masked slots only hit through their baked 16x16 alpha bitmap.
    ``use_bitmap=False`` (the exact texture-sampled peel, which also takes the
    scene and a re-trace budget) raises: it is port queue item 6b."""
    if not use_bitmap:
        raise NotImplementedError(
            "occlusion_masked(use_bitmap=False), the exact alpha peel of traced rays, is not "
            "ported to androidrenderer_tpu_torch yet (ROADMAP.md, port queue item 6b)"
        )
    hits = trace_rays(bvh, origins, directions, tmin, tmax, any_hit=True, active=active,
                      alpha_bitmap_test=True)
    return hits.slot >= 0 if active is None else (hits.slot >= 0) & active


def sun_shadow_rays(world_position, normal, sun_direction, sun_tan_size, frame_index: int):
    """(origins (H*W, 3), directions (H*W, 3)) of the RT sun shadows: one ray per
    pixel toward the sun, jittered within the solar disc by the frame's blue
    noise, from the surface offset 2 cm along its normal."""
    h, w, _ = world_position.shape
    to_sun = -sun_direction / torch.sqrt((sun_direction * sun_direction).sum())
    u = noise.stbn_uniforms(h, w, frame_index, 2, world_position.device)
    d = noise.disc_jitter(to_sun.expand(h, w, 3), sun_tan_size, u[..., 0], u[..., 1])
    return _flat(world_position + normal * 0.02), _flat(d)


def rtao_directions(normal, frame_index: int, num_samples: int, sample: int):
    """(H*W, 3) cosine-weighted directions of RTAO sample ``sample``."""
    h, w, _ = normal.shape
    u = noise.stbn_uniforms(h, w, frame_index * num_samples + sample, 2, normal.device)
    return _flat(noise.cosine_hemisphere(normal, u[..., 0], u[..., 1]))


def rt_sun_shadows(
    bvh: DeviceBVH,
    world_position: torch.Tensor,  # (H, W, 3)
    normal: torch.Tensor,  # (H, W, 3)
    valid: torch.Tensor,  # (H, W)
    sun_direction: torch.Tensor,  # (3,)
    sun_tan_size,  # tan of angular radius: () tensor or number
    frame_index: int,
    scene=None,  # SceneArrays: unused until the exact alpha peel (item 6b) reads it
    masked: bool = False,  # alpha-tested geometry in the BVH (any-hit variant)
) -> torch.Tensor:
    """(H, W, 1) shadow factor: 0 occluded, 1 lit. Takes the JAX function's
    arguments; ``scene`` is unused here, as the bitmap path needs only the BVH."""
    h, w, _ = world_position.shape
    o, d = sun_shadow_rays(world_position, normal, sun_direction, sun_tan_size, frame_index)
    if masked:
        occ = occlusion_masked(bvh, o, d, RAY_EPS, 1e30)
    else:
        occ = occlusion(bvh, o, d, RAY_EPS, 1e30)
    occ = occ.reshape(h, w) & valid
    return torch.where(occ, 0.0, 1.0)[..., None]


def rtao(
    bvh: DeviceBVH,
    world_position: torch.Tensor,
    normal: torch.Tensor,
    valid: torch.Tensor,
    num_samples: int,
    max_distance,
    frame_index: int,
    scene=None,  # unused here, as in rt_sun_shadows
    masked: bool = False,
) -> torch.Tensor:
    """(H, W, 1) ambient visibility in [0, 1] (rtao.comp.slang)."""
    h, w, _ = world_position.shape
    o = _flat(world_position + normal * 0.02)
    vis = torch.zeros(h * w, dtype=torch.float32, device=world_position.device)
    for s in range(num_samples):
        d = rtao_directions(normal, frame_index, num_samples, s)
        if masked:
            occ = occlusion_masked(bvh, o, d, RAY_EPS, max_distance)
        else:
            occ = occlusion(bvh, o, d, RAY_EPS, max_distance)
        vis = vis + torch.where(occ, 0.0, 1.0)
    ao = (vis / num_samples).reshape(h, w)
    return torch.where(valid, ao, 1.0)[..., None]
