"""RT effects over the BVH: sun shadows, ambient occlusion, multi-bounce GI.

Parity targets (the JAX package's ops/rt/effects.py):
- RT sun shadows (directional_light.cpp:372-422, directional_light.rt.slang): one ray
  per pixel toward the sun, jittered within the solar disc (tan size from
  sun_light_constants), origin offset along the normal.
- RTAO (shaders/ao/rtao.comp.slang:55-90): cosine-weighted hemisphere rays, TMin
  0.01, TMax cvar (default 8 m), occlusion decrements the sample count.
- RTGI (gi/rtgi.cpp:69-139, rtgi.rt.slang:57-110): one noise-driven cosine ray per
  pixel; the closest hit evaluates sun diffuse with a shadow ray; sky on miss;
  the result is irradiance scaled by the 0.0031415927 exposure fudge. Backface
  hits go black (gltf_basic_pbr.slang:380-521). ``num_bounces`` >= 2 unrolls the
  reference's recursive closest-hit bounce as a wavefront loop with
  diffuse-albedo throughput.

Alpha-masked geometry: by default ONE trace tests the baked 16x16 barycentric
alpha bitmaps inside the traversal; ``use_bitmap=False`` is the exact path,
which alpha-tests the committed hit's texture and re-traces past an ignored
hit, up to ``peels`` traversals (the wavefront form of the reference's any-hit
IgnoreHit loop).

Sampling uses the spatio-temporal blue-noise stack frame-indexed like the
reference's STBN textures (ops/noise.py). Like the JAX functions, shadows and
AO trace every pixel's rays, sky pixels included, and mask the result by
``valid`` afterwards. ``row_offset`` (a band of a sharded frame) offsets the
blue noise, so a band traces the rays of those rows of the whole frame.
"""

from __future__ import annotations

import numpy as np
import torch

from androidrenderer_tpu_torch.ops import noise
from androidrenderer_tpu_torch.ops import sky as sky_ops
from androidrenderer_tpu_torch.ops import texture as tex
from androidrenderer_tpu_torch.ops.brdf import brdf
from androidrenderer_tpu_torch.ops.post import srgb_to_linear
from androidrenderer_tpu_torch.ops.rt.traverse import (
    SCATTERED, DeviceBVH, Hits, occlusion, trace_rays,
)

RAY_EPS = 0.01  # TMin (rtao.comp.slang)
ALPHA_PEELS = 4  # re-trace budget of the exact alpha peel (IgnoreHit emulation)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]) if x.dim() == 3 else x.reshape(-1)


def _bary(corners, hits: Hits):
    """(R, K) attribute at the hits from the (R, 3, K) corner values, weighted
    (1 - u - v, u, v) and summed in the JAX order."""
    uu, vv = hits.u[:, None], hits.v[:, None]
    ww = 1.0 - uu - vv
    return corners[:, 0] * ww + corners[:, 1] * uu + corners[:, 2] * vv


def _hit_tris(scene, bvh: DeviceBVH, hits: Hits):
    """(R,) i64 triangle id and (R, 3) i64 vertex ids at the hit slots (slot 0's
    for a miss, as the JAX gathers clamp)."""
    slot = hits.slot.clamp(min=0).long()
    tri = bvh.slot_tri[slot].clamp(min=0).long()
    return tri, scene.tri_indices[tri].long()


def _hit_uv(scene, bvh: DeviceBVH, hits: Hits):
    """(R, 2) interpolated texcoords and (R,) triangle id at the hit slots."""
    tri, idx = _hit_tris(scene, bvh, hits)
    return _bary(scene.uvs[idx], hits), tri


def _hit_alpha_passes(scene, bvh: DeviceBVH, hits: Hits) -> torch.Tensor:
    """True where the committed hit survives the reference's any-hit alpha test
    (gltf_basic_pbr.slang:291-317: SampleLevel(uv, 0).a * tint.a; IgnoreHit when
    a <= opacity_threshold). Opaque triangles always pass."""
    uv, tri = _hit_uv(scene, bvh, hits)
    masked = scene.tri_alpha_mode[tri] == 1
    mat = scene.tri_material[tri].long()
    tex_id = scene.mat_texture_ids[mat][..., 0].long()
    s = tex.sample_bilinear(scene.textures, scene.tex_start[tex_id], scene.tex_log2b[tex_id], uv,
                            torch.zeros_like(tex_id))
    alpha = s[..., 3] * scene.mat_base_color[mat][..., 3]
    cutoff = scene.mat_alpha[mat][..., 1]
    return ~masked | (alpha > cutoff)


def _ray_tmin(tmin, r: int, device) -> torch.Tensor:
    """(R,) float32 copy of a number or an (R,) tensor: the peel's lower bounds."""
    if isinstance(tmin, torch.Tensor):
        return tmin.to(device=device, dtype=torch.float32).expand(r).clone()
    return torch.full((r,), float(tmin), dtype=torch.float32, device=device)


def _require_scene(scene) -> None:
    if scene is None:
        raise ValueError("the exact alpha peel (use_bitmap=False) alpha-tests each hit against "
                         "the scene's textures: pass the SceneArrays as ``scene``")


def _live(active, r: int, device) -> torch.Tensor:
    return torch.ones(r, dtype=torch.bool, device=device) if active is None else active


def trace_rays_masked(bvh, scene, origins, directions, tmin, tmax,
                      peels: int = ALPHA_PEELS, active=None, use_bitmap: bool = True,
                      scattered: bool = False) -> Hits:
    """Closest-hit trace honouring alpha-masked geometry.

    Default (``use_bitmap``): ONE trace with the in-traversal 16x16 barycentric
    alpha bitmaps (the ones the rasterizer tests). ``use_bitmap=False`` is the
    exact texture-sampling path: hits whose base-color alpha fails the cutoff
    are ignored and the ray re-traced past them, at ``peels`` full traversals;
    rays still unresolved after ``peels`` masked layers take the last hit as
    opaque. The exact path's ``steps``/``overflow``/``ray_steps`` sum its
    traces (longest walk of any trace, any overflow, each ray's total).
    ``scattered`` as in ``trace_rays``."""
    if use_bitmap:
        return trace_rays(bvh, origins, directions, tmin, tmax, active=active,
                          alpha_bitmap_test=True, scattered=scattered)
    _require_scene(scene)
    dev, r = origins.device, origins.shape[0]
    t0 = _ray_tmin(tmin, r, dev)
    unresolved = _live(active, r, dev)
    res_t = torch.full((r,), float(tmax), dtype=torch.float32, device=dev)
    res_slot = torch.full((r,), -1, dtype=torch.int32, device=dev)
    res_u = torch.zeros(r, dtype=torch.float32, device=dev)
    res_v = torch.zeros(r, dtype=torch.float32, device=dev)
    steps, overflow, ray_steps = [], [], []
    for p in range(peels):
        hits = trace_rays(bvh, origins, directions, t0, tmax, active=unresolved,
                          scattered=scattered)
        steps.append(hits.steps)
        overflow.append(hits.overflow)
        ray_steps.append(hits.ray_steps)
        hit = (hits.slot >= 0) & unresolved
        ok = _hit_alpha_passes(scene, bvh, hits)
        commit = hit if p == peels - 1 else hit & ok
        res_t = torch.where(commit, hits.t, res_t)
        res_slot = torch.where(commit, hits.slot, res_slot)
        res_u = torch.where(commit, hits.u, res_u)
        res_v = torch.where(commit, hits.v, res_v)
        unresolved = hit & ~ok
        # The next trace's strict t > tmin excludes exactly the ignored hit.
        t0 = torch.where(unresolved, hits.t, t0)
    return Hits(t=res_t, slot=res_slot, u=res_u, v=res_v, steps=torch.stack(steps).max(),
                overflow=torch.stack(overflow).any(), ray_steps=torch.stack(ray_steps).sum(0))


def occlusion_masked(bvh, scene, origins, directions, tmin, tmax, peels: int = ALPHA_PEELS,
                     active=None, use_bitmap: bool = True, scattered: bool = False) -> torch.Tensor:
    """(R,) bool any-hit occlusion with alpha-masked geometry.

    Default (``use_bitmap``): ONE any-hit trace where masked slots only hit
    through their baked 16x16 alpha bitmap (``scene`` is not read). The exact
    path (``use_bitmap=False``): rays park on opaque hits (the traversal's
    ``masked_any_hit``); a masked hit alpha-tests the texture and re-traces
    past itself, up to ``peels`` traversals. ``scattered`` as in ``trace_rays``."""
    dev, r = origins.device, origins.shape[0]
    if use_bitmap:
        hits = trace_rays(bvh, origins, directions, tmin, tmax, any_hit=True, active=active,
                          alpha_bitmap_test=True, scattered=scattered)
        return hits.slot >= 0 if active is None else (hits.slot >= 0) & active
    _require_scene(scene)
    # Per-slot opacity, as baked into the node rows for the park test.
    slot_opaque = scene.tri_alpha_mode[bvh.slot_tri.clamp(min=0).long()] != 1
    t0 = _ray_tmin(tmin, r, dev)
    occ = torch.zeros(r, dtype=torch.bool, device=dev)
    live = _live(active, r, dev)
    for _ in range(peels):
        hits = trace_rays(bvh, origins, directions, t0, tmax, any_hit=True, active=live,
                          masked_any_hit=True, scattered=scattered)
        hit = (hits.slot >= 0) & live
        opaque = hit & slot_opaque[hits.slot.clamp(min=0).long()]
        ok = _hit_alpha_passes(scene, bvh, hits)
        occ = occ | (hit & (opaque | ok))
        live = hit & ~opaque & ~ok
        t0 = torch.where(live, hits.t, t0)
    return occ


def sun_shadow_rays(world_position, normal, sun_direction, sun_tan_size, frame_index: int,
                    row_offset: int = 0):
    """(origins (H*W, 3), directions (H*W, 3)) of the RT sun shadows: one ray per
    pixel toward the sun, jittered within the solar disc by the frame's blue
    noise, from the surface offset 2 cm along its normal."""
    h, w, _ = world_position.shape
    to_sun = -sun_direction / torch.sqrt((sun_direction * sun_direction).sum())
    u = noise.stbn_uniforms(h, w, frame_index, 2, world_position.device, row_offset)
    d = noise.disc_jitter(to_sun.expand(h, w, 3), sun_tan_size, u[..., 0], u[..., 1])
    return _flat(world_position + normal * 0.02), _flat(d)


def rtao_directions(normal, frame_index: int, num_samples: int, sample: int,
                    row_offset: int = 0):
    """(H*W, 3) cosine-weighted directions of RTAO sample ``sample``."""
    h, w, _ = normal.shape
    u = noise.stbn_uniforms(h, w, frame_index * num_samples + sample, 2, normal.device,
                            row_offset)
    return _flat(noise.cosine_hemisphere(normal, u[..., 0], u[..., 1]))


def rt_sun_shadows(
    bvh: DeviceBVH,
    world_position: torch.Tensor,  # (H, W, 3)
    normal: torch.Tensor,  # (H, W, 3)
    valid: torch.Tensor,  # (H, W)
    sun_direction: torch.Tensor,  # (3,)
    sun_tan_size,  # tan of angular radius: () tensor or number
    frame_index: int,
    scene=None,  # SceneArrays, passed on to occlusion_masked as the JAX function does
    masked: bool = False,  # alpha-tested geometry in the BVH (any-hit variant)
    row_offset: int = 0,
) -> torch.Tensor:
    """(H, W, 1) shadow factor: 0 occluded, 1 lit."""
    h, w, _ = world_position.shape
    o, d = sun_shadow_rays(world_position, normal, sun_direction, sun_tan_size, frame_index,
                           row_offset)
    scattered = SCATTERED["rt_shadow"]
    if masked:
        occ = occlusion_masked(bvh, scene, o, d, RAY_EPS, 1e30, scattered=scattered)
    else:
        occ = occlusion(bvh, o, d, RAY_EPS, 1e30, scattered=scattered)
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
    scene=None,  # passed on to occlusion_masked, as in rt_sun_shadows
    masked: bool = False,
    row_offset: int = 0,
) -> torch.Tensor:
    """(H, W, 1) ambient visibility in [0, 1] (rtao.comp.slang)."""
    h, w, _ = world_position.shape
    o = _flat(world_position + normal * 0.02)
    vis = torch.zeros(h * w, dtype=torch.float32, device=world_position.device)
    for s in range(num_samples):
        d = rtao_directions(normal, frame_index, num_samples, s, row_offset)
        if masked:
            occ = occlusion_masked(bvh, scene, o, d, RAY_EPS, max_distance,
                                   scattered=SCATTERED["rtao"])
        else:
            occ = occlusion(bvh, o, d, RAY_EPS, max_distance, scattered=SCATTERED["rtao"])
        vis = vis + torch.where(occ, 0.0, 1.0)
    ao = (vis / num_samples).reshape(h, w)
    return torch.where(valid, ao, 1.0)[..., None]


def gi_rays(world_position, normal, frame_index: int, row_offset: int = 0):
    """(origins (H*W, 3), directions (H*W, 3)) of RTGI's first bounce: one
    cosine-weighted ray per pixel from the frame's blue noise, from the surface
    offset 2 cm along its normal."""
    h, w, _ = world_position.shape
    u = noise.stbn_uniforms(h, w, frame_index, 2, world_position.device, row_offset)
    d = _flat(noise.cosine_hemisphere(normal, u[..., 0], u[..., 1]))
    return _flat(world_position + normal * 0.02), d


def hit_geometry(scene, bvh: DeviceBVH, origins, directions, hits: Hits):
    """(hit points (R, 3), unit shading normals (R, 3), front-face (R,) bool)
    of traced rays: the interpolated vertex normal, and whether it faces the
    ray's origin (backface hits go black in the closest-hit shader)."""
    _, idx = _hit_tris(scene, bvh, hits)
    hn = _bary(scene.normals[idx], hits)
    hn = hn / torch.clamp(torch.sqrt((hn * hn).sum(-1, keepdim=True)), min=1e-9)
    hp = origins + directions * hits.t[:, None]
    return hp, hn, (hn * -directions).sum(-1) > 0.0


def _hit_material(scene, tri, idx, hits: Hits, use_textures: bool):
    """(albedo (R, 3), roughness (R,), metalness (R,), emission (R, 3)) at the
    hits: the closest-hit shader's inputs (gltf_basic_pbr.slang:413-437), the
    textures sampled at LOD 0 (base color x tint x vertex color, metal-rough
    from the triple row, emission x factor)."""
    vc = _bary(scene.colors[idx][..., :3], hits)
    mat = scene.tri_material[tri].long()
    base_f = scene.mat_base_color[mat][:, :3]
    mr_f = scene.mat_metal_rough[mat]  # [metal, rough]
    emission_f = scene.mat_emission[mat]
    if not use_textures:
        return base_f * vc, torch.clamp(mr_f[:, 1], 0.045, 1.0), mr_f[:, 0], emission_f
    huv = _bary(scene.uvs[idx], hits)
    tex_ids = scene.mat_texture_ids[mat].long()  # (R, 4)
    lod0 = torch.zeros(tri.shape, dtype=torch.int32, device=tri.device)

    def samp(k, sample=tex.sample_bilinear):
        t = tex_ids[:, k]
        return sample(scene.textures, scene.tex_start[t], scene.tex_log2b[t], huv, lod0)

    albedo = srgb_to_linear(samp(0)[:, :3]) * base_f * vc
    mr_s = samp(2, tex.sample_mr_bilinear)  # [G = roughness, B = metalness]
    rough = torch.clamp(mr_s[:, 0] * mr_f[:, 1], 0.045, 1.0)
    metal = mr_s[:, 1] * mr_f[:, 0]
    emission = srgb_to_linear(samp(3)[:, :3]) * emission_f
    return albedo, rough, metal, emission


def rtgi(
    bvh: DeviceBVH,
    scene,  # SceneArrays
    world_position: torch.Tensor,  # (H, W, 3)
    normal: torch.Tensor,  # (H, W, 3)
    valid: torch.Tensor,  # (H, W)
    frame_index: int,
    exposure: float,  # rtgi exposure fudge (0.0031415927)
    sun_exposure: float,
    num_bounces: int = 1,
    masked: bool = False,  # honour alpha-masked geometry (the bitmap traces)
    use_textures: bool = True,  # sample base/data/emission textures at the hit
    row_offset: int = 0,
) -> torch.Tensor:
    """(H, W, 3) diffuse GI irradiance (x albedo happens in lighting).

    The wavefront loop: each bounce traces the live rays, adds sun + emission at
    front-face hits (weighted by the path throughput), ends rays on a miss
    (adding sky) or a backface, and continues with a cosine-sampled ray and
    albedo-scaled throughput. Per bounce: one closest-hit trace and one
    any-hit sun trace from the hits. The JAX function's ``inverse_view``,
    ``p00`` and ``p11`` arguments, which it does not read, are left out."""
    h, w, _ = world_position.shape
    dev = world_position.device
    sun = scene.sun_direction
    to_sun = -sun / torch.sqrt((sun * sun).sum())
    o, d = gi_rays(world_position, normal, frame_index, row_offset)
    n_rays = h * w
    radiance = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((n_rays, 3), dtype=torch.float32, device=dev)
    alive = valid.reshape(-1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for b in range(num_bounces):
        if masked:
            hits = trace_rays_masked(bvh, scene, o, d, RAY_EPS, 1e30, active=alive,
                                     scattered=SCATTERED["rtgi_rays"])
        else:
            hits = trace_rays(bvh, o, d, RAY_EPS, 1e30, scattered=SCATTERED["rtgi_rays"])
        hit = (hits.slot >= 0) & alive
        tri, idx = _hit_tris(scene, bvh, hits)
        hp, hn, front = hit_geometry(scene, bvh, o, d, hits)
        albedo, rough, metal, emission = _hit_material(scene, tri, idx, hits, use_textures)
        # Direct sun at the hit: Burley Fd diffuse (slang:438 Fd()) + shadow ray.
        ndotl = torch.clamp((hn * to_sun).sum(-1), 0.0, 1.0)
        sun_dirs = to_sun.expand(hp.shape).contiguous()  # the kernel reads (R, 3) rows
        if masked:
            sh_occ = occlusion_masked(bvh, scene, hp + hn * 0.02, sun_dirs, RAY_EPS, 1e30,
                                      active=hit & front, scattered=SCATTERED["rtgi_sun"])
        else:
            sh_occ = occlusion(bvh, hp + hn * 0.02, sun_dirs, RAY_EPS, 1e30,
                               scattered=SCATTERED["rtgi_sun"])
        fd = brdf(albedo, hn, metal[:, None], rough[:, None], sun_dirs, -d, diffuse_only=True)
        sun_li = (fd * scene.sun_color[None, :] * (ndotl * torch.where(sh_occ, 0.0, 1.0))[:, None]
                  * sun_exposure)
        emit = torch.where((hit & front)[:, None], sun_li + emission * sun_exposure, zero)
        radiance = radiance + throughput * emit
        # Sky on miss: the analytic march, scaled as the reference's miss shader.
        sky_l = sky_ops.sky_radiance(d, sun) * scene.sun_color[None, :] * sun_exposure
        radiance = radiance + torch.where((alive & ~hit)[:, None], throughput * sky_l, zero)
        alive = hit & front
        if b + 1 < num_bounces:
            throughput = throughput * albedo
            ub = noise.stbn_uniforms(h, w, frame_index + (b + 1) * 7919, 2, dev, row_offset)
            d = _flat(noise.cosine_hemisphere(hn.reshape(h, w, 3), ub[..., 0], ub[..., 1]))
            o = hp + hn * 0.02
    # The float32 quotient, as the reference's parameters are float32 scalars.
    scale = float(np.float32(exposure) / np.float32(0.00031415927))
    gi = radiance.reshape(h, w, 3) * scale
    return torch.where(valid[..., None], gi, zero)
