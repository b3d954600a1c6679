"""Irradiance probe cache: the DDGI-style IrradianceCache (gi/irradiance_cache.cpp).

The port of the JAX package's ops/probes.py, single device:

- Probe grid cascades follow the camera (cpp:90-218, 362-453) with toroidal
  addressing: a probe slot owns world cell ``cell mod grid``, so scrolling never
  moves data, it only invalidates slots whose world cell changed.
- Budgeted updates (1024 probes/frame cvar, scored by invalid-then-age,
  cpp:496-583): each cascade refreshes its ``budget`` stalest slots, ties to the
  lower slot, as ``jax.lax.top_k`` picks them.
- Per-probe octahedral maps: irradiance (light cache) + depth mean/mean^2 for
  Chebyshev visibility (cpp:585-724).
- Probe rays are shaded like the RTGI bounce (sun diffuse + emission), missed
  rays from the sky-view LUT. All cascades' rays go through ONE closest-hit
  trace and ONE sun-occlusion trace.
- Sampling: 8 surrounding probes with trilinear x wrap-normal x Chebyshev
  weights (probe_sampling.slangi), the finest containing cascade fading into
  the next coarser one near its edge.

The ray -> texel convolutions are (texels x rays) products outside any kernel,
``torch.matmul``/``einsum`` here as the JAX package leaves them to XLA. In a
sharded frame (``update_probes(group=)``) the ranks divide the cascades.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from androidrenderer_tpu_torch.ops import sky as sky_ops
from androidrenderer_tpu_torch.ops import texture as tex
from androidrenderer_tpu_torch.ops.octahedral import dir_to_oct_uv, oct_texel_directions
from androidrenderer_tpu_torch.ops.post import srgb_to_linear
from androidrenderer_tpu_torch.ops.rt.traverse import SCATTERED, DeviceBVH, occlusion, trace_rays
from androidrenderer_tpu_torch.parallel.collectives import assemble, band_index

IRR_RES = 13  # irradiance octahedral resolution (reference light cache 13x13)
DEPTH_RES = 12  # depth octahedral resolution (reference 12x12)
HYSTERESIS = 0.9  # default history kept per update (RenderParams.probe_hysteresis)
DEPTH_SHARPNESS = 32.0
INVALID_AGE = 10_000  # the age of a slot whose world cell changed (or never held one)

# The 8 corner probes of a cell, in the JAX sampler's order (dz, dy, dx nested).
_CORNERS = tuple((dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1))


class ProbeCascades(NamedTuple):
    irradiance: torch.Tensor  # (C, P, IRR_RES*IRR_RES, 3) f32
    depth: torch.Tensor  # (C, P, DEPTH_RES*DEPTH_RES, 2) f32 mean / mean^2
    cell: torch.Tensor  # (C, P, 3) i32 world cell each slot currently represents
    age: torch.Tensor  # (C, P) i32 frames since last update (high = stale/invalid)


def make_probe_state(num_cascades: int, grid, device) -> ProbeCascades:
    """Empty cascades: every slot invalid. (The JAX function's ``spacing_base``
    argument, which it does not read, is left out.)"""
    p = grid[0] * grid[1] * grid[2]
    return ProbeCascades(
        irradiance=torch.zeros((num_cascades, p, IRR_RES * IRR_RES, 3), dtype=torch.float32,
                               device=device),
        depth=torch.zeros((num_cascades, p, DEPTH_RES * DEPTH_RES, 2), dtype=torch.float32,
                          device=device),
        cell=torch.full((num_cascades, p, 3), 2**20, dtype=torch.int32, device=device),
        age=torch.full((num_cascades, p), INVALID_AGE, dtype=torch.int32, device=device),
    )


def _slot_coords(grid, device) -> torch.Tensor:
    """(P, 3) i32 slot grid coordinates."""
    gx, gy, gz = grid
    idx = np.arange(gx * gy * gz)
    return torch.from_numpy(
        np.stack([idx % gx, (idx // gx) % gy, idx // (gx * gy)], axis=-1).astype(np.int32)
    ).to(device)


def _spacing_tensor(spacings, device) -> torch.Tensor:
    return torch.tensor(spacings, dtype=torch.float32, device=device)


def _bases(camera_pos, grid, spacings) -> torch.Tensor:
    """(C, 3) i32 lowest world cell each cascade covers (the camera's cell - g//2)."""
    g = torch.tensor(grid, dtype=torch.int32, device=camera_pos.device)
    sp = _spacing_tensor(spacings, camera_pos.device)[:, None]
    return torch.floor(camera_pos[None, :] / sp).to(torch.int32) - g // 2


def _desired_cells(camera_pos, grid, spacings) -> torch.Tensor:
    """(C, P, 3) world cells the grids should cover, toroidally assigned to slots:
    the cell assigned to slot s is the one in range with (cell mod g) == s."""
    g = torch.tensor(grid, dtype=torch.int32, device=camera_pos.device)
    base = _bases(camera_pos, grid, spacings)[:, None, :]  # (C, 1, 3)
    slots = _slot_coords(grid, camera_pos.device)[None]  # (1, P, 3)
    return base + (slots - base % g) % g


def cascade_spacings(spacing_base: float, num: int, ladder=None):
    """Per-cascade probe spacings. ``ladder`` = multipliers on spacing_base;
    the default follows the reference's cascade extents (irradiance_cache.cpp:
    15-18: 16x16x4 m / 64x64x16 / 512x512x128 / 8x8x2 km over a 32x8x32 grid =>
    spacings 0.5, 2, 16, 250 m, multipliers 1x/4x/32x/500x). Cascades beyond
    the ladder keep doubling off its last entry."""
    if ladder is None:
        ladder = (1.0, 4.0, 32.0, 500.0)
    out = []
    for ci in range(num):
        out.append(spacing_base * float(ladder[ci]) if ci < len(ladder) else out[-1] * 2.0)
    return tuple(out)


def pick_stalest(age: torch.Tensor, budget: int) -> torch.Tensor:
    """(C, budget) i64 slots of each cascade's ``budget`` highest ages, ties to
    the lower slot: the order ``jax.lax.top_k`` returns (a stable descending
    sort; ``torch.topk`` promises no tie order)."""
    return torch.sort(age, dim=-1, descending=True, stable=True).indices[:, :budget]


def probe_ray_directions(rays_per_probe: int, frame_index: int, device) -> torch.Tensor:
    """(R, 3) spherical-Fibonacci ray set shared by every probe, rotated per frame."""
    i = torch.arange(rays_per_probe, dtype=torch.float32, device=device)
    golden = 2.399963229728653
    z = 1.0 - (2.0 * i + 1.0) / rays_per_probe
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    frame = torch.full_like(i, float(np.float32(frame_index)))
    phi = i * golden + frame * 1.618
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def _shade_hits(scene, bvh, o, d, hits, sun_exposure, masked, use_textures):
    """(R, 3) radiance of the probe rays: sun diffuse (Lambert, with a shadow
    ray from each hit) + emission at hits, the sky-view LUT on misses."""
    from androidrenderer_tpu_torch.ops.rt.effects import (
        _bary, _hit_tris, hit_geometry, occlusion_masked,
    )

    tri, idx = _hit_tris(scene, bvh, hits)
    hp, hn, _ = hit_geometry(scene, bvh, o, d, hits)
    mat = scene.tri_material[tri].long()
    albedo = scene.mat_base_color[mat][:, :3]
    emission = scene.mat_emission[mat]
    if use_textures:
        # probe_tracing.rt.slang shares the closest-hit shader: LOD 0.
        huv = _bary(scene.uvs[idx], hits)
        tex_ids = scene.mat_texture_ids[mat].long()
        lod0 = torch.zeros(tri.shape, dtype=torch.int32, device=tri.device)

        def samp(k):
            t = tex_ids[:, k]
            return tex.sample_bilinear(scene.textures, scene.tex_start[t], scene.tex_log2b[t],
                                       huv, lod0)

        albedo = albedo * srgb_to_linear(samp(0)[:, :3])
        emission = emission * srgb_to_linear(samp(3)[:, :3])
    sun = scene.sun_direction
    to_sun = -sun / torch.sqrt((sun * sun).sum())
    ndotl = torch.clamp((hn * to_sun).sum(-1), 0.0, 1.0)
    # Sun occlusion only matters where the probe ray hit geometry.
    hit = hits.slot >= 0
    sun_dirs = to_sun.expand(hp.shape).contiguous()  # the kernel reads (R, 3) rows
    scattered = SCATTERED["probe_sun"]
    if masked:
        occ = occlusion_masked(bvh, scene, hp + hn * 0.02, sun_dirs, 0.01, 1e30, active=hit,
                               scattered=scattered)
    else:
        occ = occlusion(bvh, hp + hn * 0.02, sun_dirs, 0.01, 1e30, active=hit,
                        scattered=scattered)
    li = (albedo / math.pi * scene.sun_color[None, :] * sun_exposure
          * (ndotl * torch.where(occ, 0.0, 1.0))[:, None] + emission * sun_exposure)
    sky_lut = sky_ops.build_sky_view_lut(sun)
    sky_l = sky_ops.sample_sky_lut(sky_lut, d, sun) * (scene.sun_color[None, :] * sun_exposure)
    return torch.where(hit[:, None], li, sky_l)


class ProbeRays(NamedTuple):
    """One frame's probe update plan: each cascade's world cells and ages after
    the scroll, the slots it refreshes and their rays (C x B probes x R rays,
    probe-major), with each ray's miss/clamp distance."""

    desired: torch.Tensor  # (C, P, 3) i32
    age: torch.Tensor  # (C, P) i32
    pick: torch.Tensor  # (C, B) i64
    origins: torch.Tensor  # (C*B*R, 3) f32
    directions: torch.Tensor  # (C*B*R, 3) f32
    clamp_d: torch.Tensor  # (C*B*R,) f32


def probe_rays(state: ProbeCascades, camera_position, grid, spacing_base: float,
               budget_per_cascade: int, rays_per_probe: int, frame_index: int,
               spacing_ladder=None) -> ProbeRays:
    """Scroll the cascades to the camera and pick each one's stalest probes;
    their rays share one spherical-Fibonacci set rotated per frame."""
    dev = camera_position.device
    c = state.irradiance.shape[0]
    b, n_r = budget_per_cascade, rays_per_probe
    spacings = cascade_spacings(spacing_base, c, spacing_ladder)
    spac = _spacing_tensor(spacings, dev)
    desired = _desired_cells(camera_position, grid, spacings)  # (C, P, 3)
    moved = (desired != state.cell).any(-1)
    age = torch.where(moved, INVALID_AGE, state.age + 1)
    pick = pick_stalest(age, b)  # (C, B), stalest first (invalid = huge age)
    rows = torch.arange(c, device=dev)[:, None]
    probe_pos = (desired[rows, pick].to(torch.float32) + 0.5) * spac[:, None, None]  # (C, B, 3)
    o = probe_pos.reshape(c * b, 1, 3).expand(c * b, n_r, 3).reshape(-1, 3)
    d = probe_ray_directions(n_r, frame_index, dev).repeat(c * b, 1)
    clamp_d = (spac * 4.0).repeat_interleave(b * n_r)  # per-cascade spacing * 4
    return ProbeRays(desired, age, pick, o, d, clamp_d)


def update_probes(
    state: ProbeCascades,
    bvh: DeviceBVH,
    scene,
    camera_position: torch.Tensor,  # (3,) f32
    grid: tuple,
    spacing_base: float,
    budget_per_cascade: int,
    rays_per_probe: int,
    frame_index: int,
    sun_exposure: float,
    masked: bool = False,  # alpha-tested geometry: the bitmap traces
    use_textures: bool = True,  # sample base/emission textures at hits (LOD 0)
    hysteresis: float = HYSTERESIS,  # traced history blend (irradiance_cache cvar)
    spacing_ladder=None,  # per-cascade spacing multipliers (cascade_spacings)
    group=None,  # torch.distributed group: divide the cascades across its ranks
) -> ProbeCascades:
    """Scroll the cascades, pick each one's stalest probes, trace + convolve +
    blend. The traced cascades' probe rays go through one closest-hit trace and
    one sun-occlusion trace (budget x rays rays per cascade). Returns new
    tensors; the state passed in is not changed.

    With ``group`` (a band of a sharded frame) rank d traces only the cascades
    {i : i % n == d} (probe updates are cascade-independent) and the updated
    cascades are assembled by one all-reduce in which each cascade has one
    owner (parallel/collectives.assemble), so every rank ends with the
    single-device update bit for bit; picks, ages and cells are functions of
    replicated inputs and stay replicated. JAX sums the owners' deltas
    (old + (new - old)) instead, which differs from the update by an ulp
    where the blended value does not round back."""
    dev = camera_position.device
    c = state.irradiance.shape[0]
    b, n_r = budget_per_cascade, rays_per_probe
    plan = probe_rays(state, camera_position, grid, spacing_base, b, n_r, frame_index,
                      spacing_ladder)
    if group is None:
        owned = list(range(c))
    else:
        rank, n = band_index(group)
        owned = list(range(rank, c, n))
    age, pick = plan.age, plan.pick
    new_irr, new_dep = state.irradiance.clone(), state.depth.clone()
    if owned:
        per = b * n_r  # rays per cascade

        def rays(x):  # the owned cascades' rows of a (C*B*R, ...) ray tensor
            if len(owned) == c:
                return x
            return torch.cat([x[ci * per:(ci + 1) * per] for ci in owned])

        o, d = rays(plan.origins), rays(plan.directions)
        scattered = SCATTERED["probe_rays"]
        if masked:
            from androidrenderer_tpu_torch.ops.rt.effects import trace_rays_masked

            hits = trace_rays_masked(bvh, scene, o, d, 0.01, 1e30, scattered=scattered)
        else:
            hits = trace_rays(bvh, o, d, 0.01, 1e30, scattered=scattered)
        radiance = _shade_hits(scene, bvh, o, d, hits, sun_exposure, masked, use_textures)
        clamp_d = rays(plan.clamp_d)
        # Per-cascade miss/clamp distance (spacing * 4).
        dist = torch.minimum(torch.where(hits.slot >= 0, hits.t, clamp_d), clamp_d)
        dirs = plan.directions[:n_r]  # (R, 3): every probe's ray set
        irr_dirs = oct_texel_directions(IRR_RES, dev).reshape(-1, 3)  # (T, 3)
        dep_dirs = oct_texel_directions(DEPTH_RES, dev).reshape(-1, 3)
        cosw = torch.clamp(irr_dirs @ dirs.T, min=0.0)  # (T, R)
        cos_sum = torch.clamp(cosw.sum(1)[None, :, None], min=1e-6)
        dw = torch.clamp(dep_dirs @ dirs.T, min=0.0) ** DEPTH_SHARPNESS  # (Td, R)
        wsum = torch.clamp(dw.sum(1), min=1e-6)
        # Hysteresis blend; fresh (moved/invalid) probes take the new value. The
        # weights are the float32 ones of the reference's float32 parameter.
        keep = np.float32(hysteresis)
        take = float(np.float32(1.0) - keep)
        keep = float(keep)
        for j, ci in enumerate(owned):
            # Convolutions: texel x ray weight products over the cascade's B
            # probes, one cascade at a time (the same shapes on every rank).
            rad = radiance[j * per:(j + 1) * per].reshape(b, n_r, 3)
            dis = dist[j * per:(j + 1) * per].reshape(b, n_r)
            irr_b = torch.einsum("tr,brk->btk", cosw, rad) / cos_sum  # (B, T, 3)
            dep_b = torch.stack([(dis @ dw.T) / wsum[None, :],
                                 ((dis * dis) @ dw.T) / wsum[None, :]], dim=-1)  # (B, Td, 2)
            pk = pick[ci]
            fresh = (age[ci, pk] > 5_000)[:, None, None]
            old_irr, old_dep = state.irradiance[ci, pk], state.depth[ci, pk]
            new_irr[ci, pk] = torch.where(fresh, irr_b, old_irr * keep + irr_b * take)
            new_dep[ci, pk] = torch.where(fresh, dep_b, old_dep * keep + dep_b * take)
    if group is not None:
        def mine(x):  # the owned cascades, zeros elsewhere
            out = torch.zeros_like(x)
            out[owned] = x[owned]
            return out

        new_irr, new_dep = assemble(mine(new_irr), group), assemble(mine(new_dep), group)
    new_age = age.clone()
    new_age[torch.arange(c, device=dev)[:, None], pick] = 0
    return ProbeCascades(irradiance=new_irr, depth=new_dep, cell=plan.desired, age=new_age)


def sample_probes(
    state: ProbeCascades,
    world_position: torch.Tensor,  # (H, W, 3)
    normal: torch.Tensor,  # (H, W, 3)
    valid: torch.Tensor,  # (H, W)
    camera_position: torch.Tensor,  # (3,)
    grid: tuple,
    spacing_base: float,
    spacing_ladder=None,  # per-cascade multipliers (cascade_spacings)
) -> torch.Tensor:
    """(H, W, 3) irradiance, blended across cascades near their borders.

    The finest containing cascade dominates; within ~1.5 cells of its usable
    edge it cross-fades into the next coarser one (irradiance_cache.cpp:
    362-453). Per pixel only that cascade pair is fetched; the irradiance of a
    cell's 8 corner probes rides one 24-float row (the texel depends only on
    the normal), the depth moments are fetched per corner. The 8 corners are
    evaluated as one batch and summed in the JAX order."""
    dev = world_position.device
    cnum = state.irradiance.shape[0]
    gx, gy, gz = grid
    h, w, _ = world_position.shape
    p = gx * gy * gz
    t_irr, t_dep = IRR_RES * IRR_RES, DEPTH_RES * DEPTH_RES
    spacings = cascade_spacings(spacing_base, cnum, spacing_ladder)
    spac = _spacing_tensor(spacings, dev)  # (C,)
    bases = _bases(camera_position, grid, spacings)  # (C, 3)
    gvec = torch.tensor(grid, dtype=torch.int32, device=dev)
    offs = torch.tensor(_CORNERS, dtype=torch.int32, device=dev)  # (8, 3)

    # Corner-packed irradiance table: row ((ci*P + slot)*T + texel) holds that
    # texel of the cell's 8 corner probes (+dx +dy +dz in slot space).
    corner_slots = (_slot_coords(grid, dev)[None] + offs[:, None, :]) % gvec  # (8, P, 3)
    s = (corner_slots[..., 0] + corner_slots[..., 1] * gx
         + corner_slots[..., 2] * gx * gy).long()  # (8, P)
    irr_tab = state.irradiance[:, s.T]  # (C, P, 8, T, 3)
    irr_tab = irr_tab.permute(0, 1, 3, 2, 4).reshape(-1, 24)
    dep_tab = state.depth.reshape(-1, 2)

    # Per-pixel finest containing cascade.
    cellf_all = world_position[None] / spac[:, None, None, None] - 0.5  # (C, H, W, 3)
    c0_all = torch.floor(cellf_all).to(torch.int32)
    b_all = bases[:, None, None, :]
    inside_any = ((c0_all >= b_all + 1) & (c0_all + 1 <= b_all + gvec - 2)).all(-1)  # (C, H, W)
    ci0 = torch.argmax(inside_any.to(torch.int32), dim=0)  # the first containing cascade
    has_any = inside_any.any(0)

    # The normal's irradiance texel (the same for every corner and cascade).
    iuv = dir_to_oct_uv(normal)
    it = torch.clamp((iuv * IRR_RES).to(torch.int32), 0, IRR_RES - 1)
    iidx = (it[..., 1] * IRR_RES + it[..., 0]).long()

    total = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((h, w, 1), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for j in (0, 1):
        ci_px = torch.clamp(ci0 + j, max=cnum - 1)
        sp = spac[ci_px][..., None]  # (H, W, 1)
        base = bases[ci_px]  # (H, W, 3)
        cellf = world_position / sp - 0.5
        c0 = torch.floor(cellf).to(torch.int32)
        f = cellf - c0
        inside = ((c0 >= base + 1) & (c0 + 1 <= base + gvec - 2)).all(-1)
        lo = (base + 1).to(torch.float32)
        hi = (base + gvec - 2).to(torch.float32)
        edge = torch.minimum(cellf - lo, hi - (cellf + 1.0)).amin(-1)
        fade = torch.clamp(edge / 1.5, 0.0, 1.0)
        if j == 0:
            wc = torch.where(ci_px == cnum - 1, 1.0, fade)  # the coarsest: a hard edge
        else:
            # The coarser member's own fade ~ 1 where the finer one fades (bands
            # of 4x-spaced cascades do not nest); the front-to-back (1 - acc)
            # below applies the remainder. Nothing when j = 0 was the coarsest.
            wc = torch.where(ci_px == ci0, 0.0, 1.0)
        use = inside & valid & has_any
        wct = torch.where(use, wc, zero)[..., None]

        # Irradiance: ONE corner-packed row at the normal's texel.
        cw = ((c0 % gvec) + gvec) % gvec
        slot0 = cw[..., 0] + cw[..., 1] * gx + cw[..., 2] * gx * gy
        row = irr_tab[(ci_px.long() * p + slot0.long()) * t_irr + iidx]  # (H, W, 24)
        e8 = row.reshape(h, w, 8, 3).permute(2, 0, 1, 3)  # (8, H, W, 3)

        # The 8 corners' weights as one batch (8, H, W, ...).
        cell = c0[None] + offs[:, None, None, :]
        cw_k = ((cell % gvec) + gvec) % gvec
        slot = cw_k[..., 0] + cw_k[..., 1] * gx + cw_k[..., 2] * gx * gy
        probe_pos = (cell.to(torch.float32) + 0.5) * sp[None]
        to_probe = probe_pos - world_position[None]
        dist = torch.sqrt((to_probe * to_probe).sum(-1, keepdim=True))
        dir_tp = to_probe / torch.clamp(dist, min=1e-6)
        sel = offs.bool()[:, None, None, :]  # (8, 1, 1, 3)
        tri = torch.where(sel, f[None], 1 - f[None])
        tw = (tri[..., 0] * tri[..., 1] * tri[..., 2])[..., None]
        bw = ((dir_tp * normal[None]).sum(-1, keepdim=True) + 1.0) * 0.5
        bw = bw * bw + 0.2
        duv = dir_to_oct_uv(-dir_tp)
        dt = torch.clamp((duv * DEPTH_RES).to(torch.int32), 0, DEPTH_RES - 1)
        didx = dt[..., 1] * DEPTH_RES + dt[..., 0]
        moments = dep_tab[(ci_px.long()[None] * p + slot.long()) * t_dep + didx.long()]
        mean = moments[..., 0:1]
        var = torch.clamp(moments[..., 1:2] - mean * mean, min=1e-4)
        delta = torch.clamp(dist - mean, min=0.0)
        cheb = var / (var + delta * delta)
        vis = torch.where(dist <= mean, 1.0, torch.clamp(cheb, min=0.05))
        wgt = tw * bw * vis  # (8, H, W, 1)
        ew = e8 * wgt
        irr = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        wsum = torch.zeros((h, w, 1), dtype=torch.float32, device=dev)
        for k in range(8):
            irr = irr + ew[k]
            wsum = wsum + wgt[k]
        irr = irr / torch.clamp(wsum, min=1e-5)
        total = total + irr * wct * (1.0 - acc)
        acc = acc + wct * (1.0 - acc)
    return total / torch.clamp(acc, min=1e-5) * torch.clamp(acc * 1e5, max=1.0)
