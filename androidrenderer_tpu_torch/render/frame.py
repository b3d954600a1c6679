"""The frame function — SceneRenderer::render() on one device.

Phase sequence (the JAX package's render/frame.py, single device):

    frustum cull -> corner-table triangle setup -> CUDA raster with in-kernel
    alpha test [or two-phase HiZ occlusion: raster last frame's visible
    primitives, build the HiZ pyramid, re-test every sphere, raster the newly
    visible, merge] -> [exact alpha-test peel of the masked triangles] ->
    gbuffer resolve -> sky -> [staggered CSM + packed 2x2 PCF, or RT sun
    shadows: one jittered any-hit ray per pixel through the CUDA traversal] ->
    [half-rate SSAO + joint-bilateral 2x upsample, or RTAO: rtao_num_samples
    any-hit rays per pixel] -> [LPV GI: staggered cascade rebuild
    (RSM on the proxy through the CUDA raster -> VPLs -> SH inject ->
    propagate), half-rate apply + upsample; or probe GI: the budgeted probe
    update (one closest-hit and one sun trace for every cascade's probe rays),
    half-rate sampling + upsample; or RTGI: one cosine ray per pixel and a sun
    ray per hit per bounce, a-trous filter, temporal accumulation] -> sun BRDF
    + GI * AO ->
    [translucency: peeled BLEND layers, back-to-front composite] -> [VRSAA fine
    pass, or TAA, or TAAU to the output resolution] -> bloom -> Reinhard -> u8

Under VRSAA the geometry rasterizes at twice the output resolution and every
stage from the resolve on shades the coarse grid (the quads' top-left samples);
the fine pass re-shades the other 3 samples of the quads with contrast and
box-resolves them (ops/vrsaa.py). Every tensor of the frame stays on the
scene's device. The TPU tunables of RenderConfig have no effect here.

The JAX frame's profiling switches act as they do there, each replacing one
stage with shape-identical synthetic data so that whole-frame deltas isolate
that stage's in-frame cost: ``debug_stub_raster`` (the main view's raster and
occlusion culling: analytic depth and pseudo-random ids, ``_stub_raster``),
``debug_stub_resolve`` (the gbuffer from elementwise math on the depth, outside
VRSAA), ``debug_resolve_gather_only`` (the resolve's plane gather without its
per-pixel heads), ``debug_stub_shadow_sample`` (the cascade rasters run, the
main view's PCF sample is 1; the VRSAA fine pass still samples),
``debug_stub_rsm`` (each RSM's raster replaced like the main view's; injection
still runs) and ``debug_stub_lpv_apply`` (the volumes are built, the apply and
its upsample skipped, GI = base color x 0.1). Their ``+ 0.0 * texel`` terms
keep a NaN in the skipped stage's input propagating as it does in JAX.
``gbuffer_barrier`` only constrains how XLA fuses the JAX frame, whose values do
not change with it; eager PyTorch materialises the gbuffer anyway, so it has no
effect here.

Band rendering (``band_height``/``row_offset``, the JAX frame's three modes):
the frame renders rows [row_offset, row_offset + band_height) of the screen.
With ``group`` (a ``torch.distributed`` process group, one band per rank;
parallel/mesh.py) every feature runs: cross-band neighbourhoods come from row
halos (SSAO, the upsamples, the TAA and RTGI clamps), full-frame passes (the
TAA/RTGI history fetch, TAAU, bloom, upscale) gather their inputs and run
replicated, the LPV surfels are gathered so that every rank builds the same
volumes, the temporal visibility list is OR-reduced, and the cascade rasters
and the probe updates are divided across the ranks
(parallel/collectives.py; each collective inside a ``frame/collectives``
range). Without a group, band rendering is the legacy raster + shade path
(no occlusion culling, RT, GI or TAA, and no cross-band post). Row offsets
are Python ints: nothing waits on the device for them.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from androidrenderer_tpu_torch.camera import ViewData
from androidrenderer_tpu_torch.config import (
    AAMode, AOMode, GIMode, RenderConfig, RenderParams, ShadowMode,
)
from androidrenderer_tpu_torch.ops import bloom as bloom_ops
from androidrenderer_tpu_torch.ops import culling, lighting, post, sky
from androidrenderer_tpu_torch.ops import lpv as lpv_ops
from androidrenderer_tpu_torch.ops import probes as probe_ops
from androidrenderer_tpu_torch.ops import shadow as shadow_ops
from androidrenderer_tpu_torch.ops import taa as taa_ops
from androidrenderer_tpu_torch.ops import vrsaa as vrsaa_ops
from androidrenderer_tpu_torch.ops.denoise import atrous_filter, temporal_accumulate
from androidrenderer_tpu_torch.ops.gbuffer import GBuffer, pack_attribute_planes, resolve_gbuffer
from androidrenderer_tpu_torch.ops.raster import rasterize, triangle_setup_corners
from androidrenderer_tpu_torch.ops.raster.masked import (
    _sample_alpha, pack_alpha_planes, rasterize_masked_peeled,
)
from androidrenderer_tpu_torch.ops.rt import effects as rt_effects
from androidrenderer_tpu_torch.ops.upsample import bilateral_upsample_2x
from androidrenderer_tpu_torch.parallel import collectives as coll
from androidrenderer_tpu_torch.render.temporal import TemporalState
from androidrenderer_tpu_torch.scene.proxy import swap_in_proxy
from androidrenderer_tpu_torch.scene.scene import SceneArrays


class FrameOutputs(NamedTuple):
    image: torch.Tensor  # (H, W, 3) u8 display-ready
    hdr: torch.Tensor  # (OH, OW, 3) f32 lit scene (pre-tonemap; output res after TAAU)
    depth: torch.Tensor  # (H, W) f32
    visibility: torch.Tensor  # (H, W) i32
    gbuffer: GBuffer
    # CSM cascade data the frame sampled with (None when shadows are off).
    csm: object = None
    # (H, W, 2) uv-space reprojection motion (None unless TAA ran).
    motion: object = None
    # () i32 quads dropped past vrsaa_budget this frame, on the device (None
    # unless VRSAA ran): the worklist's true overflow count, never silently capped.
    vrsaa_dropped: object = None


def _check_vrsaa(config: RenderConfig) -> None:
    """The JAX frame's ValueErrors for configs VRSAA cannot render."""
    if config.translucency:
        raise ValueError("VRSAA + translucency unsupported (peel at 2x res)")
    if (config.render_width != 2 * config.output_width
            or config.render_height != 2 * config.output_height):
        raise ValueError("VRSAA needs render resolution == 2x output resolution")


def _require_bvh(scene: SceneArrays, config: RenderConfig) -> None:
    """Raise ValueError when a ray-traced switch meets a scene without a BVH."""
    rt = [name for name, on in (("shadow_mode=RT", config.shadow_mode == ShadowMode.RT),
                                ("ao_mode=RT", config.ao_mode == AOMode.RT),
                                ("gi_mode=RT", config.gi_mode == GIMode.RT),
                                ("gi_mode=PROBES", config.gi_mode == GIMode.PROBES)) if on]
    if rt and scene.bvh is None:
        raise ValueError(
            f"{' and '.join(rt)} trace rays, but the scene has no BVH: build it with "
            "RenderScene.build(with_bvh=True), or carry bvh.<field> leaves into "
            "scene_arrays_from_numpy"
        )


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def main_view_setup(scene: SceneArrays, view: ViewData, config: RenderConfig):
    """(setup, opaque-pass setup, alpha grid or None) of the main view: the
    triangle-grain frustum cull and the corner-table setup. With
    ``alpha_bitmap`` masked triangles rasterize in the opaque pass against their
    alpha bitmaps; without it they leave the pass for the exact peel. BLEND
    triangles never draw in the opaque pass (render_scene.cpp:57-69)."""
    dev = scene.positions.device
    tri_mask = culling.frustum_cull_triangles(
        scene.tri_corner_pos, _f32(view.view, dev), _f32(view.frustum, dev),
        float(view.z_near), scene.tri_valid,
    )
    setup = triangle_setup_corners(
        scene.tri_corner_pos, _f32(view.view_proj, dev),
        config.render_width, config.render_height,
        double_sided=scene.tri_double_sided, tri_valid=tri_mask,
    )
    drop = scene.tri_alpha_mode == 2
    if _exact_alpha(config):
        drop = drop | (scene.tri_alpha_mode == 1)
    setup_opaque = setup._replace(valid=setup.valid & ~drop)
    alpha_grid = scene.tri_alpha_grid if config.alpha_masking and config.alpha_bitmap else None
    return setup, setup_opaque, alpha_grid


def _exact_alpha(config: RenderConfig) -> bool:
    """Masked triangles go through the exact peel (masked.py), not the bitmaps."""
    return config.alpha_masking and not config.alpha_bitmap


def _stub_raster(height: int, width: int, n_tri: int, device):
    """The profiling stub of a raster (``debug_stub_raster``, ``debug_stub_rsm``):
    (depth 0.05 + 0.9 |sin(0.013 y + 0.007 x)| f32, ids (7919 y + 104729 x) &
    (m - 1) i32), m the largest power of 2 <= ``n_tri``, over the local rows of
    the target. The ids stay within int32: at 3840x2176 they reach about 4.2e8."""
    m = 1
    while m * 2 <= n_tri:
        m *= 2
    yy = torch.arange(height, dtype=torch.int32, device=device)[:, None]
    xx = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    vis = (yy * 7919 + xx * 104729) & (m - 1)
    depth = 0.05 + 0.9 * torch.abs(torch.sin((yy * 0.013 + xx * 0.007).to(torch.float32)))
    return depth, vis


def _stub_gbuffer(vis: torch.Tensor, depth: torch.Tensor) -> GBuffer:
    """The profiling stub of the resolve (``debug_stub_resolve``): a gbuffer of
    the same shapes from elementwise math on the depth, with no plane gather
    and no texture fetch."""
    zz = depth[..., None]
    xyz = torch.cat([zz * 3.0, zz * zz, torch.cos(zz)], dim=-1)
    one = torch.ones_like(zz)
    return GBuffer(
        base_color=torch.abs(torch.sin(xyz)),
        normal=xyz / torch.sqrt((xyz * xyz).sum(dim=-1, keepdim=True) + 1e-6),
        roughness=0.5 * one,
        metalness=0.1 * one,
        emission=torch.zeros_like(xyz),
        world_position=xyz * 4.0,
        depth=depth,
        valid=vis >= 0,
    )


class Band(NamedTuple):
    """The rows a frame renders: [row_offset, row_offset + height) of a screen
    ``full_height`` rows high, by a rank of ``group`` (None: one device)."""

    height: int
    row_offset: int
    full_height: int
    group: object = None

    @property
    def banded(self) -> bool:
        return self.height != self.full_height


def _occlusion_raster(scene, view, config, setup_opaque, alpha_grid, temporal, band):
    """Two-phase HiZ occlusion culling (depth_culling_phase.cpp:182-241): raster
    last frame's visible primitives, build the HiZ pyramid from that depth,
    re-test every primitive's sphere, raster the newly visible and merge by
    reversed-Z max (exact). Returns (depth, vis, next temporal state). A band
    builds its pyramid from its own rows, tests the spheres against them, and
    ORs the visibility list across the ranks."""
    dev = scene.positions.device
    h, w, r0 = band.height, config.render_width, band.row_offset
    view_m = _f32(view.view, dev)
    prim_mask = culling.frustum_cull_spheres(
        scene.prim_bounds, view_m, _f32(view.frustum, dev), float(view.z_near),
    ) & scene.prim_valid
    np_ = scene.prim_bounds.shape[0]
    phase1 = prim_mask & temporal.prev_visible_prims[:np_]
    tri_p1 = culling.primitive_mask_to_triangle_mask(phase1, scene.tri_primitive, scene.tri_valid)
    depth, vis = rasterize(
        setup_opaque._replace(valid=setup_opaque.valid & tri_p1), h, w, alpha_grid=alpha_grid,
        row_offset=r0,
    )
    n_levels = config.hiz_levels
    while n_levels > 1 and (h % (1 << (n_levels - 1)) or w % (1 << (n_levels - 1))):
        n_levels -= 1
    hiz = culling.build_hiz_pyramid(depth, n_levels)
    not_occluded = culling.occlusion_cull_spheres(
        scene.prim_bounds, view_m, float(view.z_near),
        float(view.projection[0, 0]), float(view.projection[1, 1]), hiz,
        row_offset=r0, full_height=band.full_height if band.banded else None,
    )
    visible_now = prim_mask & not_occluded
    tri_new = culling.primitive_mask_to_triangle_mask(
        visible_now & ~phase1, scene.tri_primitive, scene.tri_valid
    )
    d2, v2 = rasterize(
        setup_opaque._replace(valid=setup_opaque.valid & tri_new), h, w, alpha_grid=alpha_grid,
        row_offset=r0,
    )
    vis = torch.where(d2 > depth, v2, vis)
    depth = torch.maximum(depth, d2)
    if band.group is not None:
        # Temporal visibility = union over the bands (replicated next frame).
        visible_now = coll.any_across(visible_now, band.group)
    prev = temporal.prev_visible_prims.clone()
    prev[:np_] = visible_now
    return depth, vis, temporal._replace(prev_visible_prims=prev)


def _translucency(scene, view, params, config, setup, depth, lit, flags, row_offset):
    """Depth-peeled BLEND layers composited back to front over the opaque lit
    scene, each only where it lies in front of the opaque depth: per layer a
    raster under the previous layer's depth (``z_limit``), a gbuffer resolve,
    the alpha at the winning fragment and sun lighting + emission."""
    h, w = depth.shape
    setup_b = setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 2))
    view_pos = _f32(view.position, scene.positions.device)
    aplanes = pack_alpha_planes(scene, setup_b)
    z_lim = torch.full((h, w), float("inf"), dtype=torch.float32, device=depth.device)
    layers = []
    for i in range(config.translucent_layers):
        d_t, v_t = rasterize(setup_b, h, w, z_limit=None if i == 0 else z_lim,
                             row_offset=row_offset)
        gb_t = resolve_gbuffer(scene, setup_b, v_t, d_t, row_offset=row_offset, **flags)
        alpha_t, _ = _sample_alpha(scene, setup_b, v_t, row_offset, alpha_planes=aplanes)
        color_t = lighting.sun_lighting(
            gb_t, view_pos, scene.sun_direction, scene.sun_color, None, params.sun_exposure,
        ) + gb_t.emission
        layers.append((d_t, color_t, alpha_t[..., None], gb_t.valid))
        z_lim = torch.where(v_t >= 0, d_t, z_lim)
    for d_t, color_t, alpha_t, ok_t in reversed(layers):
        front = (ok_t & (d_t > depth))[..., None]
        lit = torch.where(front, lit * (1.0 - alpha_t) + color_t * alpha_t, lit)
    return lit


def _shadows(scene, inv_view, p00, p11, z_near, params, temporal, config, gbuf, depth, group):
    """Cascade fit + depth rasters + packed PCF: (shadow (H, W, 1), cascades as
    sampled, next temporal state, and ``sample(gbuffer, depth)``, the PCF of any
    other samples against the same maps: the VRSAA fine pass's). With ``group``
    the frame's cascade rasters are divided across its ranks, the staggered
    update's and, with ``raster_bitmask`` (where the JAX frame shards them),
    every cascade's; each rank ends with the same maps."""
    cascades = shadow_ops.fit_cascades(
        inv_view, p00, p11, scene.sun_direction,
        config.num_shadow_cascades, config.shadow_cascade_resolution,
        config.z_near, config.shadow_max_distance, config.shadow_cascade_split_lambda,
    )
    geometry = dict(
        double_sided=scene.tri_double_sided, proxy=scene.proxy,
        proxy_from_cascade=config.shadow_proxy_from_cascade, corners=scene.tri_corner_pos,
    )
    shadow_maps = packed = None
    if 0 < config.shadow_update_budget < config.num_shadow_cascades:
        res = config.shadow_cascade_resolution
        want = (config.num_shadow_cascades, res, res, 2)
        if tuple(temporal.csm_packed.shape) != want:
            raise ValueError(
                f"TemporalState.csm_packed {tuple(temporal.csm_packed.shape)} != "
                f"{want}: build the state with temporal_state_for(config)"
            )
        packed, matrices = shadow_ops.render_shadow_cascades_staggered(
            scene.positions, scene.tri_indices, scene.tri_valid, cascades, res,
            temporal.csm_packed, temporal.csm_matrices, temporal.frame_index,
            update_budget=config.shadow_update_budget, group=group, **geometry,
        )
        temporal = temporal._replace(csm_packed=packed, csm_matrices=matrices)
        # Each cascade pairs with the matrix its cached map was built with.
        cascades = cascades._replace(matrices=matrices)
    elif group is not None and config.raster_bitmask:
        shadow_maps = shadow_ops.render_shadow_cascades_sharded(
            scene.positions, scene.tri_indices, scene.tri_valid, cascades,
            config.shadow_cascade_resolution, group, **geometry,
        )
    else:
        shadow_maps = shadow_ops.render_shadow_cascades(
            scene.positions, scene.tri_indices, scene.tri_valid, cascades,
            config.shadow_cascade_resolution, **geometry,
        )
    l = -scene.sun_direction / torch.sqrt((scene.sun_direction ** 2).sum())

    def sample(gb, dep):
        ndotl = torch.clamp((gb.normal * l[None, None, :]).sum(dim=-1, keepdim=True), 0.0, 1.0)
        view_distance = torch.where(
            dep > 0.0, z_near / torch.clamp(dep, min=1e-12), torch.zeros_like(dep)
        )
        return shadow_ops.sample_csm(
            gb.world_position, view_distance, ndotl, cascades, shadow_maps,
            params.shadow_bias, normal=gb.normal, packed_taps=packed,
        )

    if config.debug_stub_shadow_sample:
        # The main view's sample only: the VRSAA fine pass samples the maps.
        keep = packed[0, 0, 0, 0].to(torch.float32) if packed is not None else shadow_maps[0, 0, 0]
        shadow = torch.ones_like(depth)[..., None] * (1.0 + 0.0 * keep)
    else:
        shadow = sample(gbuf, depth)
    return shadow, cascades, temporal, sample


def _half_rate(config: RenderConfig, h: int, w: int) -> bool:
    """Screen-space GI and AO shade the [::2, ::2] grid (config.half_rate_gi);
    under VRSAA they already shade the coarse grid."""
    return (config.half_rate_gi and config.aa_mode != AAMode.VRSAA
            and h % 2 == 0 and w % 2 == 0)


def _upsample(signal_h, depth_h, normal_h, depth, normal, group):
    """The joint bilateral 2x upsample of a half-grid signal; a band of a
    sharded frame reads one half-grid row of each neighbour band."""
    if group is None:
        return bilateral_upsample_2x(signal_h, depth_h, normal_h, depth, normal)
    halos = [coll.row_halo(x, 1, group, wrap=False) for x in (signal_h, depth_h, normal_h)]
    return bilateral_upsample_2x(*halos, depth, normal, row_halo=1)


def _ssao(cam_pos, z_near, params, config, gbuf, depth, band):
    """(H, W, 1) AO: the estimator on the half grid, reconstructed by the joint
    bilateral 2x upsample (the JAX frame's SSAO block). A band of a sharded
    frame runs the estimator on its rows with 11 halo rows from each neighbour
    band (SSAO taps reach +-9 rows, the blur +-2), masked by frame rows."""
    h, w = depth.shape
    half = _half_rate(config, h, w)

    def sub(a):
        return a[::2, ::2] if half else a

    d_h, n_h = sub(depth), sub(gbuf.normal)
    grid_div = 2 if half else 1
    full_h = (config.render_height // (2 if config.aa_mode == AAMode.VRSAA else 1)) // grid_div
    fields = dict(world_position=sub(gbuf.world_position), normal=n_h, valid=sub(gbuf.valid),
                  depth=d_h)
    args = dict(radius=params.ssao_radius, bias=params.ssao_bias,
                intensity=params.ssao_intensity, full_height=full_h)
    if band.group is None:
        # One device, or a legacy band (rolled within itself, as in JAX).
        ao = lighting.ssao(gbuf._replace(**fields), cam_pos, z_near, row0=0, **args)
    else:
        halo = 11
        fields = {k: coll.row_halo(v, halo, band.group, wrap=False) for k, v in fields.items()}
        ao = lighting.ssao(gbuf._replace(**fields), cam_pos, z_near,
                           row0=band.row_offset // grid_div - halo, **args)[halo:-halo]
    return _upsample(ao, d_h, n_h, depth, gbuf.normal, band.group) if half else ao


def _lpv(scene, inv_view, cam_pos, params, temporal, config, gbuf, depth, group):
    """(GI (H, W, 3), next temporal state): the LPV volumes rebuilt (one cascade
    round-robin with ``lpv_update_budget``, else all), each cascade's RSM a
    launch of the CUDA rasterizer on the proxy mesh, then the apply on the half
    grid, reconstructed by the joint bilateral 2x upsample and modulated by the
    full-resolution base color. A band of a sharded frame gathers every band's
    surfels, so that each rank builds the same volumes."""
    h, w = depth.shape
    cam_forward = -inv_view[:3, 2]
    # Scene-view depth surfels for the geometry volume (every 8th pixel).
    surfels = (gbuf.world_position[::8, ::8].reshape(-1, 3),
               gbuf.normal[::8, ::8].reshape(-1, 3), gbuf.valid[::8, ::8].reshape(-1))
    if group is not None:
        surfels = tuple(coll.gather_rows(x.contiguous(), group) for x in surfels)
    # The RSMs rasterize the vertex-clustered proxy: their texels are meters wide.
    gi_scene = swap_in_proxy(scene) if config.rsm_proxy else scene
    raster_fn = rasterize
    if config.debug_stub_rsm:
        # As in JAX, m comes from the frame's scene, not the proxy. JAX's gather
        # reads an id past the last plane row as that row, so the stub clamps
        # the ids to the RSM scene's rows itself.
        n_tri, last = scene.tri_indices.shape[0], gi_scene.tri_indices.shape[0] - 1

        def raster_fn(setup, hh, ww):
            d, v = _stub_raster(hh, ww, n_tri, depth.device)
            return d, v.clamp(max=last)
    args = (config.lpv_num_cascades, config.lpv_resolution, config.lpv_cell_size,
            config.lpv_rsm_resolution, config.lpv_num_propagation_steps,
            config.lpv_behind_camera_percent)
    kw = dict(scene_view_surfels=surfels, use_base_textures=config.use_base_textures)
    if 0 < config.lpv_update_budget < config.lpv_num_cascades:
        want = (config.lpv_num_cascades, 3, 4) + (config.lpv_resolution,) * 3
        if tuple(temporal.lpv.radiance.shape) != want:
            raise ValueError(
                f"TemporalState.lpv radiance {tuple(temporal.lpv.radiance.shape)} != {want}: "
                "build the state with temporal_state_for(config)"
            )
        volumes = lpv_ops.update_lpv_staggered(
            gi_scene, cam_pos, cam_forward, raster_fn, temporal.lpv, temporal.frame_index,
            *args, update_budget=config.lpv_update_budget, **kw,
        )
        temporal = temporal._replace(lpv=volumes)
    else:
        volumes = lpv_ops.build_lpv(gi_scene, cam_pos, cam_forward, raster_fn, *args, **kw)
    if config.debug_stub_lpv_apply:
        return gbuf.base_color * (0.1 + 0.0 * volumes.radiance[0, 0, 0, 0, 0, 0]), temporal
    # float32 product, as the reference's parameters are float32 scalars.
    exposure = float(np.float32(params.lpv_exposure) * np.float32(params.sun_exposure))
    if not _half_rate(config, h, w):
        gi = lpv_ops.apply_lpv(volumes, gbuf.world_position, gbuf.normal, gbuf.base_color,
                               gbuf.valid, exposure)
        return gi, temporal
    wp_h, n_h = gbuf.world_position[::2, ::2], gbuf.normal[::2, ::2]
    irr_h = lpv_ops.apply_lpv(volumes, wp_h, n_h, torch.ones_like(wp_h), gbuf.valid[::2, ::2],
                              exposure)
    irr = _upsample(irr_h, depth[::2, ::2], n_h, depth, gbuf.normal, group)
    return irr * gbuf.base_color, temporal


def _probes(scene, cam_pos, params, temporal, config, gbuf, depth, group):
    """(GI (H, W, 3), next temporal state): the budgeted probe update (one
    closest-hit trace and one sun trace for every cascade's probe rays), then
    the probes sampled on the half grid, reconstructed by the joint bilateral
    2x upsample and modulated by the full-resolution base color."""
    h, w = depth.shape
    p = config.probe_grid[0] * config.probe_grid[1] * config.probe_grid[2]
    want = (config.probe_cascades, p, probe_ops.IRR_RES ** 2, 3)
    if tuple(temporal.probes.irradiance.shape) != want:
        raise ValueError(
            f"TemporalState.probes irradiance {tuple(temporal.probes.irradiance.shape)} != "
            f"{want}: build the state with temporal_state_for(config)"
        )
    probes = probe_ops.update_probes(
        temporal.probes, scene.bvh, scene, cam_pos, config.probe_grid, config.probe_spacing,
        config.probe_budget, config.probe_rays, temporal.frame_index, params.sun_exposure,
        masked=config.alpha_masking, use_textures=config.use_base_textures,
        hysteresis=params.probe_hysteresis, spacing_ladder=config.probe_spacing_ladder,
        group=group,
    )
    grid_args = (cam_pos, config.probe_grid, config.probe_spacing)
    ladder = config.probe_spacing_ladder
    if _half_rate(config, h, w):
        n_h = gbuf.normal[::2, ::2]
        irr_h = probe_ops.sample_probes(probes, gbuf.world_position[::2, ::2], n_h,
                                        gbuf.valid[::2, ::2], *grid_args, spacing_ladder=ladder)
        irr = _upsample(irr_h, depth[::2, ::2], n_h, depth, gbuf.normal, group)
    else:
        irr = probe_ops.sample_probes(probes, gbuf.world_position, gbuf.normal, gbuf.valid,
                                      *grid_args, spacing_ladder=ladder)
    return irr * gbuf.base_color, temporal._replace(probes=probes)


def _rtgi(scene, view, params, temporal, config, gbuf, depth, band):
    """(GI (H, W, 3), next temporal state): per-pixel RTGI (gi/rtgi.cpp:69-139;
    bounce count r.GI.RT.Bounces), the a-trous reconstruction of the 1-spp
    signal (the rtgi overlay filter), then the reprojected accumulation of the
    pre-albedo irradiance (the vendor-denoiser slot), modulated by base color.
    Under VRSAA the frame shades the coarse grid and the accumulation is skipped,
    as in the JAX frame: the render-sized history is never read. A band of a
    sharded frame filters its own rows (the a-trous rolls stay in the band, as
    in the JAX frame) and reprojects into the gathered full-frame history."""
    h, w = depth.shape
    accumulate = config.aa_mode != AAMode.VRSAA
    if accumulate and tuple(temporal.rtgi_history.shape) != (h, w, 3):
        raise ValueError(
            f"TemporalState.rtgi_history {tuple(temporal.rtgi_history.shape)} != {(h, w, 3)}: "
            "build the state with temporal_state_for(config)"
        )
    dev = depth.device
    irr = rt_effects.rtgi(
        scene.bvh, scene, gbuf.world_position, gbuf.normal, gbuf.valid, temporal.frame_index,
        params.rtgi_exposure, params.sun_exposure, num_bounces=config.rtgi_num_bounces,
        masked=config.alpha_masking, use_textures=config.use_base_textures,
        row_offset=band.row_offset,
    )
    irr = atrous_filter(irr, depth, gbuf.normal, gbuf.valid, sigma_z=params.atrous_sigma_z,
                        sigma_n=params.atrous_sigma_n)
    if not accumulate:
        return irr * gbuf.base_color, temporal
    mv = taa_ops.motion_vectors(gbuf.world_position, gbuf.valid, _f32(view.last_view_proj, dev),
                                _f32(view.unjittered_view_proj, dev))
    history, halo = temporal.rtgi_history, None
    if band.group is not None:
        history = coll.gather_rows(history, band.group)
        halo = coll.row_halo(irr, 1, band.group, wrap=False)
    irr, history = temporal_accumulate(irr, history, temporal.rtgi_valid, mv,
                                       row_offset=band.row_offset, signal_halo=halo)
    valid = torch.ones((), dtype=torch.bool, device=dev)
    return irr * gbuf.base_color, temporal._replace(rtgi_history=history, rtgi_valid=valid)


def _vrsaa_fine_pass(scene, cam_pos, params, config, setup, attr_planes, flags, vis_ss,
                     depth_ss, lit, csm_sample, shadow, gi, ao, sky_img, row_offset_ss):
    """(resolved lit (H, W, 3), dropped () i32): the quads with an id or depth
    edge among their 4 samples, or a luminance contrast with a neighbour, enter
    the worklist up to the budget; their 3 other samples are resolved and
    lit (CSM sampled at each sample; RT shadows, GI, AO and sky fetched from
    the quad's coarse value, as coarse-rate VRS does for them) and averaged with
    the coarse shade."""
    h, w = lit.shape[:2]
    fine = vrsaa_ops.detect_fine_quads(vis_ss, depth_ss) | vrsaa_ops.luminance_contrast(lit)
    budget = max(1, int(config.vrsaa_budget * h * w))
    qy, qx, live, dropped = vrsaa_ops.fine_worklist(fine, budget)
    offs = ((0, 1), (1, 0), (1, 1))
    pys = torch.stack([qy * 2 + dy for dy, _ in offs], dim=1)  # (B, 3)
    pxs = torch.stack([qx * 2 + dx for _, dx in offs], dim=1)
    flat_idx = pys * (2 * w) + pxs
    vis_f = vis_ss.reshape(-1)[flat_idx]
    depth_f = depth_ss.reshape(-1)[flat_idx]
    gbuf_f = resolve_gbuffer(scene, setup, vis_f, depth_f, attr_planes=attr_planes,
                             pixel_coords=(pxs.to(torch.float32),
                                           pys.to(torch.float32) + row_offset_ss),
                             **flags)
    quad = torch.clamp(qy * w + qx, max=h * w - 1)

    def quad_fetch(img):  # coarse (h, w, C) values at the quads -> (B, 1, C)
        return img.reshape(h * w, -1)[quad][:, None, :]

    if csm_sample is not None:
        shadow_f = csm_sample(gbuf_f, depth_f)
    elif shadow is not None:
        shadow_f = quad_fetch(shadow)
    else:
        shadow_f = None
    direct_f = lighting.sun_lighting(
        gbuf_f, cam_pos, scene.sun_direction, scene.sun_color, shadow_f, params.sun_exposure,
    )
    lit_f = lighting.compose_lit_scene(
        gbuf_f, direct_f, gi=quad_fetch(gi) if gi is not None else None,
        ao=quad_fetch(ao) if ao is not None else None, sky=quad_fetch(sky_img),
    )
    return vrsaa_ops.resolve_quads(lit, lit_f, qy, qx, live), dropped


def _taa(view, temporal, config, gbuf, lit, band):
    """(resolved lit at output resolution, motion, next temporal state): TAAU
    when the frame renders below its output resolution, else TAA. A band of a
    sharded frame reprojects into the gathered full history; TAAU gathers lit
    and motion, resolves the whole frame (a band-local resample would not be
    the full-frame one) and keeps its output band; TAA reads one neighbour row
    of each band for its clamp."""
    dev = lit.device
    oh, ow = config.output_height, config.output_width
    n_bands = config.render_height // band.height
    want = (oh // n_bands, ow, 3)
    if tuple(temporal.taa_history.shape) != want:
        raise ValueError(
            f"TemporalState.taa_history {tuple(temporal.taa_history.shape)} != {want}: "
            "build the state with temporal_state_for(config) (and shard_temporal for bands)"
        )
    mv = taa_ops.motion_vectors(gbuf.world_position, gbuf.valid, _f32(view.last_view_proj, dev),
                                _f32(view.unjittered_view_proj, dev))
    history, group = temporal.taa_history, band.group
    upscaling = (config.render_height, config.render_width) != (oh, ow)
    if group is not None:
        history = coll.gather_rows(history, group)
        if upscaling:
            lit_f, mv_f = coll.gather_rows(lit, group), coll.gather_rows(mv, group)
        else:
            lit_halo = coll.row_halo(lit, 1, group, wrap=False)
    if upscaling:
        if group is None:
            lit_f, mv_f = lit, mv
        lit, history = taa_ops.taau_resolve(lit_f, history, temporal.taa_valid, mv_f,
                                            view.jitter, oh, ow, pack8=config.taa_pack8)
        if group is not None:
            ob = oh // n_bands
            r0 = coll.band_index(group)[0] * ob
            lit, history = lit[r0:r0 + ob], history[r0:r0 + ob]
    else:
        lit, history = taa_ops.taa_resolve(
            lit, history, temporal.taa_valid, mv, pack8=config.taa_pack8,
            row_offset=band.row_offset, current_halo=None if group is None else lit_halo,
        )
    valid = torch.ones((), dtype=torch.bool, device=dev)
    return lit, mv, temporal._replace(taa_history=history, taa_valid=valid)


@torch.no_grad()
def render_frame(
    scene: SceneArrays,
    view: ViewData,
    params: RenderParams,
    temporal: TemporalState,
    config: RenderConfig,
    band_height: int | None = None,
    row_offset: int = 0,
    group=None,
):
    """Render one frame: (FrameOutputs, next TemporalState).

    ``band_height``/``row_offset`` render a horizontal band of the screen (the
    module docstring's band modes); ``group`` is the process group whose ranks
    render the other bands (parallel/mesh.py), or None. Each stage runs inside
    a ``torch.profiler.record_function`` range named ``frame/<stage>``, so a
    profile of the frame sums device time by stage."""
    vrsaa = config.aa_mode == AAMode.VRSAA
    if vrsaa:
        _check_vrsaa(config)
    dev = scene.positions.device
    h, w = band_height or config.render_height, config.render_width
    band = Band(h, int(row_offset), config.render_height, group)
    # Band rendering without collectives is the legacy raster + shade path.
    full = band_height is None or group is not None
    if full:
        _require_bvh(scene, config)
    inv_view = _f32(view.inverse_view, dev)
    cam_pos = _f32(view.position, dev)
    z_near = float(view.z_near)
    p00 = float(view.projection[0, 0])
    p11 = float(view.projection[1, 1])

    with record_function("frame/cull_setup"):
        setup, setup_opaque, alpha_grid = main_view_setup(scene, view, config)
    if config.debug_stub_raster:
        # No raster and no occlusion test: the visibility list stays as it was.
        with record_function("frame/raster"):
            depth, vis = _stub_raster(h, w, scene.tri_indices.shape[0], dev)
    elif config.occlusion_culling and full:
        with record_function("frame/occlusion"):
            depth, vis, temporal = _occlusion_raster(
                scene, view, config, setup_opaque, alpha_grid, temporal, band
            )
    else:
        with record_function("frame/raster"):
            depth, vis = rasterize(setup_opaque, h, w, alpha_grid=alpha_grid,
                                   row_offset=band.row_offset)
    if _exact_alpha(config):
        with record_function("frame/alpha_peel"):
            setup_m = setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 1))
            depth, vis = rasterize_masked_peeled(
                scene, setup_m, depth, vis, layers=config.alpha_peel_layers,
                row_offset=band.row_offset,
            )
    flags = dict(
        use_base_textures=config.use_base_textures,
        use_normal_maps=config.use_normal_maps,
        use_mr_textures=config.use_mr_textures,
        use_emission=config.use_emission,
    )
    row_offset_ss = band.row_offset
    with record_function("frame/resolve"):
        if vrsaa:
            # Every stage from here shades the coarse grid: the quads' top-left
            # samples, at their supersampled pixel coordinates.
            vis_ss, depth_ss = vis, depth
            h, w = h // 2, w // 2
            band = Band(h, row_offset_ss // 2, config.render_height // 2, group)
            vis = vis_ss[::2, ::2].contiguous()
            depth = depth_ss[::2, ::2].contiguous()
            attr_planes = pack_attribute_planes(scene, setup)
            px = (torch.arange(w, dtype=torch.float32, device=dev) * 2.0)[None, :].expand(h, w)
            py = (torch.arange(h, dtype=torch.float32, device=dev) * 2.0)[:, None] + row_offset_ss
            gbuf = resolve_gbuffer(scene, setup, vis, depth, attr_planes=attr_planes,
                                   pixel_coords=(px, py.expand(h, w)), **flags)
        elif config.debug_stub_resolve:
            gbuf = _stub_gbuffer(vis, depth)
        else:
            gbuf = resolve_gbuffer(scene, setup, vis, depth, row_offset=band.row_offset,
                                   debug_gather_only=config.debug_resolve_gather_only, **flags)
    with record_function("frame/sky"):
        if config.sky:
            sky_img = sky.sky_background(
                inv_view, p00, p11, scene.sun_direction, scene.sun_color, h, w,
                exposure=params.sun_exposure, row_offset=band.row_offset,
                full_height=band.full_height,
            )
        else:
            sky_img = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    cascades = shadow = csm_sample = None
    if config.shadow_mode == ShadowMode.CSM:
        with record_function("frame/csm"):
            shadow, cascades, temporal, csm_sample = _shadows(
                scene, inv_view, p00, p11, z_near, params, temporal, config, gbuf, depth, group,
            )
    elif config.shadow_mode == ShadowMode.RT and full:
        # Ray-traced sun shadows (directional_light.cpp:372-422).
        with record_function("frame/rt_shadows"):
            shadow = rt_effects.rt_sun_shadows(
                scene.bvh, gbuf.world_position, gbuf.normal, gbuf.valid, scene.sun_direction,
                scene.sun_angular_size, temporal.frame_index, scene=scene,
                masked=config.alpha_masking, row_offset=band.row_offset,
            )
    ao = gi = motion = None
    if config.ao_mode == AOMode.RT and full:
        with record_function("frame/rtao"):
            ao = rt_effects.rtao(
                scene.bvh, gbuf.world_position, gbuf.normal, gbuf.valid,
                config.rtao_num_samples, params.rtao_max_distance, temporal.frame_index,
                scene=scene, masked=config.alpha_masking, row_offset=band.row_offset,
            )
    elif config.ao_mode == AOMode.SSAO:
        with record_function("frame/ssao"):
            ao = _ssao(cam_pos, z_near, params, config, gbuf, depth, band)
    if config.gi_mode == GIMode.LPV and full:
        with record_function("frame/lpv"):
            gi, temporal = _lpv(scene, inv_view, cam_pos, params, temporal, config, gbuf, depth,
                                group)
    elif config.gi_mode == GIMode.PROBES and full:
        # DDGI-style budgeted probe cache (irradiance_cache.cpp:496-724).
        with record_function("frame/probes"):
            gi, temporal = _probes(scene, cam_pos, params, temporal, config, gbuf, depth, group)
    elif config.gi_mode == GIMode.RT and full:
        with record_function("frame/rtgi"):
            gi, temporal = _rtgi(scene, view, params, temporal, config, gbuf, depth, band)
    with record_function("frame/shade"):
        direct = lighting.sun_lighting(
            gbuf, cam_pos, scene.sun_direction, scene.sun_color, shadow, params.sun_exposure,
        )
        lit = lighting.compose_lit_scene(gbuf, direct, gi=gi, ao=ao, sky=sky_img)
    if config.translucency:
        with record_function("frame/translucency"):
            lit = _translucency(scene, view, params, config, setup, depth, lit, flags,
                                band.row_offset)
    vrsaa_dropped = None
    if vrsaa:
        with record_function("frame/vrsaa"):
            lit, vrsaa_dropped = _vrsaa_fine_pass(
                scene, cam_pos, params, config, setup, attr_planes, flags, vis_ss, depth_ss,
                lit, csm_sample, shadow, gi, ao, sky_img, row_offset_ss,
            )
    if config.aa_mode == AAMode.TAA and full:
        with record_function("frame/taa"):
            lit, motion, temporal = _taa(view, temporal, config, gbuf, lit, band)
    with record_function("frame/post"):
        if band_height is not None and group is None:
            # Legacy band path: the render-resolution band, no cross-band post.
            image = post.to_uint8(post.composite(lit, None, params.bloom_strength))
        else:
            # Cross-band post: upscale and bloom read far outside a band, so a
            # band gathers the lit scene, runs them replicated and keeps its
            # output rows.
            lit_full = lit if group is None else coll.gather_rows(lit, group)
            display = taa_ops.upscale_bilinear(lit_full, config.output_height, config.output_width)
            bloom_tex = (
                bloom_ops.bloom_chain(display, config.bloom_num_mips) if config.bloom else None
            )
            image = post.to_uint8(post.composite(display, bloom_tex, params.bloom_strength))
            if group is not None:
                rank, n = coll.band_index(group)
                ob = config.output_height // n
                image = image[rank * ob:(rank + 1) * ob]

    next_temporal = temporal._replace(frame_index=temporal.frame_index + 1)
    outputs = FrameOutputs(
        image=image, hdr=lit, depth=depth, visibility=vis, gbuffer=gbuf, csm=cascades,
        motion=motion, vrsaa_dropped=vrsaa_dropped,
    )
    return outputs, next_temporal


def make_renderer(config: RenderConfig):
    """The frame callable ``(scene, view, params, temporal) -> (FrameOutputs,
    TemporalState)`` with ``config`` bound, as bench.py uses the JAX one
    (parallel/mesh.py::make_sharded_renderer is its band-sharded twin)."""
    return partial(render_frame, config=config)
