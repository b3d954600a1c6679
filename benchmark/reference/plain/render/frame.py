# Frozen copy of androidrenderer_tpu_torch/render/frame.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed, and only the paths of the
# benchmark's frames kept: one device, no band, no VRSAA, exact alpha peel, 8-byte TAA
# history or profiling switches. The SSAO, LPV and TAA stages are those of commit
# dfc74ed377a9, where this file is as at c15a27329e0a, on one device.
"""The frame function — SceneRenderer::render() on one device.

Phase sequence (the JAX package's render/frame.py, single device), as the
benchmark's frames run it:

    frustum cull -> corner-table triangle setup -> raster with the alpha
    bitmaps [or two-phase HiZ occlusion: raster last frame's visible
    primitives, build the HiZ pyramid, re-test every sphere, raster the newly
    visible, merge] -> gbuffer resolve -> sky -> [staggered CSM + packed 2x2
    PCF, or RT sun shadows: one jittered any-hit ray per pixel] -> [half-rate
    SSAO + joint-bilateral 2x upsample, or RTAO: rtao_num_samples any-hit rays
    per pixel] -> [LPV GI: staggered cascade rebuild (RSM on the proxy through
    the plain raster -> VPLs -> SH inject -> propagate), half-rate apply +
    upsample; or probe GI: the budgeted probe update (one closest-hit and one
    sun trace for every cascade's probe rays), half-rate sampling + upsample;
    or RTGI: one cosine ray per pixel and a sun ray per hit per bounce, a-trous
    filter, temporal accumulation] -> sun BRDF + GI * AO -> [translucency:
    peeled BLEND layers, back-to-front composite] -> [TAA, or TAAU to the
    output resolution] -> bloom -> Reinhard -> u8
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.reference.plain.camera import ViewData
from benchmark.reference.plain.config import (
    AAMode, AOMode, GIMode, RenderConfig, RenderParams, ShadowMode,
)
from benchmark.reference.plain.ops import bloom as bloom_ops
from benchmark.reference.plain.ops import culling, lighting, post, sky
from benchmark.reference.plain.ops import lpv as lpv_ops
from benchmark.reference.plain.ops import probes as probe_ops
from benchmark.reference.plain.ops import shadow as shadow_ops
from benchmark.reference.plain.ops import taa as taa_ops
from benchmark.reference.plain.ops.denoise import atrous_filter, temporal_accumulate
from benchmark.reference.plain.ops.gbuffer import GBuffer, resolve_gbuffer
from benchmark.reference.plain.ops.raster import rasterize, triangle_setup_corners
from benchmark.reference.plain.ops.raster.masked import _sample_alpha, pack_alpha_planes
from benchmark.reference.plain.ops.rt import effects as rt_effects
from benchmark.reference.plain.ops.upsample import bilateral_upsample_2x
from benchmark.reference.plain.render.temporal import TemporalState
from benchmark.reference.plain.scene.proxy import swap_in_proxy
from benchmark.reference.plain.scene.scene import SceneArrays


class FrameOutputs(NamedTuple):
    image: torch.Tensor  # (H, W, 3) u8 display-ready
    hdr: torch.Tensor  # (OH, OW, 3) f32 lit scene (pre-tonemap; output res after TAAU)
    depth: torch.Tensor  # (H, W) f32
    visibility: torch.Tensor  # (H, W) i32
    gbuffer: GBuffer
    # CSM cascade data the frame sampled with (None when shadows are off).
    csm: object = None


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
    triangle-grain frustum cull and the corner-table setup. Masked triangles
    rasterize in the opaque pass against their alpha bitmaps; BLEND triangles
    never draw in it (render_scene.cpp:57-69)."""
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
    if config.alpha_masking and not config.alpha_bitmap:
        raise ValueError("the reference has no exact alpha peel: keep alpha_bitmap on")
    setup_opaque = setup._replace(valid=setup.valid & ~(scene.tri_alpha_mode == 2))
    alpha_grid = scene.tri_alpha_grid if config.alpha_masking and config.alpha_bitmap else None
    return setup, setup_opaque, alpha_grid


def _occlusion_raster(scene, view, config, setup_opaque, alpha_grid, temporal):
    """Two-phase HiZ occlusion culling (depth_culling_phase.cpp:182-241): raster
    last frame's visible primitives, build the HiZ pyramid from that depth,
    re-test every primitive's sphere, raster the newly visible and merge by
    reversed-Z max (exact). Returns (depth, vis, next temporal state)."""
    dev = scene.positions.device
    h, w = config.render_height, config.render_width
    view_m = _f32(view.view, dev)
    prim_mask = culling.frustum_cull_spheres(
        scene.prim_bounds, view_m, _f32(view.frustum, dev), float(view.z_near),
    ) & scene.prim_valid
    np_ = scene.prim_bounds.shape[0]
    phase1 = prim_mask & temporal.prev_visible_prims[:np_]
    tri_p1 = culling.primitive_mask_to_triangle_mask(phase1, scene.tri_primitive, scene.tri_valid)
    depth, vis = rasterize(
        setup_opaque._replace(valid=setup_opaque.valid & tri_p1), h, w, alpha_grid=alpha_grid,
    )
    n_levels = config.hiz_levels
    while n_levels > 1 and (h % (1 << (n_levels - 1)) or w % (1 << (n_levels - 1))):
        n_levels -= 1
    hiz = culling.build_hiz_pyramid(depth, n_levels)
    not_occluded = culling.occlusion_cull_spheres(
        scene.prim_bounds, view_m, float(view.z_near),
        float(view.projection[0, 0]), float(view.projection[1, 1]), hiz,
    )
    visible_now = prim_mask & not_occluded
    tri_new = culling.primitive_mask_to_triangle_mask(
        visible_now & ~phase1, scene.tri_primitive, scene.tri_valid
    )
    d2, v2 = rasterize(
        setup_opaque._replace(valid=setup_opaque.valid & tri_new), h, w, alpha_grid=alpha_grid,
    )
    vis = torch.where(d2 > depth, v2, vis)
    depth = torch.maximum(depth, d2)
    prev = temporal.prev_visible_prims.clone()
    prev[:np_] = visible_now
    return depth, vis, temporal._replace(prev_visible_prims=prev)


def _translucency(scene, view, params, config, setup, depth, lit, flags):
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
        d_t, v_t = rasterize(setup_b, h, w, z_limit=None if i == 0 else z_lim)
        gb_t = resolve_gbuffer(scene, setup_b, v_t, d_t, **flags)
        alpha_t, _ = _sample_alpha(scene, setup_b, v_t, alpha_planes=aplanes)
        color_t = lighting.sun_lighting(
            gb_t, view_pos, scene.sun_direction, scene.sun_color, None, params.sun_exposure,
        ) + gb_t.emission
        layers.append((d_t, color_t, alpha_t[..., None], gb_t.valid))
        z_lim = torch.where(v_t >= 0, d_t, z_lim)
    for d_t, color_t, alpha_t, ok_t in reversed(layers):
        front = (ok_t & (d_t > depth))[..., None]
        lit = torch.where(front, lit * (1.0 - alpha_t) + color_t * alpha_t, lit)
    return lit


def _shadows(scene, inv_view, p00, p11, z_near, params, temporal, config, gbuf, depth):
    """The staggered cascade update + packed PCF: (shadow (H, W, 1), cascades
    as sampled, next temporal state)."""
    if not 0 < config.shadow_update_budget < config.num_shadow_cascades:
        raise ValueError("the reference renders the staggered cascades only: "
                         "0 < shadow_update_budget < num_shadow_cascades")
    cascades = shadow_ops.fit_cascades(
        inv_view, p00, p11, scene.sun_direction,
        config.num_shadow_cascades, config.shadow_cascade_resolution,
        config.z_near, config.shadow_max_distance, config.shadow_cascade_split_lambda,
    )
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
        update_budget=config.shadow_update_budget,
        double_sided=scene.tri_double_sided, proxy=scene.proxy,
        proxy_from_cascade=config.shadow_proxy_from_cascade, corners=scene.tri_corner_pos,
    )
    temporal = temporal._replace(csm_packed=packed, csm_matrices=matrices)
    # Each cascade pairs with the matrix its cached map was built with.
    cascades = cascades._replace(matrices=matrices)
    l = -scene.sun_direction / torch.sqrt((scene.sun_direction ** 2).sum())
    ndotl = torch.clamp((gbuf.normal * l[None, None, :]).sum(dim=-1, keepdim=True), 0.0, 1.0)
    view_distance = torch.where(
        depth > 0.0, z_near / torch.clamp(depth, min=1e-12), torch.zeros_like(depth)
    )
    shadow = shadow_ops.sample_csm(
        gbuf.world_position, view_distance, ndotl, cascades, None,
        params.shadow_bias, normal=gbuf.normal, packed_taps=packed,
    )
    return shadow, cascades, temporal


def _half_rate(config: RenderConfig, h: int, w: int) -> bool:
    """Screen-space GI shades the [::2, ::2] grid (config.half_rate_gi)."""
    return config.half_rate_gi and h % 2 == 0 and w % 2 == 0


def _ssao(cam_pos, z_near, params, config, gbuf, depth):
    """(H, W, 1) AO: the estimator on the half grid, reconstructed by the joint
    bilateral 2x upsample (the JAX frame's SSAO block)."""
    h, w = depth.shape
    half = _half_rate(config, h, w)

    def sub(a):
        return a[::2, ::2] if half else a

    d_h, n_h = sub(depth), sub(gbuf.normal)
    fields = dict(world_position=sub(gbuf.world_position), normal=n_h, valid=sub(gbuf.valid),
                  depth=d_h)
    ao = lighting.ssao(gbuf._replace(**fields), cam_pos, z_near, radius=params.ssao_radius,
                       bias=params.ssao_bias, intensity=params.ssao_intensity)
    return bilateral_upsample_2x(ao, d_h, n_h, depth, gbuf.normal) if half else ao


def _lpv(scene, inv_view, cam_pos, params, temporal, config, gbuf, depth):
    """(GI (H, W, 3), next temporal state): the LPV volumes rebuilt (one cascade
    round-robin with ``lpv_update_budget``, else all), each cascade's RSM a
    plain raster of the proxy mesh, then the apply on the half grid,
    reconstructed by the joint bilateral 2x upsample and modulated by the
    full-resolution base color."""
    h, w = depth.shape
    cam_forward = -inv_view[:3, 2]
    # Scene-view depth surfels for the geometry volume (every 8th pixel).
    surfels = (gbuf.world_position[::8, ::8].reshape(-1, 3),
               gbuf.normal[::8, ::8].reshape(-1, 3), gbuf.valid[::8, ::8].reshape(-1))
    # The RSMs rasterize the vertex-clustered proxy: their texels are meters wide.
    gi_scene = swap_in_proxy(scene) if config.rsm_proxy else scene
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
            gi_scene, cam_pos, cam_forward, rasterize, temporal.lpv, temporal.frame_index,
            *args, update_budget=config.lpv_update_budget, **kw,
        )
        temporal = temporal._replace(lpv=volumes)
    else:
        volumes = lpv_ops.build_lpv(gi_scene, cam_pos, cam_forward, rasterize, *args, **kw)
    # float32 product, as the reference's parameters are float32 scalars.
    exposure = float(np.float32(params.lpv_exposure) * np.float32(params.sun_exposure))
    if not _half_rate(config, h, w):
        gi = lpv_ops.apply_lpv(volumes, gbuf.world_position, gbuf.normal, gbuf.base_color,
                               gbuf.valid, exposure)
        return gi, temporal
    wp_h, n_h = gbuf.world_position[::2, ::2], gbuf.normal[::2, ::2]
    irr_h = lpv_ops.apply_lpv(volumes, wp_h, n_h, torch.ones_like(wp_h), gbuf.valid[::2, ::2],
                              exposure)
    irr = bilateral_upsample_2x(irr_h, depth[::2, ::2], n_h, depth, gbuf.normal)
    return irr * gbuf.base_color, temporal


def _probes(scene, cam_pos, params, temporal, config, gbuf, depth):
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
    )
    grid_args = (cam_pos, config.probe_grid, config.probe_spacing)
    ladder = config.probe_spacing_ladder
    if _half_rate(config, h, w):
        n_h = gbuf.normal[::2, ::2]
        irr_h = probe_ops.sample_probes(probes, gbuf.world_position[::2, ::2], n_h,
                                        gbuf.valid[::2, ::2], *grid_args, spacing_ladder=ladder)
        irr = bilateral_upsample_2x(irr_h, depth[::2, ::2], n_h, depth, gbuf.normal)
    else:
        irr = probe_ops.sample_probes(probes, gbuf.world_position, gbuf.normal, gbuf.valid,
                                      *grid_args, spacing_ladder=ladder)
    return irr * gbuf.base_color, temporal._replace(probes=probes)


def _rtgi(scene, view, params, temporal, config, gbuf, depth):
    """(GI (H, W, 3), next temporal state): per-pixel RTGI (gi/rtgi.cpp:69-139;
    bounce count r.GI.RT.Bounces), the a-trous reconstruction of the 1-spp
    signal (the rtgi overlay filter), then the reprojected accumulation of the
    pre-albedo irradiance (the vendor-denoiser slot), modulated by base color."""
    h, w = depth.shape
    if tuple(temporal.rtgi_history.shape) != (h, w, 3):
        raise ValueError(
            f"TemporalState.rtgi_history {tuple(temporal.rtgi_history.shape)} != {(h, w, 3)}: "
            "build the state with temporal_state_for(config)"
        )
    dev = depth.device
    irr = rt_effects.rtgi(
        scene.bvh, scene, gbuf.world_position, gbuf.normal, gbuf.valid, temporal.frame_index,
        params.rtgi_exposure, params.sun_exposure, num_bounces=config.rtgi_num_bounces,
        masked=config.alpha_masking, use_textures=config.use_base_textures,
    )
    irr = atrous_filter(irr, depth, gbuf.normal, gbuf.valid, sigma_z=params.atrous_sigma_z,
                        sigma_n=params.atrous_sigma_n)
    mv = taa_ops.motion_vectors(gbuf.world_position, gbuf.valid, _f32(view.last_view_proj, dev),
                                _f32(view.unjittered_view_proj, dev))
    irr, history = temporal_accumulate(irr, temporal.rtgi_history, temporal.rtgi_valid, mv)
    valid = torch.ones((), dtype=torch.bool, device=dev)
    return irr * gbuf.base_color, temporal._replace(rtgi_history=history, rtgi_valid=valid)


def _taa(view, temporal, config, gbuf, lit):
    """(resolved lit at output resolution, next temporal state): TAAU when the
    frame renders below its output resolution, else TAA."""
    dev = lit.device
    oh, ow = config.output_height, config.output_width
    if tuple(temporal.taa_history.shape) != (oh, ow, 3):
        raise ValueError(
            f"TemporalState.taa_history {tuple(temporal.taa_history.shape)} != {(oh, ow, 3)}: "
            "build the state with temporal_state_for(config)"
        )
    mv = taa_ops.motion_vectors(gbuf.world_position, gbuf.valid, _f32(view.last_view_proj, dev),
                                _f32(view.unjittered_view_proj, dev))
    if (config.render_height, config.render_width) != (oh, ow):
        lit, history = taa_ops.taau_resolve(lit, temporal.taa_history, temporal.taa_valid, mv,
                                            view.jitter, oh, ow)
    else:
        lit, history = taa_ops.taa_resolve(lit, temporal.taa_history, temporal.taa_valid, mv)
    valid = torch.ones((), dtype=torch.bool, device=dev)
    return lit, temporal._replace(taa_history=history, taa_valid=valid)


def _check_config(config: RenderConfig) -> None:
    """Raise ValueError for a switch whose path the reference does not carry."""
    off = {"aa_mode=VRSAA": config.aa_mode == AAMode.VRSAA, "taa_pack8": config.taa_pack8}
    off.update({name: True for name in ("debug_stub_raster", "debug_stub_resolve",
                                         "debug_stub_shadow_sample", "debug_resolve_gather_only",
                                         "debug_stub_rsm", "debug_stub_lpv_apply")
                if getattr(config, name)})
    bad = [name for name, on in off.items() if on]
    if bad:
        raise ValueError(f"the reference renders the benchmark's frames only, not {bad}")


@torch.no_grad()
def render_frame(
    scene: SceneArrays,
    view: ViewData,
    params: RenderParams,
    temporal: TemporalState,
    config: RenderConfig,
):
    """Render one frame: (FrameOutputs, next TemporalState). Each stage runs
    inside a ``torch.profiler.record_function`` range named ``frame/<stage>``."""
    _check_config(config)
    dev = scene.positions.device
    h, w = config.render_height, config.render_width
    _require_bvh(scene, config)
    inv_view = _f32(view.inverse_view, dev)
    cam_pos = _f32(view.position, dev)
    z_near = float(view.z_near)
    p00 = float(view.projection[0, 0])
    p11 = float(view.projection[1, 1])

    with record_function("frame/cull_setup"):
        setup, setup_opaque, alpha_grid = main_view_setup(scene, view, config)
    if config.occlusion_culling:
        with record_function("frame/occlusion"):
            depth, vis, temporal = _occlusion_raster(
                scene, view, config, setup_opaque, alpha_grid, temporal
            )
    else:
        with record_function("frame/raster"):
            depth, vis = rasterize(setup_opaque, h, w, alpha_grid=alpha_grid)
    flags = dict(
        use_base_textures=config.use_base_textures,
        use_normal_maps=config.use_normal_maps,
        use_mr_textures=config.use_mr_textures,
        use_emission=config.use_emission,
    )
    with record_function("frame/resolve"):
        gbuf = resolve_gbuffer(scene, setup, vis, depth, **flags)
    with record_function("frame/sky"):
        if config.sky:
            sky_img = sky.sky_background(
                inv_view, p00, p11, scene.sun_direction, scene.sun_color, h, w,
                exposure=params.sun_exposure,
            )
        else:
            sky_img = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    cascades = shadow = None
    if config.shadow_mode == ShadowMode.CSM:
        with record_function("frame/csm"):
            shadow, cascades, temporal = _shadows(
                scene, inv_view, p00, p11, z_near, params, temporal, config, gbuf, depth,
            )
    elif config.shadow_mode == ShadowMode.RT:
        # Ray-traced sun shadows (directional_light.cpp:372-422).
        with record_function("frame/rt_shadows"):
            shadow = rt_effects.rt_sun_shadows(
                scene.bvh, gbuf.world_position, gbuf.normal, gbuf.valid, scene.sun_direction,
                scene.sun_angular_size, temporal.frame_index, scene=scene,
                masked=config.alpha_masking,
            )
    ao = gi = None
    if config.ao_mode == AOMode.RT:
        with record_function("frame/rtao"):
            ao = rt_effects.rtao(
                scene.bvh, gbuf.world_position, gbuf.normal, gbuf.valid,
                config.rtao_num_samples, params.rtao_max_distance, temporal.frame_index,
                scene=scene, masked=config.alpha_masking,
            )
    elif config.ao_mode == AOMode.SSAO:
        with record_function("frame/ssao"):
            ao = _ssao(cam_pos, z_near, params, config, gbuf, depth)
    if config.gi_mode == GIMode.LPV:
        with record_function("frame/lpv"):
            gi, temporal = _lpv(scene, inv_view, cam_pos, params, temporal, config, gbuf, depth)
    elif config.gi_mode == GIMode.PROBES:
        # DDGI-style budgeted probe cache (irradiance_cache.cpp:496-724).
        with record_function("frame/probes"):
            gi, temporal = _probes(scene, cam_pos, params, temporal, config, gbuf, depth)
    elif config.gi_mode == GIMode.RT:
        with record_function("frame/rtgi"):
            gi, temporal = _rtgi(scene, view, params, temporal, config, gbuf, depth)
    with record_function("frame/shade"):
        direct = lighting.sun_lighting(
            gbuf, cam_pos, scene.sun_direction, scene.sun_color, shadow, params.sun_exposure,
        )
        lit = lighting.compose_lit_scene(gbuf, direct, gi=gi, ao=ao, sky=sky_img)
    if config.translucency:
        with record_function("frame/translucency"):
            lit = _translucency(scene, view, params, config, setup, depth, lit, flags)
    if config.aa_mode == AAMode.TAA:
        with record_function("frame/taa"):
            lit, temporal = _taa(view, temporal, config, gbuf, lit)
    with record_function("frame/post"):
        display = taa_ops.upscale_bilinear(lit, config.output_height, config.output_width)
        bloom_tex = bloom_ops.bloom_chain(display, config.bloom_num_mips) if config.bloom else None
        image = post.to_uint8(post.composite(display, bloom_tex, params.bloom_strength))

    next_temporal = temporal._replace(frame_index=temporal.frame_index + 1)
    outputs = FrameOutputs(
        image=image, hdr=lit, depth=depth, visibility=vis, gbuffer=gbuf, csm=cascades,
    )
    return outputs, next_temporal


def make_renderer(config: RenderConfig):
    """The frame callable ``(scene, view, params, temporal) -> (FrameOutputs,
    TemporalState)`` with ``config`` bound, as bench.py uses the JAX one."""
    return partial(render_frame, config=config)
