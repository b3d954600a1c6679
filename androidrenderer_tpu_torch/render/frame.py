"""The frame function — the raster-only slice of SceneRenderer::render().

Phase sequence (the JAX package's render/frame.py, raster-only branch):

    frustum cull -> corner-table triangle setup -> CUDA raster with in-kernel
    alpha test -> gbuffer resolve -> sky -> staggered CSM + packed 2x2 PCF ->
    sun BRDF -> bloom -> Reinhard -> u8

Every tensor of the frame stays on the scene's device. Switches the port does
not carry yet raise NotImplementedError naming their item in ROADMAP.md's port
queue.
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
from androidrenderer_tpu_torch.ops import shadow as shadow_ops
from androidrenderer_tpu_torch.ops.gbuffer import GBuffer, resolve_gbuffer
from androidrenderer_tpu_torch.ops.raster import rasterize, triangle_setup_corners
from androidrenderer_tpu_torch.ops.taa import upscale_bilinear
from androidrenderer_tpu_torch.render.temporal import TemporalState
from androidrenderer_tpu_torch.scene.scene import SceneArrays


class FrameOutputs(NamedTuple):
    image: torch.Tensor  # (H, W, 3) u8 display-ready
    hdr: torch.Tensor  # (H, W, 3) f32 lit scene (pre-tonemap)
    depth: torch.Tensor  # (H, W) f32
    visibility: torch.Tensor  # (H, W) i32
    gbuffer: GBuffer
    # CSM cascade data the frame sampled with (None when shadows are off).
    csm: object = None


_QUEUE = "ROADMAP.md, port queue"


def check_slice(config: RenderConfig) -> None:
    """Raise NotImplementedError for every switch outside the raster-only slice."""
    unported = [
        (config.ao_mode == AOMode.SSAO, f"ao_mode=SSAO ({_QUEUE} item 2: SSAO at half rate)"),
        (config.gi_mode == GIMode.LPV, f"gi_mode=LPV ({_QUEUE} item 3: LPV with RSM)"),
        (config.aa_mode == AAMode.TAA, f"aa_mode=TAA ({_QUEUE} item 4: TAAU)"),
        (config.occlusion_culling,
         f"occlusion_culling=True ({_QUEUE} item 5: the rest of the raster family)"),
        (config.translucency,
         f"translucency=True ({_QUEUE} item 5: the rest of the raster family)"),
        (not config.alpha_bitmap,
         f"alpha_bitmap=False ({_QUEUE} item 5: the rest of the raster family)"),
        (config.gi_mode in (GIMode.RT, GIMode.PROBES),
         f"gi_mode={config.gi_mode.name} ({_QUEUE} item 6: RT)"),
        (config.ao_mode == AOMode.RT, f"ao_mode=RT ({_QUEUE} item 6: RT)"),
        (config.shadow_mode == ShadowMode.RT, f"shadow_mode=RT ({_QUEUE} item 6: RT)"),
        (config.aa_mode == AAMode.VRSAA,
         f"aa_mode=VRSAA ({_QUEUE} item 7: VRSAA and interpolation)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported to androidrenderer_tpu_torch yet")


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


def main_view_setup(scene: SceneArrays, view: ViewData, config: RenderConfig):
    """(setup, opaque-pass setup, alpha grid or None) of the main view: the
    triangle-grain frustum cull and the corner-table setup. Masked triangles
    rasterize in the main pass against their alpha bitmaps; BLEND triangles
    never draw in the opaque pass (render_scene.cpp:57-69)."""
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
    is_blend = scene.tri_alpha_mode == 2
    setup_opaque = setup._replace(valid=setup.valid & ~is_blend)
    alpha_grid = scene.tri_alpha_grid if config.alpha_masking else None
    return setup, setup_opaque, alpha_grid


def _shadows(scene, inv_view, p00, p11, z_near, params, temporal, config, gbuf, depth):
    """Cascade fit + depth rasters + packed PCF: (shadow (H, W, 1), cascades as
    sampled, next temporal state)."""
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
            update_budget=config.shadow_update_budget, **geometry,
        )
        temporal = temporal._replace(csm_packed=packed, csm_matrices=matrices)
        # Each cascade pairs with the matrix its cached map was built with.
        cascades = cascades._replace(matrices=matrices)
    else:
        shadow_maps = shadow_ops.render_shadow_cascades(
            scene.positions, scene.tri_indices, scene.tri_valid, cascades,
            config.shadow_cascade_resolution, **geometry,
        )
    l = -scene.sun_direction / torch.sqrt((scene.sun_direction ** 2).sum())
    ndotl = torch.clamp((gbuf.normal * l[None, None, :]).sum(dim=-1, keepdim=True), 0.0, 1.0)
    view_distance = torch.where(
        depth > 0.0, z_near / torch.clamp(depth, min=1e-12), torch.zeros_like(depth)
    )
    shadow = shadow_ops.sample_csm(
        gbuf.world_position, view_distance, ndotl, cascades, shadow_maps,
        params.shadow_bias, normal=gbuf.normal, packed_taps=packed,
    )
    return shadow, cascades, temporal


@torch.no_grad()
def render_frame(
    scene: SceneArrays,
    view: ViewData,
    params: RenderParams,
    temporal: TemporalState,
    config: RenderConfig,
):
    """Render one raster-only frame: (FrameOutputs, next TemporalState).

    Each stage runs inside a ``torch.profiler.record_function`` range named
    ``frame/<stage>``, so a profile of the frame sums device time by stage."""
    check_slice(config)
    dev = scene.positions.device
    h, w = config.render_height, config.render_width
    inv_view = _f32(view.inverse_view, dev)
    z_near = float(view.z_near)
    p00 = float(view.projection[0, 0])
    p11 = float(view.projection[1, 1])

    with record_function("frame/cull_setup"):
        setup, setup_opaque, alpha_grid = main_view_setup(scene, view, config)
    with record_function("frame/raster"):
        depth, vis = rasterize(setup_opaque, h, w, alpha_grid=alpha_grid)
    with record_function("frame/resolve"):
        gbuf = resolve_gbuffer(
            scene, setup, vis, depth,
            use_base_textures=config.use_base_textures,
            use_normal_maps=config.use_normal_maps,
            use_mr_textures=config.use_mr_textures,
            use_emission=config.use_emission,
        )
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
    with record_function("frame/shade"):
        direct = lighting.sun_lighting(
            gbuf, _f32(view.position, dev), scene.sun_direction, scene.sun_color, shadow,
            params.sun_exposure,
        )
        lit = lighting.compose_lit_scene(gbuf, direct, gi=None, ao=None, sky=sky_img)
    with record_function("frame/post"):
        display = upscale_bilinear(lit, config.output_height, config.output_width)
        bloom_tex = (
            bloom_ops.bloom_chain(display, config.bloom_num_mips) if config.bloom else None
        )
        image = post.to_uint8(post.composite(display, bloom_tex, params.bloom_strength))

    next_temporal = temporal._replace(frame_index=temporal.frame_index + 1)
    outputs = FrameOutputs(
        image=image, hdr=lit, depth=depth, visibility=vis, gbuffer=gbuf, csm=cascades,
    )
    return outputs, next_temporal


def make_renderer(config: RenderConfig):
    """The frame callable ``(scene, view, params, temporal) -> (FrameOutputs,
    TemporalState)`` with ``config`` bound, as bench.py uses the JAX one."""
    check_slice(config)
    return partial(render_frame, config=config)
