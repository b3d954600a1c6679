"""GBuffer resolve — visibility buffer -> shaded surface attributes.

The port of the JAX package's ops/gbuffer.py (GbufferPhase + the gltf_basic_pbr
gbuffer stage, phase/gbuffer_phase.cpp:27-98): one per-triangle row of
attribute planes per pixel, perspective-correct interpolation as plane / s-plane,
analytic UV derivatives for the LOD, the fused trilinear material fetch, TBN
normal mapping, and the reference's channel conventions.

On CUDA tensors ``resolve_gbuffer`` launches ``csrc/gbuffer.cu`` (built by
``ops/cuda_build.py``), one thread per sample; on CPU tensors it runs
``resolve_gbuffer_reference``, the plain PyTorch version, which the kernel
equals bit for bit on the card. There is no fallback from one to the other.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_longlong, c_void_p
from typing import NamedTuple

import torch

from androidrenderer_tpu_torch.ops import texture as tex
from androidrenderer_tpu_torch.ops.cuda_build import Library
from androidrenderer_tpu_torch.ops.post import srgb_to_linear
from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup
from androidrenderer_tpu_torch.scene.material_storage import START_ALIGN, MaterialStorage
from androidrenderer_tpu_torch.scene.scene import SceneArrays


class GBuffer(NamedTuple):
    """Deferred surface attributes (all (H, W, C) f32)."""

    base_color: torch.Tensor  # (H, W, 3) linear
    normal: torch.Tensor  # (H, W, 3) world, unit
    roughness: torch.Tensor  # (H, W, 1)
    metalness: torch.Tensor  # (H, W, 1)
    emission: torch.Tensor  # (H, W, 3) linear
    world_position: torch.Tensor  # (H, W, 3)
    depth: torch.Tensor  # (H, W) reversed-Z ndc
    valid: torch.Tensor  # (H, W) bool


def _normalize(v, eps=1e-12):
    return v / torch.sqrt(torch.clamp((v * v).sum(dim=-1, keepdim=True), min=eps))


ATTR_CHANNELS = 16  # uv(2) normal(3) tangent(4) color(3) position(3) pad(1)
CONST_CHANNELS = 12  # base(3) metal(1) rough(1) emission(3) packed_tex(4)


def pack_attribute_planes(scene: SceneArrays, setup: TriangleSetup) -> torch.Tensor:
    """(N, 3 * (A + 1 + K)) per-triangle interpolation planes + constants.

    Attribute a interpolates as a(p) = (fa*x + fb*y + fc) / s(p) with
    (fa, fb, fc) = sum_i edge_i * a_i; channel A is the s-plane, and the material
    constants ride multiplied by the s-plane so the per-pixel divide recovers
    them. Rows are flat: the [fa | fb | fc] blocks side by side."""
    t = scene.tri_attr_corners  # (N, 3, A)
    blocks = []
    for c in range(3):
        attrs_c = (
            setup.edge[:, 0, c, None] * t[:, 0]
            + setup.edge[:, 1, c, None] * t[:, 1]
            + setup.edge[:, 2, c, None] * t[:, 2]
        )  # (N, A)
        s_c = setup.edge[:, 0, c] + setup.edge[:, 1, c] + setup.edge[:, 2, c]  # (N,)
        const_c = scene.tri_consts * s_c[:, None]  # (N, K)
        blocks += [attrs_c, s_c[:, None], const_c]
    return torch.cat(blocks, dim=1)


LIBRARY = Library("gbuffer.cu", {
    "gbuffer_launch": [c_void_p, c_void_p, c_void_p, c_longlong, c_int, c_int, c_void_p,
                       c_longlong, c_void_p, c_longlong, c_float, c_int, *[c_void_p] * 7,
                       c_void_p],
})


def _check(vis, depth, planes, pool) -> None:
    """Raise on what csrc/gbuffer.cu does not take."""
    dev = vis.device
    for name, x in (("depth", depth), ("attr_planes", planes), ("scene.textures", pool)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, vis on {dev}")
    if vis.dtype != torch.int32:
        raise TypeError(f"vis must be int32, got {vis.dtype}")
    if depth.dtype != torch.float32 or depth.shape != vis.shape:
        raise TypeError(f"depth must be float32 of vis' shape {tuple(vis.shape)}, got "
                        f"{tuple(depth.shape)} {depth.dtype}")
    nch = 3 * (ATTR_CHANNELS + 1 + CONST_CHANNELS)
    if planes.dtype != torch.float32 or planes.dim() != 2 or planes.shape[1] != nch:
        raise TypeError(f"attr_planes must be (N, {nch}) float32, got {tuple(planes.shape)} "
                        f"{planes.dtype}")
    row = MaterialStorage.POOL_CHANNELS
    if pool.dtype != torch.uint8 or pool.dim() != 2 or pool.shape[1] != row:
        raise TypeError(f"scene.textures must be (R, {row}) uint8, got {tuple(pool.shape)} "
                        f"{pool.dtype}")
    if not (vis.is_contiguous() and planes.is_contiguous() and pool.is_contiguous()):
        raise ValueError("vis, attr_planes and scene.textures must be contiguous")
    if pool.data_ptr() % 4:
        raise ValueError("scene.textures must start on a 4-byte boundary")


class ResolveCall(NamedTuple):
    """A prepared kernel call: its outputs, and ``launch()``, which fills them."""

    out: GBuffer
    launch: object


def prepare_resolve(scene: SceneArrays, vis: torch.Tensor, depth: torch.Tensor,
                    attr_planes: torch.Tensor, mip_bias: float = 0.0, row_offset: int = 0,
                    use_base_textures: bool = True, use_normal_maps: bool = True,
                    use_mr_textures: bool = True, use_emission: bool = True,
                    pixel_coords=None) -> ResolveCall:
    """Check a kernel call's inputs and allocate its outputs (the kernel
    allocates nothing). Launches nothing and counts nothing; ``launch()`` holds
    every tensor it reads, so it may run after the caller has let them go."""
    if vis.device.type != "cuda":
        raise ValueError(f"the resolve kernel runs on cuda tensors, got {vis.device}")
    pool = scene.textures
    _check(vis, depth, attr_planes, pool)
    if pixel_coords is None:
        if vis.dim() != 2:
            raise ValueError(f"without pixel_coords vis must be (H, W), got {tuple(vis.shape)}")
        px = py = None
        width = vis.shape[1]
    else:
        px, py = (torch.broadcast_to(torch.as_tensor(c, device=vis.device).to(torch.float32),
                                     vis.shape).contiguous() for c in pixel_coords)
        width = 0
    shape, dev = tuple(vis.shape), vis.device

    def planes(c):
        return torch.empty(shape + (c,), dtype=torch.float32, device=dev)

    out = GBuffer(base_color=planes(3), normal=planes(3), roughness=planes(1),
                  metalness=planes(1), emission=planes(3), world_position=planes(3),
                  depth=depth, valid=torch.empty(shape, dtype=torch.bool, device=dev))
    flags = (use_base_textures * 1 | use_normal_maps * 2 | use_mr_textures * 4
             | use_emission * 8)
    fn = LIBRARY.load().gbuffer_launch

    def ptr(t):
        return None if t is None else t.data_ptr()

    def launch():
        with torch.cuda.device(dev):
            err = fn(vis.data_ptr(), ptr(px), ptr(py), vis.numel(), width, int(row_offset),
                     attr_planes.data_ptr(), attr_planes.shape[0], pool.data_ptr(),
                     pool.shape[0], float(mip_bias), int(flags),
                     *(x.data_ptr() for x in out[:6]), out.valid.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"gbuffer_launch failed with cudaError_t {err}")

    return ResolveCall(out, launch)


def resolve_gbuffer(
    scene: SceneArrays,
    setup: TriangleSetup,
    vis: torch.Tensor,  # (H, W) int32
    depth: torch.Tensor,  # (H, W) f32
    mip_bias: float = 0.0,
    row_offset: int = 0,  # band mode: the first frame row of vis
    attr_planes: torch.Tensor | None = None,
    use_base_textures: bool = True,
    use_normal_maps: bool = True,
    use_mr_textures: bool = True,
    use_emission: bool = True,
    pixel_coords=None,  # optional ((...,) px, (...,) py) matching vis' shape
    debug_gather_only: bool = False,
) -> GBuffer:
    """Shade the visibility buffer: ``resolve_gbuffer_reference``'s function and
    arguments. CUDA tensors launch csrc/gbuffer.cu once (counted in
    ``resolve_gbuffer.launches``); CPU tensors, and ``debug_gather_only`` (the
    profiling switch, which profiles the plain plane gather), run the plain
    version. On the card ``vis``, ``attr_planes`` and ``scene.textures`` must be
    contiguous; an id in ``vis`` past the last row of ``attr_planes``, which the
    plain version refuses with an IndexError, shades as -1 there."""
    flags = dict(use_base_textures=use_base_textures, use_normal_maps=use_normal_maps,
                 use_mr_textures=use_mr_textures, use_emission=use_emission)
    if vis.device.type == "cpu" or debug_gather_only:
        return resolve_gbuffer_reference(
            scene, setup, vis, depth, mip_bias=mip_bias, row_offset=row_offset,
            attr_planes=attr_planes, pixel_coords=pixel_coords,
            debug_gather_only=debug_gather_only, **flags,
        )
    if attr_planes is None:
        attr_planes = pack_attribute_planes(scene, setup)
    call = prepare_resolve(scene, vis, depth, attr_planes, mip_bias, row_offset,
                           pixel_coords=pixel_coords, **flags)
    call.launch()
    resolve_gbuffer.launches += 1
    return call.out


resolve_gbuffer.launches = 0


def resolve_gbuffer_reference(
    scene: SceneArrays,
    setup: TriangleSetup,
    vis: torch.Tensor,  # (H, W) int32
    depth: torch.Tensor,  # (H, W) f32
    mip_bias: float = 0.0,
    row_offset: int = 0,  # band mode: the first frame row of vis
    attr_planes: torch.Tensor | None = None,
    use_base_textures: bool = True,
    use_normal_maps: bool = True,
    use_mr_textures: bool = True,
    use_emission: bool = True,
    pixel_coords=None,  # optional ((...,) px f32, (...,) py f32) matching vis' shape
    debug_gather_only: bool = False,
) -> GBuffer:
    """Shade the visibility buffer. ``vis`` may be any shape: pixel coordinates
    come from the (H, W) grid + ``row_offset``, or from ``pixel_coords`` for
    strided or scattered shading (VRSAA's coarse quad grid and its fine samples).

    ``debug_gather_only`` (the profiling switch ``debug_resolve_gather_only``):
    the plane gather runs, then one cheap pass consumes every gathered channel
    (``pa + pb + pc``) in place of the per-pixel plane heads and texture fetches."""
    valid = vis >= 0
    tid = vis.clamp(min=0).to(torch.int64)

    if attr_planes is None:
        attr_planes = pack_attribute_planes(scene, setup)
    pl = attr_planes[tid]
    nch = pl.shape[-1] // 3
    pa = pl[..., :nch]
    pb = pl[..., nch : 2 * nch]
    pc = pl[..., 2 * nch :]
    if debug_gather_only:
        g = pa + pb + pc
        one = torch.ones_like(g[..., :1])
        return GBuffer(
            base_color=torch.abs(g[..., 0:3]),
            normal=_normalize(g[..., 2:5] + 0.1),
            roughness=0.5 * one + 0.0 * g[..., 5:6],
            metalness=0.1 * one + 0.0 * g[..., 6:7],
            emission=0.0 * g[..., 7:10],
            world_position=g[..., 10:13],
            depth=depth,
            valid=valid,
        )
    if pixel_coords is None:
        height, width = vis.shape
        dev = vis.device
        px = torch.arange(width, dtype=torch.float32, device=dev)[None, :, None]
        py = (torch.arange(height, dtype=torch.float32, device=dev) + row_offset)[:, None, None]
    else:
        px = pixel_coords[0].to(torch.float32)[..., None]
        py = pixel_coords[1].to(torch.float32)[..., None]
    f = pa * px + pb * py + pc  # (..., A+1+K)
    s = f[..., ATTR_CHANNELS : ATTR_CHANNELS + 1]
    inv_s = 1.0 / torch.where(s == 0.0, torch.ones_like(s), s)
    a = f * inv_s  # interpolated attributes; constant channels recover exactly
    uv = a[..., 0:2]
    geo_n = _normalize(a[..., 2:5])
    tan4 = a[..., 5:9]
    vcolor = a[..., 9:12]
    world_pos = a[..., 12:15]
    c0 = ATTR_CHANNELS + 1
    base_factor = a[..., c0 : c0 + 3]
    metal_f = a[..., c0 + 3 : c0 + 4]
    rough_f = a[..., c0 + 4 : c0 + 5]
    emission_f = a[..., c0 + 5 : c0 + 8]
    packed_tv = torch.round(a[..., c0 + 8 : c0 + 12]).to(torch.int32)
    tex_log2b = packed_tv & 15
    tex_start = (packed_tv >> 4) * START_ALIGN
    # Analytic UV derivatives from the planes: da/dx = (fa*s - f*sa) / s^2.
    sa = pa[..., ATTR_CHANNELS : ATTR_CHANNELS + 1]
    sb = pb[..., ATTR_CHANNELS : ATTR_CHANNELS + 1]
    duvdx = (pa[..., 0:2] - uv * sa) * inv_s
    duvdy = (pb[..., 0:2] - uv * sb) * inv_s

    lod_uv = tex.compute_lod_uv(duvdx, duvdy, mip_bias)

    def slot(k):
        return tex_start[..., k], tex_log2b[..., k], (
            lod_uv + tex_log2b[..., k].to(torch.float32)
        )

    if use_base_textures or use_normal_maps or use_mr_textures:
        s0, b0, lod0 = slot(0)
        base_s, nrm_s, mr_s = tex.sample_material_fused(scene.textures, s0, b0, uv, lod0)
    if use_base_textures:
        base_rgb = srgb_to_linear(base_s[..., :3])
        base_color = base_rgb * base_factor * vcolor
    else:
        base_color = 1.0 * base_factor * vcolor

    if use_normal_maps:
        n_ts = nrm_s * 2.0 - 1.0
        t = tan4[..., :3]
        t_len2 = (t * t).sum(dim=-1, keepdim=True)
        has_tangent = t_len2 > 1e-8
        t = torch.where(
            has_tangent, t / torch.sqrt(torch.clamp(t_len2, min=1e-12)), torch.zeros_like(t)
        )
        b = torch.linalg.cross(geo_n, t) * tan4[..., 3:4]
        mapped_n = _normalize(
            t * n_ts[..., 0:1] + b * n_ts[..., 1:2] + geo_n * n_ts[..., 2:3]
        )
        normal = torch.where(has_tangent, mapped_n, geo_n)
    else:
        normal = geo_n

    if use_mr_textures:
        roughness = mr_s[..., 0:1] * rough_f
        metalness = mr_s[..., 1:2] * metal_f
    else:
        roughness = rough_f
        metalness = metal_f

    if use_emission:
        s3, b3, lod3 = slot(3)
        em_s = tex.sample_trilinear_fused(scene.textures, s3, b3, uv, lod3)
        emission = srgb_to_linear(em_s[..., :3]) * emission_f
    else:
        emission = torch.zeros_like(base_color)

    mask = valid[..., None]
    zero = torch.zeros_like(base_color)
    return GBuffer(
        base_color=torch.where(mask, base_color, zero),
        normal=torch.where(mask, normal, zero),
        roughness=torch.where(mask, roughness.clamp(0.045, 1.0), torch.ones_like(roughness)),
        metalness=torch.where(mask, metalness.clamp(0.0, 1.0), torch.zeros_like(metalness)),
        emission=torch.where(mask, emission, zero),
        world_position=torch.where(mask, world_pos, zero),
        depth=depth,
        valid=valid,
    )
