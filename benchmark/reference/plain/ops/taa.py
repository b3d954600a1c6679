# Frozen copy of androidrenderer_tpu_torch/ops/taa.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed; the TAA and TAAU resolves on one
# device, without the 8-byte history rows (taa_pack8) and the frame interpolation's sampler;
# scale_and_translate's contractions run widened under precision.WIDE.
"""Motion vectors, the packed history fetch, the neighbourhood clamp, the TAA
and TAAU resolves and the bilinear upscale: the port of the JAX package's
ops/taa.py that the frame and the RTGI accumulation read.

The reference delegates AA/upscaling to FSR3/DLSS/XeSS behind an IUpscaler
interface with Halton jitter (upscaling/upscaler.hpp:13-32) and renders motion
vectors by reprojection (motion_vectors_phase.cpp:14-103). This module is the
IUpscaler-shaped native implementation: reprojection motion vectors from the
visibility buffer's world positions, a bilinear history fetch through
R11G11B10 rows, a 3x3 neighborhood clamp and an exponential blend;
``taau_resolve`` also resamples the render-resolution signals to the output grid
(``scale_and_translate``, rebuilt here from jax.image's weight matrices).
"""

from __future__ import annotations

import functools
import math

import torch

from benchmark.reference.plain.ops.bloom import resize_linear
from benchmark.reference.plain.precision import widened


def motion_vectors(
    world_position: torch.Tensor,  # (H, W, 3)
    valid: torch.Tensor,  # (H, W) bool
    last_view_proj: torch.Tensor,  # (4, 4) previous frame, unjittered
    unjittered_view_proj: torch.Tensor,  # (4, 4) current frame, unjittered
) -> torch.Tensor:
    """(H, W, 2) uv-space motion: uv_prev = uv_curr - mv (motion_vectors.frag)."""

    def project_uv(m):
        clip = world_position @ m[:3, :3].T + m[:3, 3]
        wc = world_position @ m[3, :3] + m[3, 3]
        wc = wc[..., None]
        ndc = clip[..., :2] / torch.where(wc == 0.0, torch.ones_like(wc), wc)
        return torch.stack([ndc[..., 0] * 0.5 + 0.5, 0.5 - ndc[..., 1] * 0.5], dim=-1)

    mv = project_uv(unjittered_view_proj) - project_uv(last_view_proj)
    return torch.where(valid[..., None], mv, torch.zeros_like(mv))


def _f16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the u16 bit pattern of its round-to-nearest-even float16, as i64."""
    return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def _from_f16_bits(bits: torch.Tensor) -> torch.Tensor:
    """u16 bit patterns below 0x8000 (i64) -> float32 through float16."""
    return bits.to(torch.int16).view(torch.float16).to(torch.float32)


def _to_i32(u: torch.Tensor) -> torch.Tensor:
    """u32 values held in i64 -> the i32 of the same bits."""
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def _encode_r11g11b10(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) f32 HDR -> (...,) i32 packed R11G11B10 float (round-to-nearest).

    The 11/10-bit floats are f16 with the mantissa rounded to 6/5 bits (same
    5-bit exponent), so encode/decode are f16 bit casts + shifts. Clamped at
    64512 so the rounding carry never reaches the f16 infinity."""
    bits = _f16_bits(torch.clamp(rgb, 0.0, 64512.0))
    r = ((bits[..., 0] + 8) >> 4) & 0x7FF
    g = ((bits[..., 1] + 8) >> 4) & 0x7FF
    b = ((bits[..., 2] + 16) >> 5) & 0x3FF
    return _to_i32(r | (g << 11) | (b << 22))


def _decode_r11g11b10(packed: torch.Tensor) -> torch.Tensor:
    """(...,) i32 packed R11G11B10 -> (..., 3) f32."""
    u = packed.to(torch.int64) & 0xFFFFFFFF
    r = _from_f16_bits((u & 0x7FF) << 4)
    g = _from_f16_bits(((u >> 11) & 0x7FF) << 4)
    b = _from_f16_bits(((u >> 22) & 0x3FF) << 5)
    return torch.stack([r, g, b], dim=-1)


def _taps4(a: torch.Tensor):
    """a and its right, down and down-right neighbours, edge-clamped."""
    right = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    down = torch.cat([a[1:], a[-1:]], dim=0)
    down_right = torch.cat([right[1:], right[-1:]], dim=0)
    return a, right, down, down_right


def _bilinear_sample_packed(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample (H, W, 3) f32 at (..., 2) uv through an R11G11B10 row:
    the 2x2 footprint's four taps ride one (H*W, 4) i32 row, fetched by one
    row gather; edges clamp."""
    h, w, _ = img.shape
    enc = _encode_r11g11b10(img)  # (H, W) i32
    x = torch.clamp(uv[..., 0] * w - 0.5, 0.0, w - 1.0)
    y = torch.clamp(uv[..., 1] * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    idx = y0.to(torch.int64) * w + x0.to(torch.int64)
    taps = torch.stack(_taps4(enc), dim=-1).reshape(h * w, 4)[idx]
    c00 = _decode_r11g11b10(taps[..., 0])
    c01 = _decode_r11g11b10(taps[..., 1])
    c10 = _decode_r11g11b10(taps[..., 2])
    c11 = _decode_r11g11b10(taps[..., 3])
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    return top + (bot - top) * fy


def _neighborhood_minmax(img: torch.Tensor):
    """3x3 min/max per pixel over edge-replicated neighbours (the clamp box for
    history rectification)."""
    h, w, _ = img.shape
    p = torch.cat([img[:1], img, img[-1:]], dim=0)
    p = torch.cat([p[:, :1], p, p[:, -1:]], dim=1)
    mn = img
    mx = img
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            s = p[dy : dy + h, dx : dx + w]
            mn = torch.minimum(mn, s)
            mx = torch.maximum(mx, s)
    return mn, mx


def _on_screen(prev_uv: torch.Tensor) -> torch.Tensor:
    return ((prev_uv[..., 0] >= 0.0) & (prev_uv[..., 0] <= 1.0)
            & (prev_uv[..., 1] >= 0.0) & (prev_uv[..., 1] <= 1.0))[..., None]


def _pixel_uv(h: int, w: int, device):
    """(H, W, 2) uv of the pixel centres."""
    px = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    py = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    return torch.stack([px[None, :].expand(h, w), py[:, None].expand(h, w)], dim=-1)


def taa_resolve(
    current: torch.Tensor,  # (H, W, 3) this frame's lit scene (jittered render)
    history: torch.Tensor,  # (H_full, W, 3) accumulated history (FULL frame)
    history_valid: torch.Tensor,  # () bool
    mv: torch.Tensor,  # (H, W, 2) uv motion
    blend: float = 0.1,
):
    """(resolved, new_history) — exponential accumulation with a neighborhood
    clamp, at render resolution. The history is quantized per fetch only
    (R11G11B10); the state stays f32."""
    h, w, _ = current.shape
    prev_uv = _pixel_uv(h, w, current.device) - mv
    hist = _bilinear_sample_packed(history, prev_uv)
    mn, mx = _neighborhood_minmax(current)
    hist = torch.minimum(torch.maximum(hist, mn), mx)
    # Off-screen reprojection falls back to current.
    one = torch.ones((), dtype=torch.float32, device=current.device)
    alpha = torch.where(history_valid, one * blend, one)
    alpha = torch.where(_on_screen(prev_uv), alpha, one)
    resolved = hist + (current - hist) * alpha
    return resolved, resolved


# scale_and_translate: jax.image's weight matrices (jax/_src/image/scale.py::
# compute_weight_mat and _scale_and_translate) rebuilt in float32.


def _triangle_kernel(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _lanczos3_kernel(x: torch.Tensor) -> torch.Tensor:
    radius = 3.0
    px = math.pi * x
    y = radius * torch.sin(px) * torch.sin(px / radius)
    den = torch.where(x != 0, math.pi**2 * (x * x), torch.ones_like(x))
    out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle_kernel, "lanczos3": _lanczos3_kernel}


@functools.lru_cache(maxsize=64)
def scale_weights(in_size: int, out_size: int, scale: float, translation: float, method: str,
                  device) -> torch.Tensor:
    """(in_size, out_size) f32 weights of jax.image.scale_and_translate along
    one axis without antialiasing: output o samples input coordinate
    (o + 0.5 - translation) / scale - 0.5; the kernel's weights are normalised
    per output (zero where their sum is ~0), and an output whose sample lies
    outside [-0.5, in_size - 0.5] gets no weight. Cached per argument set (a
    frame's jitter takes a few phases): the result must not be written to."""
    f32 = dict(dtype=torch.float32, device=torch.device(device))
    inv_scale = 1.0 / torch.full((), scale, **f32)  # filled on the device: no host copy
    t = torch.full((), translation, **f32)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - t * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, **f32)[:, None])
    w = _KERNELS[method](x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        torch.abs(total) > 1000.0 * float(torch.finfo(torch.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


@widened
def _contract(equation: str, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """One of the resample's two contractions, accumulated in float32 (in
    float64 under precision.WIDE, rounded back to float32)."""
    return torch.einsum(equation, x, weights)


def scale_and_translate(
    x: torch.Tensor,  # (H, W, C) f32
    out_h: int,
    out_w: int,
    scale,  # (sy, sx)
    translation,  # (ty, tx)
    method: str,
    dtype=torch.float32,
) -> torch.Tensor:
    """(out_h, out_w, C) jax.image.scale_and_translate over the two spatial axes
    (antialias off), in ``dtype`` as jax computes it on an image of that dtype:
    the weights and the input rounded to ``dtype``, each of the two
    contractions accumulated in float32 and its result rounded to ``dtype``.
    The axes contract in jnp.einsum's order for these shapes (the cheaper
    order by multiply-adds, rows first on a tie); returns float32."""
    h, w, c = x.shape
    wh = _round(scale_weights(h, out_h, float(scale[0]), float(translation[0]), method,
                              x.device), dtype)
    ww = _round(scale_weights(w, out_w, float(scale[1]), float(translation[1]), method,
                              x.device), dtype)
    x = _round(x, dtype)
    rows_first = out_h * w * h + out_h * out_w * w
    cols_first = h * out_w * w + out_h * out_w * h
    if cols_first < rows_first:
        t = _round(_contract("hwc,wo->hoc", x, ww), dtype)
        return _round(_contract("hoc,hp->poc", t, wh), dtype)
    t = _round(_contract("hwc,hp->pwc", x, wh), dtype)
    return _round(_contract("pwc,wo->poc", t, ww), dtype)


def taau_resolve(
    current: torch.Tensor,  # (rh, rw, 3) this frame's lit scene (jittered render)
    history: torch.Tensor,  # (out_h, out_w, 3) OUTPUT-res accumulation
    history_valid: torch.Tensor,  # () bool
    mv: torch.Tensor,  # (rh, rw, 2) uv motion (resolution-free uv space)
    jitter,  # (2,) current-frame jitter in render pixels
    out_h: int,
    out_w: int,
    blend: float = 0.1,
    conf_sigma: float = 10.0,  # subpixel-confidence falloff (render px^-2)
    alpha_floor: float = 0.02,  # min fraction of blend for far samples
    clamp_pad: float = 0.5,  # clamp-box inflation as a fraction of its size
):
    """(resolved (oh, ow, 3), new_history) — temporal UPSCALING resolve (the
    reference's default frame is FSR3 Quality: render at output/1.5 per axis,
    upscale temporally; scene_renderer.cpp:28, fsr3.cpp:18).

    - Current (lanczos3), the 3x3 clamp box and motion (linear) resample
      render -> output with the frame's jitter cancelled, through
      ``scale_and_translate``: current and box in bfloat16 as the reference
      does, motion in float32.
    - The history fetch is the one gather, through R11G11B10 rows.
    - New samples are confidence-weighted by their subpixel distance to the
      output pixel, so static scenes converge to the supersampled image."""
    rh, rw, _ = current.shape
    sx = out_w / rw
    oh = out_h
    sy = oh / rh
    jx = float(jitter[0])
    jy = float(jitter[1])
    # Jitter cancellation (camera.py projection_matrix): the render-space sample
    # of output coordinate o is (o+.5)/s-.5 + (-jx, +jy), i.e. translation -d*s.
    # Computed in float32 as the reference's traced scalars are.
    f32 = torch.float32
    tx = torch.tensor(jx, dtype=f32) * torch.tensor(sx, dtype=f32)
    ty = -torch.tensor(jy, dtype=f32) * torch.tensor(sy, dtype=f32)

    # Replicated padding on every side: the resample reads up to 3 px outside
    # the render grid (lanczos3 radius) and would fill it with zeros.
    k = 3
    cur_p = torch.cat([current[:1], current, current[-1:]], dim=0)
    mn_p, mx_p = _neighborhood_minmax(cur_p)
    mv_p = torch.cat([mv[:1], mv, mv[-1:]], dim=0)
    stacked = torch.cat([cur_p, mn_p, mx_p, mv_p], dim=-1)
    ep = k - 1  # rows/cols beyond the first replicated ring
    stacked = torch.cat([stacked[:1].expand(ep, -1, -1), stacked,
                         stacked[-1:].expand(ep, -1, -1)], dim=0)
    stacked = torch.cat([stacked[:, :1].expand(-1, k, -1), stacked,
                         stacked[:, -1:].expand(-1, k, -1)], dim=1)  # (rh+2K, rw+2K, 11)
    scale = (float(torch.tensor(sy, dtype=f32)), float(torch.tensor(sx, dtype=f32)))
    trans = (float(ty - torch.tensor(k * sy, dtype=f32)),
             float(tx - torch.tensor(k * sx, dtype=f32)))
    # Current through lanczos3 (the windowed sinc recovers detail near render
    # Nyquist); the clamp box and motion LINEAR (a ringing min/max box would
    # mis-clamp history). Motion stays float32: quantized, it would misplace the
    # history fetch by up to ~0.5 output px.
    cur_up = scale_and_translate(stacked[..., 0:3], oh, out_w, scale, trans, "lanczos3",
                                 torch.bfloat16)
    box = scale_and_translate(stacked[..., 3:9], oh, out_w, scale, trans, "linear",
                              torch.bfloat16)
    mv_up = scale_and_translate(stacked[..., 9:11], oh, out_w, scale, trans, "linear")
    mn_up = box[..., 0:3]
    mx_up = box[..., 3:6]
    # Lanczos overshoot control: ring suppression against the local box.
    ring = 0.25 * (mx_up - mn_up)
    cur_up = torch.minimum(torch.maximum(cur_up, mn_up - ring), mx_up + ring)

    prev_uv = _pixel_uv(oh, out_w, current.device) - mv_up
    hist = _bilinear_sample_packed(history, prev_uv)
    pad = clamp_pad * (mx_up - mn_up)
    hist = torch.minimum(torch.maximum(hist, mn_up - pad), mx_up + pad)

    # Subpixel confidence: distance (render px) from this output pixel's
    # jitter-cancelled sample position to the nearest render sample center.
    dev = current.device
    ox = (torch.arange(out_w, dtype=f32, device=dev) + 0.5) / sx - 0.5 - jx
    oy = (torch.arange(oh, dtype=f32, device=dev) + 0.5) / sy - 0.5 + jy
    dx = ox - torch.round(ox)
    dy = oy - torch.round(oy)
    d2 = (dx * dx)[None, :] + (dy * dy)[:, None]
    w_new = torch.exp(-conf_sigma * d2)[..., None]

    one = torch.ones((), dtype=f32, device=dev)
    alpha = torch.where(history_valid, blend * (alpha_floor + (1.0 - alpha_floor) * w_new), one)
    alpha = torch.where(_on_screen(prev_uv), alpha, one)
    resolved = hist + (cur_up - hist) * alpha
    return resolved, resolved


def upscale_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Render-res -> output-res (scene_upsample.frag bilinear contract)."""
    if img.shape[0] == out_h and img.shape[1] == out_w:
        return img
    return resize_linear(img, out_h, out_w)
