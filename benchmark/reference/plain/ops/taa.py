# Frozen copy of androidrenderer_tpu_torch/ops/taa.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed; only the helpers the RTGI accumulation
# and the output upscale read.
"""Motion vectors, the packed history fetch, the neighbourhood clamp and the
bilinear upscale: the helpers of the port of the JAX package's ops/taa.py
that the RTGI accumulation and the frame's output read."""

from __future__ import annotations


import torch

from benchmark.reference.plain.ops.bloom import resize_linear


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


# scale_and_translate: jax.image's weight matrices (jax/_src/image/scale.py::
# compute_weight_mat and _scale_and_translate) rebuilt in float32.



def upscale_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Render-res -> output-res (scene_upsample.frag bilinear contract)."""
    if img.shape[0] == out_h and img.shape[1] == out_w:
        return img
    return resize_linear(img, out_h, out_w)
