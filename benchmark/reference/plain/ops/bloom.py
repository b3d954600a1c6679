# Frozen copy of androidrenderer_tpu_torch/ops/bloom.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed; resize_linear runs widened
# under precision.WIDE (its weights in the image's dtype).
"""Bloom — CoD-style 13-tap downsample + tent upsample chain (Bloomer,
bloomer.cpp:38-285; bloom_downsample.comp:16-53, bloom_upsample.comp). 6 mips
(bloomer.cpp:9); the composite adds ``bloom * 0.014159`` (scene_upsample.frag:61).

The port of the JAX package's ops/bloom.py dense formulation: the 13-tap
stencil as separable shift+FMA passes over half-size parity planes, and the
upsample as a bilinear resize + 3x3 tent. The resize rebuilds the weights of
``jax.image.resize(..., "linear")`` (half-pixel centres, triangle kernel,
per-output normalisation, samples outside the input zeroed) and applies them as
two float32 matrix products, so odd mip sizes resample as in the JAX frame.
"""

from __future__ import annotations

from typing import List

import torch

from benchmark.reference.plain.precision import widened


def _shift(a: torch.Tensor, d: int, axis: int) -> torch.Tensor:
    """a[i - d] along ``axis`` with ZERO fill (a conv's SAME zero padding)."""
    if d == 0:
        return a
    n = a.shape[axis]
    z = torch.zeros_like(a.narrow(axis, 0, abs(d)))
    if d > 0:
        return torch.cat([z, a.narrow(axis, 0, n - d)], dim=axis)
    return torch.cat([a.narrow(axis, -d, n + d), z], dim=axis)


def _axis_se_so(a: torch.Tensor, axis: int):
    """1-d stride-2 factor pair along ``axis`` with XLA SAME alignment:
    se = [.25,.5,.25] and so = [.5,.5] on the two parity planes."""
    n = a.shape[axis]
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(0, n, 2)
    ep = a[tuple(idx)]
    idx[axis] = slice(1, n, 2)
    op = a[tuple(idx)]
    if n % 2 == 0:
        se = 0.25 * _shift(op, 1, axis) + 0.5 * op + 0.25 * _shift(op, -1, axis)
        so = 0.5 * ep + 0.5 * _shift(ep, -1, axis)
    else:
        op = torch.cat([op, torch.zeros_like(ep.narrow(axis, 0, 1))], dim=axis)
        se = 0.25 * _shift(ep, 1, axis) + 0.5 * ep + 0.25 * _shift(ep, -1, axis)
        so = 0.5 * _shift(op, 1, axis) + 0.5 * op
    return se, so


def downsample_13tap(img: torch.Tensor) -> torch.Tensor:
    """Half-resolution 13-tap downsample (bloom_downsample.comp:16-53)."""
    c_se, c_so = _axis_se_so(img, 1)
    r_se, _ = _axis_se_so(c_se, 0)
    _, r_so = _axis_se_so(c_so, 0)
    return 0.5 * r_se + 0.5 * r_so


def resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) f32 weights of jax.image.resize's linear method
    (antialiased triangle kernel, translation 0)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (
        (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    )
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = torch.abs(sample_f[None, :] - src[:, None]) / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        torch.abs(total) > 1000.0 * float(torch.finfo(torch.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@widened
def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(h, w, C) -> (out_h, out_w, C), jax.image.resize(..., "linear") semantics."""
    h, w, c = img.shape
    out = img
    if out_h != h:
        wh = resize_weights(h, out_h, img.device).to(img.dtype)  # (h, out_h)
        out = (wh.T @ out.reshape(h, w * c)).reshape(out_h, w, c)
    if out_w != w:
        ww = resize_weights(w, out_w, img.device).to(img.dtype)  # (w, out_w)
        out = (out.permute(0, 2, 1) @ ww).permute(0, 2, 1).contiguous()
    return out


def upsample_tent(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear x2 upsample + 3x3 tent (bloom_upsample.comp) as dense
    separable shift+FMAs (zero-fill edges = the conv's SAME padding)."""
    up = resize_linear(img, out_h, out_w)
    h = 0.25 * _shift(up, 1, 1) + 0.5 * up + 0.25 * _shift(up, -1, 1)
    return 0.25 * _shift(h, 1, 0) + 0.5 * h + 0.25 * _shift(h, -1, 0)


def bloom_chain(scene_color: torch.Tensor, num_mips: int = 6) -> torch.Tensor:
    """Full bloom: down chain, additive tent up chain; returns the full-res
    bloom texture (the blurred energy, scene color subtracted)."""
    mips: List[torch.Tensor] = [scene_color]
    cur = scene_color
    for _ in range(num_mips):
        cur = downsample_13tap(cur)
        mips.append(cur)
    acc = mips[-1]
    for level in range(num_mips - 1, -1, -1):
        target = mips[level]
        acc = upsample_tent(acc, target.shape[0], target.shape[1]) + target
    return acc - scene_color
