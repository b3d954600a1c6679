# Frozen copy of androidrenderer_tpu_torch/ops/upsample.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed; no band halo.
"""Depth/normal-aware 2x upsampling for half-rate shading.

The reference spends full-rate shading only where VRS says it matters
(sampling_rate_calculator.cpp:26-124) and leans on upscalers for the rest; the
frame shades low-frequency screen signals (LPV GI apply, SSAO) on the
``[::2, ::2]`` grid and reconstructs them with a joint bilateral filter, the
shape of FFX CACAO's edge-aware upsample (ambient_occlusion_phase.cpp:191-355).
The port of the JAX package's ops/upsample.py.
"""

from __future__ import annotations

import torch


def _shift_rows(a: torch.Tensor, d: int, lo: int, n: int) -> torch.Tensor:
    """Rows [lo + d, lo + d + n) of a (possibly halo-extended) array, the last
    row repeated past its end (edge clamp)."""
    start = lo + d
    if start + n <= a.shape[0]:
        return a[start:start + n]
    pad = start + n - a.shape[0]
    return torch.cat([a[start:], a[-1:].expand(pad, *a.shape[1:])], dim=0)


def _shift_cols(a: torch.Tensor, d: int) -> torch.Tensor:
    if d == 0:
        return a
    return torch.cat([a[:, d:], a[:, -1:].expand(a.shape[0], d, *a.shape[2:])], dim=1)


def _repeat2(a: torch.Tensor) -> torch.Tensor:
    """Each half-grid texel over its 2x2 full-resolution pixels."""
    return a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def bilateral_upsample_2x(
    signal_half: torch.Tensor,  # (Hh, Wh, C) or (Hh, Wh) half-res signal
    depth_half: torch.Tensor,  # (Hh, Wh) half-res reversed-Z ndc depth
    normal_half: torch.Tensor,  # (Hh, Wh, 3)
    depth_full: torch.Tensor,  # (H, W)
    normal_full: torch.Tensor,  # (H, W, 3)
) -> torch.Tensor:
    """(H, W, C) joint-bilateral reconstruction of a half-rate signal.

    Half-res sample (j, i) corresponds to full-res pixel (2j, 2i) (the [::2]
    subsample). Each full pixel blends its 4 surrounding half samples with
    bilinear x depth-similarity x normal-similarity weights; when every
    similarity weight dies (isolated silhouette pixels) the plain bilinear
    fallback keeps the result finite."""
    h, w = depth_full.shape
    hh = h // 2
    dev = depth_full.device
    sig = signal_half if signal_half.dim() > 2 else signal_half[..., None]

    dy = (torch.arange(h, dtype=torch.float32, device=dev) % 2.0)[:, None] * 0.5  # {0, .5}
    dx = (torch.arange(w, dtype=torch.float32, device=dev) % 2.0)[None, :] * 0.5
    wy = (1.0 - dy, dy)
    wx = (1.0 - dx, dx)

    num = den = num_b = den_b = 0.0
    for dj in (0, 1):
        for di in (0, 1):
            s = _repeat2(_shift_cols(_shift_rows(sig, dj, 0, hh), di))
            d = _repeat2(_shift_cols(_shift_rows(depth_half, dj, 0, hh), di))
            n = _repeat2(_shift_cols(_shift_rows(normal_half, dj, 0, hh), di))
            wb = wy[dj] * wx[di]
            rel = torch.abs(d - depth_full) / (torch.abs(depth_full) + 1e-6)
            wd = 1.0 / (1.0 + 32.0 * rel)
            c = torch.clamp((n * normal_full).sum(dim=-1), min=0.0)
            c2 = c * c
            c4 = c2 * c2
            wn = c4 * c4  # ** 8, by squaring as the reference's integer power
            wgt = wb * wd * wn
            num = num + s * wgt[..., None]
            den = den + wgt
            num_b = num_b + s * wb[..., None]
            den_b = den_b + wb
    bilat = num / torch.clamp(den[..., None], min=1e-8)
    bilin = num_b / torch.clamp(den_b[..., None], min=1e-8)
    return torch.where((den > 1e-4)[..., None], bilat, bilin)
