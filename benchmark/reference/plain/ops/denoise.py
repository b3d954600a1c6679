# Frozen copy of androidrenderer_tpu_torch/ops/denoise.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed; atrous_filter runs widened
# under precision.WIDE; no band mode.
"""Stochastic-GI reconstruction: the RTGI denoiser slot.

The port of the JAX package's ops/denoise.py. The reference reconstructs its
1-spp RTGI with a screen-space filter (gi/rtgi.cpp:160-188,
shaders/gi/rtgi/overlay.frag.slang) and hands the rest to a vendor denoiser
when present. Here, as there:

- ``atrous_filter``: a-trous wavelet (Dammertz 2010), N dilated 5-tap-cross
  passes with depth/normal edge-stopping weights, the overlay.frag analog.
  Neighbours wrap at the image edges (``jnp.roll`` there, ``torch.roll`` here).
- ``temporal_accumulate``: TAA-style reprojected exponential accumulation of the
  pre-albedo irradiance with a widened neighbourhood clamp, the
  vendor-denoiser replacement.

"""

from __future__ import annotations

import torch

from benchmark.reference.plain.precision import widened
from benchmark.reference.plain.ops.taa import (
    _bilinear_sample_packed, _neighborhood_minmax, _on_screen, _pixel_uv,
)

# 5-tap B3-spline cross weights.
_W = (0.375, 0.25, 0.0625)  # center, +-1, +-2


@widened
def atrous_filter(
    signal: torch.Tensor,  # (H, W, 3) noisy GI
    depth: torch.Tensor,  # (H, W) reversed-Z
    normal: torch.Tensor,  # (H, W, 3)
    valid: torch.Tensor,  # (H, W)
    iterations: int = 3,
    sigma_z: float = 0.02,
    sigma_n: float = 16.0,
) -> torch.Tensor:
    """Edge-preserving smoothing of per-pixel stochastic GI.

    Each pass rolls the signal, depth and normal together once per tap (one
    (H, W, 7) tensor) and weighs the pass's 8 taps in one batch; the weighted
    taps are summed one by one in the JAX order."""
    out = signal
    vz = torch.where(valid, depth, torch.full_like(depth, -1.0))
    weights = torch.tensor([wt for wt in (_W[1], _W[2]) for _ in range(4)],
                           dtype=signal.dtype, device=signal.device)[:, None, None]
    for it in range(iterations):
        step = 1 << it
        shifts = [(dy, dx) for d in (step, 2 * step)
                  for dy, dx in ((0, d), (0, -d), (d, 0), (-d, 0))]
        packed = torch.cat([out, vz[..., None], normal], dim=-1)
        taps = torch.stack([torch.roll(packed, s, dims=(0, 1)) for s in shifts])  # (8, H, W, 7)
        s, zq, nq = taps[..., 0:3], taps[..., 3], taps[..., 4:7]
        w_z = torch.exp(-torch.abs(zq - vz) / sigma_z)
        w_n = torch.clamp((nq * normal).sum(-1), min=0.0) ** sigma_n
        w = (weights * w_z * w_n * (zq >= 0.0))[..., None]  # (8, H, W, 1)
        sw = s * w
        acc = out * _W[0]
        wsum = torch.full(depth.shape + (1,), _W[0], dtype=signal.dtype, device=depth.device)
        for k in range(len(shifts)):
            acc = acc + sw[k]
            wsum = wsum + w[k]
        out = acc / torch.clamp(wsum, min=1e-6)
    return torch.where(valid[..., None], out, signal)


def temporal_accumulate(
    signal: torch.Tensor,  # (H, W, 3) this frame's filtered irradiance
    history: torch.Tensor,  # (H_full, W, 3) accumulated irradiance (FULL frame)
    history_valid: torch.Tensor,  # () bool
    mv: torch.Tensor,  # (H, W, 2) uv motion (ops/taa.py::motion_vectors)
    blend: float = 0.15,
):
    """(accumulated, new_history): reprojected exponential accumulation with a
    3x3 neighbourhood clamp (rejects ghosting on disocclusion)."""
    h, w, _ = signal.shape
    prev_uv = _pixel_uv(h, w, signal.device) - mv
    # R11G11B10-packed fetch (16-byte gather rows; see taa._bilinear_sample_packed).
    hist = _bilinear_sample_packed(history, prev_uv)
    mn, mx = _neighborhood_minmax(signal)
    # Wider clamp box than TAA: irradiance is low-frequency and 1-spp noisy, so a
    # tight clamp would reject the very history that removes the noise.
    pad = 0.5 * (mx - mn) + 1e-4
    hist = torch.minimum(torch.maximum(hist, mn - pad), mx + pad)
    one = torch.ones((), dtype=torch.float32, device=signal.device)
    alpha = torch.where(history_valid, torch.full_like(one, blend), one)
    alpha = torch.where(_on_screen(prev_uv), alpha, one)
    out = hist + (signal - hist) * alpha
    return out, out
