"""VRSAA — contrast-adaptive supersampling anti-aliasing. The port of the JAX
package's ops/vrsaa.py.

The reference's VRSAA renders at 2x resolution with a variable-rate-shading image
from contrast detection, so flat regions shade one fragment per 2x2 quad while
detailed regions shade all four (phase/sampling_rate_calculator.cpp:26-175,
vrsaa/contrast_detection.comp). Here geometry rasterizes at 2x the output
resolution, shading runs on the quad top-left samples, quads whose samples
differ in triangle id or depth (or whose coarse shade contrasts with a
neighbour) enter a fixed-size fine worklist, shade their other 3 samples, and
box-resolve. Quads past the budget (``RenderConfig.vrsaa_budget``) keep their
coarse sample, and the frame reports how many (``FrameOutputs.vrsaa_dropped``).

The worklist is a static-size compaction on the device: no host sync, no
``torch.nonzero``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def detect_fine_quads(
    vis: torch.Tensor,  # (2H, 2W) i32 visibility at the supersampled resolution
    depth: torch.Tensor,  # (2H, 2W) f32
    depth_rel_eps: float = 2e-3,
) -> torch.Tensor:
    """(H, W) bool: quads needing full-rate shading (contrast_detection analog)."""
    h2, w2 = vis.shape
    v = vis.reshape(h2 // 2, 2, w2 // 2, 2).permute(0, 2, 1, 3)
    d = depth.reshape(h2 // 2, 2, w2 // 2, 2).permute(0, 2, 1, 3)
    v00 = v[..., 0, 0]
    id_edge = (v[..., 0, 1] != v00) | (v[..., 1, 0] != v00) | (v[..., 1, 1] != v00)
    d00 = d[..., 0, 0]
    dmax = d.amax(dim=(-2, -1))
    dmin = d.amin(dim=(-2, -1))
    z_edge = (dmax - dmin) > depth_rel_eps * torch.clamp(torch.abs(d00), min=1e-6)
    return id_edge | z_edge


def luminance_contrast(
    lit: torch.Tensor,  # (H, W, 3) coarse-shaded quads (linear HDR)
    threshold: float = 0.15,
) -> torch.Tensor:
    """(H, W) bool: quads whose shade contrasts with a neighbour (the
    reference's contrast_detection.comp criterion on the current coarse shade).
    The neighbours wrap around the image edges, as ``jnp.roll`` does."""
    lum = lit[..., 0] * 0.2126 + lit[..., 1] * 0.7152 + lit[..., 2] * 0.0722
    mx = lum
    mn = lum
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        n = torch.roll(lum, shifts=(dy, dx), dims=(0, 1))
        mx = torch.maximum(mx, n)
        mn = torch.minimum(mn, n)
    return (mx - mn) > threshold * (mx + 0.05)


def fine_worklist(
    fine: torch.Tensor,  # (H, W) bool
    budget: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact fine quads into a ``budget``-long worklist, in scan order.

    Returns (qy (B,), qx (B,), live (B,), dropped () i32): the quads' coarse
    coordinates, padded past the last fine quad; quads past the budget are
    dropped (they keep their coarse shade) and counted in ``dropped``. Each fine
    quad's rank is its inclusive prefix count less one; ranks below the budget
    scatter the quad's index into their slot, every other quad into one spare
    slot past the end, which is cut off."""
    h, w = fine.shape
    flat = fine.reshape(-1)
    pos = torch.cumsum(flat, dim=0) - 1
    slot = torch.where(flat & (pos < budget), pos, torch.full_like(pos, budget))
    idx = torch.full((budget + 1,), h * w, dtype=torch.int64, device=fine.device)
    idx.scatter_(0, slot, torch.arange(h * w, dtype=torch.int64, device=fine.device))
    idx = idx[:budget]
    live = idx < h * w
    idx = torch.clamp(idx, max=h * w - 1)
    total = flat.sum(dtype=torch.int32)
    dropped = torch.clamp(total - budget, min=0)
    return idx // w, idx % w, live, dropped


def resolve_quads(
    lit_coarse: torch.Tensor,  # (H, W, 3) quad top-left shade
    fine_rgb: torch.Tensor,  # (B, 3, 3) the 3 extra samples' shade
    qy: torch.Tensor,
    qx: torch.Tensor,
    live: torch.Tensor,
) -> torch.Tensor:
    """Box-resolve: worklist quads average all 4 samples; others keep coarse.
    Dead entries write a pad row past the end, which is cut off."""
    h, w, _ = lit_coarse.shape
    base = lit_coarse[torch.clamp(qy, max=h - 1), torch.clamp(qx, max=w - 1)]
    avg = (base + fine_rgb.sum(dim=1)) * 0.25
    flat = torch.cat([lit_coarse.reshape(-1, 3), lit_coarse.new_zeros((1, 3))])
    idx = torch.where(live, qy * w + qx, torch.full_like(qy, h * w))
    flat = flat.index_put((idx,), torch.where(live[:, None], avg, torch.zeros_like(avg)))
    return flat[: h * w].reshape(h, w, 3)
