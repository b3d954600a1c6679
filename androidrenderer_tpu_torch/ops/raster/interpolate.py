"""Visibility-buffer resolve: perspective-correct attribute interpolation.

The port of the JAX package's ops/raster/interpolate.py, in plain torch. For each
pixel it gathers the winning triangle's edge coefficients and vertex
attributes, re-evaluates the edge functions, and interpolates with the
perspective-correct barycentrics ``lambda_i = D_i / sum(D)`` (raw attributes
interpolate directly, no divide by w; see setup.py). The frame's gbuffer
resolve (ops/gbuffer.py) interpolates per-triangle planes instead; these are the
package's general-purpose resolve functions.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup


class PixelBarycentrics(NamedTuple):
    tri_id: torch.Tensor  # (H, W) int32, -1 = background
    vertex_ids: torch.Tensor  # (H, W, 3) int32 (clamped-safe for background)
    lam: torch.Tensor  # (H, W, 3) f32 perspective-correct barycentrics
    valid: torch.Tensor  # (H, W) bool
    w: torch.Tensor  # (H, W) f32 interpolated clip w (view distance along -z)
    # For analytic screen-space derivatives: attribute a(p) = f/s with
    # f = sum d_i a_i, so da/dx = (sum A_i a_i * s - f * sum A_i) / s^2.
    d: torch.Tensor  # (H, W, 3) raw edge-function values
    s: torch.Tensor  # (H, W) sum of edge values
    edge_a: torch.Tensor  # (H, W, 3) x-gradient coefficients A_i
    edge_b: torch.Tensor  # (H, W, 3) y-gradient coefficients B_i


def compute_barycentrics(
    vis: torch.Tensor,  # (H, W) int32 visibility buffer
    setup: TriangleSetup,
    tri_indices: torch.Tensor,  # (N, 3) int32
    row_offset: torch.Tensor | int = 0,
) -> PixelBarycentrics:
    height, width = vis.shape
    dev = vis.device
    valid = vis >= 0
    tid = vis.clamp(min=0).long()

    # One flat 12-wide row gather (edges + q) per pixel.
    n = setup.edge.shape[0]
    table = torch.cat([setup.edge.reshape(n, 9), setup.q.reshape(n, 3)], dim=1)  # (N, 12)
    row = table[tid]  # (H, W, 12)
    edge = row[..., :9].reshape(row.shape[:-1] + (3, 3))  # (H, W, 3, 3)
    q = row[..., 9:12]  # (H, W, 3)
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :, None]
    py = (torch.arange(height, dtype=torch.float32, device=dev) + row_offset)[:, None, None]

    d = edge[..., 0] * px + edge[..., 1] * py + edge[..., 2]  # (H, W, 3)
    s = d.sum(dim=-1, keepdim=True)
    lam = d / torch.where(s == 0.0, torch.ones_like(s), s)

    qv = q[..., 0] * px[..., 0] + q[..., 1] * py[..., 0] + q[..., 2]
    w = qv / torch.where(s[..., 0] == 0.0, torch.ones_like(qv), s[..., 0])

    return PixelBarycentrics(
        tri_id=vis,
        vertex_ids=tri_indices[tid],
        lam=lam.to(torch.float32),
        valid=valid,
        w=w.to(torch.float32),
        d=d.to(torch.float32),
        s=s[..., 0].to(torch.float32),
        edge_a=edge[..., 0].to(torch.float32),
        edge_b=edge[..., 1].to(torch.float32),
    )


def interpolate_with_derivatives(
    bary: PixelBarycentrics,
    attr: torch.Tensor,  # (V, K)
):
    """Interpolated value + analytic d/dx, d/dy (the replacement of hardware quad
    derivatives for mip selection). Returns three (H, W, K) tensors."""
    av = attr[bary.vertex_ids.long()]  # (H, W, 3, K)
    s = torch.where(bary.s == 0.0, torch.ones_like(bary.s), bary.s)[..., None]
    f = (av * bary.d[..., None]).sum(dim=-2)
    fx = (av * bary.edge_a[..., None]).sum(dim=-2)
    fy = (av * bary.edge_b[..., None]).sum(dim=-2)
    sx = bary.edge_a.sum(dim=-1)[..., None]
    sy = bary.edge_b.sum(dim=-1)[..., None]
    value = f / s
    inv_s2 = 1.0 / (s * s)
    ddx = (fx * s - f * sx) * inv_s2
    ddy = (fy * s - f * sy) * inv_s2
    mask = bary.valid[..., None]
    zero = torch.zeros((), dtype=value.dtype, device=value.device)
    return torch.where(mask, value, zero), torch.where(mask, ddx, zero), torch.where(mask, ddy, zero)


def interpolate_attributes(
    bary: PixelBarycentrics,
    attributes: Dict[str, torch.Tensor],  # name -> (V, K) vertex attribute arrays
) -> Dict[str, torch.Tensor]:
    """Interpolate each attribute to (H, W, K). Background pixels get zeros."""
    out: Dict[str, torch.Tensor] = {}
    vids = bary.vertex_ids.long()  # (H, W, 3)
    lam = bary.lam[..., None]  # (H, W, 3, 1)
    mask = bary.valid[..., None]
    for name, a in attributes.items():
        interp = (a[vids] * lam).sum(dim=-2)
        out[name] = torch.where(mask, interp, torch.zeros_like(interp)).to(a.dtype)
    return out
