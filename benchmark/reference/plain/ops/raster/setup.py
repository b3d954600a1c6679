# Frozen copy of androidrenderer_tpu_torch/ops/raster/setup.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed only.
"""Vertex transform + clipless homogeneous triangle setup, and the raster records.

Math (2DH rasterization, Olano-Greer style — no clipping needed), as in the JAX
package's ops/raster/setup.py: clip-space vertices fold the viewport into
homogeneous pixel space ``v' = (X', Y', W)``; the edge functions
``D_i(px, py) = dot(cross(v'_j, v'_k), (px, py, 1))`` are affine in pixel
coordinates; coverage is all D_i <= 0 (front) or all >= 0 (double-sided back);
``q = sum D_i W_i`` and ``r = sum D_i Z_i`` give the depth ``z = r / q``.

Every formula keeps the JAX version's operation order, so a float32 evaluation
on either device rounds the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TriangleSetup(NamedTuple):
    """SoA per-triangle raster constants. N is padded; invalid lanes have valid=0."""

    edge: torch.Tensor  # (N, 3, 3) f32 — D_i(px,py) = edge[i] . (px, py, 1)
    q: torch.Tensor  # (N, 3) f32 — q(px,py) coefficients (sum D_i * W_i)
    r: torch.Tensor  # (N, 3) f32 — r(px,py) coefficients (sum D_i * Z_i)
    bbox: torch.Tensor  # (N, 4) f32 — [x0, y0, x1, y1] inclusive pixel bounds
    valid: torch.Tensor  # (N,) bool
    double_sided: torch.Tensor  # (N,) bool — accept back-facing coverage


def triangle_setup_corners(
    corner_pos: torch.Tensor,  # (N, 3, 3) world-space per-triangle corners
    view_proj: torch.Tensor,  # (4, 4)
    width: int,
    height: int,
    double_sided: torch.Tensor | None = None,  # (N,) bool
    tri_valid: torch.Tensor | None = None,  # (N,) bool — padding mask
) -> TriangleSetup:
    """triangle_setup from a baked corner table: gather-free, component-wise
    transforms on the (N,) columns of the table."""
    vp = view_proj.to(torch.float32)
    cp = corner_pos.to(torch.float32)

    def corner(k):
        wx = cp[:, k, 0]
        wy = cp[:, k, 1]
        wz = cp[:, k, 2]
        x = vp[0, 0] * wx + vp[0, 1] * wy + vp[0, 2] * wz + vp[0, 3]
        y = vp[1, 0] * wx + vp[1, 1] * wy + vp[1, 2] * wz + vp[1, 3]
        z = vp[2, 0] * wx + vp[2, 1] * wy + vp[2, 2] * wz + vp[2, 3]
        w = vp[3, 0] * wx + vp[3, 1] * wy + vp[3, 2] * wz + vp[3, 3]
        return x, y, z, w

    return _setup_from_corner_components(
        corner(0), corner(1), corner(2), width, height, double_sided, tri_valid
    )


def _setup_from_corner_components(
    c0,  # (x, y, z, w) clip components of corner 0, each (N,) f32
    c1,
    c2,
    width: int,
    height: int,
    double_sided: torch.Tensor | None,
    tri_valid: torch.Tensor | None,
) -> TriangleSetup:
    _, _, z0, w0 = c0
    _, _, z1, w1 = c1
    _, _, z2, w2 = c2

    def pix(c):
        x, y, _, w = c
        xp = (x + w) * (0.5 * width) - 0.5 * w
        yp = (w - y) * (0.5 * height) - 0.5 * w
        return xp, yp

    x0p, y0p = pix(c0)
    x1p, y1p = pix(c1)
    x2p, y2p = pix(c2)
    n = x0p.shape[0]
    dev = x0p.device

    def cross(xa, ya, wa, xb, yb, wb):
        return ya * wb - wa * yb, wa * xb - xa * wb, xa * yb - ya * xb

    e0a, e0b, e0c = cross(x1p, y1p, w1, x2p, y2p, w2)
    e1a, e1b, e1c = cross(x2p, y2p, w2, x0p, y0p, w0)
    e2a, e2b, e2c = cross(x0p, y0p, w0, x1p, y1p, w1)

    qa = e0a * w0 + e1a * w1 + e2a * w2
    qb = e0b * w0 + e1b * w1 + e2b * w2
    qc_ = e0c * w0 + e1c * w1 + e2c * w2
    ra = e0a * z0 + e1a * z1 + e2a * z2
    rb = e0b * z0 + e1b * z1 + e2b * z2
    rc_ = e0c * z0 + e1c * z1 + e2c * z2

    # Degenerate triangles: zero area in the homogeneous sense (all cross rows ~ 0).
    nondegenerate = (
        (e0a.abs() + e1a.abs() + e2a.abs())
        + (e0b.abs() + e1b.abs() + e2b.abs())
        + (e0c.abs() + e1c.abs() + e2c.abs())
    ) > 0.0

    # Pixel-space AABB; triangles crossing w == 0 get a full-screen box.
    eps = 1e-6
    all_front = (w0 > eps) & (w1 > eps) & (w2 > eps)

    def safe(w):
        return torch.where(w == 0, torch.ones_like(w), w)

    px0, px1, px2 = x0p / safe(w0), x1p / safe(w1), x2p / safe(w2)
    py0, py1, py2 = y0p / safe(w0), y1p / safe(w1), y2p / safe(w2)
    zero = torch.zeros_like(px0)
    x0 = torch.where(all_front, torch.floor(torch.minimum(torch.minimum(px0, px1), px2)), zero)
    y0 = torch.where(all_front, torch.floor(torch.minimum(torch.minimum(py0, py1), py2)), zero)
    x1 = torch.where(
        all_front, torch.ceil(torch.maximum(torch.maximum(px0, px1), px2)),
        torch.full_like(px0, float(width - 1)),
    )
    y1 = torch.where(
        all_front, torch.ceil(torch.maximum(torch.maximum(py0, py1), py2)),
        torch.full_like(px0, float(height - 1)),
    )
    x0 = x0.clamp(0.0, float(width - 1))
    y0 = y0.clamp(0.0, float(height - 1))
    x1 = x1.clamp(0.0, float(width - 1))
    y1 = y1.clamp(0.0, float(height - 1))
    bbox = torch.stack([x0, y0, x1, y1], dim=-1)

    # Fully behind the camera => never visible; cull in setup.
    any_front = (w0 > eps) | (w1 > eps) | (w2 > eps)
    on_screen = torch.where(all_front, (x1 >= x0) & (y1 >= y0), torch.ones_like(all_front))

    # Backface culling (single-sided, fully in front of the camera): glTF CCW
    # front faces have NEGATIVE signed area in y-down pixel space.
    area2 = (px1 - px0) * (py2 - py0) - (py1 - py0) * (px2 - px0)
    if double_sided is None:
        double_sided = torch.ones((n,), dtype=torch.bool, device=dev)
    front_facing = ~all_front | (area2 < 0.0) | double_sided

    valid = nondegenerate & any_front & on_screen & front_facing
    if tri_valid is not None:
        valid = valid & tri_valid

    # Orientation folding: a double-sided triangle fully in front of the camera
    # has one screen orientation — negate its rows when back-facing so its
    # interior is the all-D<=0 test; only camera-plane-crossing triangles keep
    # the double-sided flag. IEEE negation is exact, so every ratio is unchanged.
    det = x0p * e0a + y0p * e0b + w0 * e0c
    flip = double_sided & all_front & (det > 0.0)
    sgn = torch.where(flip, torch.full_like(det, -1.0), torch.ones_like(det))
    edge = torch.stack(
        [
            torch.stack([e0a * sgn, e0b * sgn, e0c * sgn], dim=-1),
            torch.stack([e1a * sgn, e1b * sgn, e1c * sgn], dim=-1),
            torch.stack([e2a * sgn, e2b * sgn, e2c * sgn], dim=-1),
        ],
        dim=1,
    )  # (N, 3, 3)
    qc = torch.stack([qa * sgn, qb * sgn, qc_ * sgn], dim=-1)
    rc = torch.stack([ra * sgn, rb * sgn, rc_ * sgn], dim=-1)
    double_sided = double_sided & ~all_front

    return TriangleSetup(
        edge=edge.to(torch.float32),
        q=qc.to(torch.float32),
        r=rc.to(torch.float32),
        bbox=bbox.to(torch.float32),
        valid=valid,
        double_sided=double_sided,
    )


REC = 24  # f32 slots per raster record


def pack_fused_records(setup: TriangleSetup, affine_z: bool = False) -> torch.Tensor:
    """(N, 24) f32 raster records — the rasterizer's input layout.

      [0:9]   e0/e1/e2 (A, B, C)       [9:12]  inv_A (sign-preserving reciprocal)
      [12:15] q coeffs                 [15:18] r coeffs
      [18]    sid: +1 single-sided, -1 double-sided, 0 dead
      [19:23] pixel bbox (x0, y0, x1, y1)      [23] pad

    ``affine_z``: for orthographic projections every vertex has w == 1, so
    z = r / qc is an affine plane; slots 12:15 then carry that plane and 15:18
    are zero."""
    n = setup.edge.shape[0]
    a = setup.edge[:, :, 0]
    eps = 1e-12
    small = torch.where(a < 0, torch.full_like(a, -eps), torch.full_like(a, eps))
    inv_a = 1.0 / torch.where(a.abs() < eps, small, a)
    sid = torch.where(
        setup.double_sided, torch.full((n,), -1.0, device=a.device), torch.ones(n, device=a.device)
    )
    sid = torch.where(setup.valid, sid, torch.zeros_like(sid))
    if affine_z:
        qc = setup.q[:, 2:3]
        zplane = setup.r / torch.where(qc == 0.0, torch.ones_like(qc), qc)
        mid = [zplane, torch.zeros((n, 3), dtype=torch.float32, device=a.device)]
    else:
        mid = [setup.q, setup.r]
    return torch.cat(
        [
            setup.edge.reshape(n, 9),
            inv_a,
            *mid,
            sid[:, None],
            setup.bbox,
            torch.zeros((n, REC - 23), dtype=torch.float32, device=a.device),
        ],
        dim=1,
    ).to(torch.float32).contiguous()
