"""Frustum culling at triangle grain (hi_z_culling.comp:85-99 frustum semantics).

The port of the JAX package's ``ops/culling.py::frustum_cull_triangles``. The
two-phase HiZ occlusion path is not ported yet (ROADMAP.md): the raster-only
frame runs with ``occlusion_culling=False``.
"""

from __future__ import annotations

import torch


def frustum_cull_triangles(
    corners: torch.Tensor,  # (N, 3, 3) world-space baked corner table
    view: torch.Tensor,  # (4, 4)
    frustum: torch.Tensor,  # (4,) [fx.x, fx.z, fy.y, fy.z]
    z_near,
    tri_valid: torch.Tensor,  # (N,) bool
) -> torch.Tensor:
    """(N,) bool — conservative separating-plane test: a triangle is culled only
    when all three corners lie outside ONE frustum plane (or all are nearer than
    the near plane), so it removes only triangles that can cover no pixel."""
    wx = corners[:, :, 0]
    wy = corners[:, :, 1]
    wz = corners[:, :, 2]
    x = view[0, 0] * wx + view[0, 1] * wy + view[0, 2] * wz + view[0, 3]
    y = view[1, 0] * wx + view[1, 1] * wy + view[1, 2] * wz + view[1, 3]
    z = view[2, 0] * wx + view[2, 1] * wy + view[2, 2] * wz + view[2, 3]
    lt = z * frustum[1] - x * frustum[0]  # > 0 = inside the left plane
    rt = z * frustum[1] + x * frustum[0]
    tp = z * frustum[3] - y * frustum[2]
    bt = z * frustum[3] + y * frustum[2]
    out = (
        (lt <= 0.0).all(dim=1)
        | (rt <= 0.0).all(dim=1)
        | (tp <= 0.0).all(dim=1)
        | (bt <= 0.0).all(dim=1)
        | (-z < z_near).all(dim=1)  # all corners nearer than the near plane
    )
    return tri_valid & ~out
