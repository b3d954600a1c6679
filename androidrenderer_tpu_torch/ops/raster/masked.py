"""Alpha-masked rasterization via depth peeling — the exact alpha-test path.

The port of the JAX package's ``ops/raster/masked.py``. The reference's masked
pipelines sample base-color alpha and discard below the cutoff
(material_pipelines.cpp:14-175). A visibility-buffer rasterizer decides
coverage before shading, so the alpha test becomes depth peeling: rasterize the
masked subset, evaluate alpha at the winning fragments, and re-rasterize with a
per-pixel z upper bound to peel the failed layers until every pixel has an
alpha-passing fragment or none. ``config.alpha_bitmap=False`` takes this path;
the bitmap path tests a per-triangle 16x16 lattice inside the raster instead.

Each peel layer is one call of ``rasterize_binned`` with ``z_limit`` (the CUDA
kernel on the card, its plain version on the CPU). The JAX package's off-TPU
branch (``bin_triangles`` + the XLA raster) is its own fallback and is not ported
(ROADMAP.md, port queue item 5). ``row_offset`` peels a band of a sharded frame
(rows [row_offset, row_offset + H) of it), as the band raster does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from androidrenderer_tpu_torch.ops import texture as tex
from androidrenderer_tpu_torch.ops.raster.raster_binned import rasterize_binned
from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup
from androidrenderer_tpu_torch.scene.material_storage import START_ALIGN
from androidrenderer_tpu_torch.scene.scene import SceneArrays


def _uv_planes(scene: SceneArrays, setup: TriangleSetup) -> torch.Tensor:
    """(N, 3 = coeff, 2 = uv): f_k(p) = sum_i edge_i * uv_i[k], affine in pixels."""
    idx = scene.tri_indices.to(torch.int64)
    uvs = scene.uvs
    e = setup.edge  # (N, 3, 3)
    return (
        e[:, 0, :, None] * uvs[idx[:, 0]][:, None, :]
        + e[:, 1, :, None] * uvs[idx[:, 1]][:, None, :]
        + e[:, 2, :, None] * uvs[idx[:, 2]][:, None, :]
    )


def _triangle_lod_uv(scene: SceneArrays, setup: TriangleSetup) -> torch.Tensor:
    """(N,) size-free LOD per triangle, evaluated at the bbox centre: a
    per-triangle footprint in place of the reference's hardware derivatives
    (within one level at foliage scales)."""
    f = _uv_planes(scene, setup)
    q = setup.q  # (N, 3)
    cx = 0.5 * (setup.bbox[:, 0] + setup.bbox[:, 2])
    cy = 0.5 * (setup.bbox[:, 1] + setup.bbox[:, 3])
    fv = f[:, 0] * cx[:, None] + f[:, 1] * cy[:, None] + f[:, 2]  # (N, 2)
    qv = q[:, 0] * cx + q[:, 1] * cy + q[:, 2]
    inv_q = 1.0 / torch.where(qv == 0.0, torch.ones_like(qv), qv)
    uv_c = fv * inv_q[:, None]
    duvdx = (f[:, 0] - uv_c * q[:, 0:1]) * inv_q[:, None]
    duvdy = (f[:, 1] - uv_c * q[:, 1:2]) * inv_q[:, None]
    return tex.compute_lod_uv(duvdx, duvdy)


def pack_alpha_planes(scene: SceneArrays, setup: TriangleSetup) -> torch.Tensor:
    """(N, 13) per-triangle rows for single-gather alpha evaluation: uv-plane
    coefficients (6) + s-plane (3) + packed texture meta (1) + triangle LOD (1)
    + alpha factor (1) + cutoff (1)."""
    f = _uv_planes(scene, setup)
    e = setup.edge
    s_plane = e[:, 0] + e[:, 1] + e[:, 2]  # (N, 3), summed in edge order
    mat = scene.tri_material.to(torch.int64)
    tex_id = scene.mat_texture_ids[mat][:, 0].to(torch.int64)
    meta = torch.div(scene.tex_start[tex_id], START_ALIGN, rounding_mode="floor") * 16 \
        + scene.tex_log2b[tex_id]
    lod_tri = _triangle_lod_uv(scene, setup)
    return torch.cat(
        [
            f[:, :, 0], f[:, :, 1], s_plane,
            meta.to(torch.float32)[:, None],
            lod_tri[:, None],
            scene.mat_base_color[mat][:, 3:4],
            scene.mat_alpha[mat][:, 1:2],
        ],
        dim=1,
    ).to(torch.float32)


def _sample_alpha(
    scene: SceneArrays, setup: TriangleSetup, vis: torch.Tensor, row_offset: int = 0,
    alpha_planes: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha, cutoff) (H, W) each: base-color alpha x factor at the winning
    fragments, at the triangle's LOD. Pass ``alpha_planes`` (pack_alpha_planes,
    reused across peel layers) to evaluate with one row gather + one texel gather."""
    if alpha_planes is None:
        alpha_planes = pack_alpha_planes(scene, setup)
    tid = torch.clamp(vis, min=0).to(torch.int64)
    row = alpha_planes[tid]  # (H, W, 13) — the one gather
    h, w = vis.shape
    px = torch.arange(w, dtype=torch.float32, device=vis.device)[None, :]
    py = torch.arange(h, dtype=torch.float32, device=vis.device)[:, None] + row_offset
    fu = row[..., 0] * px + row[..., 1] * py + row[..., 2]
    fv = row[..., 3] * px + row[..., 4] * py + row[..., 5]
    sv = row[..., 6] * px + row[..., 7] * py + row[..., 8]
    inv_s = 1.0 / torch.where(sv == 0.0, torch.ones_like(sv), sv)
    uv = torch.stack([fu * inv_s, fv * inv_s], dim=-1)
    meta = torch.round(row[..., 9]).to(torch.int32)
    log2b = meta & 15
    start = (meta >> 4) * START_ALIGN
    lod = torch.minimum(
        torch.round(row[..., 10] + log2b.to(torch.float32)).clamp(min=0),
        log2b.to(torch.float32),
    ).to(torch.int32)
    s = tex.sample_bilinear(scene.textures, start, log2b, uv, lod)
    return s[..., 3] * row[..., 11], row[..., 12]


def rasterize_masked_peeled(
    scene: SceneArrays,
    setup_masked: TriangleSetup,  # setup with valid &= masked
    base_depth: torch.Tensor,  # (H, W) opaque depth
    base_vis: torch.Tensor,  # (H, W) opaque visibility
    layers: int = 3,
    row_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth, vis) of the opaque buffers merged with the alpha-tested masked
    geometry: ``layers`` peel layers, each keeping the first alpha-passing
    fragment per pixel and pushing ``z_limit`` behind the ones that fail; a
    masked fragment wins where it is nearer than the opaque one (reversed-Z max)."""
    height, width = base_depth.shape
    aplanes = pack_alpha_planes(scene, setup_masked)
    z_limit = torch.full((height, width), float("inf"), dtype=torch.float32,
                         device=base_depth.device)
    out_depth = torch.zeros_like(base_depth)
    out_vis = torch.full_like(base_vis, -1)
    settled = torch.zeros((height, width), dtype=torch.bool, device=base_depth.device)
    for layer in range(layers):
        d, v = rasterize_binned(
            setup_masked, height, width, z_limit=None if layer == 0 else z_limit,
            row_offset=row_offset,
        )
        covered = v >= 0
        alpha, cutoff = _sample_alpha(scene, setup_masked, v, row_offset, alpha_planes=aplanes)
        passes = covered & (alpha >= cutoff)
        take = passes & ~settled
        out_depth = torch.where(take, d, out_depth)
        out_vis = torch.where(take, v, out_vis)
        settled = settled | passes | ~covered
        z_limit = torch.where(covered & ~passes, d, z_limit)

    masked_wins = (out_vis >= 0) & (out_depth > base_depth)
    depth = torch.where(masked_wins, out_depth, base_depth)
    vis = torch.where(masked_wins, out_vis, base_vis)
    return depth, vis
