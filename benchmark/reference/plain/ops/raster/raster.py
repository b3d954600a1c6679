# Frozen copy of androidrenderer_tpu_torch/ops/raster/raster.py at commit c15a27329e0a,
# part of the benchmark's plain reference: the plain walk alone, for every call (no kernel),
# without band mode; RECORD, when a list, collects each call's records for the raster bound.
"""The plain rasterizer: every raster call of the reference's frame.

Contract (from the records of ``setup.pack_fused_records``): coverage by the
three edge functions at integer pixel coordinates (all <= 0, or all >= 0 for
double-sided records), z = r/q (or the affine plane), accepted when
0 < z <= 1 (and z < z_limit), optionally alpha-tested against the triangle's
16x16 barycentric bitmap. Reversed-Z: the greatest z wins a pixel, ties going
to the higher triangle id. Depth clears to 0 and vis to -1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.plain.ops.raster.setup import TriangleSetup, pack_fused_records

# Elements of one evaluation patch batch in the plain version (keeps each
# batch's temporaries near 100 MB at the bench shapes).
_PATCH_BUDGET = 1 << 22

# Set to a list to record each call (the benchmark's bound counting).
RECORD = None


def rasterize(
    setup: TriangleSetup,
    height: int,
    width: int,
    depth_only: bool = False,
    affine_z: bool = False,
    z_limit: torch.Tensor | None = None,
    alpha_grid: torch.Tensor | None = None,
):
    """(depth (H, W) f32, vis (H, W) i32), or depth alone with ``depth_only``."""
    records = pack_fused_records(setup, affine_z=affine_z)
    if RECORD is not None:
        RECORD.append((records, height, width, depth_only, affine_z, z_limit, alpha_grid))
    return _reference_from_records(records, height, width, depth_only, affine_z, z_limit,
                                   alpha_grid)


def _reference_from_records(rec, height, width, depth_only, affine_z, z_limit, alpha_grid):
    """Evaluate each live triangle on its clipped bbox, in patches grouped by
    bbox size class (next power of two per axis), and combine the fragments with
    ``scatter_reduce_("amax")`` on the int64 key (bits(z) << 32 | id) — exact and
    independent of order."""
    npix = height * width
    keys = torch.zeros(npix + 1, dtype=torch.int64, device=rec.device)  # last = discard slot
    zl = None if z_limit is None else z_limit.reshape(-1)
    for tri, frag in patch_fragments(rec, height, width, affine_z):
        cov = frag.covered & (frag.z > 0.0) & (frag.z <= 1.0)
        if zl is not None:
            cov = cov & (frag.z < zl[frag.pix])
        if alpha_grid is not None:
            idx = alpha_bit_index(frag)
            b = tri.numel()
            words = torch.gather(
                alpha_grid[tri].to(torch.int32), 1, (idx >> 5).reshape(b, -1).to(torch.int64)
            ).reshape(idx.shape)
            cov = cov & (((words >> (idx & 31)) & 1) == 1)
        zbits = frag.z.contiguous().view(torch.int32).to(torch.int64)
        key = (zbits << 32) | tri.reshape(tri.shape + (1,) * (frag.z.dim() - 1))
        target = torch.where(cov, frag.pix, torch.full_like(frag.pix, npix))
        keys.scatter_reduce_(0, target.reshape(-1), key.reshape(-1), "amax")
    keys = keys[:npix].reshape(height, width)
    depth = (keys >> 32).to(torch.int32).view(torch.float32)
    if depth_only:
        return depth
    vis = torch.where(
        keys == 0, torch.full_like(keys, -1), keys & 0xFFFFFFFF
    ).to(torch.int32)
    return depth, vis


class Fragments(NamedTuple):
    """A batch of triangles evaluated on (B, ph, pw) patches at their bbox corners."""

    pix: torch.Tensor  # i64 target pixel index (clamped into the target)
    covered: torch.Tensor  # inside the clipped bbox and all three edge tests passed
    z: torch.Tensor  # f32
    d0: torch.Tensor  # f32 edge functions
    d1: torch.Tensor
    d2: torch.Tensor


def record_bboxes(rec, height, width):
    """(x0, y0, x1, y1, live) of each record's bbox clipped to the target;
    live = sid != 0 and a non-empty clipped bbox."""
    bx0 = torch.floor(rec[:, 19]).clamp(min=0).to(torch.int64)
    by0 = torch.floor(rec[:, 20]).clamp(min=0).to(torch.int64)
    bx1 = torch.ceil(rec[:, 21]).clamp(max=width - 1).to(torch.int64)
    by1 = torch.ceil(rec[:, 22]).clamp(max=height - 1).to(torch.int64)
    live = (rec[:, 18] != 0.0) & (bx1 >= bx0) & (by1 >= by0)
    return bx0, by0, bx1, by1, live


def patch_fragments(rec, height, width, affine_z):
    """Yield (triangle ids, Fragments) over every live record, in batches of one
    bbox size class and at most ``_PATCH_BUDGET`` patch pixels, each product and
    sum rounded on its own, IEEE division."""
    dev = rec.device
    bx0, by0, bx1, by1, live = record_bboxes(rec, height, width)
    ids = torch.nonzero(live).flatten()
    if not ids.numel():
        return
    lw = torch.ceil(torch.log2((bx1 - bx0 + 1)[ids].to(torch.float64))).to(torch.int64)
    lh = torch.ceil(torch.log2((by1 - by0 + 1)[ids].to(torch.float64))).to(torch.int64)
    cls = lw * 64 + lh
    for c in torch.unique(cls).tolist():
        pw, ph = 1 << (c // 64), 1 << (c % 64)
        members = ids[cls == c]
        step = max(1, _PATCH_BUDGET // (pw * ph))
        for s in range(0, members.numel(), step):
            tri = members[s:s + step]
            r = rec[tri]  # (B, 24)
            px = bx0[tri, None, None] + torch.arange(pw, device=dev)[None, None, :]
            py = by0[tri, None, None] + torch.arange(ph, device=dev)[None, :, None]
            inside = (px <= bx1[tri, None, None]) & (py <= by1[tri, None, None])
            yield tri, _evaluate(lambda k: r[:, k, None, None], px, py, inside, height, width,
                                 affine_z)


def _evaluate(col, px, py, inside, height, width, affine_z) -> Fragments:
    """The contract's edge tests and z at integer pixels (px, py); ``col(k)``
    is record slot k broadcast against them."""
    fx = px.to(torch.float32)
    fy = py.to(torch.float32)
    d0 = col(0) * fx + col(1) * fy + col(2)
    d1 = col(3) * fx + col(4) * fy + col(5)
    d2 = col(6) * fx + col(7) * fy + col(8)
    front = (d0 <= 0.0) & (d1 <= 0.0) & (d2 <= 0.0)
    back = (col(18) < 0.0) & (d0 >= 0.0) & (d1 >= 0.0) & (d2 >= 0.0)
    if affine_z:
        z = col(12) * fx + col(13) * fy + col(14)
    else:
        z = (col(15) * fx + col(16) * fy + col(17)) / (col(12) * fx + col(13) * fy + col(14))
    pix = (py * width + px).clamp(max=height * width - 1)
    return Fragments(pix, inside & (front | back), z, d0, d1, d2)


def alpha_bit_index(frag: Fragments) -> torch.Tensor:
    """The bit (vi * 16 + ui) of the 16x16 barycentric alpha grid each fragment tests."""
    sv = frag.d0 + frag.d1 + frag.d2
    inv = 1.0 / torch.where(sv == 0.0, torch.ones_like(sv), sv)

    def lattice(d):
        t = torch.nan_to_num(d * inv * 16.0, nan=0.0, posinf=15.0, neginf=0.0)
        return t.clamp(0.0, 15.0).to(torch.int32)

    return lattice(frag.d2) * 16 + lattice(frag.d1)
