"""The yardstick of the hand kernels: the card's peaks and each call's least time.

A frozen copy of chip_smoke.py's bound arithmetic (``raster_bound``,
``traverse_bound`` and their constants, at commit c15a27329e0a). The work is
counted by the reference's plain walks (benchmark/reference/plain), never by a
kernel's counters: the fragment walk over each raster call's records, and the
BVH walk's own counts for each trace. So the bound of a frame reads the same
work whatever implements the kernels.
"""

from __future__ import annotations

import torch

# The card's peaks (NVIDIA's H100 SXM data sheet: HBM3 rate, and float32
# outside the tensor cores). The data sheet's 67 TFLOP/s counts a fused
# multiply-add as two operations; the hand kernels are built with -fmad=false
# and issue none, so one float32 instruction does one operation, at half that
# rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2

# Operations of one test, as csrc/traverse.cu does them: a slab test is 6
# subtractions, 6 products, 6 pairwise min/max, 4 min/max folds and 3 compares
# (25); a Moller-Trumbore test is two cross products (2 x 9), three dot
# products and the determinant's (4 x 5), the guard, divide and 3 scalings (6),
# the tvec differences (3), u + v (1) and 7 compares (55); the bitmap lookup 2
# products, 4 clamps, 2 conversions and 6 integer operations (14); examining a
# lookahead target, its slot compare (1), and its slab test where the slot is
# a node (25).
SLAB_OPS, MT_OPS, BITMAP_OPS, TARGET_OPS = 25, 55, 14, 1
ROW_BYTES = 109 * 4
WORK_COUNTS = ("steps", "leaf_visits", "inner_visits", "lookahead_targets",
               "lookahead_slabs", "bitmap_lookups")


def _least_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def raster_bound_ms(records, height, width, depth_only, affine_z, z_limit, alpha_grid) -> float:
    """The least ms the card could take for one raster call, from the work its
    records need, counted with the plain fragment walk over each live record's
    clipped bbox. Bytes, each input read once and each output written once:
    96 B for each live record (sid != 0 and a non-empty clipped bbox), 4 B for
    each dead one; 4 B of z_limit for each distinct pixel a fragment in depth
    range tests; 4 B for each distinct alpha word a fragment tests; depth (f32)
    and vis (i32) written for every pixel. Operations, in float32, per covered
    pixel: 12 for the edge tests and the z (1 plane, 4, with affine_z; else 2
    planes and a divide, 9); 7 per alpha test."""
    from benchmark.reference.plain.ops.raster.raster import (
        alpha_bit_index, patch_fragments, record_bboxes,
    )

    rec = records
    n = rec.shape[0]
    live = record_bboxes(rec, height, width)[4]
    n_live = int(live.sum())
    zl = None if z_limit is None else z_limit.reshape(-1)
    zl_read = torch.zeros(height * width, dtype=torch.bool, device=rec.device)
    words = torch.zeros(n * 8, dtype=torch.bool, device=rec.device)
    covered = alpha_tests = 0
    for tri, frag in patch_fragments(rec, height, width, affine_z):
        covered += int(frag.covered.sum())
        tested = frag.covered & (frag.z > 0.0) & (frag.z <= 1.0)
        if zl is not None:
            zl_read[frag.pix[tested]] = True
            tested = tested & (frag.z < zl[frag.pix])
        if alpha_grid is not None:
            word = tri[:, None, None] * 8 + (alpha_bit_index(frag) >> 5)
            words[word[tested]] = True
            alpha_tests += int(tested.sum())
    nbytes = (n_live * 96 + (n - n_live) * 4 + height * width * 4 * (1 if depth_only else 2)
              + int(zl_read.sum()) * 4 + int(words.sum()) * 4)
    ops = covered * (12 + (4 if affine_z else 9)) + alpha_tests * 7
    return _least_ms(nbytes, ops)


def traverse_bound_ms(work, rows: int, rays: int, active_rays=None,
                      per_ray_tmin=False) -> float:
    """The least ms the card could take for one trace, from the work the plain
    walk made (``work``: the sums of its six counts, in ``WORK_COUNTS`` order;
    ``rows``: the distinct node rows it read). Operations, each charged where
    the walk makes it: a slab test per step, 4 Moller-Trumbore tests per leaf
    visit, a bitmap lookup per slot that passed, and per inner visit the
    lookahead targets examined up to the first hit and the slab tests run on
    them. Bytes: each distinct node row read once (109 x 4 B); for every ray
    its outputs t, slot, u, v, steps (20 B) and its active flag (1 B, where the
    call passes a mask) once; for each ray that walks its origin and direction
    (24 B) and its tmin (4 B, where the call passes one per ray) once."""
    w = dict(zip(WORK_COUNTS, (int(x) for x in work)))
    ops = (w["steps"] * SLAB_OPS + w["leaf_visits"] * 4 * MT_OPS
           + w["bitmap_lookups"] * BITMAP_OPS + w["lookahead_targets"] * TARGET_OPS
           + w["lookahead_slabs"] * SLAB_OPS)
    masked = active_rays is not None
    walking = active_rays if masked else rays
    nbytes = rows * ROW_BYTES + rays * (20 + masked) + walking * (24 + 4 * per_ray_tmin) + 5
    return _least_ms(nbytes, ops)
