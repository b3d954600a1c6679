"""``rasterize_binned`` — the port of the JAX package's window-binned rasterizer.

The JAX entry point (ops/raster/raster_binned.py::rasterize_binned, Pallas
kernel ``_binned_kernel``) is one TPU schedule of the raster family's shared
contract: per-window SMEM bins filled by a scalar Phase A and drained into
register accumulators. Its outputs are bit-identical to the bitmask kernel's
(raster_bitmask.py:34, raster_binned.py:42). On Hopper the whole family is one
hand-written CUDA kernel (csrc/raster.cu, see ops/raster/raster.py), so this entry
point keeps the JAX signature and launches that kernel with what its twin
computes: ``depth_only``, ``affine_z``, ``z_limit`` and ``alpha_grid``.

The exact alpha-test peel (ops/raster/masked.py) calls it with ``z_limit``.
"""

from __future__ import annotations

import torch

from androidrenderer_tpu_torch.ops.raster.raster import raster_records
from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup, pack_fused_records


def rasterize_binned(
    setup: TriangleSetup,
    height: int,
    width: int,
    num_slabs: int = 2,
    chunk: int = 1024,
    cap: int = 14,
    kb: int = 8,
    depth_only: bool = False,
    affine_z: bool = False,
    interpret: bool = False,
    win_h: int = 8,
    unroll: int = 4,
    pa_unroll: int = 1,
    debug_mode: int = 0,
    z_limit: torch.Tensor | None = None,  # (H, W) reversed-Z upper bound (peel)
    alpha_grid: torch.Tensor | None = None,  # (N, 8) i32 barycentric alpha bitmaps
    row_offset: int = 0,  # band mode: the target's first frame row (ops/raster/raster.py)
):
    """(depth (H, W) f32, vis (H, W) i32), or depth alone with ``depth_only``.

    A CUDA setup launches csrc/raster.cu (counted in ``rasterize_binned.launches``);
    a CPU setup runs the plain version; any other device raises.

    The TPU schedule's tunables (``num_slabs``, ``chunk``, ``cap``, ``kb``,
    ``win_h``, ``unroll``, ``pa_unroll``) and ``interpret`` are accepted and
    have no effect: they size VMEM slabs, SMEM bins and Mosaic loops that the
    Hopper kernel does not have, and they never changed the output. So do the
    TPU layout limits (width % 128, width <= 2048, the packed row fields): the
    Hopper kernel takes any size. ``debug_mode`` other than 0 (the JAX kernel's
    profiling stubs, which skip parts of the work) raises."""
    del num_slabs, chunk, cap, kb, interpret, win_h, unroll, pa_unroll
    if debug_mode != 0:
        raise ValueError(
            f"debug_mode={debug_mode}: the TPU kernel's profiling stubs are not ported"
        )
    records = pack_fused_records(setup, affine_z=affine_z)
    return raster_records(
        records, height, width, depth_only, affine_z, z_limit, alpha_grid,
        counter=rasterize_binned, row_offset=row_offset,
    )


rasterize_binned.launches = 0
