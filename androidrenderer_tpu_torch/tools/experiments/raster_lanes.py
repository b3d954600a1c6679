"""``rasterize_lanes`` — the port of the sublane-batched raster study.

The JAX entry point (tools/experiments/raster_lanes.py::rasterize_lanes, Pallas
kernel ``_lanes_kernel``) folds eight touches per issued TPU vector instruction,
fed by win8 window bitmask tables (``build_window_masks``) and the TPU VMEM
row layout of ``records.pack_lane_records``. That machinery, and the timing
stubs behind ``debug_mode``, exist to feed the TPU's scalar and vector units and
are not ported. On Hopper the raster family is one hand-written CUDA kernel
(csrc/raster.cu, see ops/raster/raster.py) that reads the fused record layout
(``pack_fused_records``); this entry point keeps the JAX signature and launches
it with what its twin computes: ``depth_only``, ``affine_z``, ``z_limit`` and
``alpha_grid``. Ties go to the higher triangle id, the lexicographic (z, id)
max of the TPU fold.

The TPU kernel evaluates ``A0 + (b0*y + c0)`` in that association and may
contract products into its adds (raster_lanes.py:168-196); the Hopper kernel
rounds ``(A*x + B*y) + C`` one operation at a time. The JAX suite holds the
study to the XLA rasterizer and to ``rasterize_binned`` at depth rtol 5e-6,
visibility differing only where depth does (test_raster_lanes.py:49-55).
"""

from __future__ import annotations

import torch

from androidrenderer_tpu_torch.ops.raster.raster import raster_records
from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup, pack_fused_records


def rasterize_lanes(
    setup: TriangleSetup,
    height: int,
    width: int,
    num_slabs: int = 2,
    chunk: int = 1024,
    kb: int = 8,
    unroll: int = 2,
    depth_only: bool = False,
    affine_z: bool = False,
    interpret: bool = False,
    z_limit: torch.Tensor | None = None,
    alpha_grid: torch.Tensor | None = None,
    debug_mode: int = 0,
):
    """(depth (H, W) f32, vis (H, W) i32), or depth alone with ``depth_only``.

    A CUDA setup launches csrc/raster.cu (counted in ``rasterize_lanes.launches``);
    a CPU setup runs the plain version; any other device raises. The TPU
    schedule's tunables (``num_slabs``, ``chunk``, ``kb``, ``unroll``),
    ``interpret`` and the TPU layout limits (width % 128, width <= 2048, height
    <= 2040, N < 2^24) have no effect; ``debug_mode`` other than 0 raises."""
    del num_slabs, chunk, kb, unroll, interpret
    if debug_mode != 0:
        raise ValueError(
            f"debug_mode={debug_mode}: the TPU kernel's profiling stubs are not ported"
        )
    records = pack_fused_records(setup, affine_z=affine_z)
    return raster_records(
        records, height, width, depth_only, affine_z, z_limit, alpha_grid,
        counter=rasterize_lanes,
    )


rasterize_lanes.launches = 0
