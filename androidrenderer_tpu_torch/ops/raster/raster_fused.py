"""``rasterize_fused`` and ``rasterize_hybrid`` — the port of the JAX package's
fused touch-expansion rasterizer and its splat hybrid.

The JAX entry points (ops/raster/raster_fused.py::rasterize_fused and
::rasterize_hybrid, Pallas kernel ``_fused_kernel``) are one TPU schedule of the
raster family's shared contract: a scalar Phase A stages (triangle, window)
touches in SMEM and a vector Phase B retires each with a window
read-modify-write. On Hopper the family is one hand-written CUDA kernel
(csrc/raster.cu, see ops/raster/raster.py); these entry points keep the JAX
signatures and launch it with what their twins compute: ``depth_only`` and
``affine_z``. tools/bench_raster.py calls the JAX pair.
"""

from __future__ import annotations

from androidrenderer_tpu_torch.ops.raster.raster import raster_records
from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup, pack_fused_records

WIN_H = 32

# The TPU tunables ``rasterize_hybrid`` forwards to its window kernel, by backend.
_HYBRID_TUNABLES = {
    "fused": {"chunk", "stage_cap", "kb", "compact", "win_h", "accum_bufs"},
    "binned": {"chunk", "cap", "kb", "win_h", "unroll", "pa_unroll", "debug_mode"},
}


def rasterize_fused(
    setup: TriangleSetup,
    height: int,
    width: int,
    num_slabs: int = 2,
    chunk: int = 1024,
    stage_cap: int = 2048,
    kb: int = 2,
    depth_only: bool = False,
    affine_z: bool = False,
    compact: bool = False,
    interpret: bool = False,
    win_h: int = WIN_H,
    accum_bufs: int = 1,
):
    """(depth (H, W) f32, vis (H, W) i32), or depth alone with ``depth_only``.

    A CUDA setup launches csrc/raster.cu (counted in ``rasterize_fused.launches``);
    a CPU setup runs the plain version; any other device raises.

    ``compact`` keeps the JAX rule (raster_fused.py:427): it reorders triangle
    ids, so it is valid only with ``depth_only``, where the output does not
    change; the Hopper kernel skips dead records itself and needs no compaction.
    The TPU schedule's tunables (``num_slabs``, ``chunk``, ``stage_cap``,
    ``kb``, ``win_h``, ``accum_bufs``), ``interpret`` and the TPU layout limits
    (width % 128, width <= 2048, the 5-bit row field) have no effect."""
    del num_slabs, chunk, stage_cap, kb, interpret, win_h, accum_bufs
    if compact and not depth_only:
        raise ValueError("compact reorders triangle ids; only valid with depth_only")
    records = pack_fused_records(setup, affine_z=affine_z)
    return raster_records(
        records, height, width, depth_only, affine_z, None, None, counter=rasterize_fused
    )


rasterize_fused.launches = 0


def rasterize_hybrid(
    setup: TriangleSetup,
    height: int,
    width: int,
    num_slabs: int = 2,
    depth_only: bool = False,
    affine_z: bool = False,
    interpret: bool = False,
    backend: str = "fused",
    **fused_kwargs,
):
    """(depth (H, W) f32, vis (H, W) i32), or depth alone with ``depth_only``.

    The JAX hybrid (raster_fused.py:512-586) retires triangles whose integer
    bbox is one pixel with an XLA scatter-max outside its Pallas kernel, because
    every touch costs the TPU kernel a whole (32, 128) window. The Hopper kernel
    spends one warp on such a triangle and covers it itself, so this
    entry point sends every triangle through the kernel: one launch, counted in
    ``rasterize_hybrid.launches``; a CPU setup runs the plain version. The JAX
    hybrid's splat and kernel agree to a few ULP (test_raster_binned.py:230-238);
    here there is one evaluation, so no such seam.

    ``backend`` ("fused" or "binned") picked the TPU window kernel and, with
    ``num_slabs``, ``interpret`` and the tunables in ``fused_kwargs``, has no
    effect; a keyword the chosen JAX kernel does not take raises TypeError, and
    so does ``debug_mode`` other than 0 or ``compact`` without ``depth_only``."""
    del num_slabs, interpret
    if backend not in _HYBRID_TUNABLES:
        raise ValueError(f"backend must be 'fused' or 'binned', got {backend!r}")
    unknown = set(fused_kwargs) - _HYBRID_TUNABLES[backend]
    if unknown:
        raise TypeError(f"rasterize_hybrid(backend={backend!r}) got unexpected {sorted(unknown)}")
    if fused_kwargs.get("debug_mode", 0) != 0:
        raise ValueError("debug_mode: the TPU kernel's profiling stubs are not ported")
    if fused_kwargs.get("compact", False) and not depth_only:
        raise ValueError("compact reorders triangle ids; only valid with depth_only")
    records = pack_fused_records(setup, affine_z=affine_z)
    return raster_records(
        records, height, width, depth_only, affine_z, None, None, counter=rasterize_hybrid
    )


rasterize_hybrid.launches = 0
