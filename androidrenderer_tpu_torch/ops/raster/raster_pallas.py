"""``rasterize_pallas`` — the port of the JAX package's span-scalar rasterizer.

The JAX entry point (ops/raster/raster_pallas.py::rasterize_pallas, Pallas
kernel ``_raster_kernel``) buckets its own records (``pack_records``: signed
id + 1 in slot 15) by slab and walks each triangle's (8, 128) windows
sequentially, clipping single-sided triangles to a per-strip x-span. It computes
the raster family's contract without ``affine_z``, ``z_limit`` or an alpha grid
(raster_pallas.py:255-263). On Hopper the family is one hand-written CUDA kernel
(csrc/raster.cu, see ops/raster/raster.py), fed the fused record layout; this
entry point keeps the JAX signature and launches it with ``depth_only``.

Where the contracts differ: the TPU kernel's span clip (raster_pallas.py:
182-216) bounds each 8-row strip by -(B*y + C)/A rounded in float32, so a
fragment at a span end can in principle be skipped there; the Hopper kernel
walks row spans too, but widened by a rounding margin wide enough that no
pixel its rounded test accepts is skipped (bit-equal to the plain version,
which tests every pixel of the bbox). The JAX package's own test holds the span
kernel to the XLA rasterizer at depth rtol 1e-6 with visibility differing only
where depth does (tests/test_raster_pallas.py:38-62), and the port's test holds
this entry point to the span kernel at that tolerance.
"""

from __future__ import annotations

from androidrenderer_tpu_torch.ops.raster.raster import raster_records
from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup, pack_fused_records


def rasterize_pallas(
    setup: TriangleSetup,
    height: int,
    width: int,
    num_slabs: int = 4,
    chunk: int = 512,
    depth_only: bool = False,
    interpret: bool = False,
):
    """(depth (H, W) f32, vis (H, W) i32), or depth alone with ``depth_only``.

    A CUDA setup launches csrc/raster.cu (counted in ``rasterize_pallas.launches``);
    a CPU setup runs the plain version; any other device raises. ``num_slabs``,
    ``chunk``, ``interpret`` and the TPU layout limits (height % (8 *
    num_slabs), width % 128) have no effect."""
    del num_slabs, chunk, interpret
    records = pack_fused_records(setup)
    return raster_records(
        records, height, width, depth_only, False, None, None, counter=rasterize_pallas
    )


rasterize_pallas.launches = 0
