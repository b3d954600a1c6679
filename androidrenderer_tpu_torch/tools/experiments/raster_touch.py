"""``rasterize_touch`` — the port of the touch-expansion raster study.

The JAX entry point (tools/experiments/raster_touch.py::rasterize_touch, Pallas
kernel ``_touch_kernel``) expands triangles in XLA into (8, 128)-window touches
(``expand_touches``) and retires K touches per batch in a vector pass. That
expansion and its capacity exist to feed the TPU's vector unit and are not
ported. On Hopper the raster family is one hand-written CUDA kernel
(csrc/raster.cu, see ops/raster/raster.py); this entry point keeps the JAX
signature and launches it with ``depth_only``, on the fused record layout
(``pack_fused_records``).

Where the contracts differ:

- The TPU kernel keeps at most ``touches_per_slab`` touches per slab and drops
  the rest (raster_touch.py:284-287, 155-158; the true counts are returned by
  ``expand_touches`` as a diagnostic). The Hopper kernel drops no touch, so it
  draws every triangle whatever ``touches_per_slab`` says.
- The TPU kernel evaluates ``A*x + B*y + C`` and ``r/q`` in vector code that
  the compiler may contract (raster_touch.py:228-236), and tests coverage on
  whole windows; the Hopper kernel rounds each product and sum on its own and
  walks each triangle's clipped bbox. The JAX suite holds the study at 99.5% of
  depth within rtol 1e-6 of the XLA rasterizer (test_raster_touch.py:33-36).
"""

from __future__ import annotations

from androidrenderer_tpu_torch.ops.raster.raster import raster_records
from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup, pack_fused_records


def rasterize_touch(
    setup: TriangleSetup,
    height: int,
    width: int,
    num_slabs: int = 4,
    chunk: int = 1024,
    k_batch: int = 16,
    touches_per_slab: int | None = None,
    depth_only: bool = False,
    interpret: bool = False,
):
    """(depth (H, W) f32, vis (H, W) i32), or depth alone with ``depth_only``.

    A CUDA setup launches csrc/raster.cu (counted in ``rasterize_touch.launches``);
    a CPU setup runs the plain version; any other device raises. The TPU
    schedule's tunables (``num_slabs``, ``chunk``, ``k_batch``,
    ``touches_per_slab``), ``interpret`` and the TPU layout limits (height %
    (8 * num_slabs), width % 128) have no effect."""
    del num_slabs, chunk, k_batch, touches_per_slab, interpret
    records = pack_fused_records(setup)
    return raster_records(
        records, height, width, depth_only, False, None, None, counter=rasterize_touch
    )


rasterize_touch.launches = 0
