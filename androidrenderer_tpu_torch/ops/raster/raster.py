"""The rasterizer: a CUDA kernel for Hopper and its plain PyTorch version.

``rasterize`` is the port of the JAX package's ``rasterize_bitmask`` (the Pallas
kernel ``raster_bitmask.py::_bitmask_kernel``) with its signature minus the TPU
tunables. On a CUDA tensor it launches ``csrc/raster.cu``; on a CPU tensor it
runs ``rasterize_reference``. There is no fallback from one to the other. The
other entry points of the raster family (``raster_binned.py``,
``raster_fused.py``, ``raster_pallas.py``) launch the same kernel through
``raster_records``, each counting its own launches.

The kernel source is compiled with nvcc for ``sm_90a`` at first use, into
``build/torch_kernels/`` at the repository root, as a shared library with a
plain C interface loaded through ctypes (``ops/cuda_build.py``).
``prepare_raster`` allocates one call's outputs and scratch and returns its
launch, which measurements time alone; ``work_counts`` reads the work counts
the kernel leaves in its scratch. ``rasterize_spans`` is the plain mirror of
the kernel's work split and margin-widened row spans, for the tests.

Contract (both versions, from the records of ``setup.pack_fused_records``):
coverage by the three edge functions at integer pixel coordinates (all <= 0,
or all >= 0 for double-sided records), z = r/q (or the affine plane), accepted
when 0 < z <= 1 (and z < z_limit), optionally alpha-tested against the
triangle's 16x16 barycentric bitmap. Reversed-Z: the greatest z wins a pixel,
ties going to the higher triangle id. Depth clears to 0 and vis to -1.

Band mode (``row_offset``): the target is rows [row_offset, row_offset +
height) of a taller frame. Setups stay in full-frame pixel space, pixel (x, y)
of the target is evaluated at (x, row_offset + y), and each bbox clips to the
band, so a band equals those rows of the full raster bit for bit.
"""

from __future__ import annotations

from ctypes import c_int, c_void_p
from typing import NamedTuple

import torch

from androidrenderer_tpu_torch.ops.cuda_build import Library
from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup, pack_fused_records

# Elements of one evaluation patch batch in the plain version (keeps each
# batch's temporaries near 100 MB at the bench shapes).
_PATCH_BUDGET = 1 << 22

_vp, _ci = c_void_p, c_int
LIBRARY = Library("raster.cu", {
    "raster_launch": [_vp, _ci, _ci, _ci, _vp, _vp, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _ci],
})

# The kernel's work counters (csrc/raster.cu, ``counts``), in order.
WORK_COUNTS = ("small", "large", "large_units", "evaluated", "bbox_pixels")

# The kernel's work split and span margin, mirrored by ``rasterize_spans``: a
# work unit is a record's bbox when it fits one tile, else one tile of it; an
# edge with |A| below SPAN_MIN_A bounds no span; each span bound is widened by
# 1 pixel + SPAN_REL * (max |x| + (|B y| + |C|) / |A|).
TILE_ROWS, TILE_COLS = 32, 128
SPAN_MIN_A = 1e-12
SPAN_REL = 2.0 ** -19


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, records are on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rasterize(
    setup: TriangleSetup,
    height: int,
    width: int,
    depth_only: bool = False,
    affine_z: bool = False,
    z_limit: torch.Tensor | None = None,
    alpha_grid: torch.Tensor | None = None,
    row_offset: int = 0,
):
    """(depth (H, W) f32, vis (H, W) i32), or depth alone with ``depth_only``:
    rows [row_offset, row_offset + height) of the frame ``setup`` was made for.

    A CUDA setup launches the kernel (counted in ``rasterize.launches``); a CPU
    setup runs ``rasterize_reference``; any other device raises."""
    records = pack_fused_records(setup, affine_z=affine_z)
    return raster_records(
        records, height, width, depth_only, affine_z, z_limit, alpha_grid, counter=rasterize,
        row_offset=row_offset,
    )


rasterize.launches = 0


def raster_records(records, height, width, depth_only, affine_z, z_limit, alpha_grid,
                   counter, row_offset: int = 0):
    """Rasterize packed records on their own device: the kernel for CUDA tensors
    (adding one to ``counter.launches``, the calling entry point's count), the
    plain version for CPU tensors; any other device raises. Every entry point of
    the raster family (rasterize, rasterize_binned, rasterize_fused,
    rasterize_hybrid, rasterize_pallas) ends here."""
    if records.device.type == "cpu":
        return _reference_from_records(
            records, height, width, depth_only, affine_z, z_limit, alpha_grid,
            row_offset=row_offset,
        )
    call = prepare_raster(records, height, width, depth_only, affine_z, z_limit, alpha_grid,
                          row_offset=row_offset)
    call.launch()
    counter.launches += 1
    return call.outputs


class RasterCall(NamedTuple):
    """One kernel call with its buffers allocated: ``launch()`` enqueues it on
    the current stream (clear, compaction, scan, raster, resolve) into
    ``outputs``; ``counts`` (8 int64 on the card) then holds its work counts."""

    launch: object
    outputs: object
    counts: torch.Tensor


def prepare_raster(records, height, width, depth_only, affine_z, z_limit, alpha_grid,
                   library=LIBRARY, row_offset: int = 0):
    """Check the inputs of a kernel call and allocate its outputs and scratch
    (``torch.empty``: the kernel allocates nothing). Launches nothing and counts
    nothing; ``raster_records`` launches once and counts it. ``library``: a
    build of another source with raster_launch's signature (tools/raster_cuts.py)."""
    if records.device.type != "cuda":
        raise ValueError(f"the rasterizer runs on cuda or cpu tensors, got {records.device}")
    n = records.shape[0]
    if not 0 <= row_offset < 2**31 - height:
        raise ValueError(f"row_offset {row_offset} is outside the kernel's int32 rows")
    if n >= 2**31 or height * width >= 2**31:
        raise ValueError(f"{n} triangles into {height}x{width} exceeds the kernel's int32 indexing")
    dev = records.device
    _check(records, "records", torch.float32, (n, 24), dev)
    if records.data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned (the kernel reads them as float4)")
    if z_limit is not None:
        _check(z_limit, "z_limit", torch.float32, (height, width), dev)
    if alpha_grid is not None:
        _check(alpha_grid, "alpha_grid", torch.int32, (n, 8), dev)
    lib = library.load()
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    if depth_only:
        keys = vis = None
    else:
        keys = torch.empty((height, width), dtype=torch.int64, device=dev)
        vis = torch.empty((height, width), dtype=torch.int32, device=dev)
    # Tile offsets of the large records (n u64), then the small list, the large
    # list and the large records' tile counts (n i32 each).
    work = torch.empty(5 * n, dtype=torch.int32, device=dev)
    counts = torch.empty(8, dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        with torch.cuda.device(dev):
            err = lib.raster_launch(
                records.data_ptr(), n, height, width, ptr(z_limit), ptr(alpha_grid),
                int(depth_only), int(affine_z), ptr(keys), depth.data_ptr(), ptr(vis),
                work.data_ptr(), counts.data_ptr(), stream, int(row_offset),
            )
        if err != 0:
            raise RuntimeError(f"raster_launch failed with cudaError_t {err}")

    return RasterCall(launch, depth if depth_only else (depth, vis), counts)


def work_counts(counts: torch.Tensor) -> dict:
    """The kernel's work counts by name (reads the device: for measurements,
    never on the frame path): small and large live records, the large ones'
    tiles, ``units`` (small + tiles), pixels evaluated, bbox pixels."""
    c = dict(zip(WORK_COUNTS, counts.tolist()))
    c["live"] = c["small"] + c["large"]
    c["units"] = c["small"] + c["large_units"]
    return c


def rasterize_reference(
    setup: TriangleSetup,
    height: int,
    width: int,
    depth_only: bool = False,
    affine_z: bool = False,
    z_limit: torch.Tensor | None = None,
    alpha_grid: torch.Tensor | None = None,
    row_offset: int = 0,
):
    """The plain PyTorch rasterizer, on any device: the kernel's contract with
    the kernel's rounding (each product and sum rounded on its own, IEEE
    division), so the two agree bit for bit; rows [row_offset, row_offset +
    height) of the frame ``setup`` was made for."""
    records = pack_fused_records(setup, affine_z=affine_z)
    return _reference_from_records(
        records, height, width, depth_only, affine_z, z_limit, alpha_grid,
        row_offset=row_offset,
    )


def _reference_from_records(rec, height, width, depth_only, affine_z, z_limit, alpha_grid,
                            fragments=None, row_offset: int = 0):
    """Evaluate each live triangle on its clipped bbox, in patches grouped by
    bbox size class (next power of two per axis), and combine the fragments with
    ``scatter_reduce_("amax")`` on the int64 key (bits(z) << 32 | id) — exact and
    independent of order, like the kernel's atomicMax. ``fragments`` replaces
    the bbox walk (``patch_fragments``) with another that yields (triangle ids,
    Fragments) with one id per leading index of the fragments; both take
    ``row_offset``."""
    npix = height * width
    keys = torch.zeros(npix + 1, dtype=torch.int64, device=rec.device)  # last = discard slot
    zl = None if z_limit is None else z_limit.reshape(-1)
    for tri, frag in (fragments or patch_fragments)(rec, height, width, affine_z,
                                                    row_offset=row_offset):
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


def record_bboxes(rec, height, width, row_offset: int = 0):
    """(x0, y0, x1, y1, live) of each record's bbox clipped to the target (rows
    [row_offset, row_offset + height) of the frame, in frame rows), as the
    kernel computes them; live = sid != 0 and a non-empty clipped bbox."""
    bx0 = torch.floor(rec[:, 19]).clamp(min=0).to(torch.int64)
    by0 = torch.floor(rec[:, 20]).clamp(min=row_offset).to(torch.int64)
    bx1 = torch.ceil(rec[:, 21]).clamp(max=width - 1).to(torch.int64)
    by1 = torch.ceil(rec[:, 22]).clamp(max=row_offset + height - 1).to(torch.int64)
    live = (rec[:, 18] != 0.0) & (bx1 >= bx0) & (by1 >= by0)
    return bx0, by0, bx1, by1, live


def patch_fragments(rec, height, width, affine_z, row_offset: int = 0):
    """Yield (triangle ids, Fragments) over every live record, in batches of one
    bbox size class and at most ``_PATCH_BUDGET`` patch pixels, with the kernel's
    rounding (each product and sum rounded on its own, IEEE division)."""
    dev = rec.device
    bx0, by0, bx1, by1, live = record_bboxes(rec, height, width, row_offset)
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
                                 affine_z, row_offset)


def _evaluate(col, px, py, inside, height, width, affine_z, row_offset) -> Fragments:
    """The contract's edge tests and z at integer pixels (px, py) of the frame,
    with the kernel's rounding; ``col(k)`` is record slot k broadcast against
    them. Frame row py is target row py - row_offset."""
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
    pix = ((py - row_offset) * width + px).clamp(max=height * width - 1)
    return Fragments(pix, inside & (front | back), z, d0, d1, d2)


def work_units(rec, height, width, row_offset: int = 0):
    """The kernel's work split (csrc/raster.cu, prep and scan): (record id,
    x0, y0, x1, y1) of every work unit — a live record's clipped bbox when it
    fits one TILE_ROWS x TILE_COLS tile, else each such tile of it, from its
    bbox's corner — and the counts the kernel keeps of them."""
    dev = rec.device
    bx0, by0, bx1, by1, live = record_bboxes(rec, height, width, row_offset)
    ids = torch.nonzero(live).flatten()
    bw, bh = (bx1 - bx0 + 1)[ids], (by1 - by0 + 1)[ids]
    nx = (bw + TILE_COLS - 1) // TILE_COLS
    units = nx * ((bh + TILE_ROWS - 1) // TILE_ROWS)
    t = torch.repeat_interleave(ids, units)
    first = torch.repeat_interleave(torch.cumsum(units, 0) - units, units)
    j = torch.arange(t.numel(), device=dev) - first
    nx_t = torch.repeat_interleave(nx, units)
    ty, tx = j // nx_t, j % nx_t
    x0 = bx0[t] + tx * TILE_COLS
    y0 = by0[t] + ty * TILE_ROWS
    x1 = torch.minimum(bx1[t], x0 + TILE_COLS - 1)
    y1 = torch.minimum(by1[t], y0 + TILE_ROWS - 1)
    large = units > 1
    counts = dict(small=int((~large).sum()), large=int(large.sum()),
                  large_units=int(units[large].sum()), bbox_pixels=int((bw * bh).sum()))
    return (t, x0, y0, x1, y1), counts


def row_spans(rec, t, x0, x1, y):
    """The kernel's spans of row ``y`` of a unit of record ``t`` with columns
    x0..x1 (all (R,)): (front first x, front length, back first x, back length),
    each edge's crossing -(B*y + C) * inv_A widened by the rounding margin, in
    float32 with each operation rounded alone, as csrc/raster.cu computes them.
    Overlapping or touching spans merge into the front one."""
    f32 = torch.float32
    r = rec[t]
    fy, xmag = y.to(f32), x1.to(f32)
    lo_f, hi_f = x0.to(f32), x1.to(f32)
    lo_b, hi_b = lo_f, hi_f
    min_a = torch.tensor(SPAN_MIN_A, dtype=f32, device=rec.device)
    for k in range(3):
        a, b, c, inv_a = r[:, 3 * k], r[:, 3 * k + 1], r[:, 3 * k + 2], r[:, 9 + k]
        by = b * fy
        xe = -(by + c) * inv_a
        m = (by.abs() + c.abs()) * inv_a.abs()
        margin = 1.0 + SPAN_REL * (xmag + m)
        up, down = xe + margin, xe - margin
        bounds = a.abs() >= min_a  # false for NaN, as in the kernel
        pos, neg = bounds & (a > 0.0), bounds & ~(a > 0.0)
        # fmin/fmax drop a NaN bound, as fminf/fmaxf do.
        hi_f = torch.where(pos, torch.fmin(hi_f, up), hi_f)
        lo_b = torch.where(pos, torch.fmax(lo_b, down), lo_b)
        lo_f = torch.where(neg, torch.fmax(lo_f, down), lo_f)
        hi_b = torch.where(neg, torch.fmin(hi_b, up), hi_b)

    def pixels(lo, hi):
        lo = torch.fmin(lo, (x1 + 1).to(f32))
        hi = torch.fmax(hi, (x0 - 1).to(f32))
        start = torch.ceil(lo).to(torch.int64)
        return start, (torch.floor(hi).to(torch.int64) - start + 1).clamp(min=0)

    fx, fn = pixels(lo_f, hi_f)
    bx, bn = pixels(lo_b, hi_b)
    bn = torch.where(r[:, 18] < 0.0, bn, torch.zeros_like(bn))
    merge = (fn > 0) & (bn > 0) & (bx <= fx + fn) & (fx <= bx + bn)
    lo = torch.minimum(fx, bx)
    fn = torch.where(merge, torch.maximum(fx + fn, bx + bn) - lo, fn)
    fx = torch.where(merge, lo, fx)
    bn = torch.where(merge, torch.zeros_like(bn), bn)
    return fx, fn, bx, bn


def _unit_rows(rec, units):
    """(record, y, front x, front length, back x, back length) of every row of
    ``units`` (from ``work_units``)."""
    t, x0, y0, x1, y1 = units
    y = y0[:, None] + torch.arange(TILE_ROWS, device=rec.device)[None, :]
    keep = y <= y1[:, None]

    t, x0, x1 = (v[:, None].expand_as(y)[keep] for v in (t, x0, x1))
    y = y[keep]
    return (t, y, *row_spans(rec, t, x0, x1, y))


def span_fragments(rec, height, width, affine_z, batch_units=1 << 14, row_offset: int = 0):
    """Yield (triangle id per fragment, flat Fragments) over the pixels of the
    kernel's row spans only, unit by unit in batches: the plain mirror of
    csrc/raster.cu's walk. Used by the tests, not by the frame."""
    units, _ = work_units(rec, height, width, row_offset)
    dev = rec.device
    for s in range(0, units[0].numel(), batch_units):
        t, y, fx, fn, bx, bn = _unit_rows(rec, tuple(u[s:s + batch_units] for u in units))
        cnt = fn + bn
        row = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev), cnt)
        k = torch.arange(row.numel(), device=dev) - (torch.cumsum(cnt, 0) - cnt)[row]
        px = torch.where(k < fn[row], fx[row] + k, bx[row] + k - fn[row])
        tri = t[row]
        r = rec[tri]
        yield tri, _evaluate(lambda c: r[:, c], px, y[row], torch.ones_like(px, dtype=torch.bool),
                             height, width, affine_z, row_offset)


def span_work(rec, height, width, row_offset: int = 0) -> dict:
    """The kernel's work counts (``work_counts``' names) for these records,
    from the mirror's split and spans."""
    units, counts = work_units(rec, height, width, row_offset)
    _, _, _, fn, _, bn = _unit_rows(rec, units)
    counts["evaluated"] = int((fn + bn).sum())
    counts["live"] = counts["small"] + counts["large"]
    counts["units"] = counts["small"] + counts["large_units"]
    return counts


def rasterize_spans(
    setup: TriangleSetup,
    height: int,
    width: int,
    depth_only: bool = False,
    affine_z: bool = False,
    z_limit: torch.Tensor | None = None,
    alpha_grid: torch.Tensor | None = None,
    row_offset: int = 0,
):
    """``rasterize_reference`` evaluated on the kernel's margin-widened row
    spans instead of every bbox pixel: the plain mirror of csrc/raster.cu's
    work split and spans. Equal to the reference bit for bit exactly when no
    span misses a pixel the rounded test accepts. Tests only."""
    records = pack_fused_records(setup, affine_z=affine_z)
    return _reference_from_records(
        records, height, width, depth_only, affine_z, z_limit, alpha_grid,
        fragments=span_fragments, row_offset=row_offset,
    )


def alpha_bit_index(frag: Fragments) -> torch.Tensor:
    """The bit (vi * 16 + ui) of the 16x16 barycentric alpha grid each fragment tests."""
    sv = frag.d0 + frag.d1 + frag.d2
    inv = 1.0 / torch.where(sv == 0.0, torch.ones_like(sv), sv)

    def lattice(d):
        t = torch.nan_to_num(d * inv * 16.0, nan=0.0, posinf=15.0, neginf=0.0)
        return t.clamp(0.0, 15.0).to(torch.int32)

    return lattice(frag.d2) * 16 + lattice(frag.d1)
