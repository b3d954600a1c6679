"""The rasterizer: a CUDA kernel for Hopper and its plain PyTorch version.

``rasterize`` is the port of the JAX package's ``rasterize_bitmask`` (the Pallas
kernel ``raster_bitmask.py::_bitmask_kernel``) with its signature minus the TPU
tunables. On a CUDA tensor it launches ``csrc/raster.cu``; on a CPU tensor it
runs ``rasterize_reference``. There is no fallback from one to the other.

The kernel source is compiled with nvcc for ``sm_90a`` at first use, into
``build/torch_kernels/`` at the repository root, as a shared library with a
plain C interface loaded through ctypes. The library name carries a hash of
the source, so an edited source builds anew.

Contract (both versions, from the records of ``setup.pack_fused_records``):
coverage by the three edge functions at integer pixel coordinates (all <= 0,
or all >= 0 for double-sided records), z = r/q (or the affine plane), accepted
when 0 < z <= 1 (and z < z_limit), optionally alpha-tested against the
triangle's 16x16 barycentric bitmap. Reversed-Z: the greatest z wins a pixel,
ties going to the higher triangle id. Depth clears to 0 and vis to -1.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup, pack_fused_records

_SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "raster.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Elements of one evaluation patch batch in the plain version (keeps each
# batch's temporaries near 100 MB at the bench shapes).
_PATCH_BUDGET = 1 << 22


class _Library:
    """The compiled kernel library, built and loaded on first use."""

    def __init__(self):
        self.lib = None
        self.path = None
        self.build_log = ""
        self.build_seconds = 0.0

    def load(self):
        if self.lib is not None:
            return self.lib
        t0 = time.perf_counter()
        self.path, self.build_log = build_library()
        lib = ctypes.CDLL(str(self.path))
        fn = lib.raster_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, ci, ci, vp, vp, ci, ci, vp, vp, vp, vp]
        fn.restype = ci
        self.build_seconds = time.perf_counter() - t0
        self.lib = lib
        return lib


LIBRARY = _Library()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build csrc/raster.cu")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_library() -> tuple[Path, str]:
    """Compile csrc/raster.cu for sm_90a unless a library of this source exists.
    Returns (library path, compiler output; empty when nothing was built)."""
    src = _SOURCE.read_bytes()
    out = BUILD_DIR / f"libraster_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


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
):
    """(depth (H, W) f32, vis (H, W) i32), or depth alone with ``depth_only``.

    A CUDA setup launches the kernel (counted in ``rasterize.launches``); a CPU
    setup runs ``rasterize_reference``; any other device raises."""
    records = pack_fused_records(setup, affine_z=affine_z)
    if records.device.type == "cpu":
        return _reference_from_records(
            records, height, width, depth_only, affine_z, z_limit, alpha_grid
        )
    if records.device.type != "cuda":
        raise ValueError(f"rasterize runs on cuda or cpu tensors, got {records.device}")
    n = records.shape[0]
    if n >= 2**31 or height * width >= 2**31:
        raise ValueError(f"{n} triangles into {height}x{width} exceeds the kernel's int32 indexing")
    dev = records.device
    if z_limit is not None:
        _check(z_limit, "z_limit", torch.float32, (height, width), dev)
    if alpha_grid is not None:
        _check(alpha_grid, "alpha_grid", torch.int32, (n, 8), dev)
    lib = LIBRARY.load()
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    if depth_only:
        keys = vis = None
    else:
        keys = torch.empty((height, width), dtype=torch.int64, device=dev)
        vis = torch.empty((height, width), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raster_launch(
            records.data_ptr(), n, height, width, ptr(z_limit), ptr(alpha_grid),
            int(depth_only), int(affine_z), ptr(keys), depth.data_ptr(), ptr(vis),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_launch failed with cudaError_t {err}")
    rasterize.launches += 1
    return depth if depth_only else (depth, vis)


rasterize.launches = 0


def rasterize_reference(
    setup: TriangleSetup,
    height: int,
    width: int,
    depth_only: bool = False,
    affine_z: bool = False,
    z_limit: torch.Tensor | None = None,
    alpha_grid: torch.Tensor | None = None,
):
    """The plain PyTorch rasterizer, on any device: the kernel's contract with
    the kernel's rounding (each product and sum rounded on its own, IEEE
    division), so the two agree bit for bit."""
    records = pack_fused_records(setup, affine_z=affine_z)
    return _reference_from_records(
        records, height, width, depth_only, affine_z, z_limit, alpha_grid
    )


def _reference_from_records(rec, height, width, depth_only, affine_z, z_limit, alpha_grid):
    """Evaluate each live triangle on its clipped bbox, in patches grouped by
    bbox size class (next power of two per axis), and combine the fragments with
    ``scatter_reduce_("amax")`` on the int64 key (bits(z) << 32 | id) — exact and
    independent of order, like the kernel's atomicMax."""
    dev = rec.device
    npix = height * width
    keys = torch.zeros(npix + 1, dtype=torch.int64, device=dev)  # last = discard slot
    bx0 = torch.floor(rec[:, 19]).clamp(min=0).to(torch.int64)
    by0 = torch.floor(rec[:, 20]).clamp(min=0).to(torch.int64)
    bx1 = torch.ceil(rec[:, 21]).clamp(max=width - 1).to(torch.int64)
    by1 = torch.ceil(rec[:, 22]).clamp(max=height - 1).to(torch.int64)
    bw = bx1 - bx0 + 1
    bh = by1 - by0 + 1
    live = (rec[:, 18] != 0.0) & (bw > 0) & (bh > 0)
    ids = torch.nonzero(live).flatten()
    if ids.numel():
        lw = torch.ceil(torch.log2(bw[ids].to(torch.float64))).to(torch.int64)
        lh = torch.ceil(torch.log2(bh[ids].to(torch.float64))).to(torch.int64)
        cls = lw * 64 + lh
        zl = None if z_limit is None else z_limit.reshape(-1)
        for c in torch.unique(cls).tolist():
            pw, ph = 1 << (c // 64), 1 << (c % 64)
            members = ids[cls == c]
            step = max(1, _PATCH_BUDGET // (pw * ph))
            for s in range(0, members.numel(), step):
                _patch(rec, members[s:s + step], pw, ph, bx0, by0, bx1, by1,
                       height, width, affine_z, zl, alpha_grid, keys)
    keys = keys[:npix].reshape(height, width)
    depth = (keys >> 32).to(torch.int32).view(torch.float32)
    if depth_only:
        return depth
    vis = torch.where(
        keys == 0, torch.full_like(keys, -1), keys & 0xFFFFFFFF
    ).to(torch.int32)
    return depth, vis


def _patch(rec, tri, pw, ph, bx0, by0, bx1, by1, height, width, affine_z, zl,
           alpha_grid, keys):
    """Scatter the fragments of triangles ``tri`` evaluated on (ph, pw) patches."""
    dev = rec.device
    r = rec[tri]  # (B, 24)

    def col(k):
        return r[:, k, None, None]

    px = bx0[tri, None, None] + torch.arange(pw, device=dev)[None, None, :]
    py = by0[tri, None, None] + torch.arange(ph, device=dev)[None, :, None]
    inside = (px <= bx1[tri, None, None]) & (py <= by1[tri, None, None])
    fx = px.to(torch.float32)
    fy = py.to(torch.float32)
    d0 = col(0) * fx + col(1) * fy + col(2)
    d1 = col(3) * fx + col(4) * fy + col(5)
    d2 = col(6) * fx + col(7) * fy + col(8)
    sid = col(18)
    front = (d0 <= 0.0) & (d1 <= 0.0) & (d2 <= 0.0)
    back = (sid < 0.0) & (d0 >= 0.0) & (d1 >= 0.0) & (d2 >= 0.0)
    if affine_z:
        z = col(12) * fx + col(13) * fy + col(14)
    else:
        z = (col(15) * fx + col(16) * fy + col(17)) / (col(12) * fx + col(13) * fy + col(14))
    cov = inside & (front | back) & (z > 0.0) & (z <= 1.0)
    pix = (py * width + px).clamp(max=height * width - 1)
    if zl is not None:
        cov = cov & (z < zl[pix])
    if alpha_grid is not None:
        sv = d0 + d1 + d2
        inv = 1.0 / torch.where(sv == 0.0, torch.ones_like(sv), sv)

        def lattice(d):
            t = torch.nan_to_num(d * inv * 16.0, nan=0.0, posinf=15.0, neginf=0.0)
            return t.clamp(0.0, 15.0).to(torch.int32)

        idx = lattice(d2) * 16 + lattice(d1)
        b = tri.numel()
        words = torch.gather(
            alpha_grid[tri].to(torch.int32), 1, (idx >> 5).reshape(b, -1).to(torch.int64)
        ).reshape(idx.shape)
        cov = cov & (((words >> (idx & 31)) & 1) == 1)
    zbits = z.contiguous().view(torch.int32).to(torch.int64)
    key = (zbits << 32) | tri[:, None, None]
    target = torch.where(cov, pix, torch.full_like(pix, height * width))
    keys.scatter_reduce_(0, target.reshape(-1), key.reshape(-1), "amax")
