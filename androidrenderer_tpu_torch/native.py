"""ctypes binding of the native BVH builder (``native/sah_native.cpp`` at the
repository root), built at first use.

The JAX package loads a library built beforehand by tools/build_native.sh with
``-march=native``; this package builds the same source itself, with
``g++ -O3 -ffp-contract=off -shared -fPIC -std=c++17`` (no ``-march``: the
library must run on whatever CPU the card's host has), into
``build/torch_kernels/libsah_native_<sha16>.so`` keyed by the source's bytes
and the flags. ``sah_build_bvh``'s output is bit-identical to the numpy
builder's (scene/bvh.py; tests/test_torch_rt.py holds both against the JAX
package's ``build_bvh``); ``-ffp-contract=off`` keeps the SAH axis cost's
rounding equal to numpy's float32 expression. ``sah_sample_surface`` is bound
as the JAX module binds it (``sample_surface_native``), and ``available`` says
whether the library could be built and loaded.

``build_bvh`` picks the builder and says which ran: the native one, or the
numpy one when the scene has no live triangle or the library cannot be built
(then with a warning naming the compiler's error).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from pathlib import Path

import numpy as np

from androidrenderer_tpu_torch.scene.bvh import (
    LEAF_SIZE,
    BVHArrays,
    build_bvh as build_bvh_numpy,
    sanitize_padded_boxes,
)

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "native" / "sah_native.cpp"
BUILD_DIR = REPO / "build" / "torch_kernels"
FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


class _Native:
    """The library, built and loaded on first use (or the error that stopped it)."""

    def __init__(self):
        self.lib = None
        self.error = None

    def load(self) -> ctypes.CDLL:
        if self.lib is None and self.error is None:
            try:
                self.lib = _bind(ctypes.CDLL(str(_build())))
            except (OSError, subprocess.SubprocessError, NativeUnavailable) as e:
                self.error = f"{type(e).__name__}: {e}"
        if self.lib is None:
            raise NativeUnavailable(self.error)
        return self.lib


def _build() -> Path:
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libsah_native_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise NativeUnavailable(
            f"{' '.join(cmd)} failed ({proc.returncode}): {proc.stderr.strip()[-2000:]}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders of one source agree
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.sah_build_bvh.restype = ctypes.c_int
    lib.sah_build_bvh.argtypes = [
        f32p, ctypes.c_int64, i32p, ctypes.c_int64, u8p,
        f32p, f32p, i32p, i32p, i32p, i32p,
    ]
    lib.sah_sample_surface.restype = ctypes.c_int
    lib.sah_sample_surface.argtypes = [
        f32p, ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_float,
        ctypes.c_int32, ctypes.c_uint64, f32p,
    ]
    return lib


NATIVE = _Native()


def available() -> bool:
    """Whether the native library could be built and loaded."""
    try:
        NATIVE.load()
    except NativeUnavailable:
        return False
    return True


def sample_surface_native(positions: np.ndarray, tri_indices: np.ndarray,
                          area_per_sample: float, max_points: int,
                          seed: int = 1) -> np.ndarray | None:
    """(k, 6) f32 area-uniform surface samples [position, face normal], about one
    per ``area_per_sample`` of surface and at most ``max_points``, or None where
    the library is unavailable."""
    if not available():
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    tri_indices = np.ascontiguousarray(tri_indices, np.int32)
    out = np.empty((max_points, 6), np.float32)
    k = NATIVE.lib.sah_sample_surface(
        positions, positions.shape[0], tri_indices, tri_indices.shape[0],
        float(area_per_sample), int(max_points), int(seed), out,
    )
    if k < 0:
        return None
    return out[:k]


def build_bvh_native(positions: np.ndarray, tri_indices: np.ndarray,
                     tri_valid: np.ndarray | None = None) -> BVHArrays:
    """The native builder's BVH (the numpy builder's, bit for bit). Raises
    NativeUnavailable when the library cannot be built, ValueError when no
    triangle is live (the native builder has no empty tree)."""
    lib = NATIVE.load()
    positions = np.ascontiguousarray(positions, np.float32)
    tri_indices = np.ascontiguousarray(tri_indices, np.int32)
    n = tri_indices.shape[0]
    valid = (np.ones(n, np.uint8) if tri_valid is None
             else np.ascontiguousarray(np.asarray(tri_valid).astype(np.uint8)))
    n_live = int(valid.sum())
    if n_live == 0:
        raise ValueError("no live triangle: the native builder has no empty tree")
    num_leaves = max(1, -(-n_live // LEAF_SIZE))
    p = 1
    while p < num_leaves:
        p *= 2
    m = 2 * p - 1
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    node_miss = np.empty(m, np.int32)
    node_first = np.empty(m, np.int32)
    node_count = np.empty(m, np.int32)
    tri_order = np.empty(p * LEAF_SIZE, np.int32)
    rc = lib.sah_build_bvh(
        positions, positions.shape[0], tri_indices, n, valid,
        node_min, node_max, node_miss, node_first, node_count, tri_order,
    )
    if rc != m:
        raise RuntimeError(f"sah_build_bvh returned {rc}, expected {m} nodes")
    fixed = sanitize_padded_boxes(node_min, node_max)
    return BVHArrays(fixed["node_min"], fixed["node_max"], node_miss, node_first, node_count,
                     tri_order)


def build_bvh(positions: np.ndarray, tri_indices: np.ndarray,
              tri_valid: np.ndarray | None = None) -> tuple[BVHArrays, str]:
    """(BVH, the builder that made it): the native builder where it can run,
    else the numpy one, with a warning when the library failed to build."""
    n = np.asarray(tri_indices).shape[0]
    live = n if tri_valid is None else int(np.asarray(tri_valid).sum())
    if live == 0:
        return build_bvh_numpy(positions, tri_indices, tri_valid), "numpy (no live triangle)"
    try:
        return build_bvh_native(positions, tri_indices, tri_valid), "native"
    except NativeUnavailable as e:
        warnings.warn(f"native BVH builder unavailable, using the numpy builder: {e}",
                      RuntimeWarning, stacklevel=2)
        return build_bvh_numpy(positions, tri_indices, tri_valid), "numpy (native build failed)"
