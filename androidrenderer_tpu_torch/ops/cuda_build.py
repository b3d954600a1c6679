"""Build and load the port's CUDA sources (``csrc/*.cu``) at first use.

Each source compiles with nvcc for ``sm_90a`` into ``build/torch_kernels/`` at the
repository root, as a shared library with a plain C interface loaded through
ctypes. The library name carries the source's name and a hash of its bytes
(``lib<name>_<sha16>.so``), so an edited source builds anew and two sources never
share a library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Library:
    """One compiled source, built and loaded on first use.

    ``functions`` maps each exported C function to its ctypes argument types
    (every function returns an int, the first CUDA error or 0)."""

    def __init__(self, source: str, functions: dict):
        self.source = CSRC / source
        self.functions = functions
        self.lib = None
        self.path = None
        self.build_log = ""
        self.build_seconds = 0.0

    def load(self):
        if self.lib is not None:
            return self.lib
        t0 = time.perf_counter()
        self.path, self.build_log = build_library(self.source)
        lib = ctypes.CDLL(str(self.path))
        for name, argtypes in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        self.lib = lib
        return lib


def load_all(*libraries: Library) -> None:
    """Load ``libraries`` with one nvcc for each source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        for future in [pool.submit(lib.load) for lib in libraries]:
            future.result()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_library(source: Path) -> tuple[Path, str]:
    """Compile ``source`` for sm_90a unless a library of these bytes exists.
    Returns (library path, compiler output; empty when nothing was built)."""
    src = source.read_bytes()
    out = BUILD_DIR / f"lib{source.stem}_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr
