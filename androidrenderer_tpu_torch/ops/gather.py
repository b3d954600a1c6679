"""Gather-sum of table rows per tile of indices: a CUDA kernel for Hopper and its
plain PyTorch version.

``gather_tile_sums`` is the function of the JAX package's resolve-gather study
(tools/microbench_pallas_gather.py::pallas_gather, the Pallas kernel ``kernel``):
the rows of an (M, C) f32 table picked by (P,) i32 indices, summed per tile of
2048 indices into row 0 of a (P / 2048, 8, C) output whose rows 1-7 are 0. On a
CUDA tensor it launches ``csrc/gather.cu`` (built by ``ops/cuda_build.py``); on a
CPU tensor it runs ``gather_tile_sums_reference``. There is no fallback from one
to the other.
"""

from __future__ import annotations

from ctypes import c_int, c_longlong, c_void_p

import torch

from androidrenderer_tpu_torch.ops.cuda_build import Library

TILE = 2048  # indices summed into one output tile
OUT_ROWS = 8  # rows of an output tile; row 0 holds the sum
SPLIT = 8  # blocks that share a tile in csrc/gather.cu (its kSplit), each a partial row

LIBRARY = Library("gather.cu", {
    "gather_tile_sums_launch": [c_void_p, c_longlong, c_int, c_void_p, c_longlong, c_void_p,
                                c_void_p, c_void_p],
})


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"table must be (M, C) float32, got {tuple(table.shape)} {table.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be (P,) int32, got {tuple(idx.shape)} {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, table on {table.device}")
    if idx.shape[0] % TILE:
        raise ValueError(f"the index count {idx.shape[0]} must be a multiple of {TILE}")


def gather_tile_sums(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(P / 2048, 8, C) f32: row 0 of tile g is ``table[idx[2048 g: 2048 (g + 1)]].sum(0)``.

    A CUDA table launches the kernel (counted in ``gather_tile_sums.launches``);
    a CPU table runs ``gather_tile_sums_reference``; any other device raises.
    Indices must lie in [0, M): on the card an index outside makes its tile's
    sums NaN, on the CPU it raises."""
    _check(table, idx)
    if table.device.type == "cpu":
        return gather_tile_sums_reference(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"the gather runs on cuda or cpu tensors, got {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    m, c = table.shape
    p = idx.shape[0]
    lib = LIBRARY.load()
    out = torch.empty((p // TILE, OUT_ROWS, c), dtype=torch.float32, device=table.device)
    partial = torch.empty((p // TILE * SPLIT, c), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.gather_tile_sums_launch(
            table.data_ptr(), m, c, idx.data_ptr(), p, out.data_ptr(), partial.data_ptr(), stream
        )
    if err != 0:
        raise RuntimeError(f"gather_tile_sums_launch failed with cudaError_t {err}")
    gather_tile_sums.launches += 1
    return out


gather_tile_sums.launches = 0


def gather_tile_sums_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on any device: one gather of all P rows, then
    a sum over each tile's 2048 rows."""
    _check(table, idx)
    g, c = idx.shape[0] // TILE, table.shape[1]
    out = torch.zeros((g, OUT_ROWS, c), dtype=torch.float32, device=table.device)
    out[:, 0] = table[idx.long()].view(g, TILE, c).sum(1)
    return out
