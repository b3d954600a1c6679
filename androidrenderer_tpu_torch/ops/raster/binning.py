"""Tile binning — each screen tile's fixed-capacity list of the triangles whose
pixel AABB overlaps it.

The port of the JAX package's ops/raster/binning.py, in plain torch. Fixed
capacity keeps the shapes static; ``counts`` holds each tile's true overlap
count, so a list that overflowed ``cap`` shows (its first ``cap`` triangles, in
id order, are kept and the rest are dropped, as in the JAX version). The XLA
raster path (``raster_xla.py``) walks these lists.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup


class TileBins(NamedTuple):
    lists: torch.Tensor  # (num_tiles, cap) int32 triangle ids, -1 padded
    counts: torch.Tensor  # (num_tiles,) int32 true overlap count (may exceed cap)


def bin_triangles(
    setup: TriangleSetup,
    tiles_y: int,
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    cap: int,
    tile_row_offset: torch.Tensor | int = 0,
) -> TileBins:
    """Bin into a (tiles_y x tiles_x) tile grid whose first tile row is
    ``tile_row_offset`` (nonzero when a horizontal screen band is rendered)."""
    dev = setup.edge.device
    num_tiles = tiles_y * tiles_x

    tx0 = torch.floor(setup.bbox[:, 0] / tile_w).to(torch.int32)
    ty0 = torch.floor(setup.bbox[:, 1] / tile_h).to(torch.int32)
    tx1 = torch.floor(setup.bbox[:, 2] / tile_w).to(torch.int32)
    ty1 = torch.floor(setup.bbox[:, 3] / tile_h).to(torch.int32)

    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    tile_x = (tile_ids % tiles_x)[:, None]
    tile_y = (tile_ids // tiles_x)[:, None] + tile_row_offset

    mask = (
        (tile_x >= tx0[None, :])
        & (tile_x <= tx1[None, :])
        & (tile_y >= ty0[None, :])
        & (tile_y <= ty1[None, :])
        & setup.valid[None, :]
    )  # (num_tiles, n)

    counts = mask.sum(dim=1, dtype=torch.int32)
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    keep = mask & (pos < cap)
    lists = torch.full((num_tiles, cap), -1, dtype=torch.int32, device=dev)
    rows, cols = torch.nonzero(keep, as_tuple=True)
    lists[rows, pos[rows, cols].long()] = cols.to(torch.int32)
    return TileBins(lists=lists, counts=counts)
