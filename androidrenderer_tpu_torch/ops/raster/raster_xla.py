"""Depth + visibility rasterization as tiled reductions over binned triangles.

The port of the JAX package's ops/raster/raster_xla.py (its rasterizer outside
any Pallas kernel), in plain torch. Reversed-Z with a GREATER test makes the
depth pass a ``max`` over the triangles covering a pixel; the visibility pass
re-evaluates coverage and keeps the largest triangle id whose depth reaches the
depth buffer (the depth-EQUAL trick). Both walk each tile's bin list
(``binning.py``) in chunks, evaluating the three affine edge functions on the
tile's pixel grid; the JAX version vmaps the tile function, this one batches
tiles (as many as keep a chunk's temporaries near ``_TILE_BUDGET`` elements).
A bin that overflowed its capacity draws only the triangles it kept.
"""

from __future__ import annotations

import torch

from androidrenderer_tpu_torch.ops.raster.binning import TileBins
from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup

# Elements of one (tiles, chunk, 3, tile_h, tile_w) edge evaluation.
_TILE_BUDGET = 1 << 22


def _eval_chunk(edge, q, r, double_sided, live, px, py):
    """Coverage (T, C, th, tw) bool and ndc depth (T, C, th, tw) f32 for a chunk
    of C triangles in each of T tiles; px (T, tw) and py (T, th) are the
    tiles' pixel coordinates."""
    x = px[:, None, None, None, :]
    y = py[:, None, None, :, None]
    # D[t, c, e, y, x] = A*px + B*py + C; front faces have every D <= 0 (the
    # viewport's y-flip mirrors glTF's CCW winding).
    d = edge[..., 0, None, None] * x + edge[..., 1, None, None] * y + edge[..., 2, None, None]
    cov_front = (d <= 0.0).all(dim=2)
    cov_back = (d >= 0.0).all(dim=2)
    cov = cov_front | (cov_back & double_sided[..., None, None])

    x2 = px[:, None, None, :]
    y2 = py[:, None, :, None]
    qv = q[..., 0, None, None] * x2 + q[..., 1, None, None] * y2 + q[..., 2, None, None]
    rv = r[..., 0, None, None] * x2 + r[..., 1, None, None] * y2 + r[..., 2, None, None]
    z = rv / torch.where(qv == 0.0, torch.ones_like(qv), qv)
    # Depth-range rejection replaces near clipping: visible iff 0 < z <= 1.
    cov = cov & (z > 0.0) & (z <= 1.0) & (qv != 0.0) & live[..., None, None]
    return cov, z


def _tile_pixel_centers(tile_index, tiles_x: int, tile_h: int, tile_w: int, row_offset):
    """(px (T, tw), py (T, th)) f32 pixel coordinates of the tiles ``tile_index`` (T,)."""
    dev = tile_index.device
    ty = tile_index // tiles_x
    tx = tile_index % tiles_x
    px = (tx[:, None] * tile_w + torch.arange(tile_w, device=dev)).to(torch.float32)
    py = (ty[:, None] * tile_h + torch.arange(tile_h, device=dev) + row_offset).to(torch.float32)
    return px, py


def _gather_chunk(setup: TriangleSetup, ids: torch.Tensor):
    safe = ids.clamp(min=0).long()
    return setup.edge[safe], setup.q[safe], setup.r[safe], setup.double_sided[safe], ids >= 0


def _chunked_lists(bins: TileBins, chunk: int):
    """(lists (T, num_chunks, chunk) padded with -1, chunk)."""
    cap = bins.lists.shape[1]
    chunk = min(chunk, cap)
    num_chunks = -(-cap // chunk)
    lists = torch.nn.functional.pad(bins.lists, (0, num_chunks * chunk - cap), value=-1)
    return lists.reshape(-1, num_chunks, chunk), chunk


def _to_tiles(img, tiles_y, tiles_x, tile_h, tile_w):
    return (img.reshape(tiles_y, tile_h, tiles_x, tile_w).permute(0, 2, 1, 3)
            .reshape(-1, tile_h, tile_w))


def _from_tiles(tiles, tiles_y, tiles_x, tile_h, tile_w):
    return (tiles.reshape(tiles_y, tiles_x, tile_h, tile_w).permute(0, 2, 1, 3)
            .reshape(tiles_y * tile_h, tiles_x * tile_w))


def _tile_walk(setup, bins, tiles_y, tiles_x, tile_h, tile_w, chunk, row_offset, init, step):
    """Run ``step(acc, sl, ids, cov, z) -> acc`` over every chunk of every
    tile's list, a batch of tiles (the slice ``sl``) at a time; ``init`` is the
    (T, th, tw) start."""
    lists, chunk = _chunked_lists(bins, chunk)
    num_tiles = tiles_y * tiles_x
    acc = init
    group = max(1, _TILE_BUDGET // (chunk * 3 * tile_h * tile_w))
    for t0 in range(0, num_tiles, group):
        sl = slice(t0, min(t0 + group, num_tiles))
        tiles = torch.arange(sl.start, sl.stop, device=lists.device)
        px, py = _tile_pixel_centers(tiles, tiles_x, tile_h, tile_w, row_offset)
        for j in range(lists.shape[1]):
            ids = lists[sl, j]  # (Tg, chunk)
            cov, z = _eval_chunk(*_gather_chunk(setup, ids), px, py)
            acc[sl] = step(acc[sl], sl, ids, cov, z)
    return acc


def rasterize_depth(
    setup: TriangleSetup,
    bins: TileBins,
    height: int,
    width: int,
    tile_h: int,
    tile_w: int,
    chunk: int = 128,
    row_offset: torch.Tensor | int = 0,
    z_limit: torch.Tensor | None = None,  # (H, W): accept only z < z_limit (peeling)
) -> torch.Tensor:
    """Depth buffer (H, W) f32, cleared to 0.0, max-reduced reversed-Z.

    ``height`` is the rendered band height; ``row_offset`` is the band's first
    pixel row in the full frame (0 for a whole frame)."""
    tiles_y, tiles_x = height // tile_h, width // tile_w
    dev = setup.edge.device
    zl = None if z_limit is None else _to_tiles(z_limit, tiles_y, tiles_x, tile_h, tile_w)

    def step(acc, sl, ids, cov, z):
        if zl is not None:
            cov = cov & (z < zl[sl, None])
        return torch.maximum(acc, torch.where(cov, z, torch.zeros_like(z)).amax(dim=1))

    init = torch.zeros((tiles_y * tiles_x, tile_h, tile_w), dtype=torch.float32, device=dev)
    acc = _tile_walk(setup, bins, tiles_y, tiles_x, tile_h, tile_w, chunk, row_offset, init, step)
    return _from_tiles(acc, tiles_y, tiles_x, tile_h, tile_w)


def rasterize_visibility(
    setup: TriangleSetup,
    bins: TileBins,
    depth: torch.Tensor,  # (H, W) f32 from rasterize_depth
    tile_h: int,
    tile_w: int,
    chunk: int = 128,
    row_offset: torch.Tensor | int = 0,
    z_limit: torch.Tensor | None = None,  # (H, W): accept only z < z_limit (peeling)
) -> torch.Tensor:
    """Visibility buffer (H, W) int32 triangle ids; -1 where nothing was drawn.

    A triangle wins a pixel iff it covers it and its depth >= the depth buffer
    value (it IS the max); ties resolve to the largest id."""
    height, width = depth.shape
    tiles_y, tiles_x = height // tile_h, width // tile_w
    depth_t = _to_tiles(depth, tiles_y, tiles_x, tile_h, tile_w)
    zl = None if z_limit is None else _to_tiles(z_limit, tiles_y, tiles_x, tile_h, tile_w)

    def step(acc, sl, ids, cov, z):
        td = depth_t[sl, None]
        hit = cov & (z >= td) & (td > 0.0)
        if zl is not None:
            hit = hit & (z < zl[sl, None])
        idc = torch.where(hit, ids[:, :, None, None], torch.full_like(ids[:, :, None, None], -1))
        return torch.maximum(acc, idc.amax(dim=1))

    init = torch.full((tiles_y * tiles_x, tile_h, tile_w), -1, dtype=torch.int32,
                      device=depth.device)
    acc = _tile_walk(setup, bins, tiles_y, tiles_x, tile_h, tile_w, chunk, row_offset, init, step)
    return _from_tiles(acc, tiles_y, tiles_x, tile_h, tile_w)
