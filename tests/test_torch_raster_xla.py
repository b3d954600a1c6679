"""The port's binned reduction rasterizer and attribute interpolation against the
JAX package's (ops/raster/binning.py, raster_xla.py, interpolate.py).

Seeded random triangles at 128 x 64 (the raster suites' size,
test_raster_binned.py:24), set up by the JAX package and fed to both as the same
setup. Bins must be equal, with a capacity that covers the peak and one that
overflows it (the truncation keeps each tile's first ``cap`` triangles).
Depth and visibility are held to the raster contract of
test_raster_bitmask.py:33-36 (depth rtol 1e-6, atol 1e-9; visibility differing
only where depth does); interpolation to the port's unit tolerance, rtol 1e-5,
atol 1e-6. The JAX side runs jitted, one compile per function and shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu.ops.raster import binning as jax_binning
from androidrenderer_tpu.ops.raster import interpolate as jax_interp
from androidrenderer_tpu.ops.raster import raster_xla as jax_xla
from androidrenderer_tpu_torch.ops.raster import (
    TriangleSetup,
    interpolate_attributes,
    rasterize_depth,
    rasterize_visibility,
)
from androidrenderer_tpu_torch.ops.raster.binning import bin_triangles
from androidrenderer_tpu_torch.ops.raster.interpolate import (
    compute_barycentrics,
    interpolate_with_derivatives,
)

from test_raster import random_scene
from test_raster_binned import H, W, _setup_for

torch.set_num_threads(1)

TILE_H, TILE_W = 16, 128
# One compile per function and static shape in place of one per operation.
jax_bin = jax.jit(jax_binning.bin_triangles, static_argnums=(1, 2, 3, 4),
                  static_argnames=("cap", "tile_row_offset"))
jax_depth = jax.jit(jax_xla.rasterize_depth, static_argnums=(2, 3, 4, 5),
                    static_argnames=("chunk", "row_offset"))
jax_vis = jax.jit(jax_xla.rasterize_visibility, static_argnums=(3, 4),
                  static_argnames=("chunk", "row_offset"))


def to_torch(setup) -> TriangleSetup:
    return TriangleSetup(*(torch.from_numpy(np.array(x)) for x in setup))


def _assert_raster_contract(depth, vis, depth_ref, vis_ref):
    np.testing.assert_allclose(depth, depth_ref, rtol=1e-6, atol=1e-9)
    hard = (vis != vis_ref) & (depth == depth_ref)
    assert hard.sum() == 0, f"{hard.sum()} visibility mismatches off ULP edges"


@pytest.mark.parametrize("cap", [128, 4])
def test_bins_and_raster_match_jax(cap):
    verts, tris = random_scene(0, n_tris=50)
    setup = _setup_for(verts, tris, True)
    grid = (H // TILE_H, W // TILE_W, TILE_H, TILE_W)
    jb = jax_bin(setup, *grid, cap=cap)
    tb = bin_triangles(to_torch(setup), *grid, cap=cap)
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    np.testing.assert_array_equal(tb.lists.numpy(), np.asarray(jb.lists))
    overflow = int(tb.counts.max()) > cap
    assert overflow == (cap == 4)

    depth_ref = np.asarray(jax_depth(setup, jb, H, W, TILE_H, TILE_W, chunk=32))
    vis_ref = np.asarray(jax_vis(
        setup, jb, jnp.asarray(depth_ref), TILE_H, TILE_W, chunk=32))
    depth = rasterize_depth(to_torch(setup), tb, H, W, TILE_H, TILE_W, chunk=32)
    vis = rasterize_visibility(to_torch(setup), tb, depth, TILE_H, TILE_W, chunk=32)
    assert (vis_ref >= 0).sum() > 100
    _assert_raster_contract(depth.numpy(), vis.numpy(), depth_ref, vis_ref)


def test_band_with_row_offset_and_z_limit_matches_jax():
    """The lower half of the frame as a band (tile_row_offset / row_offset)
    under a peel bound (z_limit)."""
    verts, tris = random_scene(4, n_tris=60)
    setup = _setup_for(verts, tris, True)
    band_h, tile_row0 = H // 2, (H // 2) // TILE_H
    noise = np.random.default_rng(4).uniform(0.3, 1.0, (band_h, W)).astype(np.float32)
    jb = jax_bin(setup, band_h // TILE_H, W // TILE_W, TILE_H, TILE_W, cap=128,
                 tile_row_offset=tile_row0)
    kw = dict(chunk=32, row_offset=H // 2)
    tsetup = to_torch(setup)
    full = rasterize_depth(tsetup, bin_triangles(tsetup, H // TILE_H, 1, TILE_H, TILE_W, cap=128),
                           H, W, TILE_H, TILE_W, chunk=32).numpy()
    zl = np.where(full[H // 2:] > 0, full[H // 2:] * noise, np.inf).astype(np.float32)
    depth_ref = np.asarray(jax_depth(
        setup, jb, band_h, W, TILE_H, TILE_W, z_limit=jnp.asarray(zl), **kw))
    vis_ref = np.asarray(jax_vis(
        setup, jb, jnp.asarray(depth_ref), TILE_H, TILE_W, z_limit=jnp.asarray(zl), **kw))

    tb = bin_triangles(tsetup, band_h // TILE_H, W // TILE_W, TILE_H, TILE_W, cap=128,
                       tile_row_offset=tile_row0)
    zl_t = torch.from_numpy(zl)
    depth = rasterize_depth(tsetup, tb, band_h, W, TILE_H, TILE_W, z_limit=zl_t, **kw)
    vis = rasterize_visibility(tsetup, tb, depth, TILE_H, TILE_W, z_limit=zl_t, **kw)
    assert ((depth_ref > 0) & np.isfinite(zl)).any()
    assert np.all(depth_ref < zl)
    _assert_raster_contract(depth.numpy(), vis.numpy(), depth_ref, vis_ref)


def test_interpolation_matches_jax():
    verts, tris = random_scene(1, n_tris=50)
    setup = _setup_for(verts, tris, True)
    bins = jax_bin(setup, H // TILE_H, W // TILE_W, TILE_H, TILE_W, cap=128)
    depth = jax_depth(setup, bins, H, W, TILE_H, TILE_W, chunk=32)
    vis = np.array(jax_vis(setup, bins, depth, TILE_H, TILE_W, chunk=32))
    assert (vis >= 0).sum() > 100
    rng = np.random.default_rng(9)
    attrs = {"uv": rng.random((verts.shape[0], 2), dtype=np.float32),
             "color": rng.random((verts.shape[0], 3), dtype=np.float32)}

    jb = jax_interp.compute_barycentrics(jnp.asarray(vis), setup, jnp.asarray(tris))
    tbary = compute_barycentrics(torch.from_numpy(vis), to_torch(setup), torch.from_numpy(tris))
    for name in jb._fields:
        np.testing.assert_allclose(getattr(tbary, name).numpy(), np.asarray(getattr(jb, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    want = jax_interp.interpolate_attributes(jb, {k: jnp.asarray(v) for k, v in attrs.items()})
    got = interpolate_attributes(tbary, {k: torch.from_numpy(v) for k, v in attrs.items()})
    for name in attrs:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for g, w in zip(interpolate_with_derivatives(tbary, torch.from_numpy(attrs["uv"])),
                    jax_interp.interpolate_with_derivatives(jb, jnp.asarray(attrs["uv"]))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
