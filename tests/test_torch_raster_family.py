"""The port's raster-family entry points against their JAX Pallas kernels.

``rasterize_binned``, ``rasterize_fused``, ``rasterize_hybrid`` and
``rasterize_pallas`` of androidrenderer_tpu_torch/ops/raster/ launch one CUDA
kernel on the card; on the CPU they run its plain version. Each runs here
against the JAX entry point of the same name in Pallas interpret mode, at the
JAX tests' own size (W, H = 128, 64: test_raster_binned.py:24,
test_raster_pallas.py:23), on seeded random triangles fed to both as the same
setup. Tolerance is the raster contract of test_raster_bitmask.py:33-36: depth
rtol 1e-6, atol 1e-9, and visibility may differ only where depth differs; where
the JAX suite holds an entry point wider, the case uses that bound and cites it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu.ops.raster import raster_binned as jax_binned
from androidrenderer_tpu.ops.raster import raster_fused as jax_fused
from androidrenderer_tpu.ops.raster import raster_pallas as jax_pallas
from androidrenderer_tpu_torch.ops.raster import TriangleSetup, rasterize_reference
from androidrenderer_tpu_torch.ops.raster.raster_binned import rasterize_binned
from androidrenderer_tpu_torch.ops.raster.raster_fused import rasterize_fused, rasterize_hybrid
from androidrenderer_tpu_torch.ops.raster.raster_pallas import rasterize_pallas

from test_raster import random_scene
from test_raster_binned import _setup_for, H, W

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it.
torch.set_num_threads(1)


def to_torch(setup) -> TriangleSetup:
    return TriangleSetup(*(torch.from_numpy(np.array(x)) for x in setup))


def _z_limit(setup):
    """A peel bound: the first layer scaled by seeded noise, so no fragment sits
    within an ULP of it (the two implementations may round z by an ULP apart)."""
    first, _ = rasterize_reference(to_torch(setup), H, W)
    noise = np.random.default_rng(4).uniform(0.5, 1.0, (H, W))
    return np.where(first.numpy() > 0, first.numpy() * noise, np.inf).astype(np.float32)


def _alpha_grid(n):
    """Seeded 16x16 barycentric bitmaps, about half the lattice cells set."""
    bits = np.random.default_rng(5).integers(-(2**31), 2**31, (n, 8), dtype=np.int64)
    return bits.astype(np.int32)


# name: (seed, triangles, double_sided, JAX call, port call, extra input, depth rtol);
# seeds and sizes are those of the JAX suite's own cases.
def _cases():
    def binned(kw):
        return (
            lambda s, x: jax_binned.rasterize_binned(
                s, H, W, num_slabs=2, chunk=32, cap=6, kb=1, win_h=8, unroll=1,
                interpret=True,
                **{k: jnp.asarray(v) for k, v in x.items()}, **kw),
            lambda s, x: rasterize_binned(
                s, H, W, num_slabs=2, chunk=32, cap=6, kb=1, win_h=8, unroll=1,
                **{k: torch.from_numpy(v) for k, v in x.items()}, **kw),
        )

    fused_kw = dict(num_slabs=2, chunk=32, kb=1)
    return {
        "binned": (0, 50, False, *binned({}), None, 1e-6),
        "binned_z_limit": (4, 60, True, *binned({}), "z_limit", 1e-6),
        "binned_alpha_grid": (1, 50, True, *binned({}), "alpha_grid", 1e-6),
        "fused": (
            1, 50, True,
            lambda s, x: jax_fused.rasterize_fused(s, H, W, interpret=True, **fused_kw),
            lambda s, x: rasterize_fused(s, H, W, **fused_kw),
            None, 1e-6,
        ),
        # The JAX hybrid's splat and kernel round the same formulas apart by a
        # few ULP: its own suite holds it at rtol 5e-6 (test_raster_binned.py:233-235).
        "hybrid": (
            6, 80, True,
            lambda s, x: jax_fused.rasterize_hybrid(s, H, W, interpret=True, **fused_kw),
            lambda s, x: rasterize_hybrid(s, H, W, **fused_kw),
            None, 5e-6,
        ),
        "pallas": (
            0, 50, False,
            lambda s, x: jax_pallas.rasterize_pallas(
                s, H, W, num_slabs=2, chunk=32, interpret=True),
            lambda s, x: rasterize_pallas(s, H, W, num_slabs=2, chunk=32),
            None, 1e-6,
        ),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_entry_point_matches_jax_kernel(name):
    seed, n_tris, double_sided, jax_fn, port_fn, extra, rtol = CASES[name]
    verts, tris = random_scene(seed, n_tris=n_tris)
    setup = _setup_for(verts, tris, double_sided)
    inputs = {}
    if extra == "z_limit":
        inputs["z_limit"] = _z_limit(setup)
    elif extra == "alpha_grid":
        inputs["alpha_grid"] = _alpha_grid(tris.shape[0])
    depth_ref, vis_ref = (np.asarray(a) for a in jax_fn(setup, inputs))
    depth, vis = (a.numpy() for a in port_fn(to_torch(setup), inputs))
    assert (vis_ref >= 0).any()
    if extra == "z_limit":
        assert ((depth_ref > 0) & (depth_ref < inputs["z_limit"])).any()
    np.testing.assert_allclose(depth, depth_ref, rtol=rtol, atol=1e-9)
    hard = (vis != vis_ref) & (depth == depth_ref)
    assert hard.sum() == 0, f"{hard.sum()} visibility mismatches off ULP edges"


def test_entry_points_run_the_plain_version_on_cpu():
    """On CPU tensors each entry point returns the plain version's output and
    launches nothing; a tensor on another device raises, never falls back."""
    verts, tris = random_scene(2, n_tris=50)
    setup = to_torch(_setup_for(verts, tris, True))
    want = rasterize_reference(setup, H, W)
    meta = TriangleSetup(*(x.to("meta") for x in setup))
    for fn in (rasterize_binned, rasterize_fused, rasterize_hybrid, rasterize_pallas):
        before = fn.launches
        got = fn(setup, H, W)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert fn.launches == before
        with pytest.raises(ValueError):
            fn(meta, H, W)


def test_entry_points_keep_the_jax_argument_rules():
    verts, tris = random_scene(2, n_tris=50)
    setup = to_torch(_setup_for(verts, tris, True))
    with pytest.raises(ValueError):
        rasterize_binned(setup, H, W, debug_mode=1)
    with pytest.raises(ValueError):
        rasterize_fused(setup, H, W, compact=True)
    depth = rasterize_fused(setup, H, W, compact=True, depth_only=True)
    assert torch.equal(depth, rasterize_reference(setup, H, W, depth_only=True))
    with pytest.raises(ValueError):
        rasterize_hybrid(setup, H, W, backend="touch")
    with pytest.raises(TypeError):
        rasterize_hybrid(setup, H, W, backend="fused", cap=4)
