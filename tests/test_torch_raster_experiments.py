"""The port's raster design-study entry points against their JAX Pallas kernels.

``rasterize_touch``, ``rasterize_lanes`` and ``rasterize_subfold`` of
androidrenderer_tpu_torch/tools/experiments/ launch the one CUDA raster kernel on
the card; on the CPU they run its plain version. Each runs here against the JAX
entry point of the same name (tools/experiments/) in Pallas interpret mode, on
the JAX suites' own fixtures and sizes, fed to both as the same setup. One JAX
call per case; the cases are the fewest that cover each variant:

- touch: seeds 0 and 2, both sidednesses, ``touches_per_slab=1024``
  (tools/experiments/test_raster_touch.py:15-36). Tolerance of that suite
  (:33-36): at least 99.5% of depth within rtol 1e-6, atol 1e-9, and visibility
  differing where depth agrees on under 0.5% of pixels.
- lanes and subfold: the double-sided random scene, the orthographic
  ``affine_z`` depth-only scene and the alpha-fence ``alpha_grid`` scene
  (test_raster_lanes.py:58-174, test_raster_subfold.py:60-185), with the TPU
  tunables at one slab, one window batch and no unroll (they never change the
  output, and the interpret-mode compile grows with them). Tolerance of those
  suites (test_raster_lanes.py:49-55): depth rtol 5e-6, atol 1e-9; visibility
  differing only where depth differs, on under 0.5% of pixels; the depth-only
  case at least 99.5% of depth within that tolerance (:119-121).

Every case also holds the lanes suite's rule that visibility differs only where
depth does. Measured on these cases the port agrees more tightly than the suites
ask: no visibility difference at all; every depth within rtol 4.9e-6 of touch's
(the suite asks 99.5% within 1e-6) and within rtol 9e-7 of lanes' and subfold's
(the alpha fence bit for bit).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

_root = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
for _p in (os.path.join(_root, "tools"), os.path.join(_root, "tools", "experiments")):
    if _p not in sys.path:
        sys.path.append(_p)

import raster_lanes as jax_lanes  # noqa: E402  (tools/experiments/)
import raster_subfold as jax_subfold  # noqa: E402
import raster_touch as jax_touch  # noqa: E402

from androidrenderer_tpu.camera import Camera  # noqa: E402
from androidrenderer_tpu.ops.raster import transform_to_clip, triangle_setup  # noqa: E402
from androidrenderer_tpu_torch.ops.raster import TriangleSetup, rasterize_reference  # noqa: E402
from androidrenderer_tpu_torch.tools.experiments.raster_lanes import rasterize_lanes  # noqa: E402
from androidrenderer_tpu_torch.tools.experiments.raster_subfold import (  # noqa: E402
    rasterize_subfold,
)
from androidrenderer_tpu_torch.tools.experiments.raster_touch import rasterize_touch  # noqa: E402

from test_raster import random_scene  # noqa: E402
from test_raster_pallas import H, W, _setup_for  # noqa: E402

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it.
torch.set_num_threads(1)


def to_torch(setup) -> TriangleSetup:
    return TriangleSetup(*(torch.from_numpy(np.array(x)) for x in setup))


def _ortho_setup():
    """The orthographic scene of test_raster_lanes.py:100-110."""
    rng = np.random.default_rng(7)
    verts = rng.uniform([-1.5, -1.5, 0.1], [1.5, 1.5, 0.9], (90, 3)).astype(np.float32)
    tris = rng.integers(0, 90, (40, 3)).astype(np.int32)
    clip = jnp.concatenate([jnp.asarray(verts), jnp.ones((90, 1), jnp.float32)], axis=1)
    return triangle_setup(clip, jnp.asarray(tris), W, H)


@functools.lru_cache(maxsize=None)
def _alpha_scene():
    from androidrenderer_tpu.scene.procedural import alpha_test_scene

    return alpha_test_scene().build(with_bvh=False)[0]


def _alpha_setup(masked_only):
    """The alpha fence of test_raster_lanes.py:148-174 (lanes rasterizes only
    its masked triangles, subfold all of them)."""
    scene = _alpha_scene()
    w, h = 128, 96
    cam = Camera(fov_degrees=75.0, aspect=w / h, render_resolution=(w, h))
    cam.set_position([0.0, 1.0, -3.0])
    clip = transform_to_clip(scene.positions, jnp.asarray(cam.view_data().view_proj))
    setup = triangle_setup(clip, scene.tri_indices, w, h,
                           double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid)
    if masked_only:
        setup = setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 1))
    return setup, {"alpha_grid": np.array(scene.tri_alpha_grid)}, h, w


def _random(seed, n_tris, double_sided):
    return _setup_for(*random_scene(seed, n_tris=n_tris), double_sided), {}, H, W


# name: (fixture() -> (JAX setup, extra inputs as numpy, h, w), JAX fn, port fn, kwargs)
_TOUCH = dict(num_slabs=2, chunk=64, k_batch=8, touches_per_slab=1024)
_FOLD = dict(num_slabs=1, chunk=32, kb=1, unroll=1)
CASES = {
    f"touch_seed{seed}_{'double' if ds else 'single'}": (
        lambda seed=seed, ds=ds: _random(seed, 60, ds),
        jax_touch.rasterize_touch, rasterize_touch, _TOUCH,
    )
    for seed in (0, 2) for ds in (True, False)
}
for _name, _jax_fn, _port_fn, _masked_only in (
    ("lanes", jax_lanes.rasterize_lanes, rasterize_lanes, True),
    ("subfold", jax_subfold.rasterize_subfold, rasterize_subfold, False),
):
    CASES[f"{_name}_double_sided"] = (
        lambda: _random(0, 50, True), _jax_fn, _port_fn, _FOLD)
    CASES[f"{_name}_affine_depth_only"] = (
        lambda: (_ortho_setup(), {}, H, W), _jax_fn, _port_fn,
        dict(_FOLD, depth_only=True, affine_z=True))
    CASES[f"{_name}_alpha_grid"] = (
        lambda m=_masked_only: _alpha_setup(m), _jax_fn, _port_fn, _FOLD)


@functools.lru_cache(maxsize=None)
def _jitted(jax_fn, h, w, kw_items):
    """One compiled interpret-mode call per entry point, size and tunables: the
    cases of one family share it (eager Pallas interpret mode compiles every
    small op of the XLA prep on its own)."""
    return jax.jit(lambda setup, extra: jax_fn(setup, h, w, interpret=True, **dict(kw_items),
                                                 **extra))


@pytest.mark.parametrize("name", list(CASES))
def test_entry_point_matches_jax_kernel(name):
    fixture, jax_fn, port_fn, kw = CASES[name]
    setup, extra, h, w = fixture()
    want = _jitted(jax_fn, h, w, tuple(sorted(kw.items())))(
        setup, {k: jnp.asarray(v) for k, v in extra.items()})
    got = port_fn(to_torch(setup), h, w, **kw, **{k: torch.from_numpy(v) for k, v in extra.items()})
    if kw.get("depth_only"):
        depth_ref, depth = np.asarray(want), got.numpy()
        close = np.isclose(depth, depth_ref, rtol=5e-6, atol=1e-9)
        assert close.mean() > 0.995
        assert (depth > 0).any()
    else:
        (depth_ref, vis_ref), (depth, vis) = (np.asarray(a) for a in want), (a.numpy() for a in got)
        assert (vis_ref >= 0).sum() > 50
        if name.startswith("touch"):  # test_raster_touch.py:33-36
            close = np.isclose(depth, depth_ref, rtol=1e-6, atol=1e-9)
            assert close.mean() > 0.995, f"depth mismatch {1 - close.mean():.4f}"
            assert ((vis != vis_ref) & close).mean() < 0.005
        else:  # test_raster_lanes.py:49-55
            np.testing.assert_allclose(depth, depth_ref, rtol=5e-6, atol=1e-9)
        assert (vis != vis_ref).mean() < 0.005
        assert not ((vis != vis_ref) & (depth == depth_ref)).any()


def test_entry_points_run_the_plain_version_on_cpu():
    """On CPU tensors each entry point returns the plain version's output and
    launches nothing; a tensor on another device raises, never falls back; a
    timing stub raises."""
    setup = to_torch(_setup_for(*random_scene(2, n_tris=50), True))
    want = rasterize_reference(setup, H, W)
    meta = TriangleSetup(*(x.to("meta") for x in setup))
    for fn in (rasterize_touch, rasterize_lanes, rasterize_subfold):
        before = fn.launches
        got = fn(setup, H, W)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert fn.launches == before
        with pytest.raises(ValueError):
            fn(meta, H, W)
    for fn in (rasterize_lanes, rasterize_subfold):
        with pytest.raises(ValueError, match="debug_mode"):
            fn(setup, H, W, debug_mode=1)
    # The TPU's capacity drops touches; the port draws every triangle.
    assert torch.equal(rasterize_touch(setup, H, W, touches_per_slab=64)[1], want[1])
