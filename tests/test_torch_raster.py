"""The port's rasterizer against the JAX package's Pallas kernel.

``rasterize_reference`` (the plain PyTorch version of csrc/raster.cu) runs on the
fixtures of test_raster_bitmask.py against ``rasterize_bitmask(interpret=True)``,
fed the same triangle setup. Tolerance is the bitmask kernel's own against its
oracle (test_raster_bitmask.py:33-36, 189-196): depth rtol 1e-6 (2e-5 at width
512), atol 1e-9, and visibility may differ only where depth differs (a 1-ULP
depth difference flips which of two coplanar-ish triangles wins).

The record pack, the corner-table setup and the triangle frustum cull are held
to the JAX versions on one camera. The CUDA kernel itself is held to the plain
version on the card by test_torch_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu.camera import Camera
from androidrenderer_tpu.ops import culling as jax_culling
from androidrenderer_tpu.ops.raster import setup as jax_setup
from androidrenderer_tpu.ops.raster.raster_bitmask import rasterize_bitmask
from androidrenderer_tpu.ops.raster.raster_fused import pack_fused_records as jax_pack
from androidrenderer_tpu.scene.procedural import alpha_test_scene, courtyard_scene
from androidrenderer_tpu_torch.ops import culling
from androidrenderer_tpu_torch.ops.raster import (
    TriangleSetup,
    clip_to_pixel_h,
    pack_fused_records,
    rasterize,
    rasterize_reference,
    triangle_setup_corners,
)

from test_raster import random_scene
from test_raster_binned import _setup_for, H, W

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it (a 0.55 s test here took 27 s beside 4 busy workers).
torch.set_num_threads(1)

_bitmask = jax.jit(
    functools.partial(rasterize_bitmask, num_slabs=2, chunk=32, kb=4, win_h=8, interpret=True),
    static_argnames=("height", "width", "depth_only", "affine_z"),
)

def to_torch(setup) -> TriangleSetup:
    return TriangleSetup(*(torch.from_numpy(np.array(x)) for x in setup))


def _pad_rows(a, rows, fill=0):
    return jnp.concatenate([a, jnp.full((rows - a.shape[0], *a.shape[1:]), fill, a.dtype)])


def jax_raster(setup, height, width, **kw):
    """The Pallas kernel on ``setup`` padded with dead rows to a multiple of 256,
    so calls of one signature but different triangle counts share a compile."""
    rows = -(-setup.valid.shape[0] // 256) * 256
    setup = jax.tree.map(lambda a: _pad_rows(a, rows), setup)
    if kw.get("alpha_grid") is not None:
        kw["alpha_grid"] = _pad_rows(jnp.asarray(kw["alpha_grid"]), rows, -1)
    out = _bitmask(setup, height=height, width=width, **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def assert_raster_contract(depth, vis, depth_ref, vis_ref, rtol=1e-6):
    np.testing.assert_allclose(depth, depth_ref, rtol=rtol, atol=1e-9)
    hard = (vis != vis_ref) & (depth == depth_ref)
    assert hard.sum() == 0, f"{hard.sum()} visibility mismatches off ULP edges"


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("double_sided", [True, False])
def test_reference_matches_bitmask(seed, double_sided):
    verts, tris = random_scene(seed, n_tris=50)
    setup = _setup_for(verts, tris, double_sided)
    depth_ref, vis_ref = jax_raster(setup, H, W)
    depth, vis = rasterize_reference(to_torch(setup), H, W)
    assert (vis_ref >= 0).any()
    assert_raster_contract(depth.numpy(), vis.numpy(), depth_ref, vis_ref)


def _ortho_setup(seed, n_tris):
    """Orthographic (w == 1) setup: the CSM path's depth_only + affine_z mode."""
    verts, tris = random_scene(seed, n_tris=n_tris)
    m = np.array([[0.25, 0, 0, 0], [0, 0.25, 0, 0], [0, 0, 1 / 16.0, 1.0], [0, 0, 0, 1]],
                 np.float32)
    clip = jax_setup.transform_to_clip(jnp.asarray(verts), jnp.asarray(m))
    return jax_setup.triangle_setup(
        clip, jnp.asarray(tris), W, H, double_sided=jnp.full((tris.shape[0],), True)
    )


def test_reference_matches_bitmask_depth_only_affine():
    setup = _ortho_setup(3, 60)
    depth_ref = jax_raster(setup, H, W, depth_only=True, affine_z=True)
    depth = rasterize_reference(to_torch(setup), H, W, depth_only=True, affine_z=True)
    assert (depth_ref > 0).any()
    np.testing.assert_allclose(depth.numpy(), depth_ref, rtol=1e-6, atol=1e-9)


def test_reference_matches_bitmask_sparse_validity():
    verts, tris = random_scene(7, n_tris=160)
    setup = _setup_for(verts, tris, True)
    keep = np.zeros(tris.shape[0], dtype=bool)
    keep[[37, 63, 64, 100, 159]] = True
    setup = setup._replace(valid=setup.valid & jnp.asarray(keep))
    depth_ref, vis_ref = jax_raster(setup, H, W)
    depth, vis = rasterize_reference(to_torch(setup), H, W)
    assert set(np.unique(vis.numpy())) <= {-1, 37, 63, 64, 100, 159}
    assert_raster_contract(depth.numpy(), vis.numpy(), depth_ref, vis_ref)


def test_reference_matches_bitmask_z_limit():
    """The depth-peeling gate: accept only z < z_limit. The limit is the first
    layer scaled by seeded noise, so no triangle sits within an ULP of it (the
    two implementations round z differently by an ULP, and a limit equal to a
    layer's own depth would flip that layer in or out)."""
    verts, tris = random_scene(4, n_tris=60)
    setup = _setup_for(verts, tris, True)
    first, _ = rasterize_reference(to_torch(setup), H, W)
    noise = np.random.default_rng(4).uniform(0.5, 1.0, (H, W))
    zlim = np.where(first.numpy() > 0, first.numpy() * noise, np.inf).astype(np.float32)
    depth_ref, vis_ref = jax_raster(setup, H, W, z_limit=jnp.asarray(zlim))
    depth, vis = rasterize_reference(to_torch(setup), H, W, z_limit=torch.from_numpy(zlim))
    assert ((depth_ref > 0) & (depth_ref < zlim)).any()
    assert_raster_contract(depth.numpy(), vis.numpy(), depth_ref, vis_ref)


def test_reference_matches_bitmask_alpha_grid():
    """In-kernel 16x16 barycentric alpha bitmaps on the alpha-test fence."""
    scene, _ = alpha_test_scene().build(with_bvh=False)
    w, h = 128, 96
    cam = Camera(fov_degrees=75.0, aspect=w / h, render_resolution=(w, h))
    cam.set_position([0.0, 1.0, -3.0])
    vd = cam.view_data()
    clip = jax_setup.transform_to_clip(scene.positions, jnp.asarray(vd.view_proj))
    setup = jax_setup.triangle_setup(
        clip, scene.tri_indices, w, h,
        double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid,
    )
    setup = setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 1))
    # The scene's 16 triangles, without the bake's padding rows.
    setup = jax.tree.map(lambda a: a[:32], setup)
    grid = scene.tri_alpha_grid[:32]
    depth_ref, vis_ref = jax_raster(setup, h, w, alpha_grid=grid)
    depth, vis = rasterize_reference(
        to_torch(setup), h, w, alpha_grid=torch.from_numpy(np.array(grid))
    )
    covered = (vis_ref >= 0).mean()
    assert 0.02 < covered < 0.98  # the bitmap cut holes into the fence
    assert_raster_contract(depth.numpy(), vis.numpy(), depth_ref, vis_ref)


@pytest.mark.parametrize("width", [256, 512])
def test_reference_matches_bitmask_multi_column(width):
    h = 64
    verts, tris = random_scene(9, n_tris=80)
    cam = Camera(fov_degrees=75.0, aspect=width / h, render_resolution=(width, h))
    cam.yaw = np.pi
    vd = cam.view_data()
    clip = jax_setup.transform_to_clip(jnp.asarray(verts), jnp.asarray(vd.view_proj))
    setup = jax_setup.triangle_setup(
        clip, jnp.asarray(tris), width, h, double_sided=jnp.full((tris.shape[0],), True)
    )
    depth_ref, vis_ref = jax_raster(setup, h, width)
    depth, vis = rasterize_reference(to_torch(setup), h, width)
    # The bitmask kernel's own multi-column tolerance (test_raster_bitmask.py:
    # 189-194): wide perspective edges where q -> 0 amplify an ULP; measured
    # here max rel 1.4e-6 on 3 of 16384 pixels at width 256.
    assert_raster_contract(depth.numpy(), vis.numpy(), depth_ref, vis_ref, rtol=2e-5)


@pytest.fixture(scope="module")
def courtyard_view():
    scene, _ = courtyard_scene().build(with_bvh=False)
    w, h = 256, 128
    cam = Camera(fov_degrees=75.0, aspect=w / h, render_resolution=(w, h))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    return scene, cam.view_data(), w, h


def test_triangle_setup_corners_and_records_match(courtyard_view):
    scene, vd, w, h = courtyard_view
    js = jax_setup.triangle_setup_corners(
        scene.tri_corner_pos, jnp.asarray(vd.view_proj), w, h,
        double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid,
    )
    ts = triangle_setup_corners(
        torch.from_numpy(np.array(scene.tri_corner_pos)), torch.from_numpy(vd.view_proj),
        w, h, double_sided=torch.from_numpy(np.array(scene.tri_double_sided)),
        tri_valid=torch.from_numpy(np.array(scene.tri_valid)),
    )
    for name in ("edge", "q", "r", "bbox"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)), rtol=1e-6, atol=0,
            err_msg=name,
        )
    assert np.array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert np.array_equal(ts.double_sided.numpy(), np.asarray(js.double_sided))
    clip = np.random.default_rng(2).normal(0, 3, (64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        clip_to_pixel_h(torch.from_numpy(clip), w, h).numpy(),
        np.asarray(jax_setup.clip_to_pixel_h(jnp.asarray(clip), w, h)), rtol=1e-6, atol=1e-6,
    )
    # The record pack is bit-equal on the same setup.
    for affine in (False, True):
        ours = pack_fused_records(to_torch(js), affine_z=affine).numpy()
        assert np.array_equal(ours, np.asarray(jax_pack(js, affine_z=affine)))


def test_frustum_cull_triangles_match(courtyard_view):
    scene, vd, _, _ = courtyard_view
    jm = jax_culling.frustum_cull_triangles(
        scene.tri_corner_pos, jnp.asarray(vd.view), jnp.asarray(vd.frustum),
        vd.z_near, scene.tri_valid,
    )
    tm = culling.frustum_cull_triangles(
        torch.from_numpy(np.array(scene.tri_corner_pos)), torch.from_numpy(vd.view),
        torch.from_numpy(vd.frustum), float(vd.z_near),
        torch.from_numpy(np.array(scene.tri_valid)),
    )
    jm = np.asarray(jm)
    assert 0 < jm.sum() < np.asarray(scene.tri_valid).sum()
    assert np.array_equal(tm.numpy(), jm)


def test_rasterize_dispatches_on_device():
    """CPU tensors take the plain version; other devices raise, never fall back."""
    verts, tris = random_scene(0, n_tris=50)
    setup = to_torch(_setup_for(verts, tris, True))
    launches = rasterize.launches
    d0, v0 = rasterize(setup, H, W)
    d1, v1 = rasterize_reference(setup, H, W)
    assert torch.equal(d0, d1) and torch.equal(v0, v1)
    assert rasterize.launches == launches
    meta = TriangleSetup(*(x.to("meta") for x in setup))
    with pytest.raises(ValueError):
        rasterize(meta, H, W)
