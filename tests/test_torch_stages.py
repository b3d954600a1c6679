"""The port's frame stages against the JAX package's, each fed identical inputs.

Inputs are made with numpy from a seed (or baked by the shared numpy scene code)
and handed to both sides. Float stages are held to rtol 1e-5, atol 1e-6 unless
a comment states a measured reason. The staggered cascades and ``sample_csm``
are compared inside test_torch_frame.py, where the JAX frame's own cascade
data exists (an eager refit can flip texel snapping).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu.camera import Camera
from androidrenderer_tpu.ops import bloom as jax_bloom
from androidrenderer_tpu.ops import gbuffer as jax_gbuffer
from androidrenderer_tpu.ops import lighting as jax_lighting
from androidrenderer_tpu.ops import post as jax_post
from androidrenderer_tpu.ops import shadow as jax_shadow
from androidrenderer_tpu.ops import sky as jax_sky
from androidrenderer_tpu.ops.raster import setup as jax_setup
from androidrenderer_tpu.scene.procedural import courtyard_scene
from androidrenderer_tpu_torch.ops import bloom, lighting, post, shadow, sky
from androidrenderer_tpu_torch.ops.gbuffer import GBuffer, resolve_gbuffer
from androidrenderer_tpu_torch.ops.raster import TriangleSetup, rasterize_reference
from androidrenderer_tpu_torch.ops.taa import upscale_bilinear
from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

from test_torch_scene import jax_leaves

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it (a 0.55 s test here took 27 s beside 4 busy workers).
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(ours, theirs, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def courtyard():
    """The default courtyard baked once, as the JAX scene and its port twin."""
    jscene, _ = courtyard_scene().build(with_bvh=False)
    return jscene, scene_arrays_from_numpy(jax_leaves(jscene), "cpu")


def _camera(w, h):
    cam = Camera(fov_degrees=75.0, aspect=w / h, render_resolution=(w, h))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    return cam.view_data()


def test_fit_cascades(courtyard):
    jscene, scene = courtyard
    vd = _camera(128, 128)
    args = (4, 1024, 0.05, 128.0, 0.95)
    jc = jax_shadow.fit_cascades(
        jnp.asarray(vd.inverse_view), vd.projection[0, 0], vd.projection[1, 1],
        jscene.sun_direction, *args,
    )
    tc = shadow.fit_cascades(
        t(vd.inverse_view), float(vd.projection[0, 0]), float(vd.projection[1, 1]),
        scene.sun_direction, *args,
    )
    # Matrix entries are O(1e-3..1); the translation column is a sum of
    # products of such entries, so its absolute rounding is ~1e-6 as well.
    close(tc.matrices, jc.matrices, msg="matrices")
    close(tc.splits, jc.splits, msg="splits")
    close(tc.canonical, jc.canonical, msg="canonical")


def test_resolve_gbuffer(courtyard):
    """The bench material flags (normal + MR textures, no emission) and all on."""
    jscene, scene = courtyard
    w, h = 128, 96
    vd = _camera(w, h)
    js = jax_setup.triangle_setup_corners(
        jscene.tri_corner_pos, jnp.asarray(vd.view_proj), w, h,
        double_sided=jscene.tri_double_sided, tri_valid=jscene.tri_valid,
    )
    ts = TriangleSetup(*(t(x) for x in js))
    depth, vis = rasterize_reference(ts, h, w)
    assert (vis >= 0).float().mean() > 0.5
    for flags in (dict(use_emission=False), dict()):
        jg = jax_gbuffer.resolve_gbuffer(
            jscene, js, jnp.asarray(vis.numpy()), jnp.asarray(depth.numpy()), **flags
        )
        tg = resolve_gbuffer(scene, ts, vis, depth, **flags)
        for name in GBuffer._fields:
            ours, theirs = getattr(tg, name), getattr(jg, name)
            if name == "valid":
                assert np.array_equal(ours.numpy(), np.asarray(theirs))
            else:
                close(ours, theirs, msg=name)


def test_sky_background(courtyard):
    jscene, scene = courtyard
    w, h = 96, 64
    vd = _camera(w, h)
    vd_up = _camera(w, h)._replace(inverse_view=np.linalg.inv(
        Camera(fov_degrees=75.0, aspect=w / h).view_matrix()).astype(np.float32))
    for v in (vd, vd_up):
        js = jax_sky.sky_background(
            jnp.asarray(v.inverse_view), v.projection[0, 0], v.projection[1, 1],
            jscene.sun_direction, jscene.sun_color, h, w,
        )
        ts = sky.sky_background(
            t(v.inverse_view), float(v.projection[0, 0]), float(v.projection[1, 1]),
            scene.sun_direction, scene.sun_color, h, w,
        )
        assert float(ts.max()) > 0.0
        # Measured max rel 7.5e-4 (0.75% of values past 1e-5): the march's
        # altitude |p| - R_ground cancels in float32 (one ULP of |p| ~ 6.4 Mm
        # is ~0.5 m), so the 1-ULP ray differences between the two matmuls
        # become ~1e-4 relative density differences over 12 steps.
        close(ts, js, rtol=2e-3)


def _random_gbuffer(rng, h, w):
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    valid = rng.uniform(size=(h, w)) > 0.2
    return dict(
        base_color=rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
        normal=n,
        roughness=rng.uniform(0.045, 1, (h, w, 1)).astype(np.float32),
        metalness=rng.uniform(0, 1, (h, w, 1)).astype(np.float32),
        emission=rng.uniform(0, 2, (h, w, 3)).astype(np.float32),
        world_position=rng.uniform(-10, 10, (h, w, 3)).astype(np.float32),
        depth=rng.uniform(0, 1, (h, w)).astype(np.float32),
        valid=valid,
    )


def test_sun_lighting_and_compose():
    rng = np.random.default_rng(11)
    h, w = 24, 40
    g = _random_gbuffer(rng, h, w)
    cam = np.array([0.5, 1.7, 6.0], np.float32)
    sun_dir = np.array([0.35, -1.0, 0.25], np.float32)
    sun_col = np.array([1.0, 0.96, 0.88], np.float32) * 110000.0
    shadow_f = rng.uniform(0, 1, (h, w, 1)).astype(np.float32)
    sky_img = rng.uniform(0, 5, (h, w, 3)).astype(np.float32)
    jgb = jax_gbuffer.GBuffer(**{k: jnp.asarray(v) for k, v in g.items()})
    tgb = GBuffer(**{k: t(v) for k, v in g.items()})
    for sh in (shadow_f, None):
        jd = jax_lighting.sun_lighting(
            jgb, jnp.asarray(cam), jnp.asarray(sun_dir), jnp.asarray(sun_col),
            None if sh is None else jnp.asarray(sh), 0.00031415927,
        )
        td = lighting.sun_lighting(
            tgb, t(cam), t(sun_dir), t(sun_col), None if sh is None else t(sh), 0.00031415927,
        )
        close(td, jd)
        jl = jax_lighting.compose_lit_scene(jgb, jd, None, None, jnp.asarray(sky_img))
        tl = lighting.compose_lit_scene(tgb, td, None, None, t(sky_img))
        close(tl, jl)


@pytest.mark.parametrize("shape,mips", [((37, 53), 3), ((45, 64), 4)])
def test_bloom_chain_odd_sizes(shape, mips):
    """Odd mip sizes exercise jax.image.resize's edge weights, which the port
    rebuilds rather than assuming F.interpolate's."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 4, shape + (3,)).astype(np.float32)
    jb = jax_bloom.bloom_chain(jnp.asarray(img), mips)
    tb = bloom.bloom_chain(t(img), mips)
    close(tb, jb)


@pytest.mark.parametrize("src,dst", [((17, 9), (34, 18)), ((20, 30), (13, 47))])
def test_resize_matches_jax_image_resize(src, dst):
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, src + (3,)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), dst + (3,), method="linear")
    close(upscale_bilinear(t(img), *dst), want)


def test_composite_and_to_uint8():
    rng = np.random.default_rng(8)
    hdr = rng.uniform(0, 20, (30, 50, 3)).astype(np.float32)
    bl = rng.uniform(0, 50, (30, 50, 3)).astype(np.float32)
    jc = jax_post.composite(jnp.asarray(hdr), jnp.asarray(bl), 0.014159)
    tc = post.composite(t(hdr), t(bl), 0.014159)
    close(tc, jc)
    ldr = rng.uniform(-0.1, 1.1, (30, 50, 3)).astype(np.float32)
    assert np.array_equal(post.to_uint8(t(ldr)).numpy(), np.asarray(jax_post.to_uint8(jnp.asarray(ldr))))
