"""The port's alpha-test peel, translucency and default frames against the JAX package.

Units, fed identical inputs: ``sample_bilinear``, ``pack_alpha_planes`` and
``_sample_alpha`` at rtol 1e-5 / atol 1e-6, and ``rasterize_masked_peeled`` on
the alpha-fence fixture under the raster contract (test_raster_bitmask.py:33-36).

Frames: the headless CLI's default frame (A, ``default_frame_config``: two-phase
HiZ occlusion, in-kernel alpha bitmaps, translucency) and its exact-alpha twin
(B, ``alpha_bitmap=False``) at 128^2 on the courtyard with its blend curtains,
3 chained frames from identical temporal state (``temporal_from_numpy``), held
by the method of test_torch_frame.py: both frames sample one shared cascade cache
(the port's steady-state atlas; the cascade rasters themselves are held there),
then the u8 image agrees within one step on >= 99.5% of pixels with SSIM >= 0.99.
The JAX frame takes its cheaper CPU branch per config: A needs the Pallas branch
for its bitmaps (``pallas_interpret=True``); B runs the XLA branch with
``max_tris_per_tile`` above the peak bin count, which the test asserts.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu import config as jax_config
from androidrenderer_tpu.camera import Camera as JaxCamera
from androidrenderer_tpu.ops import shadow as jax_shadow
from androidrenderer_tpu.ops import texture as jax_tex
from androidrenderer_tpu.ops.culling import frustum_cull_triangles as jax_frustum_cull
from androidrenderer_tpu.ops.raster import masked as jax_masked
from androidrenderer_tpu.ops.raster import setup as jax_setup
from androidrenderer_tpu.ops.raster.binning import bin_triangles
from androidrenderer_tpu.render import make_renderer as jax_make_renderer
from androidrenderer_tpu.render import temporal_state_for as jax_temporal_state_for
from androidrenderer_tpu.scene import procedural as jax_procedural
from androidrenderer_tpu.utils.image import ssim
from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.config import RenderParams, default_frame_config
from androidrenderer_tpu_torch.ops import shadow, texture
from androidrenderer_tpu_torch.ops.raster import TriangleSetup, rasterize
from androidrenderer_tpu_torch.ops.raster import masked
from androidrenderer_tpu_torch.render import frame as frame_mod
from androidrenderer_tpu_torch.render import make_renderer, temporal_from_numpy
from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

from test_torch_frame import to_jax_config
from test_torch_scene import jax_leaves

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it.
torch.set_num_threads(1)

N = 128
FRAMES = 3
# Bins of the XLA branch hold this many triangles per 32x128 tile; the frames
# fixture asserts that no bin of this scene and view holds more.
XLA_CAP = 8192


def to_torch(setup) -> TriangleSetup:
    return TriangleSetup(*(torch.from_numpy(np.array(x)) for x in setup))


def _camera(cls, w=N, h=N, pos=(0.0, 1.7, 6.0), pitch=-0.05, yaw=np.pi):
    cam = cls(fov_degrees=75.0, aspect=w / h, z_near=0.05, render_resolution=(w, h))
    cam.set_position(list(pos))
    cam.pitch, cam.yaw = pitch, yaw
    return cam.view_data()


@pytest.fixture(scope="module")
def fence():
    """The alpha-fence fixture at 128^2: JAX bake, the port's arrays of it, and
    the JAX setup of its masked triangles."""
    jscene, _ = jax_procedural.alpha_test_scene().build(with_bvh=False)
    scene = scene_arrays_from_numpy(jax_leaves(jscene), "cpu")
    vd = _camera(JaxCamera, pos=(0.0, 1.0, -3.0), pitch=0.0, yaw=0.0)
    setup = jax_setup.triangle_setup_corners(
        jscene.tri_corner_pos, jnp.asarray(vd.view_proj), N, N,
        double_sided=jscene.tri_double_sided, tri_valid=jscene.tri_valid,
    )
    setup_m = setup._replace(valid=setup.valid & (jscene.tri_alpha_mode == 1))
    return jscene, scene, setup_m


def test_sample_bilinear_matches_jax(fence):
    jscene, scene, _ = fence
    rng = np.random.default_rng(11)
    shape = (64, 33)
    entry = rng.integers(0, np.asarray(jscene.tex_start).shape[0], shape)
    start = np.asarray(jscene.tex_start)[entry]
    log2b = np.asarray(jscene.tex_log2b)[entry]
    uv = rng.uniform(-2.0, 3.0, (*shape, 2)).astype(np.float32)
    level = rng.integers(-1, 9, shape).astype(np.int32)
    want = jax_tex.sample_bilinear(
        jscene.textures, jnp.asarray(start), jnp.asarray(log2b), jnp.asarray(uv),
        jnp.asarray(level),
    )
    got = texture.sample_bilinear(
        scene.textures, torch.from_numpy(start), torch.from_numpy(log2b),
        torch.from_numpy(uv), torch.from_numpy(level),
    )
    want = np.asarray(want)
    assert want.std() > 0.01
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_alpha_planes_and_sample_alpha_match_jax(fence):
    jscene, scene, setup_m = fence
    want = np.asarray(jax_masked.pack_alpha_planes(jscene, setup_m))
    got = masked.pack_alpha_planes(scene, to_torch(setup_m)).numpy()
    assert got.shape == want.shape == (np.asarray(jscene.tri_valid).shape[0], 13)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    _, vis = rasterize(to_torch(setup_m), N, N)
    assert 0.05 < (vis >= 0).float().mean() < 0.95
    a_j, c_j = jax_masked._sample_alpha(jscene, setup_m, jnp.asarray(vis.numpy()))
    a_t, c_t = masked._sample_alpha(scene, to_torch(setup_m), vis)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5, atol=1e-6)


def test_masked_peel_matches_jax(fence):
    """Three peel layers over an empty opaque pass; the JAX side takes its XLA
    branch with bins that hold every triangle (its peak count is asserted)."""
    jscene, scene, setup_m = fence
    cap = 256
    assert int(np.asarray(bin_triangles(setup_m, N // 32, 1, 32, 128, cap).counts).max()) <= cap
    base_d = np.zeros((N, N), np.float32)
    base_v = np.full((N, N), -1, np.int32)
    d_j, v_j = jax_masked.rasterize_masked_peeled(
        jscene, setup_m, jnp.asarray(base_d), jnp.asarray(base_v), 32, 128, cap=cap, layers=3,
    )
    d_t, v_t = masked.rasterize_masked_peeled(
        scene, to_torch(setup_m), torch.from_numpy(base_d), torch.from_numpy(base_v), layers=3,
    )
    d_j, v_j = np.asarray(d_j), np.asarray(v_j)
    first, _ = rasterize(to_torch(setup_m), N, N)
    # The peel punched holes the first layer covered.
    assert 0 < (v_j >= 0).sum() < (first.numpy() > 0).sum()
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-6, atol=1e-9)
    hard = (v_t.numpy() != v_j) & (d_t.numpy() == d_j)
    assert hard.sum() == 0, f"{hard.sum()} visibility mismatches off ULP edges"


@pytest.fixture(scope="module")
def courtyard():
    jscene, _ = jax_procedural.courtyard_scene(curtains=True).build(with_bvh=False)
    scene = scene_arrays_from_numpy(jax_leaves(jscene), "cpu")
    view = _camera(Camera)
    cfg = default_frame_config(N, N, shadow_cascade_resolution=N)
    cascades = shadow.fit_cascades(
        torch.from_numpy(view.inverse_view), float(view.projection[0, 0]),
        float(view.projection[1, 1]), scene.sun_direction, cfg.num_shadow_cascades, N,
        cfg.z_near, cfg.shadow_max_distance, cfg.shadow_cascade_split_lambda,
    )
    maps = shadow.render_shadow_cascades(
        scene.positions, scene.tri_indices, scene.tri_valid, cascades, N,
        double_sided=scene.tri_double_sided, proxy=scene.proxy,
        proxy_from_cascade=cfg.shadow_proxy_from_cascade, corners=scene.tri_corner_pos,
    )
    return jscene, scene, view, (maps, shadow.pack_pcf_taps(maps), cascades.matrices)


def _peak_bin_count(jscene, view, cfg):
    """The most triangles any 32x128 tile of the main view bins, over the opaque,
    masked and blend sets the XLA branch rasterizes (one jitted count)."""
    return int(_peak_bin_count_jit(jscene, jnp.asarray(view.view), jnp.asarray(view.frustum),
                                   np.float32(view.z_near), jnp.asarray(view.view_proj),
                                   cfg.max_tris_per_tile))


@partial(jax.jit, static_argnums=5)
def _peak_bin_count_jit(jscene, view_m, frustum, z_near, view_proj, cap):
    mask = jax_frustum_cull(jscene.tri_corner_pos, view_m, frustum, z_near, jscene.tri_valid)
    setup = jax_setup.triangle_setup_corners(
        jscene.tri_corner_pos, view_proj, N, N,
        double_sided=jscene.tri_double_sided, tri_valid=mask,
    )
    peak = jnp.int32(0)
    for sel in (jscene.tri_alpha_mode == 0, jscene.tri_alpha_mode == 1,
                jscene.tri_alpha_mode == 2):
        bins = bin_triangles(setup._replace(valid=setup.valid & sel), N // 32, N // 128,
                             32, 128, cap)
        peak = jnp.maximum(peak, bins.counts.max())
    return peak


@pytest.fixture(scope="module", params=["A", "B"])
def frames(request, courtyard):
    """3 chained frames of config A or B from the JAX package and the port,
    both sampling the shared cascade cache."""
    jscene, scene, view, (maps, packed, mats) = courtyard
    cfg = default_frame_config(N, N, shadow_cascade_resolution=N,
                               alpha_bitmap=request.param == "A")
    jcfg = to_jax_config(cfg)  # pallas_interpret=True
    if request.param == "B":
        jcfg = jcfg.replace(pallas_interpret=False, raster_backend=jax_config.RasterBackend.XLA,
                            max_tris_per_tile=XLA_CAP)
        assert _peak_bin_count(jscene, view, jcfg) <= XLA_CAP
    jt = jax_temporal_state_for(jcfg)
    tt = temporal_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in
         ("frame_index", "prev_visible_prims", "csm_packed", "csm_matrices")}, "cpu")
    params = RenderParams.default()
    jparams = jax_config.RenderParams.default()
    renderer = make_renderer(cfg)
    jax_out, port_out, jax_temporals = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        # The Pallas branch samples the staggered cache, the XLA branch rebuilds
        # every cascade: both get the shared atlas, as does the port.
        mp.setattr(jax_shadow, "render_shadow_cascades_staggered",
                   lambda *a, **k: (jnp.asarray(packed.numpy()), jnp.asarray(mats.numpy())))
        mp.setattr(jax_shadow, "render_shadow_cascades",
                   lambda *a, **k: jnp.asarray(maps.numpy()))
        mp.setattr(frame_mod.shadow_ops, "render_shadow_cascades_staggered",
                   lambda *a, **k: (packed, mats))
        jax_renderer = jax_make_renderer(jcfg)
        for _ in range(FRAMES):
            jo, jt = jax_renderer(jscene, view, jparams, jt)
            to, tt = renderer(scene, view, params, tt)
            jax_out.append(jo)
            port_out.append(to)
            jax_temporals.append(jt)
    return dict(cfg=cfg, scene=scene, view=view, jax=jax_out, port=port_out,
                jax_temporals=jax_temporals, port_temporal=tt, packed=packed, mats=mats)


def test_frame_depth_and_visibility(frames):
    """The raster contract, widened as test_torch_frame.py widens it for setups
    computed by two programs (XLA's jit contracts the setup's cross products into
    FMAs; measured there: z up to 2.2e-4 relative). Visibility may differ at
    equal depth on at most 2 of the 16384 pixels per frame: measured, 1 per frame
    in A and 0 in B."""
    for jo, to in zip(frames["jax"], frames["port"]):
        depth_ref, vis_ref = np.asarray(jo.depth), np.asarray(jo.visibility)
        depth, vis = to.depth.numpy(), to.visibility.numpy()
        assert (vis_ref >= 0).mean() > 0.5
        np.testing.assert_allclose(depth, depth_ref, rtol=5e-4, atol=1e-9)
        flips = int(((vis != vis_ref) & (depth == depth_ref)).sum())
        assert flips <= 2, f"{flips} pixels differ in visibility at equal depth"


def test_frame_occlusion_state_matches(frames):
    """The visibility list the occlusion pass hands the next frame."""
    for jt, (to_state) in zip(frames["jax_temporals"][-1:], [frames["port_temporal"]]):
        want = np.asarray(jt.prev_visible_prims)
        assert np.array_equal(to_state.prev_visible_prims.numpy(), want)
        assert 0 < want.sum() < want.size


def test_frame_image(frames):
    """With the cascade cache shared, the u8 image within one step on >= 99.5%
    of pixels and SSIM >= 0.99."""
    for jo, to in zip(frames["jax"], frames["port"]):
        img, ref = to.image.numpy(), np.asarray(jo.image)
        assert img.shape == ref.shape == (N, N, 3) and img.dtype == np.uint8
        off = (np.abs(img.astype(int) - ref.astype(int)).max(axis=-1) > 1).mean()
        assert off <= 0.005, f"{off:.4%} of pixels off by > 1 step"
        assert ssim(img, ref) >= 0.99
        assert np.isfinite(to.hdr.numpy()).all()


def test_frame_stages_change_the_image(frames):
    """Translucency (and, in B, the exact peel) draw something on this view:
    the port's frame without them differs."""
    cfg = frames["cfg"]
    scene, view = frames["scene"], frames["view"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(frame_mod.shadow_ops, "render_shadow_cascades_staggered",
                   lambda *a, **k: (frames["packed"], frames["mats"]))
        t = temporal_from_numpy(
            {"frame_index": 0, "prev_visible_prims": np.ones(cfg.max_primitives, bool),
             "csm_packed": frames["packed"].numpy(), "csm_matrices": frames["mats"].numpy()},
            "cpu")
        plain, _ = make_renderer(cfg.replace(translucency=False))(
            scene, view, RenderParams.default(), t)
        if not cfg.alpha_bitmap:
            bitmap, _ = make_renderer(cfg.replace(alpha_bitmap=True))(
                scene, view, RenderParams.default(), t)
            assert not torch.equal(bitmap.visibility, frames["port"][0].visibility)
    assert not torch.equal(plain.hdr, frames["port"][0].hdr)
