"""The port's two ray-traced GI modes against the JAX package: the traversal's
masked any-hit rule, the exact alpha peel of traced rays, hit shading (the
metal-rough sample, Burley Fd), RTGI, the denoiser, the octahedral maps, the
sky LUTs, the probe cache, and the 128^2 frames with ``gi_mode=RT`` and
``gi_mode=PROBES``.

Inputs are made with numpy from a seed, or baked by the shared numpy scene
code, and handed to both sides. The traversal and the exact peel are held bit
for bit against JAX's walk run op by op (``jax.disable_jit()``), as
tests/test_torch_rt.py holds the other modes. Elsewhere JAX runs jitted, and
each tolerance is stated beside what it measured: XLA's sin/cos, exp and pow
differ from PyTorch's by ulps, and its sums and products of the probe
convolutions take another order.

The kernel (csrc/traverse.cu) runs only on the card; tests/test_torch_kernels.py
holds its masked any-hit mode bit-equal to the plain version tested here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu import config as jax_config
from androidrenderer_tpu.camera import Camera
from androidrenderer_tpu.ops import brdf as jax_brdf
from androidrenderer_tpu.ops import denoise as jax_denoise
from androidrenderer_tpu.ops import octahedral as jax_oct
from androidrenderer_tpu.ops import probes as jax_probes
from androidrenderer_tpu.ops import sky as jax_sky
from androidrenderer_tpu.ops import texture as jax_texture
from androidrenderer_tpu.ops.rt import effects as jax_effects
from androidrenderer_tpu.ops.rt import traverse as jax_traverse
from androidrenderer_tpu.render import make_renderer as jax_make_renderer
from androidrenderer_tpu.render import temporal_state_for as jax_temporal_state_for
from androidrenderer_tpu.scene import procedural as jax_procedural
from androidrenderer_tpu.utils.image import ssim
from androidrenderer_tpu_torch.config import (
    AAMode, AOMode, GIMode, RenderParams, ShadowMode, default_frame_config, raster_only_config,
)
from androidrenderer_tpu_torch.ops import brdf, denoise, octahedral, probes, sky, texture
from androidrenderer_tpu_torch.ops.rt import effects, traverse
from androidrenderer_tpu_torch.render import frame as frame_mod
from androidrenderer_tpu_torch.render import (
    make_renderer, temporal_from_numpy, temporal_state_for,
)
from androidrenderer_tpu_torch.scene import procedural as torch_procedural
from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

from test_torch_frame import to_jax_config
from test_torch_rt import (  # noqa: F401  (jax_scenes is a fixture)
    EFFECT_VIEWS, XLA_CAP, _fence_case, _gbuffer, _random_case, jax_scenes, port_bvh, same, t,
)
from test_torch_scene import jax_leaves, jax_temporal_leaves

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it.
torch.set_num_threads(1)

N = 128


# ------------------------------------------------------- the masked any-hit walk

def _fence_rays(jax_scenes, tmin_kind):
    jb, o, d = _fence_case(jax_scenes)
    if tmin_kind == "ray":
        tmin = np.random.default_rng(7).uniform(0.0, 1.5, len(o)).astype(np.float32)
    else:
        tmin = 0.01
    return jb, o, d, tmin


@pytest.mark.parametrize("case", ["fence", "fence_ray_tmin", "fence_bitmap", "random"])
def test_masked_any_hit_matches_jax(jax_scenes, case):
    """``masked_any_hit``: slot, t, u, v bit-equal to JAX's walk run op by op,
    steps equal. On the fence a ray parks only on an opaque slot's hit, and
    ends on a masked one when that is its nearest at the walk's end; on random
    (all opaque) triangles it is any-hit."""
    if case == "random":
        jb, o, d = _random_case(1)
        tmin, flags = 0.01, {}
    else:
        jb, o, d, tmin = _fence_rays(jax_scenes, "ray" if case == "fence_ray_tmin" else "one")
        flags = dict(alpha_bitmap_test=case == "fence_bitmap")
    tmin_j = jnp.asarray(tmin) if isinstance(tmin, np.ndarray) else tmin
    with jax.disable_jit():
        want = jax_traverse.trace_rays(jb, jnp.asarray(o), jnp.asarray(d), tmin_j, 3.0,
                                       any_hit=True, masked_any_hit=True, **flags)
        plain = jax_traverse.trace_rays(jb, jnp.asarray(o), jnp.asarray(d), tmin_j, 3.0,
                                        any_hit=True, **flags)
    got = traverse.trace_rays(port_bvh(jb), t(o), t(d), t(tmin) if case == "fence_ray_tmin"
                              else tmin, 3.0, any_hit=True, masked_any_hit=True, **flags)
    for f in ("slot", "t", "u", "v"):
        assert same(getattr(got, f), getattr(want, f)), f
    assert int(got.steps) == int(want.steps) > 0
    hit = got.slot.numpy() >= 0
    assert hit.any()
    if case == "random":
        assert same(got.slot, plain.slot)


# ------------------------------------------------------------- hit shading

def test_sample_mr_bilinear_matches_jax():
    """Equal to JAX within rtol 1e-6 (measured: equal), at levels past the
    entry's last one too (they clamp)."""
    rng = np.random.default_rng(11)
    pool = rng.integers(0, 256, (4096, 117), dtype=np.uint8)
    n = 500
    log2b = rng.integers(0, 6, n).astype(np.int32)
    start = rng.integers(0, 4096 - 1400, n).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)
    level = rng.integers(-1, 7, n).astype(np.int32)
    want = jax_texture.sample_mr_bilinear(jnp.asarray(pool), jnp.asarray(start),
                                          jnp.asarray(log2b), jnp.asarray(uv), jnp.asarray(level))
    got = texture.sample_mr_bilinear(t(pool), t(start), t(log2b), t(uv), t(level))
    assert got.shape == (n, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_brdf_diffuse_only_matches_jax():
    """Burley Fd alone, within rtol 1e-6 (measured 2.4e-7: XLA's pow differs by
    ulps), zero where N.L <= 0; the full BRDF still adds the specular lobe."""
    rng = np.random.default_rng(12)
    n = 4096

    def unit(shape):
        v = rng.normal(size=shape).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    base = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    nrm, l, v = unit((n, 3)), unit((n, 3)), unit((n, 3))
    metal = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    rough = rng.uniform(0.045, 1, (n, 1)).astype(np.float32)
    args = (base, nrm, metal, rough, l, v)
    want = np.asarray(jax_brdf.brdf(*map(jnp.asarray, args), diffuse_only=True))
    got = brdf.brdf(*map(t, args), diffuse_only=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert (got[(nrm * l).sum(-1) <= 0] == 0).all() and (got > 0).any()
    assert (brdf.brdf(*map(t, args)).numpy() >= got).all()


# ---------------------------------------------------------- masked traces

@pytest.mark.parametrize("use_bitmap", [True, False])
def test_masked_traces_match_jax(jax_scenes, use_bitmap):
    """trace_rays_masked and occlusion_masked on the alpha fixture's fence, on
    both paths: slots equal, t/u/v bit-equal to JAX run op by op, occlusion
    equal. The exact path sees through the fence's holes where the bitmap
    path may round a hole's edge to the 16x16 lattice."""
    jscene, scene = jax_scenes["alpha_test_scene"]
    jb, o, d, _ = _fence_rays(jax_scenes, "one")
    act = np.random.default_rng(8).random(len(o)) < 0.8
    with jax.disable_jit():
        want = jax_effects.trace_rays_masked(jb, jscene, jnp.asarray(o), jnp.asarray(d), 0.01,
                                             3.0, use_bitmap=use_bitmap)
        want_occ = jax_effects.occlusion_masked(jb, jscene, jnp.asarray(o), jnp.asarray(d), 0.01,
                                                3.0, active=jnp.asarray(act),
                                                use_bitmap=use_bitmap)
    got = effects.trace_rays_masked(scene.bvh, scene, t(o), t(d), 0.01, 3.0,
                                    use_bitmap=use_bitmap)
    for f in ("slot", "t", "u", "v"):
        assert same(getattr(got, f), getattr(want, f)), f
    occ = effects.occlusion_masked(scene.bvh, scene, t(o), t(d), 0.01, 3.0, active=t(act),
                                   use_bitmap=use_bitmap)
    assert same(occ, want_occ)
    assert occ.any() and not occ.all() and not occ.numpy()[~act].any()
    # Some rays pass the fence's holes: farther hits than through solid triangles.
    solid = traverse.trace_rays(scene.bvh, t(o), t(d), 0.01, 3.0)
    assert (got.t.numpy() > solid.t.numpy()).any()


# --------------------------------------------------------------------- RTGI

@pytest.mark.parametrize("num_bounces", [1, 2])
@pytest.mark.parametrize("scene_name", ["cornell_scene", "alpha_test_scene"])
def test_rtgi_matches_jax(jax_scenes, scene_name, num_bounces):
    """On JAX's own 64^2 gbuffer, masked (bitmap traces), JAX jitted. The
    first bounce's closest hits are equal on every ray when both sides trace
    the port's rays. Irradiance within rtol 1e-3 + atol 1e-5 x its peak on
    >= 99.5% of values (measured: at most 0.1% beyond rtol 1e-3, up to 1.3e-4
    of a 14.3 peak in cornell): the cosine directions differ by ulps (libm's
    sin/cos), which moves hit points and their Burley and sky terms by ulps,
    and can flip a grazing ray."""
    jscene, scene = jax_scenes[scene_name]
    jg = _gbuffer(jscene, scene_name)
    wp, nrm, valid = (t(x) for x in (jg.world_position, jg.normal, jg.valid))
    frame, exposure, sun_exposure = 3, 0.0031415927, 0.00031415927

    @jax.jit
    def jax_rtgi(sc, wp_, n_, v_):
        return jax_effects.rtgi(sc.bvh, sc, wp_, n_, v_, None, None, None, frame,
                                jnp.float32(exposure), jnp.float32(sun_exposure),
                                num_bounces=num_bounces, masked=True)

    want = np.asarray(jax_rtgi(jscene, jg.world_position, jg.normal, jg.valid))
    got = effects.rtgi(scene.bvh, scene, wp, nrm, valid, frame, exposure, sun_exposure,
                       num_bounces=num_bounces, masked=True).numpy()
    assert got.shape == want.shape == (64, 64, 3) and np.isfinite(got).all()
    tol = 1e-3 * np.abs(want) + 1e-5 * np.abs(want).max()
    assert (np.abs(got - want) > tol).mean() <= 0.005
    assert (got[~valid.numpy()] == 0).all() and got.max() > 0
    # The first bounce's rays traced on both sides: the same hits.
    u = effects.noise.stbn_uniforms(64, 64, frame, 2, "cpu")
    d = effects._flat(effects.noise.cosine_hemisphere(nrm, u[..., 0], u[..., 1]))
    o = effects._flat(wp + nrm * 0.02)
    hits = effects.trace_rays_masked(scene.bvh, scene, o, d, effects.RAY_EPS, 1e30,
                                     active=valid.reshape(-1))
    jhits = jax.jit(lambda b, o_, d_, a_: jax_effects.trace_rays_masked(
        b, jscene, o_, d_, jax_effects.RAY_EPS, 1e30, active=a_))(
        jscene.bvh, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jg.valid.reshape(-1))
    assert same(hits.slot, jhits.slot)


# ----------------------------------------------------------------- denoiser

def test_atrous_filter_matches_jax():
    """Within rtol 1e-5 + atol 1e-7 (measured 4.8e-7: exp and pow by ulps), on a
    noisy signal with sky holes; the wrapped edges take the same taps."""
    rng = np.random.default_rng(21)
    h, w = 48, 64
    sig = rng.gamma(2.0, 0.5, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.1, 0.3, (h, w)).astype(np.float32)
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32) * 0.2 + np.float32([0, 1, 0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    valid = rng.random((h, w)) < 0.9
    args = (sig, depth, nrm, valid)
    want = np.asarray(jax.jit(jax_denoise.atrous_filter)(*map(jnp.asarray, args)))
    got = denoise.atrous_filter(*map(t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert (got[~valid] == sig[~valid]).all()
    assert got[valid].std() < sig[valid].std()


def test_temporal_accumulate_matches_jax():
    """Three chained frames, the camera moving: motion from the JAX motion
    vectors of the alpha fixture's gbuffer under a moved camera, part of the
    frame reprojecting off screen; the first with no valid history. Within rtol
    1e-5 + atol 1e-6 (measured: equal); the off-screen pixels take the new
    signal (within rtol 1e-6: hist + (signal - hist) * 1 rounds)."""
    rng = np.random.default_rng(22)
    h = w = 64
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(h, w))
    cam.set_position([0.3, 1.0, -2.5])
    cam.yaw = 0.15
    jscene, _ = jax_procedural.alpha_test_scene().build(with_bvh=False)
    jg = _gbuffer(jscene, "alpha_test_scene")
    jhist = jnp.zeros((h, w, 3), jnp.float32)
    thist = torch.zeros((h, w, 3))
    jvalid, tvalid = jnp.array(False), torch.tensor(False)
    for i in range(3):
        last = cam.view_data().unjittered_view_proj
        cam.translate_local([0.35, 0.0, 0.1])
        cam.rotate(0.0, 0.2)
        now = cam.view_data().unjittered_view_proj
        from androidrenderer_tpu.ops.taa import motion_vectors

        mv = np.asarray(motion_vectors(jg.world_position, jg.valid, jnp.asarray(last),
                                       jnp.asarray(now)))
        sig = rng.gamma(2.0, 0.5, (h, w, 3)).astype(np.float32)
        want, jhist = jax.jit(jax_denoise.temporal_accumulate)(jnp.asarray(sig), jhist, jvalid,
                                                               jnp.asarray(mv))
        got, thist = denoise.temporal_accumulate(t(sig), thist, tvalid, t(mv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        prev = (np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h),
                         -1) - mv)
        off = ((prev < 0) | (prev > 1)).any(-1)
        assert off.any() and not off.all()
        np.testing.assert_allclose(got.numpy()[off], sig[off], rtol=1e-6)
        jvalid, tvalid = jnp.array(True), torch.tensor(True)


# ---------------------------------------------------- octahedral maps, sky LUTs

def test_octahedral_maps_match_jax():
    """Within atol 1e-6 (measured 1.2e-7: the norms' sums); uv -> dir -> uv
    round-trips."""
    rng = np.random.default_rng(31)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    uv = octahedral.dir_to_oct_uv(t(d)).numpy()
    np.testing.assert_allclose(uv, np.asarray(jax_oct.dir_to_oct_uv(jnp.asarray(d))), atol=1e-6)
    back = octahedral.oct_uv_to_dir(t(uv)).numpy()
    np.testing.assert_allclose(back, np.asarray(jax_oct.oct_uv_to_dir(jnp.asarray(uv))),
                               atol=1e-6)
    np.testing.assert_allclose(back, d, atol=1e-5)
    for res in (12, 13):
        np.testing.assert_allclose(octahedral.oct_texel_directions(res).numpy(),
                                   np.asarray(jax_oct.oct_texel_directions(res)), atol=1e-6)


def test_sky_luts_match_jax():
    """The transmittance LUT bit-equal (the same float64 march, batched). The
    sky-view LUT above the horizon within rtol 3e-4 (measured 1.2e-4:
    exp/sin/cos by ulps, summed over 32 steps), below it within rtol 3e-3 (measured 2.3e-3; JAX
    jitted against JAX eager differs as much): a ground-hitting ray's
    t_ground = -b - sqrt(b^2 - c) cancels, so ulps of the direction move it by
    ~1e-3 relative. Its samples and the LUT background, on the same LUT,
    within rtol 1e-4 + atol 1e-6 of the peak, sun disc included."""
    sun = np.array([-0.3, -0.8, 0.2], np.float32)
    assert np.array_equal(sky.transmittance_lut("cpu").numpy(),
                          np.asarray(jax_sky.transmittance_lut()))
    want = np.asarray(jax.jit(jax_sky.build_sky_view_lut)(jnp.asarray(sun)))
    got = sky.build_sky_view_lut(t(sun)).numpy()
    assert got.shape == (sky.SKY_LUT_H, sky.SKY_LUT_W, 3)
    up = sky.SKY_LUT_H // 2  # rows from here up look above the horizon
    np.testing.assert_allclose(got[up:], want[up:], rtol=3e-4, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=3e-3, atol=1e-12)
    rng = np.random.default_rng(32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[0] = -sun
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ws = np.asarray(jax.jit(jax_sky.sample_sky_lut)(jnp.asarray(want), jnp.asarray(d),
                                                    jnp.asarray(sun)))
    gs = sky.sample_sky_lut(t(want), t(d), t(sun)).numpy()
    np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-6 * ws.max())
    assert gs[0].max() > 100.0  # the sun disc
    cam = Camera(fov_degrees=75.0, aspect=2.0, render_resolution=(64, 32))
    cam.pitch = 0.4
    vd = cam.view_data()
    args = (vd.inverse_view, float(vd.projection[0, 0]), float(vd.projection[1, 1]))
    sun_color = np.array([1.0, 0.95, 0.9], np.float32)
    with pytest.MonkeyPatch.context() as mp:
        # Both backgrounds sample the LUT held above (JAX's), not a march of their own.
        mp.setattr(jax_sky, "build_sky_view_lut", lambda sun_: jnp.asarray(want))
        mp.setattr(sky, "build_sky_view_lut", lambda sun_: t(want))
        wb = np.asarray(jax_sky.sky_background_lut(jnp.asarray(args[0]), *args[1:],
                                                   jnp.asarray(sun), jnp.asarray(sun_color),
                                                   32, 64))
        gb = sky.sky_background_lut(t(args[0].astype(np.float32)), *args[1:], t(sun),
                                    t(sun_color), 32, 64).numpy()
    assert gb.shape == (32, 64, 3)
    np.testing.assert_allclose(gb, wb, rtol=1e-4, atol=1e-6 * wb.max())


# --------------------------------------------------------------- probe cache

def test_pick_stalest_breaks_ties_as_top_k():
    """Ages with many ties (a first frame: every slot at 10,000): the same
    slots in the same order as jax.lax.top_k, lowest slot first on a tie."""
    rng = np.random.default_rng(41)
    age = rng.integers(0, 4, (3, 64)).astype(np.int32)
    age[0] = 10_000
    age[2, ::3] = 10_000
    got = probes.pick_stalest(t(age), 16).numpy()
    for c in range(3):
        _, want = jax.lax.top_k(jnp.asarray(age[c]), 16)
        assert np.array_equal(got[c], np.asarray(want)), c
    assert np.array_equal(got[0], np.arange(16))


PROBE_GRID, PROBE_BUDGET, PROBE_RAYS = (6, 4, 6), 16, 16


def test_probe_update_and_sample_match_jax(jax_scenes):
    """2 cascades of 6x4x6 probes (a grid needs 4 cells an axis for a usable
    interior), budget 16, 16 rays, over 3 frames with the camera crossing a
    cell, on the alpha fixture (masked: the bitmap traces):
    cells and ages equal (the first frame's picks tie at age 10,000),
    irradiance and depth moments within rtol 1e-4 + atol 1e-6 of their peak
    (measured 3.6e-7: the convolutions' sum order and the LUT's ulps); then
    sample_probes on JAX's gbuffer within rtol 1e-4 + atol 1e-6 of its peak
    (measured 2.5e-7)."""
    jscene, scene = jax_scenes["alpha_test_scene"]
    c, spacing = 2, 0.5
    jstate = jax_probes.make_probe_state(c, PROBE_GRID, spacing)
    tstate = probes.make_probe_state(c, PROBE_GRID, "cpu")
    params = (PROBE_GRID, spacing, PROBE_BUDGET, PROBE_RAYS)

    @jax.jit
    def jax_update(state, sc, cam, frame):
        return jax_probes.update_probes(state, sc.bvh, sc, cam, *params, frame,
                                        jnp.float32(0.00031415927), masked=True,
                                        hysteresis=jnp.float32(0.9))

    for frame in range(3):
        cam = np.array([0.1 + 0.3 * frame, 1.0, -0.5], np.float32)
        jstate = jax_update(jstate, jscene, jnp.asarray(cam), jnp.int32(frame))
        tstate = probes.update_probes(tstate, scene.bvh, scene, t(cam), *params, frame,
                                      0.00031415927, masked=True, hysteresis=0.9)
        for f in ("cell", "age"):
            assert same(getattr(tstate, f), getattr(jstate, f)), (frame, f)
        for f in ("irradiance", "depth"):
            got, want = getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())
    assert (tstate.age.numpy() == 0).sum() == c * PROBE_BUDGET
    assert tstate.irradiance.numpy().max() > 0
    jg = _gbuffer(jscene, "alpha_test_scene")
    cam = jnp.asarray([0.7, 1.0, -0.5], jnp.float32)
    want = np.asarray(jax.jit(lambda s, wp, n, v: jax_probes.sample_probes(
        s, wp, n, v, cam, PROBE_GRID, spacing))(jstate, jg.world_position, jg.normal, jg.valid))
    got = probes.sample_probes(tstate, t(jg.world_position), t(jg.normal), t(jg.valid),
                               t(np.asarray(cam)), PROBE_GRID, spacing).numpy()
    assert got.shape == (64, 64, 3) and np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


# --------------------------------------------------------------------- frames

def _frame_config(gi):
    """The 128^2 courtyard frame with one GI mode, no shadows (the CSM path is
    held in tests/test_torch_frame.py, RT shadows and AO in
    tests/test_torch_rt.py) and ``alpha_bitmap=False``: the JAX XLA branch
    rasterizes masked triangles only through its exact peel; the traced rays
    take the alpha bitmaps on both sides (``alpha_masking``). Probes: a 2x
    cache of (8, 4, 8) probes, budget 32, 64 rays."""
    kw = dict(probe_grid=(8, 4, 8), probe_budget=32, probe_rays=64) if gi == "probes" else {}
    return raster_only_config(N, N, shadow_mode=ShadowMode.OFF, alpha_bitmap=False,
                              gi_mode=GIMode.RT if gi == "rt" else GIMode.PROBES, **kw)


@pytest.fixture(scope="module", params=["rt", "probes"])
def gi_frames(request):
    """2 chained 128^2 frames of the default courtyard, the camera moving, from
    the JAX package (XLA raster branch, one compile) and the port, the port
    reading the JAX bake's arrays and starting from the JAX state."""
    jscene, _ = jax_procedural.courtyard_scene().build(with_bvh=True)
    scene = scene_arrays_from_numpy(jax_leaves(jscene, bvh=True), "cpu")
    cfg = _frame_config(request.param)
    jcfg = to_jax_config(cfg).replace(
        pallas_interpret=False, raster_backend=jax_config.RasterBackend.XLA,
        max_tris_per_tile=XLA_CAP)
    cam = Camera(fov_degrees=75.0, aspect=1.0, z_near=0.05, render_resolution=(N, N))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    jt = jax_temporal_state_for(jcfg)
    tt = temporal_from_numpy(jax_temporal_leaves(jt), "cpu")
    jr, tr = jax_make_renderer(jcfg), make_renderer(cfg)
    outs = []
    for _ in range(2):
        view = cam.view_data()
        jo, jt = jr(jscene, view, jax_config.RenderParams.default(), jt)
        to, tt = tr(scene, view, RenderParams.default(), tt)
        outs.append((jo, to))
        cam.end_frame()
        cam.translate_local([0.04, 0.0, -0.15])
        cam.rotate(0.004, -0.01)
    return dict(kind=request.param, outs=outs, jax_temporal=jt, temporal=tt, cfg=cfg,
                scene=scene, view=view)


def test_gi_frame_matches_jax(gi_frames):
    """Each of the 2 frames: image within one u8 step on >= 99% of pixels and
    SSIM >= 0.999, depth and visibility as tests/test_torch_rt.py holds them.
    Measured: RTGI 0.09% / 0.04% of pixels beyond one step (a grazing GI ray
    that flips between hit and sky, spread by the a-trous filter; SSIM
    0.99975 / 0.99993), probes 0.006% / 0% (SSIM 0.99998 / 0.999998)."""
    for jo, to in gi_frames["outs"]:
        img, ref = to.image.numpy(), np.asarray(jo.image)
        assert img.shape == ref.shape == (N, N, 3)
        assert (np.abs(img.astype(int) - ref.astype(int)).max(-1) > 1).mean() <= 0.01
        assert ssim(img, ref) >= 0.999
        depth, depth_ref = to.depth.numpy(), np.asarray(jo.depth)
        np.testing.assert_allclose(depth, depth_ref, rtol=2e-3, atol=1e-9)
        assert (to.visibility.numpy() != np.asarray(jo.visibility)).mean() <= 0.002
        assert np.isfinite(to.hdr.numpy()).all()


def test_gi_frame_state_matches_jax(gi_frames):
    """The state both frames hand on: the RTGI history (valid after a frame)
    within 2e-3 relative in L1 and rtol 2e-2 on >= 99% of values (measured
    4.7e-4, and 0.9% at the 99th percentile: the a-trous filter spreads a
    flipped grazing ray over its 17x17 reach), or the probe cells and ages equal
    and the irradiance within rtol 1e-3 + atol 1e-5 of its peak on >= 99.9%
    of values; and GI changes the port's HDR."""
    jt, tt = gi_frames["jax_temporal"], gi_frames["temporal"]
    assert tt.frame_index == 2
    if gi_frames["kind"] == "rt":
        assert bool(tt.rtgi_valid) and bool(jt.rtgi_valid)
        got, want = tt.rtgi_history.numpy(), np.asarray(jt.rtgi_history)
        err = np.abs(got - want)
        assert err.sum() / np.abs(want).sum() <= 2e-3
        assert (err > 2e-2 * np.abs(want) + 1e-6).mean() <= 0.01
    else:
        for f in ("cell", "age"):
            assert same(getattr(tt.probes, f), getattr(jt.probes, f)), f
        got, want = tt.probes.irradiance.numpy(), np.asarray(jt.probes.irradiance)
        tol = 1e-3 * np.abs(want) + 1e-5 * np.abs(want).max()
        assert (np.abs(got - want) > tol).mean() <= 0.001 and want.max() > 0
    cfg = gi_frames["cfg"].replace(gi_mode=GIMode.OFF)
    lit, _ = make_renderer(cfg)(gi_frames["scene"], gi_frames["view"], RenderParams.default(),
                                temporal_state_for(cfg, device="cpu"))
    assert float((gi_frames["outs"][-1][1].hdr - lit.hdr).abs().max()) > 1e-3


# -------------------------------------------------------- switches and state

def test_check_slice_raises_only_for_vrsaa_and_gi_needs_a_bvh():
    """RT and probe GI, and VRSAA over them, pass make_renderer: the frame's
    check_slice, which raised for VRSAA, is gone. VRSAA with translucency, or
    at a render size other than twice the output, raises the JAX frame's
    ValueError when rendered (before any GI work). An RT or probe GI mode over
    a scene without a BVH raises a ValueError naming the remedy."""
    assert not hasattr(frame_mod, "check_slice")
    cfg = default_frame_config(N, N)
    for gi in (GIMode.RT, GIMode.PROBES):
        c = cfg.replace(gi_mode=gi, shadow_mode=ShadowMode.RT, ao_mode=AOMode.RT)
        make_renderer(c)
        make_renderer(c.replace(aa_mode=AAMode.VRSAA))
    leaves, _ = torch_procedural.cornell_scene().bake(with_bvh=False)
    scene = scene_arrays_from_numpy({k: v for k, v in leaves.items()
                                     if not k.startswith("bvh.")}, "cpu")
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(N, N))
    for gi in (GIMode.RT, GIMode.PROBES):
        c = cfg.replace(gi_mode=gi)
        with pytest.raises(ValueError, match=f"gi_mode={gi.name}.*with_bvh"):
            make_renderer(c)(scene, cam.view_data(), RenderParams.default(),
                             temporal_state_for(c, device="cpu"))
        v = c.replace(aa_mode=AAMode.VRSAA, output_width=N // 2, output_height=N // 2)
        for c2, match in ((v, "translucency"), (v.replace(output_width=N), "2x")):
            with pytest.raises(ValueError, match=match):
                make_renderer(c2)(scene, cam.view_data(), RenderParams.default(),
                                  temporal_state_for(c2, device="cpu"))


def test_temporal_state_carries_rtgi_and_probe_leaves():
    """temporal_state_for sizes the RTGI history at render resolution and the
    probe cascades from the config, with the JAX state's defaults; the JAX
    state's leaves carry over through temporal_from_numpy."""
    cfg = default_frame_config(128, 32, gi_mode=GIMode.PROBES, probe_cascades=3,
                               probe_grid=(4, 2, 6))
    jt = jax_temporal_state_for(to_jax_config(cfg))
    jt = jt._replace(rtgi_valid=jnp.array(True),
                     rtgi_history=jnp.full(jt.rtgi_history.shape, 0.5, jnp.float32),
                     probes=jt.probes._replace(age=jt.probes.age.at[1, 2].set(7)))
    ours = temporal_state_for(cfg, device="cpu")
    carried = temporal_from_numpy(jax_temporal_leaves(jt), "cpu")
    assert tuple(ours.rtgi_history.shape) == (32, 128, 3) and not bool(ours.rtgi_valid)
    for f in probes.ProbeCascades._fields:
        theirs = np.asarray(getattr(jt.probes, f))
        assert tuple(getattr(ours.probes, f).shape) == theirs.shape, f
        assert same(getattr(carried.probes, f), theirs), f
    assert int(ours.probes.age.min()) == probes.INVALID_AGE
    assert same(ours.probes.cell, np.asarray(jax_temporal_state_for(
        to_jax_config(cfg)).probes.cell))
    assert same(carried.rtgi_history, jt.rtgi_history) and bool(carried.rtgi_valid)
