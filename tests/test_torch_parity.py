"""The port's parity-frame stages against the JAX package: SSAO, the half-rate
upsample, LPV GI, TAA/TAAU, and the frame bench.py times, end to end.

Units are fed identical inputs made from a seed with numpy. Where the reference
runs eagerly (op by op, no fusion) the port's op order rounds the same way and
the outputs are bit-equal: the R11G11B10 round trip, the packed history fetches,
the VPL picks, the LPV injection's scatter-max. Elsewhere each tolerance is
stated beside the value it measured.

The frame: ``parity_frame_config`` at 128^2 render -> 192^2 output on the
courtyard with ``alpha_bitmap=False``, 2 LPV cascades of 16^3, 64^2 RSMs and 8
propagation steps, 3 chained frames from identical temporal state, the camera
stepping and turning with the TAA jitter of each frame. The JAX
frame runs its XLA branch (no Pallas), with bins above the peak count of every
raster it makes, which the test asserts. Both frames sample one shared cascade
cache (as tests/test_torch_alpha_translucency.py does) and resolve one shared
RSM per frame: the JAX frame's own raster of it, recorded from inside its jit.
The cell size is 0.2261 m, off the courtyard's wall lattice, for the reason
tools/make_goldens.py:90-99 gives: walls on exact cell boundaries would flip
whole layers of surfels between cells on a one-ULP position change.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu import config as jax_config
from androidrenderer_tpu.ops import lighting as jax_lighting
from androidrenderer_tpu.ops import lpv as jax_lpv
from androidrenderer_tpu.ops import shadow as jax_shadow
from androidrenderer_tpu.ops import sh as jax_sh
from androidrenderer_tpu.ops import taa as jax_taa
from androidrenderer_tpu.ops import upsample as jax_upsample
from androidrenderer_tpu.ops.gbuffer import GBuffer as JaxGBuffer
from androidrenderer_tpu.ops.raster import setup as jax_setup
from androidrenderer_tpu.ops.raster.binning import bin_triangles
from androidrenderer_tpu.ops.raster.raster_xla import rasterize_depth, rasterize_visibility
from androidrenderer_tpu.render import make_renderer as jax_make_renderer
from androidrenderer_tpu.render import temporal_state_for as jax_temporal_state_for
from androidrenderer_tpu.scene import procedural as jax_procedural
from androidrenderer_tpu.scene.proxy import swap_in_proxy as jax_swap_in_proxy
from androidrenderer_tpu.utils.image import ssim
from androidrenderer_tpu_torch.camera import Camera, taa_jitter
from androidrenderer_tpu_torch.config import AOMode, GIMode, RenderParams, parity_frame_config
from androidrenderer_tpu_torch.ops import lighting, lpv, sh, shadow, taa, upsample
from androidrenderer_tpu_torch.ops.gbuffer import GBuffer
from androidrenderer_tpu_torch.render import frame as frame_mod
from androidrenderer_tpu_torch.render import make_renderer, temporal_from_numpy
from androidrenderer_tpu_torch.scene.proxy import swap_in_proxy
from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

from test_torch_frame import to_jax_config
from test_torch_scene import jax_leaves, jax_temporal_leaves

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it.
torch.set_num_threads(1)

N, OUT = 128, 192
FRAMES = 3
# Bins of the JAX XLA branch hold this many triangles per tile; the frame
# fixture asserts that no bin of its main view, peel layers or RSMs holds more.
XLA_CAP = 8192
LPV = dict(lpv_num_cascades=2, lpv_resolution=16, lpv_rsm_resolution=64,
           lpv_num_propagation_steps=8, lpv_cell_size=0.2261)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(np.asarray(a))


def both(*arrays):
    """Each numpy array as (jax array, tensor)."""
    return [j(a) for a in arrays], [t(a) for a in arrays]


def rel_err(got, want, floor=1e-3) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), floor)).max())


# ---------------------------------------------------------------- inputs

def smooth_gbuffer(rng, h, w):
    """A gbuffer of a bumpy floor seen from above, with a depth step, holes and
    a few random normals: taps of the SSAO radii land on real neighbours."""
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    height = 0.08 * np.sin(xx * 0.45) * np.cos(yy * 0.3) + 0.3 * (xx > w // 2)
    wp = np.stack([xx * 0.03, height, yy * 0.03], -1).astype(np.float32)
    wp += rng.normal(0, 0.004, wp.shape).astype(np.float32)
    n = np.stack([-0.2 * np.cos(xx * 0.45), np.ones_like(xx), 0.1 * np.sin(yy * 0.3)], -1)
    n += rng.normal(0, 0.2, n.shape)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    depth = (0.02 + 0.01 * np.cos(yy * 0.05) + 0.01 * (xx > w // 2)).astype(np.float32)
    valid = rng.uniform(size=(h, w)) > 0.05
    valid[: h // 6, : w // 5] = False
    return dict(world_position=wp, normal=n, depth=np.where(valid, depth, 0).astype(np.float32),
                valid=valid, base_color=rng.uniform(0, 1, (h, w, 3)).astype(np.float32))


def gbuffers(g):
    z3 = np.zeros(g["world_position"].shape, np.float32)
    z1 = np.zeros(g["depth"].shape + (1,), np.float32)
    fields = dict(base_color=g["base_color"], normal=g["normal"], roughness=z1, metalness=z1,
                  emission=z3, world_position=g["world_position"], depth=g["depth"],
                  valid=g["valid"])
    return (JaxGBuffer(**{k: j(v) for k, v in fields.items()}),
            GBuffer(**{k: t(v) for k, v in fields.items()}))


def hdr_image(rng, h, w):
    """HDR colours over 8 decades, zeros, clamp-range and above-range values."""
    img = (10.0 ** rng.uniform(-4, 4, (h, w, 3))).astype(np.float32)
    img[rng.uniform(size=(h, w)) < 0.05] = 0.0
    img[0, 0] = [64512.0, 70000.0, 1e9]
    img[0, 1] = [6.1e-5, 5.9e-8, 1e-12]
    return img


# ---------------------------------------------------------------- SSAO + upsample

def test_sh_matches_jax():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    for fj, ft in ((jax_sh.sh_evaluate, sh.sh_evaluate),
                   (jax_sh.sh_cosine_lobe, sh.sh_cosine_lobe)):
        assert np.array_equal(ft(t(d)).numpy(), np.asarray(fj(j(d))))
    assert np.array_equal(sh.sh_dot(t(d), t(d[::-1])).numpy(),
                          np.asarray(jax_sh.sh_dot(j(d), j(d[::-1]))))


@pytest.mark.parametrize("radius,bias,intensity", [(0.5, 0.02, 1.0), (1.2, 0.05, 2.0)])
def test_ssao_matches_jax(radius, bias, intensity):
    """24 de-wrapped taps and the depth-aware blur, at the defaults and at a
    wider, stronger setting. Measured max |delta| 1.8e-7 and 2.4e-7 against the
    jitted reference."""
    rng = np.random.default_rng(2)
    jg, tg = gbuffers(smooth_gbuffer(rng, 24, 36))
    cam = np.array([0.5, 3.0, 0.4], np.float32)
    kw = dict(radius=radius, bias=bias, intensity=intensity)
    want = np.asarray(jax.jit(lambda g, c: jax_lighting.ssao(g, c, 0.05, **kw))(jg, j(cam)))
    got = lighting.ssao(tg, t(cam), 0.05, **kw).numpy()
    assert got.shape == want.shape == (24, 36, 1)
    assert 0.05 < want.std() and want.min() < 0.9  # occlusion somewhere, not everywhere
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("channels", [3, None])
def test_bilateral_upsample_matches_jax(channels):
    """An RGB signal (the GI irradiance) and a 2-d one (the AO, which comes
    back (H, W, 1) as in the reference). Measured max |delta| 1.2e-6 of values
    up to 5.0, against the jitted reference."""
    rng = np.random.default_rng(3)
    g = smooth_gbuffer(rng, 32, 48)
    sig = rng.uniform(0, 5, (16, 24, 3)).astype(np.float32)
    if channels is None:
        sig = sig[..., 0]
    args = (sig, g["depth"][::2, ::2], g["normal"][::2, ::2], g["depth"], g["normal"])
    ja, ta = both(*args)
    want = np.asarray(jax.jit(jax_upsample.bilateral_upsample_2x)(*ja))
    got = upsample.bilateral_upsample_2x(*ta).numpy()
    assert got.shape == want.shape == (32, 48, channels or 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- TAA

def _matrices(rng):
    cam = Camera(fov_degrees=75.0, aspect=1.5, z_near=0.05, render_resolution=(48, 32))
    cam.set_position([0.3, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    cam.end_frame()
    cam.translate_local(rng.uniform(-0.2, 0.2, 3))
    cam.rotate(0.01, -0.02)
    cam.set_jitter([0.3, -0.2])
    return cam.view_data()


def test_motion_vectors_match_jax():
    """Measured max |delta| 6e-8 uv (the 3x3 products' summation order)."""
    rng = np.random.default_rng(4)
    view = _matrices(rng)
    g = smooth_gbuffer(rng, 32, 48)
    wp = g["world_position"] + np.array([0.0, 0.0, -2.0], np.float32)
    args = (wp, g["valid"], view.last_view_proj, view.unjittered_view_proj)
    ja, ta = both(*args)
    want = np.asarray(jax_taa.motion_vectors(*ja))
    got = taa.motion_vectors(*ta).numpy()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_r11g11b10_round_trip_is_bit_equal():
    rng = np.random.default_rng(5)
    img = hdr_image(rng, 40, 50)
    enc_j = np.asarray(jax_taa._encode_r11g11b10(j(img)))
    enc_t = taa._encode_r11g11b10(t(img))
    assert enc_t.dtype == torch.int32 and (enc_j < 0).any()  # the top bits are used
    assert np.array_equal(enc_t.numpy(), enc_j)
    assert np.array_equal(taa._decode_r11g11b10(enc_t).numpy(),
                          np.asarray(jax_taa._decode_r11g11b10(j(enc_j))))
    l11 = img[..., 1]
    assert np.array_equal(taa._enc_l11(t(l11)).numpy(), np.asarray(jax_taa._enc_l11(j(l11))))


@pytest.mark.parametrize("pack8", [False, True])
def test_packed_history_fetch_is_bit_equal(pack8):
    """The history fetch at uv in and outside the frame, fractional, on texel
    centres and on the 1/256-px snap, both fed one history: bit-equal to the
    reference run op by op."""
    rng = np.random.default_rng(6)
    hist = hdr_image(rng, 24, 40)
    uv = rng.uniform(-0.1, 1.1, (30, 20, 2)).astype(np.float32)
    uv[0, :, 0] = (np.arange(20) + 0.5) / 40
    uv[0, :, 1] = (np.arange(20) + 0.5) / 24
    fj = jax_taa._bilinear_sample_packed8 if pack8 else jax_taa._bilinear_sample_packed
    ft = taa._bilinear_sample_packed8 if pack8 else taa._bilinear_sample_packed
    want = np.asarray(fj(j(hist), j(uv)))
    got = ft(t(hist), t(uv)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pack8", [False, True])
def test_taa_resolve_matches_jax(pack8):
    """Valid history, motion that leaves the frame in a corner. Measured max
    |delta| 0 (both run op by op)."""
    rng = np.random.default_rng(7)
    cur = hdr_image(rng, 24, 40) * 1e-3
    hist = hdr_image(rng, 24, 40) * 1e-3
    mv = rng.normal(0, 0.02, (24, 40, 2)).astype(np.float32)
    mv[:4, :4] = 0.9
    for valid in (False, True):
        ja, ta = both(cur, hist, np.array(valid), mv)
        want = [np.asarray(x) for x in jax_taa.taa_resolve(*ja, pack8=pack8)]
        got = [x.numpy() for x in taa.taa_resolve(*ta, pack8=pack8)]
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_, w_, rtol=1e-6, atol=0)


def test_scale_and_translate_matches_jax():
    """The rebuilt resample against jax.image.scale_and_translate, 134^2 -> 192^2
    at TAAU's scale and a jittered translation, and at a non-square ratio that
    contracts the columns first. float32: measured max |delta| 2.9e-7 of the
    largest value (lanczos3: the sines' last bit), 0 (linear). bfloat16, where
    the inputs, the weights and each contraction's result round to bfloat16:
    measured bit-equal; a float32 sum that lands on a bfloat16 rounding
    boundary could move a value by one bfloat16 step (2^-8 relative), which the
    bound allows on at most 0.1% of values."""
    rng = np.random.default_rng(8)
    for (h, w, oh, ow) in ((134, 134, 192, 192), (70, 134, 96, 192)):
        x = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
        scale = (oh / (h - 6), ow / (w - 6))
        trans = (np.float32(-0.13) - 3 * scale[0], np.float32(0.29) - 3 * scale[1])
        for method in ("lanczos3", "linear"):
            for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
                want = np.asarray(jax.image.scale_and_translate(
                    j(x).astype(dt_j), (oh, ow, 3), (0, 1),
                    jnp.array(scale, jnp.float32), jnp.array(trans, jnp.float32),
                    method=method, antialias=False).astype(jnp.float32))
                got = taa.scale_and_translate(t(x), oh, ow, scale, trans, method, dt_t).numpy()
                assert got.shape == want.shape
                top = np.abs(want).max()
                if dt_t == torch.float32:
                    assert np.abs(got - want).max() <= 1e-6 * top, (h, w, method)
                else:
                    assert np.abs(got - want).max() <= 2.0**-8 * top, (h, w, method)
                    assert (got != want).mean() <= 1e-3, (h, w, method)


def test_taau_resolve_matches_jax():
    """192^2 output from 128^2 with jitter and motion, without and with a valid
    history, against the reference run op by op. Measured: bit-equal without
    history; with it, max |delta| 1.2e-8 of the largest value (the confidence
    weight's exp and round)."""
    rng = np.random.default_rng(9)
    cur = hdr_image(rng, N, N) * 1e-3
    hist = hdr_image(rng, OUT, OUT) * 1e-3
    mv = rng.normal(0, 0.01, (N, N, 2)).astype(np.float32)
    jitter = np.array([0.31, -0.17], np.float32)
    for valid in (False, True):
        ja, ta = both(cur, hist, np.array(valid), mv, jitter)
        want = np.asarray(jax_taa.taau_resolve(*ja, OUT, OUT)[0])
        got = taa.taau_resolve(*ta[:4], jitter, OUT, OUT)[0].numpy()
        assert got.shape == want.shape == (OUT, OUT, 3)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# ---------------------------------------------------------------- LPV

MINS = np.array([[-2.0, -0.5, 2.25], [-4.0, -2.5, -1.5]], np.float32)
CELLS = np.array([0.25, 0.5], np.float32)
R = 16


def _points(rng, k):
    p = rng.uniform(-5, 6, (k, 3)).astype(np.float32)
    n = rng.normal(size=(k, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    f = rng.uniform(0, 3, (k, 3)).astype(np.float32)
    return p, n, f, rng.uniform(size=k) < 0.8


@pytest.fixture(scope="module")
def injected():
    """inject_all of the same random VPLs, RSM surfels, shared surfels and
    emissive points into two cascades on both sides."""
    rng = np.random.default_rng(10)
    vpls = [_points(rng, 500) for _ in MINS]
    surfels = [(p, n, m) for p, n, _, m in (_points(rng, 800) for _ in MINS)]
    p, n, _, m = _points(rng, 300)
    emissive = _points(rng, 100)
    rad0 = np.zeros((2, 3, 4, R, R, R), np.float32)
    gv0 = np.zeros((2, 4, R, R, R), np.float32)

    def side(f):
        return ([tuple(f(x) for x in v) for v in vpls], [tuple(f(x) for x in s) for s in surfels],
                (f(p), f(n), f(m)), tuple(f(x) for x in emissive), f(MINS), f(CELLS))

    jv, js, jsh, je, jm, jc = side(j)
    tv, ts, tsh, te, tm, tc = side(t)
    want = jax.jit(jax_lpv.inject_all, static_argnums=8)(j(rad0), j(gv0), jv, js, jsh, je, jm,
                                                         jc, R)
    got = lpv.inject_all(t(rad0), t(gv0), tv, ts, tsh, te, tm, tc, R)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def test_inject_all_matches_jax(injected):
    """The scatter-max is exact in any order; the scatter-add sums in index
    order on the CPU on both sides (measured: equal), and in atomic order on
    the card, hence the rtol stated for it."""
    (rad_j, gv_j), (rad_t, gv_t) = injected
    assert (gv_j > 0).mean() > 0.01 and (rad_j != 0).mean() > 0.01
    assert np.array_equal(gv_t, gv_j)
    np.testing.assert_allclose(rad_t, rad_j, rtol=1e-5, atol=1e-6)


def test_single_cascade_injection_matches_jax():
    """The reference's one-cascade helpers (``inject``: VPLs into the radiance
    and their occlusion into the GV; then ``inject_gv_surfels``: surfels into
    that GV) against the port's ``inject_all`` of one cascade, which replaces
    both: the GVs equal, the radiance at the stated rtol."""
    rng = np.random.default_rng(11)
    p, n, f, m = _points(rng, 400)
    sp, sn, _, sm = _points(rng, 600)
    rad0 = np.zeros((3, 4, R, R, R), np.float32)
    gv0 = np.zeros((4, R, R, R), np.float32)
    want = jax.jit(jax_lpv.inject, static_argnums=(7, 8))(
        j(rad0), j(gv0), j(p), j(n), j(f), j(m), j(MINS[0]), 0.25, R)
    want_gv = jax.jit(jax_lpv.inject_gv_surfels, static_argnums=(5, 6))(
        want[1], j(sp), j(sn), j(sm), j(MINS[0]), 0.25, R)
    mins, cells = t(MINS[:1]), t(CELLS[:1])
    none = (t(sp[:0]), t(sn[:0]), t(sm[:0]))
    rad, gv = lpv.inject_all(t(rad0[None]), t(gv0[None]), [(t(p), t(n), t(f), t(m))], [none],
                             None, None, mins, cells, R)
    np.testing.assert_allclose(rad[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    assert np.array_equal(gv[0].numpy(), np.asarray(want[1]))
    _, gv2 = lpv.inject_all(torch.zeros_like(rad), gv, [tuple(x[:0] for x in (t(p), t(n), t(f),
                                                                              t(m)))],
                            [(t(sp), t(sn), t(sm))], None, None, mins, cells, R)
    assert (np.asarray(want_gv) > np.asarray(want[1])).any()  # the surfels add occluders
    assert np.array_equal(gv2[0].numpy(), np.asarray(want_gv))


def test_propagate_matches_jax(injected):
    """R = 16, 8 steps, with and without occlusion. The port contracts the 30
    face terms as two matrix products; measured max |delta| 4.8e-7 of values
    up to 5.1."""
    (rad_j, gv_j), _ = injected
    for occlusion in (True, False):
        want = np.asarray(jax.jit(jax_lpv.propagate, static_argnums=(2, 3))(
            j(rad_j), j(gv_j), 8, occlusion))
        got = lpv.propagate(t(rad_j), t(gv_j), 8, occlusion=occlusion).numpy()
        assert np.abs(want).max() > 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_apply_lpv_matches_jax(injected):
    """The finest containing cascade, the trilinear fetch of its 8 corners and
    the lobe toward the normal, on points inside, between and outside the two
    cascades. Measured max |delta| 1.9e-6 of values up to 11.6 against the
    jitted reference."""
    (rad_j, gv_j), _ = injected
    rng = np.random.default_rng(12)
    g = smooth_gbuffer(rng, 24, 32)
    wp = rng.uniform([-4.5, -3.0, -2.0], [4.5, 6.0, 7.0], (24, 32, 3)).astype(np.float32)
    wp[:8] = rng.uniform(MINS[0], MINS[0] + 4.0, (8, 32, 3))  # in the finer cascade
    args = (wp, g["normal"], g["base_color"], g["valid"])
    ja, ta = both(*args)
    want = np.asarray(jax.jit(jax_lpv.apply_lpv)(
        jax_lpv.LPVVolumes(j(rad_j), j(gv_j), j(MINS), j(CELLS)), *ja, 31.4159))
    got = lpv.apply_lpv(lpv.LPVVolumes(t(rad_j), t(gv_j), t(MINS), t(CELLS)), *ta,
                        31.4159).numpy()
    lit = want.max(axis=-1) > 0
    assert lit.mean() > 0.05 and (~lit).mean() > 0.1  # measured 9.2% lit
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_extract_vpls_picks_match_jax():
    """Brightest of each 2x2 quad with the tie-break nudge, on quads of equal
    luminance among random ones: the picks (the gathered positions, distinct
    per texel) are identical, and so are the fluxes and masks."""
    rng = np.random.default_rng(13)
    r = 32
    albedo = rng.uniform(0, 1, (r, r, 3)).astype(np.float32)
    albedo[:8, :8] = 0.3  # exact ties
    albedo[::4, ::4] = 0.5
    yy, xx = np.meshgrid(np.arange(r), np.arange(r), indexing="ij")
    wp = np.stack([xx, yy, xx * r + yy], -1).astype(np.float32)
    normal = rng.normal(size=(r, r, 3)).astype(np.float32)
    valid = rng.uniform(size=(r, r)) < 0.9
    sun = np.array([1.0, 0.9, 0.8], np.float32) * 110000.0
    ja, ta = both(albedo, normal, wp, valid, sun)
    want = [np.asarray(x) for x in jax_lpv.extract_vpls(*ja)]
    got = [x.numpy() for x in lpv.extract_vpls(*ta)]
    picks_j = want[0][:, 2] - want[0][:, 0] * r  # the picked texel's row
    assert len(set(zip(*want[0][:, :2].T))) == (r // 2) ** 2
    for g_, w_ in zip(got, want):
        assert np.array_equal(g_, w_)
    assert np.array_equal(got[0][:, 2] - got[0][:, 0] * r, picks_j)


# ---------------------------------------------------------------- the courtyard

@pytest.fixture(scope="module")
def courtyard():
    jscene, _ = jax_procedural.courtyard_scene(curtains=True).build(with_bvh=False)
    return jscene, scene_arrays_from_numpy(jax_leaves(jscene), "cpu")


def test_swap_in_proxy_matches_jax(courtyard):
    jscene, scene = courtyard
    want, got = jax_swap_in_proxy(jscene), swap_in_proxy(scene)
    for f in got._fields:
        if f in ("bvh", "proxy"):
            continue
        w_, g_ = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g_.dtype == w_.dtype and np.array_equal(g_, w_), f


def _xla_raster(setup, h, w):
    """The JAX frame's XLA-branch raster of an RSM (frame.py:560-566)."""
    th, tw = min(32, h), min(128, w)
    bins = bin_triangles(setup, h // th, w // tw, th, tw, cap=XLA_CAP)
    d = rasterize_depth(setup, bins, h, w, th, tw)
    return d, rasterize_visibility(setup, bins, d, th, tw), bins.counts.max()


def test_update_lpv_staggered_matches_jax(courtyard):
    """3 chained frames of the staggered update on the proxy scene, the camera
    moving, both fed the JAX package's own raster of each RSM (its peak bin
    count asserted under the cap; recorded from inside the jitted update). The
    cached mins and cells are equal. XLA's jit contracts the derived RSM setup's
    products into FMAs, so the resolved surfel positions differ by ~1e-4 m and
    a surfel within that of a cell boundary lands in the neighbouring cell:
    measured 2 of 8192 GV cells off by more than 1e-3, radiance within 1.3% of
    its largest value (run op by op, the reference agrees to 1.2e-7 in the GV
    and 6.7e-8 of the largest radiance, at four times this test's time)."""
    jscene, scene = courtyard
    jproxy, tproxy = jax_swap_in_proxy(jscene), swap_in_proxy(scene)
    recorded = []

    def jax_raster(setup, h, w):
        d, v, peak = _xla_raster(setup, h, w)
        jax.debug.callback(lambda *a: recorded.append([np.asarray(x) for x in a]), d, v, peak)
        return d, v

    def port_raster(setup, h, w):
        d, v, _ = recorded[-1]
        return t(d), t(v)

    fwd = np.array([0.0, -0.05, -1.0], np.float32)
    fwd /= np.linalg.norm(fwd)
    common = (2, R, 0.2261, 64, 8, 0.1)
    update = jax.jit(lambda sc, p, f, st, i: jax_lpv.update_lpv_staggered(
        sc, p, f, jax_raster, st, i, *common, use_base_textures=True))
    js = jax_lpv.make_lpv_state(2, R)
    ts = lpv.make_lpv_state(2, R, "cpu")
    for i in range(FRAMES):
        pos = np.array([0.0, 1.7, 6.0 - 0.37 * i], np.float32)
        js = jax.block_until_ready(update(jproxy, j(pos), j(fwd), js, jnp.int32(i)))
        ts = lpv.update_lpv_staggered(tproxy, t(pos), t(fwd), port_raster, ts, i, *common,
                                      use_base_textures=True)
        assert len(recorded) == i + 1 and 0 < int(recorded[-1][2]) <= XLA_CAP
        assert (recorded[-1][1] >= 0).mean() > 0.3
        assert np.array_equal(ts.mins.numpy(), np.asarray(js.mins))
        assert np.array_equal(ts.cell_sizes.numpy(), np.asarray(js.cell_sizes))
        gv_j, rad_j = np.asarray(js.gv), np.asarray(js.radiance)
        assert (np.abs(ts.gv.numpy() - gv_j) > 1e-3).any(axis=1).sum() <= 8
        assert np.abs(rad_j).max() > 0
        assert np.abs(ts.radiance.numpy() - rad_j).max() <= 0.05 * np.abs(rad_j).max()


# ---------------------------------------------------------------- the frame

def _views():
    """The bench camera at 128^2, stepping forward and turning a little each
    frame, with the Halton(2,3) TAA jitter of its frame index: one ViewData per
    frame, each with the previous frame's matrix for the motion vectors."""
    cam = Camera(fov_degrees=75.0, aspect=1.0, z_near=0.05, render_resolution=(N, N))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    views = []
    for i in range(FRAMES):
        cam.set_jitter(taa_jitter(i + 1))
        views.append(cam.view_data())
        cam.end_frame()
        cam.translate_local([0.04, 0.0, -0.15])
        cam.rotate(0.004, -0.01)
    return views


def _port_temporal(jt):
    """The port's state from every leaf of the JAX state."""
    return temporal_from_numpy(jax_temporal_leaves(jt), "cpu")


def _peak_bins(jscene, view, cfg):
    """The most triangles a 32x128 tile of the main view bins, over the opaque
    and masked sets the XLA branch rasterizes (one jitted count, one compile
    for every view)."""
    return int(_peak_bins_jit(jscene, j(view.view), j(view.frustum), np.float32(view.z_near),
                              j(view.view_proj), cfg.max_tris_per_tile))


@partial(jax.jit, static_argnums=5)
def _peak_bins_jit(jscene, view_m, frustum, z_near, view_proj, cap):
    from androidrenderer_tpu.ops.culling import frustum_cull_triangles

    mask = frustum_cull_triangles(jscene.tri_corner_pos, view_m, frustum, z_near,
                                  jscene.tri_valid)
    setup = jax_setup.triangle_setup_corners(
        jscene.tri_corner_pos, view_proj, N, N,
        double_sided=jscene.tri_double_sided, tri_valid=mask,
    )
    peak = jnp.int32(0)
    for sel in (jscene.tri_alpha_mode == 0, jscene.tri_alpha_mode == 1):
        bins = bin_triangles(setup._replace(valid=setup.valid & sel), N // 32, N // 128,
                             32, 128, cap)
        peak = jnp.maximum(peak, bins.counts.max())
    return peak


@pytest.fixture(scope="module")
def frames(courtyard):
    """3 chained parity frames from the JAX package (XLA branch) and the port,
    the camera moving and jittered, both sampling one cascade cache (the maps
    of the first frame's cascades, each frame through its own fitted matrices)
    and resolving the JAX frame's RSMs."""
    jscene, scene = courtyard
    views = _views()
    cfg = parity_frame_config(OUT, OUT, N, N, shadow_cascade_resolution=N, alpha_bitmap=False,
                              **LPV)
    jcfg = to_jax_config(cfg).replace(
        pallas_interpret=False, raster_backend=jax_config.RasterBackend.XLA,
        max_tris_per_tile=XLA_CAP,
    )
    for view in views:
        assert _peak_bins(jscene, view, jcfg) <= XLA_CAP
    view = views[0]
    cascades = shadow.fit_cascades(
        t(view.inverse_view), float(view.projection[0, 0]), float(view.projection[1, 1]),
        scene.sun_direction, cfg.num_shadow_cascades, N, cfg.z_near, cfg.shadow_max_distance,
        cfg.shadow_cascade_split_lambda,
    )
    maps = shadow.render_shadow_cascades(
        scene.positions, scene.tri_indices, scene.tri_valid, cascades, N,
        double_sided=scene.tri_double_sided, proxy=scene.proxy,
        proxy_from_cascade=cfg.shadow_proxy_from_cascade, corners=scene.tri_corner_pos,
    )
    packed = shadow.pack_pcf_taps(maps)
    rsms = []  # (depth, vis, setup leaves) of each JAX RSM raster
    jax_parts, port_parts = jax_lpv._rsm_cascade_parts, frame_mod.lpv_ops._rsm_cascade_parts

    def jax_rsm(scene_, setup_rsm, m_canon, center, radius, raster_fn, res, textures):
        def recorded(setup, h, w):
            d, v = raster_fn(setup, h, w)
            jax.debug.callback(lambda *a: rsms.append([np.asarray(x) for x in a]), d, v, *setup)
            return d, v

        return jax_parts(scene_, setup_rsm, m_canon, center, radius, recorded, res, textures)

    def port_rsm(scene_, setup_rsm, m_canon, center, radius, raster_fn, res, textures):
        d, v = rsms[-1][:2]
        return port_parts(scene_, setup_rsm, m_canon, center, radius,
                          lambda *a: (t(d), t(v)), res, textures)

    def port_cascades(positions, tri_indices, tri_valid, cascades_, *a, **k):
        return packed, cascades_.matrices

    jt = jax_temporal_state_for(jcfg)
    tt = _port_temporal(jt)
    params, jparams = RenderParams.default(), jax_config.RenderParams.default()
    renderer = make_renderer(cfg)
    out = dict(jax=[], port=[], jax_temporals=[], port_temporals=[], rsm_peaks=[])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_shadow, "render_shadow_cascades", lambda *a, **k: j(maps.numpy()))
        mp.setattr(jax_lpv, "_rsm_cascade_parts", jax_rsm)
        mp.setattr(frame_mod.shadow_ops, "render_shadow_cascades_staggered", port_cascades)
        mp.setattr(frame_mod.lpv_ops, "_rsm_cascade_parts", port_rsm)
        jax_renderer = jax_make_renderer(jcfg)
        for view in views:
            jo, jt = jax_renderer(jscene, view, jparams, jt)
            jax.block_until_ready(jo.image)
            setup = jax_setup.TriangleSetup(*(j(x) for x in rsms[-1][2:]))
            out["rsm_peaks"].append(int(np.asarray(bin_triangles(
                setup, 2, 1, 32, 64, XLA_CAP).counts).max()))
            to, tt = renderer(scene, view, params, tt)
            out["jax"].append(jo)
            out["port"].append(to)
            out["jax_temporals"].append(jt)
            out["port_temporals"].append(tt)
    assert len(rsms) == FRAMES
    return dict(out, cfg=cfg, scene=scene, views=views, port_cascades=port_cascades, rsms=rsms)


def test_frame_rsm_bins_under_cap(frames):
    """The JAX frame's RSM rasters (64^2, 32x64 tiles) bin under the cap."""
    assert 0 < max(frames["rsm_peaks"]) <= XLA_CAP


def test_frame_image(frames):
    """With the cascade cache and the RSMs shared, the u8 image at 192^2 within
    one step on >= 99.5% of pixels and SSIM >= 0.99 (measured: at most 0.02%
    of pixels off by > 1 step, max 4 steps, SSIM 0.999998)."""
    for jo, to in zip(frames["jax"], frames["port"]):
        img, ref = to.image.numpy(), np.asarray(jo.image)
        assert img.shape == ref.shape == (OUT, OUT, 3) and img.dtype == np.uint8
        off = (np.abs(img.astype(int) - ref.astype(int)).max(axis=-1) > 1).mean()
        assert off <= 0.005, f"{off:.4%} of pixels off by > 1 step"
        assert ssim(img, ref) >= 0.99
        assert to.hdr.shape == (OUT, OUT, 3) and np.isfinite(to.hdr.numpy()).all()


def test_frame_depth_and_motion(frames):
    """Depth under the raster contract widened as test_torch_frame.py widens it:
    within 5e-4 relative but on at most 0.1% of pixels (measured one pixel of
    16,384, a sub-pixel triangle whose jittered setup cancels: 9.5e-4; 1.2e-4
    elsewhere), all within 2e-3; visibility equal on >= 99.8% (measured all).
    Motion: zero on the first frame (no previous view), up to 0.055 uv on the
    others as the camera steps and turns; equal within 3e-6 uv (measured
    1.5e-6: the world positions' rounding through two programs' setups)."""
    for i, (jo, to) in enumerate(zip(frames["jax"], frames["port"])):
        depth_ref, depth = np.asarray(jo.depth), to.depth.numpy()
        np.testing.assert_allclose(depth, depth_ref, rtol=2e-3, atol=1e-9)
        assert (np.abs(depth - depth_ref) > 5e-4 * np.abs(depth_ref) + 1e-9).mean() <= 1e-3
        assert (to.visibility.numpy() != np.asarray(jo.visibility)).mean() <= 0.002
        motion_ref = np.asarray(jo.motion)
        assert to.motion.shape == (N, N, 2)
        assert (np.abs(motion_ref).max() > 0.01) == (i > 0)
        np.testing.assert_allclose(to.motion.numpy(), motion_ref, rtol=0, atol=3e-6)


def test_frame_temporal_state(frames):
    """What each frame hands the next: the LPV cache (mins and cells equal; as
    in the staggered test above, surfels within ~1e-4 m of a cell boundary can
    land in the neighbouring cell: measured 2 of 8192 GV cells off by more than
    1e-3, radiance within 1.3% of its largest value), the TAA history,
    reprojected along the motion (measured max |delta| 0.72% of its largest
    value; 1.6% of values off by more than 1e-3 relative: the JAX frame's jit
    contracts products into FMAs) and its flag."""
    for i, (jt, tt) in enumerate(zip(frames["jax_temporals"], frames["port_temporals"])):
        assert tt.frame_index == int(jt.frame_index) == i + 1
        assert bool(tt.taa_valid) and bool(jt.taa_valid)
        assert np.array_equal(tt.lpv.mins.numpy(), np.asarray(jt.lpv.mins))
        assert np.array_equal(tt.lpv.cell_sizes.numpy(), np.asarray(jt.lpv.cell_sizes))
        gv_j = np.asarray(jt.lpv.gv)
        assert (np.abs(tt.lpv.gv.numpy() - gv_j) > 1e-3).any(axis=1).sum() <= 8
        rad_j = np.asarray(jt.lpv.radiance)
        assert np.abs(tt.lpv.radiance.numpy() - rad_j).max() <= 0.05 * np.abs(rad_j).max()
        hist_j, hist = np.asarray(jt.taa_history), tt.taa_history.numpy()
        assert np.abs(hist - hist_j).max() <= 0.03 * np.abs(hist_j).max()
        assert (np.abs(hist - hist_j) > 1e-3 * np.abs(hist_j)).mean() <= 0.05


def test_frame_stages_change_the_image(frames):
    """GI and AO each draw something on this view: the port's frame without
    either differs, and the parity frame's HDR differs from the one with GI
    off (the check chip_smoke makes at bench size)."""
    cfg, scene, view = frames["cfg"], frames["scene"], frames["views"][-1]
    state = frames["port_temporals"][-1]
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(frame_mod.shadow_ops, "render_shadow_cascades_staggered",
                   frames["port_cascades"])
        for label, c in (("parity", cfg), ("no gi", cfg.replace(gi_mode=GIMode.OFF)),
                         ("no ao", cfg.replace(ao_mode=AOMode.OFF))):
            outs[label], _ = make_renderer(c)(scene, view, RenderParams.default(), state)
    hdr = outs["parity"].hdr
    assert float((hdr - outs["no gi"].hdr).abs().max()) > 1e-3
    assert float((hdr - outs["no ao"].hdr).abs().max()) > 1e-3
    assert int(outs["parity"].image.amax()) > int(outs["parity"].image.amin())


def test_check_slice_raises_only_for_unported_switches(courtyard):
    """No switch is left unported: make_renderer takes the parity frame, TAA
    without the upscale, RT shadows and AO, RT and probe GI, and VRSAA (the
    frame's check_slice is gone). The parity frame switched to VRSAA renders at
    less than twice its output and raises the JAX frame's ValueError, and so
    does VRSAA with translucency, each before any work."""
    from androidrenderer_tpu_torch.config import AAMode, ShadowMode
    from androidrenderer_tpu_torch.render import temporal_state_for

    assert not hasattr(frame_mod, "check_slice")
    cfg = parity_frame_config(OUT, OUT, N, N)
    for c in (cfg, parity_frame_config(N, N, N, N),
              cfg.replace(shadow_mode=ShadowMode.RT, ao_mode=AOMode.RT),
              cfg.replace(gi_mode=GIMode.RT), cfg.replace(gi_mode=GIMode.PROBES),
              cfg.replace(aa_mode=AAMode.VRSAA)):
        make_renderer(c)
    scene = courtyard[1]
    view = _views()[0]
    vrsaa = parity_frame_config(N // 2, N // 2, N, N, aa_mode=AAMode.VRSAA)
    for c, match in ((cfg.replace(aa_mode=AAMode.VRSAA), "2x"),
                     (vrsaa.replace(translucency=True), "translucency")):
        with pytest.raises(ValueError, match=match):
            make_renderer(c)(scene, view, RenderParams.default(),
                             temporal_state_for(c, device="cpu"))
