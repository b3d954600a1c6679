"""The port's counterparts of the JAX package's last public helpers, against
the JAX functions on the same inputs (made from a seed with numpy).

White noise (``pixel_uniforms``, ``_pcg``), ``gather_corners`` and
``fd_lambert`` are integer or exact arithmetic: bit-equal. ``blue_noise`` is a
numpy copy: equal arrays. ``sample_trilinear`` is bit-equal to the port's own
one-fetch ``sample_trilinear_fused`` and within rtol 1e-6 of JAX's (both
blend the same u8 taps; XLA's jit may contract the lerps into FMAs).
``linear_to_srgb`` within 1e-6 (the power function of two libraries), and it
round-trips as tests/test_brdf_post.py holds JAX's. ``sample_surface_native``
calls the same C function: equal arrays. ``inject`` and ``inject_gv_surfels``
as tests/test_torch_parity.py holds ``inject_all``: the GV equal, the radiance
within rtol 1e-5 (the scatter-add's order). The JAX side runs eagerly or
under one small jit each; no frame compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu import native as jax_native
from androidrenderer_tpu.ops import brdf as jax_brdf
from androidrenderer_tpu.ops import lpv as jax_lpv
from androidrenderer_tpu.ops import noise as jax_noise
from androidrenderer_tpu.ops import post as jax_post
from androidrenderer_tpu.ops import texture as jax_tex
from androidrenderer_tpu.ops.raster import gather_corners as jax_gather_corners
from androidrenderer_tpu.scene.material_storage import Material as JaxMaterial
from androidrenderer_tpu.scene.material_storage import MaterialStorage as JaxMaterialStorage
from androidrenderer_tpu_torch import native
from androidrenderer_tpu_torch.ops import brdf, lpv, noise, post, texture
from androidrenderer_tpu_torch.ops.raster import gather_corners
from androidrenderer_tpu_torch.scene.procedural import cornell_scene

torch.set_num_threads(1)

U32 = 0xFFFFFFFF


@pytest.mark.parametrize("frame", [0, 3, 2**31 + 5])
def test_pixel_uniforms_bit_equal(frame):
    want = np.asarray(jax_noise.pixel_uniforms(19, 37, frame, 3))
    got = noise.pixel_uniforms(19, 37, frame, 3, "cpu").numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == (19, 37, 3)
    assert np.array_equal(got, want)


def test_pcg_bit_equal():
    rng = np.random.default_rng(5)
    v = np.concatenate([[0, 1, U32, 2**31], rng.integers(0, 2**32, 4096)]).astype(np.uint32)
    want = np.asarray(jax_noise._pcg(jnp.asarray(v)))
    got = noise._pcg(torch.from_numpy(v.astype(np.int64))).numpy()
    assert got.min() >= 0 and got.max() <= U32
    assert np.array_equal(got.astype(np.uint32), want)


def test_blue_noise_equal():
    want = jax_noise.blue_noise(32)
    got = noise.blue_noise(32)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert noise.blue_noise(32) is got  # cached per arguments
    for a, b in zip(noise._vac_energy_kernel(32, 1.9), jax_noise._vac_energy_kernel(32, 1.9)):
        assert np.array_equal(a, b)


def test_gather_corners_and_fd_lambert():
    ms = cornell_scene().meshes
    tris = np.concatenate([ms.mesh_triangles(i) for i in range(len(ms.meshes))]).astype(np.int32)
    want = np.asarray(jax_gather_corners(jnp.asarray(ms.positions), jnp.asarray(tris)))
    got = gather_corners(torch.from_numpy(ms.positions), torch.from_numpy(tris)).numpy()
    assert got.shape == (len(tris), 3, 3) and np.array_equal(got, want)
    assert brdf.fd_lambert() == jax_brdf.fd_lambert()


def test_sample_trilinear():
    """tests/test_noise.py's pool (two base textures, 64^2 and 16^2) and samples:
    uv across wraps, lod below 0 and past the last level."""
    rng = np.random.default_rng(0)
    ms = JaxMaterialStorage()
    t1 = ms.add_texture(rng.integers(0, 256, (64, 64, 4)).astype(np.uint8))
    t2 = ms.add_texture(rng.integers(0, 256, (16, 16, 4)).astype(np.uint8))
    ms.add_material(JaxMaterial(np.ones(4, np.float32), base_color_texture=t1))
    ms.add_material(JaxMaterial(np.ones(4, np.float32), base_color_texture=t2))
    pool, starts, log2b = ms.pack_texture_pool()
    n = 4096
    uv = rng.uniform(-2, 3, (n, 2)).astype(np.float32)
    lod = rng.uniform(-1, 8, (n,)).astype(np.float32)
    for t in (1, 2):
        st = np.full((n,), starts[t], np.int32)
        lb = np.full((n,), log2b[t], np.int32)
        args = [torch.from_numpy(x) for x in (pool, st, lb, uv, lod)]
        got = texture.sample_trilinear(*args).numpy()
        assert np.array_equal(got, texture.sample_trilinear_fused(*args).numpy())
        want = np.asarray(jax.jit(jax_tex.sample_trilinear)(
            *(jnp.asarray(x) for x in (pool, st, lb, uv, lod))))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_linear_to_srgb():
    x = np.concatenate([np.linspace(-0.5, 1.5, 257), [0.0031308, 0.0031309]]).astype(np.float32)
    got = post.linear_to_srgb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_post.linear_to_srgb(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    ramp = torch.linspace(0, 1, 64)
    assert torch.allclose(post.srgb_to_linear(post.linear_to_srgb(ramp)), ramp, atol=1e-5)


def test_sample_surface_native():
    """tests/test_native.py's case: cornell's 2x2 wall at 0.1 m^2 per sample,
    seed 3 (and the default seed), through each package's binding of
    sah_sample_surface; the JAX package's library is the committed prebuilt one."""
    assert native.available() and jax_native.available()
    ms = cornell_scene().meshes
    tris = ms.mesh_triangles(0)
    for kw in (dict(seed=3), {}):
        want = jax_native.sample_surface_native(ms.positions, tris, 0.1, 1000, **kw)
        got = native.sample_surface_native(ms.positions, tris, 0.1, 1000, **kw)
        assert got.dtype == np.float32 and 38 <= len(got) <= 41
        assert np.array_equal(got, want)


R = 16


def _points(rng, k, lo=-0.5, hi=4.5):
    pos = rng.uniform(lo, hi, (k, 3)).astype(np.float32)
    nrm = rng.normal(size=(k, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    flux = rng.uniform(0, 2, (k, 3)).astype(np.float32)
    mask = rng.uniform(size=k) > 0.2
    return pos, nrm, flux, mask


def test_inject_and_gv_surfels_match_jax():
    """A cascade at (0.1, -0.2, 0.05) with 0.25 m cells: 400 VPLs into empty
    volumes, then 600 surfels into the resulting GV; a quarter of the points
    fall outside the cube and are dropped."""
    rng = np.random.default_rng(11)
    p, n, f, m = _points(rng, 400)
    sp, sn, _, sm = _points(rng, 600)
    cmin = np.array([0.1, -0.2, 0.05], np.float32)
    rad0 = np.zeros((3, 4, R, R, R), np.float32)
    gv0 = np.zeros((4, R, R, R), np.float32)
    j, t = jnp.asarray, torch.from_numpy
    inject = jax.jit(jax_lpv.inject, static_argnums=(7, 8))
    want_rad, want_gv = inject(j(rad0), j(gv0), j(p), j(n), j(f), j(m), j(cmin), 0.25, R)
    rad, gv = lpv.inject(t(rad0), t(gv0), t(p), t(n), t(f), t(m), t(cmin), 0.25, R)
    assert (np.asarray(want_gv) > 0).mean() > 0.01 and (np.asarray(want_rad) != 0).mean() > 0.01
    assert np.array_equal(gv.numpy(), np.asarray(want_gv))
    np.testing.assert_allclose(rad.numpy(), np.asarray(want_rad), rtol=1e-5, atol=1e-6)
    want_gv2 = jax.jit(jax_lpv.inject_gv_surfels, static_argnums=(5, 6))(
        want_gv, j(sp), j(sn), j(sm), j(cmin), 0.25, R)
    gv2 = lpv.inject_gv_surfels(gv, t(sp), t(sn), t(sm), t(cmin), 0.25, R)
    assert (np.asarray(want_gv2) > np.asarray(want_gv)).any()
    assert np.array_equal(gv2.numpy(), np.asarray(want_gv2))


def test_rsm_ortho_matrix_matches_jax():
    """Within 2 ulps of the entries' scale (XLA's jit may contract the dot
    products into FMAs)."""
    sun = np.array([0.3, -0.8, 0.2], np.float32)
    for cmin, extent in ((np.array([-4.0, 0.5, 1.25], np.float32), 8.0),
                         (np.array([0.1, -0.2, 0.05], np.float32), 4.0)):
        want = np.asarray(jax.jit(jax_lpv._rsm_ortho_matrix, static_argnums=1)(
            jnp.asarray(cmin), extent, jnp.asarray(sun)))
        got = lpv._rsm_ortho_matrix(torch.from_numpy(cmin), extent, torch.from_numpy(sun))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.4e-7 * np.abs(want).max())
