"""The port's ray tracing slice against the JAX package: the BVH build, the packed
traversal rows, traversal, blue noise, RT sun shadows and RTAO, and the frame
with ``shadow_mode=RT, ao_mode=RT``.

Inputs are made with numpy from a seed (or baked by the shared numpy scene
code) and handed to both sides. The BVH builders, the packed rows and the STBN
uniforms are bit-equal. ``trace_rays`` is held bit-equal to JAX's walk run
op by op (``jax.disable_jit()``): the port rounds each product and sum on its
own as JAX does then, and a subnormal direction component takes JAX's
flushed-to-zero branch. Jitted, XLA contracts products into FMAs and the walk's
t/u/v move by ulps (measured up to 7.2e-7 in t on the random triangles), with
the same slots. Elsewhere each tolerance is stated beside what it measured.

The kernel (csrc/traverse.cu) runs only on the card; tests/test_torch_kernels.py
holds it bit-equal to the plain version tested here.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu import config as jax_config
from androidrenderer_tpu.camera import Camera
from androidrenderer_tpu.ops import gbuffer as jax_gbuffer
from androidrenderer_tpu.ops import noise as jax_noise
from androidrenderer_tpu.ops.raster import setup as jax_setup
from androidrenderer_tpu.ops.rt import effects as jax_effects
from androidrenderer_tpu.ops.rt import traverse as jax_traverse
from androidrenderer_tpu.render import make_renderer as jax_make_renderer
from androidrenderer_tpu.render import temporal_state_for as jax_temporal_state_for
from androidrenderer_tpu.scene import bvh as jax_bvh
from androidrenderer_tpu.scene import procedural as jax_procedural
from androidrenderer_tpu.utils.image import ssim
from androidrenderer_tpu_torch import native
from androidrenderer_tpu_torch.config import (
    AAMode, AOMode, GIMode, RenderParams, ShadowMode, default_frame_config, raster_only_config,
)
from androidrenderer_tpu_torch.ops import noise
from androidrenderer_tpu_torch.ops.raster import TriangleSetup, rasterize_reference
from androidrenderer_tpu_torch.ops.rt import effects, traverse
from androidrenderer_tpu_torch.render import frame as frame_mod
from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
from androidrenderer_tpu_torch.scene import bvh
from androidrenderer_tpu_torch.scene import procedural as torch_procedural
from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

from test_rt import brute_force_hit, device_bvh, random_tris
from test_torch_frame import to_jax_config
from test_torch_scene import jax_leaves

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it.
torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def port_bvh(jbvh) -> traverse.DeviceBVH:
    """The port's BVH from the JAX one's fields, with the kernel's layout."""
    return traverse.with_kernel_layout(
        traverse.DeviceBVH(*(t(getattr(jbvh, f)) for f in traverse.BVH_FIELDS)))


def same(ours, theirs) -> bool:
    """Equal values (+0 == -0) and equal dtypes."""
    a, b = np.asarray(ours), np.asarray(theirs)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.fixture(scope="module")
def jax_scenes():
    """The JAX bakes with their BVHs, and the port's scene from their leaves."""
    out = {}
    for name in ("cornell_scene", "alpha_test_scene"):
        jscene, _ = getattr(jax_procedural, name)().build(with_bvh=True)
        out[name] = (jscene, scene_arrays_from_numpy(jax_leaves(jscene, bvh=True), "cpu"))
    return out


# ---------------------------------------------------------------- the BVH build

def _cornell_triangles():
    ms = jax_procedural.cornell_scene().meshes
    tris = np.concatenate([ms.mesh_triangles(i) for i in range(len(ms.meshes))])
    return ms.positions, tris, None


def _random_triangles(masked):
    verts, idx = random_tris(3, n=100)
    valid = np.random.default_rng(3).random(100) < 0.6 if masked else None
    return verts, idx, valid


@pytest.mark.parametrize("builder", ["numpy", "native"])
@pytest.mark.parametrize("inputs", ["cornell", "random", "random_masked"])
def test_bvh_build_matches_jax(builder, inputs):
    """Both of the port's builders give the JAX numpy builder's arrays, bit for bit."""
    pos, tris, valid = {"cornell": _cornell_triangles,
                        "random": lambda: _random_triangles(False),
                        "random_masked": lambda: _random_triangles(True)}[inputs]()
    want = jax_bvh.build_bvh(pos, tris, valid)
    got = (bvh.build_bvh(pos, tris, valid) if builder == "numpy"
           else native.build_bvh_native(pos, tris, valid))
    for name in want._fields:
        assert same(getattr(got, name), getattr(want, name)), name
    if valid is not None:
        live = got.tri_order[got.tri_order >= 0]
        assert sorted(live.tolist()) == np.nonzero(valid)[0].tolist()


def test_native_builder_is_the_bake_builder():
    """The bake names the builder that ran; with no live triangle the numpy
    builder makes the empty tree (the native one has none)."""
    pos, tris, _ = _random_triangles(False)
    _, builder = native.build_bvh(pos, tris)
    assert builder == "native"
    empty, builder = native.build_bvh(pos, tris, np.zeros(len(tris), bool))
    assert builder.startswith("numpy") and empty.node_min.shape == (1, 3)
    _, stats = torch_procedural.cornell_scene().bake()
    assert stats["bvh_builder"] == "native" and stats["bvh_s"] >= 0.0


# ------------------------------------------------------------- the packed rows

def _slot_inputs(jscene):
    """Per-slot opacity and alpha grids as the JAX bake feeds pack_node_rows."""
    slots = np.asarray(jscene.bvh.slot_tri)
    safe = np.maximum(slots, 0)
    opaque = np.where(slots >= 0, np.asarray(jscene.tri_alpha_mode)[safe] != 1, True)
    grid = np.where(slots[:, None] >= 0, np.asarray(jscene.tri_alpha_grid)[safe], -1)
    return opaque, grid.astype(np.int32)


@pytest.mark.parametrize("scene_name", ["cornell_scene", "alpha_test_scene", "empty"])
def test_pack_node_rows_matches_jax(jax_scenes, scene_name):
    """Bit-equal rows, the alpha words' bits and the far-sentinel boxes included."""
    if scene_name == "empty":
        verts, idx = random_tris(0, n=8)
        b = jax_bvh.build_bvh(verts, idx, np.zeros(8, bool))
        fields = [b.node_min, b.node_max, b.node_miss, b.node_first, b.node_count]
        z = np.zeros((len(b.tri_order), 3), np.float32)
        args, kw = fields + [z, z, z], {}
        want = jax_traverse.pack_node_rows(*(jnp.asarray(a) for a in args))
    else:
        jscene = jax_scenes[scene_name][0]
        jb = jscene.bvh
        opaque, grid = _slot_inputs(jscene)
        args = [np.asarray(getattr(jb, f)) for f in (
            "node_min", "node_max", "node_miss", "node_first", "node_count",
            "slot_v0", "slot_e1", "slot_e2")] + [opaque]
        kw = dict(slot_alpha_grid=grid)
        want = jb.node_rows
        assert np.array_equal(bits(want), bits(jax_traverse.pack_node_rows(
            *(jnp.asarray(a) for a in args), slot_alpha_grid=jnp.asarray(grid))))
        if scene_name == "alpha_test_scene":
            assert (~opaque).any() and (grid != -1).any()
    got = traverse.pack_node_rows(*(t(a) for a in args), **{k: t(v) for k, v in kw.items()})
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.array_equal(bits(got), bits(want))


def test_bake_bvh_matches_jax(jax_scenes):
    """The port's bake (native builder, slot tables, opacity, alpha grids,
    packed rows) equals the JAX bake's BVH, leaf for leaf."""
    jscene = jax_scenes["alpha_test_scene"][0]
    leaves, stats = torch_procedural.alpha_test_scene().bake(with_bvh=True)
    assert stats["bvh_builder"] == "native"
    for f in traverse.BVH_FIELDS:
        ours, theirs = leaves[f"bvh.{f}"], np.asarray(getattr(jscene.bvh, f))
        assert ours.dtype == theirs.dtype, f
        assert np.array_equal(bits(ours) if f == "node_rows" else ours,
                              bits(theirs) if f == "node_rows" else theirs), f
    scene = scene_arrays_from_numpy(leaves, "cpu")
    assert isinstance(scene.bvh, traverse.DeviceBVH)
    assert scene.bvh.node_rows.shape[1] == traverse.NODE_ROW_CHANNELS == 109


# ------------------------------------------------------------------- traversal

def _random_case(seed):
    verts, idx = random_tris(seed, n=80)
    _, jb = device_bvh(verts, idx)
    rng = np.random.default_rng(seed + 10)
    o = rng.uniform(-6, 6, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jb, o, d


def _fence_case(jax_scenes):
    """Rays from z=-1 along +z through the alpha fixture's fence (tests/
    test_rt_alpha.py), jittered, and some toward the wall behind it."""
    jb = jax_scenes["alpha_test_scene"][0].bvh
    rng = np.random.default_rng(5)
    gx, gy = np.meshgrid(np.linspace(-1.5, 1.5, 12), np.linspace(0.3, 1.9, 8))
    o = np.stack([gx, gy, np.full_like(gx, -1.0)], -1).reshape(-1, 3)
    o = (o + rng.normal(0, 0.01, o.shape)).astype(np.float32)
    d = np.broadcast_to(np.array([0.0, 0.0, 1.0]), o.shape) + rng.normal(0, 0.2, o.shape)
    return jb, o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _quad_case():
    """tests/test_rt.py's quad at z=2 over x, y in [-1, 1], and rays whose
    origin lies on a box plane with a subnormal direction component there: JAX
    flushes the component to zero (inv_d = 1e30, 0 * 1e30 = 0); unflushed, it
    would give inv_d = inf and a NaN slab term."""
    verts = np.array([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]], np.float32)
    _, jb = device_bvh(verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    o = np.array([[-1, 0.25, 0], [1, -0.5, 0], [0.3, -1, 0], [-0.2, 1, 0], [0, 0, 0],
                  [-1, -1, 0], [3, 3, 0], [-1, 0.5, 4]], np.float32)
    d = np.array([[1e-39, 0, 1], [-2e-39, 0, 1], [0, 5e-40, 1], [0, -1e-38, 1],
                  [1e-39, -1e-39, 1], [1e-40, 1e-40, 1], [0, 0, 1], [-1e-39, 0, -1]],
                 np.float32)
    return jb, o, d


CASES = {
    "random1_closest": dict(case=1), "random1_any": dict(case=1, any_hit=True),
    "random2_closest": dict(case=2), "random2_any": dict(case=2, any_hit=True),
    "fence_bitmap_closest": dict(case="fence", alpha_bitmap_test=True),
    "fence_bitmap_any": dict(case="fence", any_hit=True, alpha_bitmap_test=True),
    "fence_solid_any": dict(case="fence", any_hit=True, tmax=2.0),
    "per_ray_tmin": dict(case=1, tmin="ray"),
    "active": dict(case=2, active=True, any_hit=True),
    "overflow": dict(case=1, max_steps=5),
    "subnormal_quad": dict(case="quad"),
    "subnormal_quad_any": dict(case="quad", any_hit=True, tmin="ray"),
}


def _case_inputs(jax_scenes, case, tmin=0.01, tmax=1e30, active=False, **flags):
    jb, o, d = (_fence_case(jax_scenes) if case == "fence" else _quad_case() if case == "quad"
                else _random_case(case))
    rng = np.random.default_rng(99)
    if tmin == "ray":
        tmin = rng.uniform(0.0, 3.0, len(o)).astype(np.float32)
    act = rng.random(len(o)) < 0.6 if active else None
    return jb, o, d, tmin, tmax, act, flags


@pytest.mark.parametrize("name", list(CASES))
def test_trace_rays_matches_jax(jax_scenes, name):
    """slot, t, u, v equal to JAX's walk run op by op, steps and overflow equal,
    every value finite."""
    jb, o, d, tmin, tmax, act, flags = _case_inputs(jax_scenes, **CASES[name])
    with jax.disable_jit():
        want = jax_traverse.trace_rays(
            jb, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tmin) if isinstance(tmin, np.ndarray) else tmin, tmax,
            active=None if act is None else jnp.asarray(act), **flags)
    got = traverse.trace_rays(
        port_bvh(jb), t(o), t(d), t(tmin) if isinstance(tmin, np.ndarray) else tmin, tmax,
        active=None if act is None else t(act), **flags)
    for f in ("slot", "t", "u", "v"):
        assert same(getattr(got, f), getattr(want, f)), f
        assert np.isfinite(getattr(got, f).numpy()).all(), f
    assert int(got.steps) == int(want.steps) > 0
    assert bool(got.overflow) == bool(want.overflow) == (name == "overflow")
    assert int(got.ray_steps.max()) == int(got.steps)
    hit = got.slot.numpy() >= 0
    assert hit.any() and (name.startswith("subnormal") or not hit.all())
    if act is not None:
        assert (got.ray_steps.numpy()[~act] == 0).all() and not hit[~act].any()


@pytest.mark.parametrize("seed", [1, 2])
def test_traversal_matches_brute_force(seed):
    """tests/test_rt.py's brute-force check, on the port's walk."""
    verts, idx = random_tris(seed, n=80)
    _, jb = device_bvh(verts, idx)
    bvh_t = port_bvh(jb)
    rng = np.random.default_rng(seed + 10)
    origins = rng.uniform(-6, 6, (64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    hits = traverse.trace_rays(bvh_t, t(origins), t(dirs), 0.01, 1e30)
    slot = hits.slot.numpy()
    tri = np.where(slot >= 0, bvh_t.slot_tri.numpy()[np.maximum(slot, 0)], -1)
    for i in range(64):
        t_ref, tri_ref = brute_force_hit(verts, idx, origins[i], dirs[i])
        assert tri[i] == tri_ref, f"ray {i}: {tri[i]} vs {tri_ref}"
        if tri_ref >= 0:
            assert abs(hits.t[i].item() - t_ref) < 1e-3


def test_occlusion_and_work_counts():
    """tests/test_rt.py's any-hit quad; the plain version's work counts add up
    (steps = leaf + inner visits + box misses) and name the rows read."""
    jb, _, _ = _quad_case()
    b = port_bvh(jb)
    o = t(np.array([[0, 0, 0], [3, 3, 0]], np.float32))
    d = t(np.array([[0, 0, 1], [0, 0, 1]], np.float32))
    assert traverse.occlusion(b, o, d, 0.01, 10.0).tolist() == [True, False]
    assert traverse.occlusion(b, o, d, 0.01, 1.0).tolist() == [False, False]
    assert traverse.occlusion(b, o, d, 0.01, 10.0, active=t(np.array([False, True]))).tolist() \
        == [False, False]
    hits, work, touched = traverse.trace_rays_reference(b, o, d, 0.01, 10.0, counts=True)
    assert work.shape == (2, len(traverse.WORK_COUNTS))
    assert torch.equal(work[:, 0], hits.ray_steps)
    assert (work[:, 1] + work[:, 2] <= work[:, 0]).all() and int(work[0, 1]) == 1
    assert bool(touched[0]) and int(touched.sum()) <= b.node_rows.shape[0]
    assert int(work[:, 5].sum()) == 0  # no bitmap test, no lookup


def test_work_counts_charge_each_test_where_it_runs(jax_scenes):
    """The alpha fixture's fence with the bitmap test: an inner visit examines
    1-4 lookahead targets (up to the first hit) and slab-tests no more of them;
    a leaf visit looks up at most its 4 slots' bits, only for slots that passed
    Moller-Trumbore, so a ray with no leaf visit looks up none."""
    _, scene = jax_scenes["alpha_test_scene"]
    gx, gy = np.meshgrid(np.linspace(-1.5, 1.5, 24), np.linspace(0.3, 1.9, 24))
    o = np.stack([gx, gy, np.full_like(gx, -1.0)], -1).reshape(-1, 3).astype(np.float32)
    d = np.broadcast_to(np.array([0.05, 0.02, 1.0], np.float32), o.shape).copy()
    names = traverse.WORK_COUNTS
    for any_hit in (False, True):
        _, work, _ = traverse.trace_rays_reference(scene.bvh, t(o), t(d), 0.01, 2.0,
                                                   any_hit=any_hit, alpha_bitmap_test=True,
                                                   counts=True)
        w = dict(zip(names, work.T))
        assert (w["inner_visits"] <= w["lookahead_targets"]).all()
        assert (w["lookahead_targets"] <= 4 * w["inner_visits"]).all()
        assert (w["lookahead_slabs"] <= w["lookahead_targets"]).all()
        assert (w["bitmap_lookups"] <= 4 * w["leaf_visits"]).all()
        assert int(w["bitmap_lookups"].sum()) > 0
        assert int(w["lookahead_slabs"].sum()) < 4 * int(w["inner_visits"].sum())
        _, plain, _ = traverse.trace_rays_reference(scene.bvh, t(o), t(d), 0.01, 2.0,
                                                    any_hit=any_hit, counts=True)
        assert int(plain[:, 5].sum()) == 0


def test_trace_rays_rejects_other_devices_and_counts_no_cpu_launch():
    jb, o, d = _quad_case()
    b = port_bvh(jb)
    launches = traverse.trace_rays.launches
    traverse.trace_rays(b, t(o), t(d), 0.01, 1e30)
    assert traverse.trace_rays.launches == launches
    with pytest.raises(ValueError):
        traverse.prepare_trace(b, t(o), t(d), 0.01, 1e30)
    meta = t(o).to("meta")
    with pytest.raises(ValueError):
        traverse.trace_rays(b, meta, meta, 0.01, 1e30)


# ----------------------------------------------------------------------- noise

def test_stbn_is_bit_equal():
    assert same(noise.stbn_stack(2), jax_noise.stbn_stack(2))
    for h, w, frame, num in ((64, 64, 0, 2), (130, 300, 77, 2), (96, 200, 1234, 2)):
        assert same(noise.stbn_uniforms(h, w, frame, num, "cpu"),
                    jax_noise.stbn_uniforms(h, w, frame, num))
    ours = noise._stbn_asset_path()
    assert "androidrenderer_tpu_torch" in ours
    assert filecmp.cmp(ours, jax_noise._stbn_asset_path(), shallow=False)


def test_stbn_stack_raises_without_its_asset(monkeypatch, tmp_path):
    """No generator stands in for a missing or short asset."""
    monkeypatch.setattr(noise, "_STBN_CACHE", {})
    monkeypatch.setattr(noise, "_stbn_asset_path", lambda: str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError):
        noise.stbn_stack(2)
    short = tmp_path / "short.npz"
    np.savez(short, stbn=np.zeros((1, 64, 128, 128), np.uint16))
    monkeypatch.setattr(noise, "_stbn_asset_path", lambda: str(short))
    with pytest.raises(ValueError):
        noise.stbn_stack(2)


def test_hemisphere_and_disc_directions_match_jax():
    """Within atol 1e-6 (measured 2.4e-7 and 6.0e-8: libm's sin/cos and the
    norm's sum order differ by ulps); both unit length."""
    rng = np.random.default_rng(1)
    n = rng.normal(size=(32, 32, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[0, 0] = [0, 0, -1]
    n[0, 1] = [0, 0, 1]
    u1, u2 = rng.random((2, 32, 32)).astype(np.float32)
    got = noise.cosine_hemisphere(t(n), t(u1), t(u2)).numpy()
    want = np.asarray(jax_noise.cosine_hemisphere(jnp.asarray(n), jnp.asarray(u1),
                                                  jnp.asarray(u2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert ((got * n).sum(-1) >= -1e-6).all()
    got = noise.disc_jitter(t(n), torch.tensor(0.00918), t(u1), t(u2)).numpy()
    want = np.asarray(jax_noise.disc_jitter(jnp.asarray(n), jnp.float32(0.00918),
                                            jnp.asarray(u1), jnp.asarray(u2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


# --------------------------------------------------------------------- effects

# Per scene: the camera (position, yaw, pitch) and the sun's travel direction.
# The alpha fixture's fence and wall are coplanar at z=0, so its sun comes from
# the +z side and the fence shadows the plane through its bitmap's holes.
EFFECT_VIEWS = {
    "cornell_scene": ([0.0, 0.5, 3.5], np.pi + 0.3, 0.2, None),
    "alpha_test_scene": ([0.3, 1.0, -2.5], 0.15, 0.0, [-0.1, -0.3, 0.95]),
}


def _gbuffer(jscene, name):
    """JAX's own 64^2 gbuffer (its setup and resolve; the port's plain raster)."""
    n = 64
    pos, yaw, pitch, _ = EFFECT_VIEWS[name]
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(n, n))
    cam.set_position(pos)
    cam.yaw, cam.pitch = yaw, pitch
    vd = cam.view_data()
    js = jax_setup.triangle_setup_corners(
        jscene.tri_corner_pos, jnp.asarray(vd.view_proj), n, n,
        double_sided=jscene.tri_double_sided, tri_valid=jscene.tri_valid)
    depth, vis = rasterize_reference(TriangleSetup(*(t(x) for x in js)), n, n)
    return jax.jit(jax_gbuffer.resolve_gbuffer)(jscene, js, jnp.asarray(vis.numpy()),
                                                jnp.asarray(depth.numpy()))


@pytest.mark.parametrize("scene_name", ["cornell_scene", "alpha_test_scene"])
def test_rt_shadows_and_rtao_match_jax(jax_scenes, scene_name):
    """On JAX's own gbuffer, masked (the bitmap any-hit path), JAX jitted:
    occlusion equal on >= 99.9% of pixels. The disc and hemisphere directions
    differ by ulps (libm's sin/cos), and XLA's FMAs move the walk's t by ulps,
    so a ray that grazes an edge may flip. Measured: equal on every pixel of
    both scenes, shadows and all 4 AO samples (also with JAX run op by op)."""
    jscene, scene = jax_scenes[scene_name]
    jg = _gbuffer(jscene, scene_name)
    wp, nrm, valid = (t(x) for x in (jg.world_position, jg.normal, jg.valid))
    sun = EFFECT_VIEWS[scene_name][3]
    jsun, tsun = ((jscene.sun_direction, scene.sun_direction) if sun is None
                  else (jnp.asarray(sun, jnp.float32), torch.tensor(sun)))
    frame, samples = 3, 4

    @jax.jit
    def jax_effects_of(bvh_, wp_, n_, valid_, sun_):
        return (jax_effects.rt_sun_shadows(bvh_, wp_, n_, valid_, sun_, jscene.sun_angular_size,
                                           frame, scene=jscene, masked=True),
                jax_effects.rtao(bvh_, wp_, n_, valid_, samples, 8.0, frame, scene=jscene,
                                 masked=True))

    js, ja = jax_effects_of(jscene.bvh, jg.world_position, jg.normal, jg.valid, jsun)
    ts = effects.rt_sun_shadows(scene.bvh, wp, nrm, valid, tsun, scene.sun_angular_size,
                                frame, scene=scene, masked=True)
    ta = effects.rtao(scene.bvh, wp, nrm, valid, samples, 8.0, frame, scene=scene, masked=True)
    assert ts.shape == ta.shape == (64, 64, 1)
    js, ja = np.asarray(js), np.asarray(ja)
    assert (ts.numpy() != js).mean() <= 1e-3
    assert (np.abs(ta.numpy() - ja) > 1e-6).mean() <= 1e-3
    # Some pixels are shadowed, some lit; sky pixels are lit and unoccluded.
    sky = ~valid.numpy()
    assert sky.any() and 0.0 < (js[..., 0] == 0).mean() < 1.0 - sky.mean()
    assert (ts.numpy()[sky] == 1.0).all() and (ta.numpy()[sky] == 1.0).all()
    if scene_name == "cornell_scene":
        assert ja.min() < 1.0


def test_occlusion_masked_exact_path_raises(jax_scenes):
    """The exact alpha peel (``use_bitmap=False``) on the alpha fixture's fence:
    occlusion equal to JAX's run op by op, the rays that pass a hole unoccluded;
    without the scene, whose textures it samples, it raises a ValueError."""
    jscene, scene = jax_scenes["alpha_test_scene"]
    jb, o, d = _fence_case(jax_scenes)
    with jax.disable_jit():
        want = jax_effects.occlusion_masked(jb, jscene, jnp.asarray(o), jnp.asarray(d), 0.01,
                                            3.0, use_bitmap=False)
    got = effects.occlusion_masked(scene.bvh, scene, t(o), t(d), 0.01, 3.0, use_bitmap=False)
    assert same(got, want) and got.any() and not got.all()
    with pytest.raises(ValueError, match="scene"):
        effects.occlusion_masked(port_bvh(jb), None, t(o), t(d), 0.01, 1e30, use_bitmap=False)


# ----------------------------------------------------------------------- frame

N = 128
XLA_CAP = 8192


@pytest.fixture(scope="module")
def rt_frames():
    """The 128^2 RT frame of the default courtyard from the JAX package (XLA
    raster branch, one compile) and the port, the port reading the JAX bake's
    arrays. ``alpha_bitmap=False``: the JAX XLA branch rasterizes masked
    triangles only through its exact peel, so the port does too; the traced
    rays take the alpha bitmaps in both (``alpha_masking``)."""
    jscene, _ = jax_procedural.courtyard_scene().build(with_bvh=True)
    scene = scene_arrays_from_numpy(jax_leaves(jscene, bvh=True), "cpu")
    cfg = raster_only_config(N, N, shadow_mode=ShadowMode.RT, ao_mode=AOMode.RT,
                             alpha_bitmap=False)
    jcfg = to_jax_config(cfg).replace(
        pallas_interpret=False, raster_backend=jax_config.RasterBackend.XLA,
        max_tris_per_tile=XLA_CAP)
    cam = Camera(fov_degrees=75.0, aspect=1.0, z_near=0.05, render_resolution=(N, N))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    view = cam.view_data()
    jo, _ = jax_make_renderer(jcfg)(jscene, view, jax_config.RenderParams.default(),
                                    jax_temporal_state_for(jcfg))
    composed = []
    compose = frame_mod.lighting.compose_lit_scene

    def recorded(gbuf, direct, gi=None, ao=None, sky=None):
        composed.append(ao)
        return compose(gbuf, direct, gi=gi, ao=ao, sky=sky)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(frame_mod.lighting, "compose_lit_scene", recorded)
        to, tt = make_renderer(cfg)(scene, view, RenderParams.default(),
                                    temporal_state_for(cfg, device="cpu"))
    return dict(jax=jo, port=to, temporal=tt, cfg=cfg, scene=scene, view=view, ao=composed)


def test_rt_frame_matches_jax(rt_frames):
    """Image within one u8 step on >= 99.5% of pixels and SSIM >= 0.99, depth
    and visibility as tests/test_torch_parity.py holds them (measured: no pixel
    off by more than one step, SSIM 0.9999995, max |d depth| 1.3e-6, one
    visibility flip of 16,384)."""
    jo, to = rt_frames["jax"], rt_frames["port"]
    img, ref = to.image.numpy(), np.asarray(jo.image)
    assert img.shape == ref.shape == (N, N, 3)
    assert (np.abs(img.astype(int) - ref.astype(int)).max(-1) > 1).mean() <= 0.005
    assert ssim(img, ref) >= 0.99
    depth, depth_ref = to.depth.numpy(), np.asarray(jo.depth)
    np.testing.assert_allclose(depth, depth_ref, rtol=2e-3, atol=1e-9)
    assert (np.abs(depth - depth_ref) > 5e-4 * np.abs(depth_ref) + 1e-9).mean() <= 1e-3
    assert (to.visibility.numpy() != np.asarray(jo.visibility)).mean() <= 0.002
    assert np.isfinite(to.hdr.numpy()).all() and rt_frames["temporal"].frame_index == 1


def test_rt_shadows_darken_and_rtao_reaches_the_composite(rt_frames):
    """RT shadows darken the view (the frame without them is brighter
    somewhere). RTAO reaches compose_lit_scene at full resolution, occluded
    somewhere; as in the JAX frame, AO scales only the GI term, so with GI off
    it leaves this frame's image as it is."""
    cfg, scene, view = rt_frames["cfg"], rt_frames["scene"], rt_frames["view"]
    c = cfg.replace(shadow_mode=ShadowMode.OFF)
    lit, _ = make_renderer(c)(scene, view, RenderParams.default(),
                              temporal_state_for(c, device="cpu"))
    assert float((lit.hdr - rt_frames["port"].hdr).max()) > 1e-3
    ao, = rt_frames["ao"]
    assert ao.shape == (N, N, 1) and 0.0 <= float(ao.min()) < 1.0 and float(ao.max()) == 1.0


def test_rt_switches_need_a_bvh():
    """make_renderer takes RT shadows and AO (default_frame_config, the CLI's
    --shadow rt --ao rt), RT and probe GI, and VRSAA over them: the frame has
    no unported switch left (its check_slice is gone). VRSAA with translucency,
    or at a render size other than twice the output, raises the JAX frame's
    ValueError when rendered. A scene without a BVH raises a ValueError naming
    the remedy, for every switch that traces rays."""
    assert not hasattr(frame_mod, "check_slice")
    cfg = default_frame_config(N, N, shadow_mode=ShadowMode.RT, ao_mode=AOMode.RT)
    for c in (cfg, cfg.replace(gi_mode=GIMode.RT), cfg.replace(gi_mode=GIMode.PROBES)):
        make_renderer(c)
        make_renderer(c.replace(aa_mode=AAMode.VRSAA))
    leaves, _ = torch_procedural.cornell_scene().bake(with_bvh=False)
    scene = scene_arrays_from_numpy({k: v for k, v in leaves.items()
                                     if not k.startswith("bvh.")}, "cpu")
    assert scene.bvh is None
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(N, N))
    vrsaa = cfg.replace(aa_mode=AAMode.VRSAA, output_width=N // 2, output_height=N // 2)
    for c, match in ((vrsaa, "translucency"), (cfg.replace(aa_mode=AAMode.VRSAA,
                                                           translucency=False), "2x")):
        with pytest.raises(ValueError, match=match):
            make_renderer(c)(scene, cam.view_data(), RenderParams.default(),
                             temporal_state_for(c, device="cpu"))
    for c in (cfg, default_frame_config(N, N, gi_mode=GIMode.RT),
              default_frame_config(N, N, gi_mode=GIMode.PROBES)):
        with pytest.raises(ValueError, match="with_bvh"):
            make_renderer(c)(scene, cam.view_data(), RenderParams.default(),
                             temporal_state_for(c, device="cpu"))
