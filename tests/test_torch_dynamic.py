"""Dynamic scenes in the port (scene/dynamic.py) against the JAX package's.

The port's update runs on the JAX bake's own arrays (``scene_arrays_from_numpy``),
so both start from bit-identical data. Held against the JAX update run eagerly
(``jax.disable_jit``): positions, primitive bounds, corner tables, the proxy's
positions and corners and every BVH tensor bit for bit; normals and tangents
within 1e-6 (measured <= 1.5e-8: the normal matrices come from another LAPACK
call). Against the jitted JAX update, whose CPU compile contracts the
multiply-adds into FMAs, everything within 1e-6 (measured <= 1.2e-7), on the
cornell box (one compile; the courtyard's takes another 9 s).
The properties of tests/test_dynamic.py and tests/test_proxy.py:90-150 are
held by the port on its own.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from androidrenderer_tpu import config as jax_config
from androidrenderer_tpu.camera import Camera
from androidrenderer_tpu.render import make_renderer as jax_make_renderer
from androidrenderer_tpu.render import temporal_state_for as jax_temporal_state_for
from androidrenderer_tpu.scene import bvh as jax_bvh
from androidrenderer_tpu.scene import dynamic as jax_dynamic
from androidrenderer_tpu.scene import procedural as jax_procedural
from androidrenderer_tpu.utils.image import ssim
from androidrenderer_tpu_torch.config import RenderParams, ShadowMode, raster_only_config
from androidrenderer_tpu_torch.ops.rt.traverse import LOOK0, occlusion
from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
from androidrenderer_tpu_torch.scene import bvh
from androidrenderer_tpu_torch.scene import dynamic
from androidrenderer_tpu_torch.scene import procedural as torch_procedural
from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

from test_torch_frame import to_jax_config
from test_torch_scene import jax_leaves

torch.set_num_threads(1)

SCENES = ("cornell_scene", "courtyard_scene")
EXACT = ("positions", "prim_bounds", "tri_corner_pos")
EXACT_BVH = ("node_min", "node_max", "node_miss", "node_first", "node_count", "slot_tri",
             "slot_v0", "slot_e1", "slot_e2", "node_rows")
CLOSE = ("normals", "tangents", "tri_attr_corners")
NORMAL_ATOL = 1e-6  # measured <= 1.5e-8 (eager), <= 1.2e-7 (jitted)


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def transforms(t0: np.ndarray) -> dict:
    """Identity (the build transforms), a lift, a non-uniform scale and a
    rotation about y, applied to every primitive."""
    lift = t0.copy()
    lift[:, 1, 3] += 0.6
    scale = t0.copy()
    scale[:, :3, :3] *= np.array([1.5, 0.7, 1.2], np.float32)[None, None, :]
    th = 0.7
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                   np.float32)
    turn = t0.copy()
    turn[:, :3, :3] = rot @ turn[:, :3, :3]
    turn[:, :3, 3] = turn[:, :3, 3] @ rot.T
    return dict(identity=t0, lift=lift, scale=scale, rotation=turn)


@pytest.fixture(scope="module", params=SCENES)
def both(request):
    """(JAX RenderScene, JAX scene, JAX dynamic data, port RenderScene, port
    scene from the JAX arrays, port dynamic data)."""
    rs = getattr(jax_procedural, request.param)()
    jscene, _ = rs.build()
    trs = getattr(torch_procedural, request.param)()
    trs.bake()  # the port's proxy_host (the bake is the JAX bake, tests/test_torch_scene.py)
    scene = scene_arrays_from_numpy(jax_leaves(jscene, bvh=True), "cpu")
    return (rs, jscene, jax_dynamic.make_dynamic_data(rs, jscene), trs, scene,
            dynamic.make_dynamic_data(trs, scene), request.param)


def test_complete_tree_level_slots_match_jax():
    for k in range(13):
        ours, theirs = bvh.complete_tree_level_slots(1 << k), jax_bvh.complete_tree_level_slots(1 << k)
        assert len(ours) == len(theirs) == k + 1
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_dynamic_data_matches_jax(both):
    _, _, jdyn, _, _, dyn, _ = both
    for f in jdyn._fields:
        if f == "level_slots":
            for a, b in zip(getattr(dyn, f), getattr(jdyn, f)):
                assert np.array_equal(a.numpy(), np.asarray(b))
        else:
            assert np.array_equal(bits(getattr(dyn, f).numpy()), bits(getattr(jdyn, f))), f


@pytest.mark.parametrize("case", ["identity", "lift", "scale", "rotation"])
def test_update_matches_jax(both, case):
    rs, jscene, jdyn, trs, scene, dyn, name = both
    tr = transforms(np.asarray(jax_dynamic.initial_transforms(rs)))[case]
    with jax.disable_jit():
        want = jax_dynamic.update_primitive_transforms(jscene, jdyn, jnp.asarray(tr))
    got = dynamic.update_primitive_transforms(scene, dyn, torch.from_numpy(tr.copy()))
    for f in EXACT:
        assert np.array_equal(bits(getattr(got, f).numpy()), bits(getattr(want, f))), f
    for f in ("positions", "corners"):
        assert np.array_equal(bits(getattr(got.proxy, f).numpy()), bits(getattr(want.proxy, f))), f
    for f in EXACT_BVH:
        assert np.array_equal(bits(getattr(got.bvh, f).numpy()), bits(getattr(want.bvh, f))), f
    for f in CLOSE:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=NORMAL_ATOL, err_msg=f)
    for f in ("normals", "attr_corners"):
        np.testing.assert_allclose(getattr(got.proxy, f).numpy(),
                                   np.asarray(getattr(want.proxy, f)), rtol=0,
                                   atol=NORMAL_ATOL, err_msg=f)
    if name != "cornell_scene":
        return
    jitted = jax.jit(jax_dynamic.update_primitive_transforms)(jscene, jdyn, jnp.asarray(tr))
    for f in EXACT + CLOSE:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(jitted, f)),
                                   rtol=0, atol=NORMAL_ATOL, err_msg=f)
    rows, jrows = got.bvh.node_rows.numpy(), np.asarray(jitted.bvh.node_rows)
    finite = np.isfinite(jrows)  # the alpha words ride as f32 bits (NaN patterns)
    np.testing.assert_allclose(rows[finite], jrows[finite], rtol=0, atol=NORMAL_ATOL)
    assert np.array_equal(bits(rows[~finite]), bits(jrows[~finite]))


def _cornell():
    rs = torch_procedural.cornell_scene()
    scene, _ = rs.build(device="cpu")
    dyn = dynamic.make_dynamic_data(rs, scene)
    return rs, scene, dyn, dynamic.initial_transforms(rs, device="cpu")


def test_identity_update_reproduces_the_bake():
    """tests/test_dynamic.py::test_identity_update_is_exact: the build
    transforms give the bake's positions and node boxes (the bake transforms
    in float64, the update in float32)."""
    rs, scene, dyn, t0 = _cornell()
    s2 = dynamic.update_primitive_transforms(scene, dyn, t0)
    n = sum(rs.meshes.meshes[p.mesh_id].num_vertices for p in rs.primitives)
    np.testing.assert_allclose(s2.positions[:n].numpy(), scene.positions[:n].numpy(), atol=2e-5)
    np.testing.assert_allclose(np.clip(s2.bvh.node_min.numpy(), -1e30, 1e30),
                               np.clip(scene.bvh.node_min.numpy(), -1e30, 1e30), atol=2e-5)


def test_moved_primitive_renders_and_traces_at_new_location():
    """tests/test_dynamic.py: the tall box lifted 0.6 m changes the raster, a
    ray at its old height misses the refit BVH and one at the new height hits."""
    rs, scene, dyn, t0 = _cornell()
    lift = t0.clone()
    lift[6, 1, 3] += 0.6
    s2 = dynamic.update_primitive_transforms(scene, dyn, lift)
    cfg = raster_only_config(128, 128, shadow_mode=ShadowMode.OFF, sky=False)
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(128, 128))
    cam.set_position([0.0, 0.0, 2.2])
    cam.yaw = np.pi
    render = make_renderer(cfg)
    ts = temporal_state_for(cfg, device="cpu")
    v1 = render(scene, cam.view_data(), RenderParams.default(), ts)[0].visibility
    v2 = render(s2, cam.view_data(), RenderParams.default(), ts)[0].visibility
    assert float((v1 != v2).float().mean()) > 0.02
    o = torch.tensor([[-0.95, -0.7, -0.3], [-0.95, 0.5, -0.3]])
    d = torch.tensor([[1.0, 0.0, 0.0]] * 2)
    hit_old = occlusion(scene.bvh, o, d, 1e-3, 1.4)
    hit_new = occlusion(s2.bvh, o, d, 1e-3, 1.4)
    assert hit_old[0] and not hit_new[0], "the old-position ray must now miss"
    assert hit_new[1], "the new-position ray must hit the lifted box"


def test_scaled_primitive_bounds_stay_conservative():
    rs, scene, dyn, t0 = _cornell()
    grow = t0.clone()
    grow[7, :3, :3] *= 2.0
    s2 = dynamic.update_primitive_transforms(scene, dyn, grow)
    b = s2.prim_bounds[7].numpy()
    pts = s2.positions.numpy()[dyn.vertex_prim.numpy() == 7]
    assert np.all(np.linalg.norm(pts - b[:3], axis=1) <= b[3] + 1e-4)


def test_refit_lookahead_boxes_track_geometry():
    rs, scene, dyn, t0 = _cornell()
    t1 = t0.clone()
    t1[1, 1, 3] += 3.0
    s2 = dynamic.update_primitive_transforms(scene, dyn, t1)
    rows = s2.bvh.node_rows.numpy()
    slots = rows[:, LOOK0:LOOK0 + 4]
    boxes = rows[:, LOOK0 + 4:LOOK0 + 28].reshape(-1, 4, 2, 3)
    ok = slots >= 0
    nmin, nmax = s2.bvh.node_min.numpy(), s2.bvh.node_max.numpy()
    si = np.clip(slots.astype(np.int64), 0, nmin.shape[0] - 1)
    assert np.array_equal(np.where(ok[..., None], boxes[:, :, 0, :], 0.0),
                          np.where(ok[..., None], nmin[si], 0.0))
    assert np.array_equal(np.where(ok[..., None], boxes[:, :, 1, :], 0.0),
                          np.where(ok[..., None], nmax[si], 0.0))


@pytest.mark.parametrize("motion", ["translation", "rotation"])
def test_update_moves_the_proxy_exactly(motion):
    """tests/test_proxy.py:90-150: the identity update gives the baked proxy; a
    translation of every primitive translates it rigidly, a rotation rotates
    its positions and normals."""
    rs, scene, dyn, t0 = _cornell()
    nv = rs.proxy_host["num_clusters"]
    base_p, base_n = scene.proxy.positions[:nv].numpy(), scene.proxy.normals[:nv].numpy()
    s_id = dynamic.update_primitive_transforms(scene, dyn, t0)
    np.testing.assert_allclose(s_id.proxy.positions[:nv].numpy(), base_p, atol=2e-5)
    t1 = t0.numpy().copy()
    if motion == "translation":
        t1[:, 0, 3] += 1.5
        t1[:, 1, 3] -= 0.25
        want_p, want_n, atol = base_p + np.float32([1.5, -0.25, 0.0]), base_n, 2e-5
    else:
        th = 0.7
        rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                       np.float32)
        t1[:, :3, :3] = rot @ t1[:, :3, :3]
        t1[:, :3, 3] = t1[:, :3, 3] @ rot.T
        want_p, want_n, atol = base_p @ rot.T, base_n @ rot.T, 3e-5
    s2 = dynamic.update_primitive_transforms(scene, dyn, torch.from_numpy(t1))
    np.testing.assert_allclose(s2.proxy.positions[:nv].numpy(), want_p, atol=atol)
    np.testing.assert_allclose(s2.proxy.normals[:nv].numpy(), want_n, atol=atol)


def test_moved_scene_rt_frame_matches_jax():
    """The cornell box with the tall box lifted and turned: the 64^2 RT-shadow
    frame of the port (plain traversal on the refit BVH) against the JAX frame
    (XLA raster branch) on the JAX update of the same scene. Held as
    tests/test_torch_rt.py holds the RT frame: image within one u8 step on
    >= 99.5% of pixels, SSIM >= 0.99, visibility equal on >= 99.8%."""
    n = 64
    rs = jax_procedural.cornell_scene()
    jscene, _ = rs.build()
    jdyn = jax_dynamic.make_dynamic_data(rs, jscene)
    trs = torch_procedural.cornell_scene()
    trs.bake()
    scene = scene_arrays_from_numpy(jax_leaves(jscene, bvh=True), "cpu")
    dyn = dynamic.make_dynamic_data(trs, scene)
    tr = np.asarray(jax_dynamic.initial_transforms(rs)).copy()
    tr[6, 1, 3] += 0.4
    c, s = np.cos(0.5), np.sin(0.5)
    tr[6, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) @ tr[6, :3, :3]
    with jax.disable_jit():
        jmoved = jax_dynamic.update_primitive_transforms(jscene, jdyn, jnp.asarray(tr))
    moved = dynamic.update_primitive_transforms(scene, dyn, torch.from_numpy(tr))
    cfg = raster_only_config(128, n, shadow_mode=ShadowMode.RT, alpha_bitmap=False).replace(
        render_width=n, output_width=n, tile_width=n)
    jcfg = to_jax_config(cfg).replace(pallas_interpret=False,
                                      raster_backend=jax_config.RasterBackend.XLA,
                                      max_tris_per_tile=1024)
    cam = Camera(fov_degrees=75.0, aspect=1.0, z_near=0.05, render_resolution=(n, n))
    cam.set_position([0.05, 0.03, 2.2])
    cam.yaw = np.pi + 0.02
    view = cam.view_data()
    jo, _ = jax_make_renderer(jcfg)(jmoved, view, jax_config.RenderParams.default(),
                                    jax_temporal_state_for(jcfg))
    to, _ = make_renderer(cfg)(moved, view, RenderParams.default(),
                               temporal_state_for(cfg, device="cpu"))
    img, ref = to.image.numpy(), np.asarray(jo.image)
    assert (np.abs(img.astype(int) - ref.astype(int)).max(-1) > 1).mean() <= 0.005
    assert ssim(img, ref) >= 0.99
    assert (to.visibility.numpy() != np.asarray(jo.visibility)).mean() <= 0.002
    # The moved box is in view and casts a different shadow than the baked one.
    base, _ = make_renderer(cfg)(scene, view, RenderParams.default(),
                                 temporal_state_for(cfg, device="cpu"))
    assert (base.visibility != to.visibility).any()
