"""The port's two-phase HiZ occlusion culling against the JAX package's.

The culling functions of androidrenderer_tpu_torch/ops/culling.py run on the
128^2 courtyard (the JAX bake's own arrays, one raster of a view from behind
the courtyard's near wall as the depth; from the bench camera no sphere is
occluded) against androidrenderer_tpu/ops/culling.py: the HiZ pyramid bit-equal,
the frustum masks equal. The sphere occlusion test diverges from the JAX one on
purpose (ops/culling.py::occlusion_cull_spheres: JAX's footprint covers only
the AABB's centre and culls visible primitives at bench size), so it is held to
what both promise: it culls only spheres the unculled raster does not show,
and it passes a sphere visible through a hole that JAX's footprint misses.
The occlusion frame is held as the JAX package holds its own
(tests/test_occlusion.py:40-66): on the same occluder fixture and config,
rebuilt with the port's RenderScene, culling changes nothing in depth and
visibility over 3 chained frames, and the box behind the wall is culled once
the visibility list settles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu.ops import culling as jax_culling
from androidrenderer_tpu.scene import procedural as jax_procedural
from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.config import RenderConfig, RenderParams, ShadowMode
from androidrenderer_tpu_torch.ops import culling
from androidrenderer_tpu_torch.ops.raster import rasterize, triangle_setup_corners
from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
from androidrenderer_tpu_torch.scene.material_storage import Material
from androidrenderer_tpu_torch.scene import procedural as torch_procedural
from androidrenderer_tpu_torch.scene.procedural import box_mesh, plane_mesh
from androidrenderer_tpu_torch.scene.scene import RenderScene, scene_arrays_from_numpy

from test_torch_scene import jax_leaves

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it.
torch.set_num_threads(1)

N = 128
LEVELS = 6


@pytest.fixture(scope="module")
def courtyard():
    jscene, _ = jax_procedural.courtyard_scene().build(with_bvh=False)
    scene = scene_arrays_from_numpy(jax_leaves(jscene), "cpu")
    cam = Camera(fov_degrees=75.0, aspect=1.0, z_near=0.05, render_resolution=(N, N))
    cam.set_position([0.0, 1.7, 14.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    vd = cam.view_data()
    setup = triangle_setup_corners(
        scene.tri_corner_pos, torch.from_numpy(vd.view_proj), N, N,
        double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid,
    )
    depth, _ = rasterize(setup, N, N)
    return jscene, scene, vd, depth


def test_hiz_pyramid_bit_equal(courtyard):
    _, _, _, depth = courtyard
    want = jax_culling.build_hiz_pyramid(jnp.asarray(depth.numpy()), LEVELS)
    got = culling.build_hiz_pyramid(depth, LEVELS)
    assert [tuple(g.shape) for g in got] == [(N >> i, N >> i) for i in range(LEVELS)]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_frustum_masks_equal(courtyard):
    """Masks equal; a flip is reported with its distance to the near plane."""
    jscene, scene, vd, _ = courtyard
    bounds = np.asarray(jscene.prim_bounds)
    want = np.asarray(jax_culling.frustum_cull_spheres(
        jnp.asarray(bounds), jnp.asarray(vd.view), jnp.asarray(vd.frustum), vd.z_near))
    got = culling.frustum_cull_spheres(
        scene.prim_bounds, torch.from_numpy(vd.view), torch.from_numpy(vd.frustum),
        float(vd.z_near),
    ).numpy()
    c = bounds[:, :3].astype(np.float64) @ vd.view[:3, :3].T.astype(np.float64) + vd.view[:3, 3]
    for i in np.flatnonzero(got != want):
        print(f"sphere {i} flipped, {-c[i, 2] + bounds[i, 3] - vd.z_near:.3e} from the near plane")
    assert np.array_equal(got, want)
    valid = np.asarray(jscene.prim_valid)
    assert 0 < (want & valid).sum() < valid.sum()


@pytest.mark.parametrize("z", [14.0, 20.0])
def test_occlusion_culls_only_hidden_spheres(z):
    """From behind the courtyard's walls: every sphere the test culls belongs to
    a primitive with no pixel in the unculled raster, and some are culled."""
    scene, _ = torch_procedural.courtyard_scene().build(device="cpu")
    cam = Camera(fov_degrees=75.0, aspect=1.0, z_near=0.05, render_resolution=(N, N))
    cam.set_position([0.0, 1.7, z])
    cam.pitch, cam.yaw = -0.05, np.pi
    vd = cam.view_data()
    setup = triangle_setup_corners(
        scene.tri_corner_pos, torch.from_numpy(vd.view_proj), N, N,
        double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid,
    )
    depth, vis = rasterize(setup, N, N)
    keep = culling.occlusion_cull_spheres(
        scene.prim_bounds, torch.from_numpy(vd.view), float(vd.z_near),
        float(vd.projection[0, 0]), float(vd.projection[1, 1]),
        culling.build_hiz_pyramid(depth, LEVELS),
    )
    culled = ~keep & scene.prim_valid
    shown = torch.zeros_like(culled)
    shown[scene.tri_primitive[vis[vis >= 0]].long()] = True
    assert culled.any()
    assert not (culled & shown).any()


def test_occlusion_footprint_covers_the_aabb():
    """A sphere behind a near wall with a hole at its AABB's top-left corner is
    visible through the hole. JAX's test reads the footprint at the AABB's
    centre and culls it; the port's footprint covers the AABB and keeps it."""
    bounds = np.array([[0.0, 0.0, -20.0, 1.0]], np.float32)
    view = np.eye(4, dtype=np.float32)
    p00 = p11 = 1.0
    z_near = 5.0  # the sphere's nearest depth: 5 / (20 - 3) ~ 0.29
    aabb, ok = culling.project_sphere_aabb(
        torch.from_numpy(bounds[:, :3]), torch.tensor([3.0]), z_near, p00, p11)
    assert bool(ok[0])
    depth = np.full((N, N), 0.9, np.float32)  # a near wall over the whole view
    x0, y0 = (aabb[0, :2].numpy() * N).astype(int)
    depth[y0:y0 + 2, x0:x0 + 2] = 0.0  # the hole: no geometry there
    hiz_t = culling.build_hiz_pyramid(torch.from_numpy(depth), LEVELS)
    hiz_j = jax_culling.build_hiz_pyramid(jnp.asarray(depth), LEVELS)
    keep = culling.occlusion_cull_spheres(
        torch.from_numpy(bounds), torch.from_numpy(view), z_near, p00, p11, hiz_t)
    keep_jax = jax_culling.occlusion_cull_spheres(
        jnp.asarray(bounds), jnp.asarray(view), z_near, p00, p11, hiz_j)
    assert bool(keep[0])
    assert not bool(keep_jax[0])
    depth[y0:y0 + 2, x0:x0 + 2] = 0.9  # the hole closed: both cull it
    keep = culling.occlusion_cull_spheres(
        torch.from_numpy(bounds), torch.from_numpy(view), z_near, p00, p11,
        culling.build_hiz_pyramid(torch.from_numpy(depth), LEVELS))
    assert not bool(keep[0])


def test_band_arguments_raise(courtyard):
    """The band arguments, which raised until band rendering was ported: a
    band's test (rows [16, 32) of the 128^2 view, its own pyramid) culls no
    sphere with a pixel in the band, and culls the spheres whose AABB misses
    it exactly as JAX's band test does (with an empty pyramid every sphere
    passes the depth test, so both keep just the spheres that meet the band)."""
    jscene, scene, vd, depth = courtyard
    view = torch.from_numpy(vd.view)
    args = (view, float(vd.z_near), float(vd.projection[0, 0]), float(vd.projection[1, 1]))
    kw = dict(row_offset=16, full_height=N)
    keep = culling.occlusion_cull_spheres(
        scene.prim_bounds, *args, culling.build_hiz_pyramid(depth[16:32], 4), **kw)
    setup = triangle_setup_corners(
        scene.tri_corner_pos, torch.from_numpy(vd.view_proj), N, N,
        double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid,
    )
    _, vis = rasterize(setup, N, N)
    band = vis[16:32]
    shown = torch.zeros_like(keep)
    shown[scene.tri_primitive[band[band >= 0]].long()] = True
    assert shown.any() and not (~keep & shown).any()
    empty = culling.build_hiz_pyramid(torch.zeros(16, N), 4)
    ours = culling.occlusion_cull_spheres(scene.prim_bounds, *args, empty, **kw).numpy()
    theirs = np.asarray(jax_culling.occlusion_cull_spheres(
        jscene.prim_bounds, jnp.asarray(vd.view), *args[1:],
        [jnp.asarray(x.numpy()) for x in empty], **kw))
    valid = scene.prim_valid.numpy()
    assert np.array_equal(ours[valid], theirs[valid])
    assert 0 < ours[valid].sum() < valid.sum()


def _occluder_scene() -> RenderScene:
    """tests/test_occlusion.py's fixture, built with the port's RenderScene."""
    scene = RenderScene()
    m = scene.materials.add_material(Material(np.array([0.7, 0.7, 0.7, 1], np.float32)))
    wall = scene.meshes.add_mesh(*plane_mesh(8.0, 8.0, subdiv=2)[:3],
                                 uvs=plane_mesh(8.0, 8.0, subdiv=2)[3])
    box = scene.meshes.add_mesh(*box_mesh(1.0, 1.0, 1.0)[:3], uvs=box_mesh(1.0, 1.0, 1.0)[3])

    def rot_x(deg):
        a = np.radians(deg)
        t = np.eye(4, dtype=np.float32)
        t[1, 1], t[1, 2] = np.cos(a), -np.sin(a)
        t[2, 1], t[2, 2] = np.sin(a), np.cos(a)
        return t

    def tr(v):
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = v
        return t

    scene.add_primitive(wall, m, rot_x(90.0) @ tr([0, 0, 0]))  # the wall (prim 0)
    scene.add_primitive(box, m, tr([0.0, 0.0, -3.0]))  # behind the wall (prim 1)
    scene.add_primitive(box, m, tr([2.5, 0.0, 2.0]))  # beside it, visible (prim 2)
    scene.set_sun([0.2, -1.0, 0.3], [1, 1, 1], 100000.0)
    return scene


def test_occlusion_frame_is_exact_and_culls():
    w = h = 128
    cfg = RenderConfig(
        render_width=w, render_height=h, output_width=w, output_height=h,
        shadow_mode=ShadowMode.OFF, sky=False, bloom=False, alpha_masking=False,
        max_tris_per_tile=256,
    )
    scene, _ = _occluder_scene().build(device="cpu")
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(w, h))
    cam.set_position([0.0, 0.5, 5.0])
    cam.yaw = np.pi
    view = cam.view_data()
    params = RenderParams.default()
    outs = {}
    for on in (True, False):
        c = cfg.replace(occlusion_culling=on)
        renderer, t = make_renderer(c), temporal_state_for(c, device="cpu")
        frames = []
        for _ in range(3):
            out, t = renderer(scene, view, params, t)
            frames.append(out)
        outs[on] = (frames, t)
    for a, b in zip(outs[True][0], outs[False][0]):
        assert torch.equal(a.depth, b.depth) and torch.equal(a.visibility, b.visibility)
        assert torch.equal(a.image, b.image)
    visible = outs[True][1].prev_visible_prims[: scene.prim_bounds.shape[0]].numpy()
    assert not visible[1], "box behind the wall should be culled"
    assert visible[0] and visible[2], "wall and side box stay visible"
