"""The port's VRSAA, frame interpolation, visualizers, cvars, application, CLI
and asset layer against the JAX package.

Units are fed identical inputs made from a seed with numpy; each tolerance is
stated beside the value it measured. The VRSAA frame is the configuration of
tests/test_vrsaa.py (cornell at 128x64 output, 256x128 render, 2 cascades of
256^2) with a budget small enough that quads are dropped; the JAX frame runs its
XLA branch (bins above the peak count, which the test asserts), compiled once,
and both frames sample one shared set of cascade maps, as
tests/test_torch_parity.py shares its cascade cache: the two programs fit the
cascades with differently rounded setups (ROADMAP.md, Queue 3). The CLI runs in
this process on the CPU (``--platform cpu``) at 128x64.
"""

import base64
import dataclasses
import enum
import functools
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu import config as jax_config
from androidrenderer_tpu.app import cvars as jax_cvars
from androidrenderer_tpu.ops import interpolation as jax_interpolation
from androidrenderer_tpu.ops import shadow as jax_shadow
from androidrenderer_tpu.ops import visualize as jax_visualize
from androidrenderer_tpu.ops import vrsaa as jax_vrsaa
from androidrenderer_tpu.ops.gbuffer import GBuffer as JaxGBuffer
from androidrenderer_tpu.ops.gbuffer import resolve_gbuffer as jax_resolve_gbuffer
from androidrenderer_tpu.ops.raster import setup as jax_setup
from androidrenderer_tpu.ops.raster.binning import bin_triangles
from androidrenderer_tpu.render import make_renderer as jax_make_renderer
from androidrenderer_tpu.render import temporal_state_for as jax_temporal_state_for
from androidrenderer_tpu.render.frame import FrameOutputs as JaxFrameOutputs
from androidrenderer_tpu.scene import procedural as jax_procedural
from androidrenderer_tpu_torch.app import cvars
from androidrenderer_tpu_torch.app import headless
from androidrenderer_tpu_torch.app.application import Application, specialize_config
from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.config import (
    AAMode, GIMode, RenderConfig, RenderParams, ShadowMode, default_frame_config,
)
from androidrenderer_tpu_torch.ops import interpolation, shadow, visualize, vrsaa
from androidrenderer_tpu_torch.ops.gbuffer import GBuffer, resolve_gbuffer
from androidrenderer_tpu_torch.ops.probes import make_probe_state
from androidrenderer_tpu_torch.ops.raster import rasterize_reference
from androidrenderer_tpu_torch.ops.raster.setup import TriangleSetup
from androidrenderer_tpu_torch.render import frame as frame_mod
from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
from androidrenderer_tpu_torch.render.frame import FrameOutputs
from androidrenderer_tpu_torch.scene import procedural as torch_procedural
from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

from test_torch_frame import to_jax_config
from test_torch_scene import jax_leaves

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it.
torch.set_num_threads(1)

W, H = 128, 64  # VRSAA output; geometry rasterizes at 256x128


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(np.asarray(a))


def _camera(scene_name, w, h):
    """The CLI's default camera of a fixture, at a w x h render target (off
    cornell's symmetry axis, as tests/test_torch_frame.py places it)."""
    cam = Camera(fov_degrees=75.0, aspect=w / h, render_resolution=(w, h))
    if scene_name == "alpha_test_scene":
        cam.set_position([0.0, 0.0, -4.0])
    else:
        cam.set_position([0.05, 0.03, 2.2])
        cam.yaw = np.pi + 0.02
    return cam.view_data()


def _jax_setup(jscene, view, width, height):
    """The JAX package's main-view setup (jitted: it is an input both sides share)."""
    return jax.jit(jax_setup.triangle_setup_corners, static_argnums=(2, 3))(
        jscene.tri_corner_pos, j(view.view_proj), width, height,
        double_sided=jscene.tri_double_sided, tri_valid=jscene.tri_valid)


# ---------------------------------------------------------------- ops/vrsaa.py

# Jitted where the JAX function has no product to contract into an FMA, so the
# jit rounds as the eager function does (compares, selects, integer scans, a
# sum then a product); luminance_contrast's weighted sum stays eager.
_jax_worklist = jax.jit(jax_vrsaa.fine_worklist, static_argnums=1)


def test_detect_fine_quads_matches_jax():
    """Id edges inside quads and depth edges on both sides of the relative
    threshold: bit-equal."""
    rng = np.random.default_rng(3)
    vis = rng.integers(0, 3, (32, 64)).astype(np.int32)
    vis[::2, ::2] = vis[1::2, 1::2] = vis[::2, 1::2] = vis[1::2, ::2] = vis[::2, ::2].copy()
    vis[rng.uniform(size=vis.shape) < 0.05] = 7  # some quads gain an id edge
    depth = rng.uniform(0.1, 0.9, (16, 32)).astype(np.float32).repeat(2, 0).repeat(2, 1)
    step = rng.choice([0.0, 1.5e-3, 2.5e-3], size=depth.shape).astype(np.float32)
    depth = depth * (1.0 + step)
    want = np.asarray(jax.jit(jax_vrsaa.detect_fine_quads)(j(vis), j(depth)))
    got = vrsaa.detect_fine_quads(t(vis), t(depth)).numpy()
    assert 0 < want.sum() < want.size and np.array_equal(got, want)


def test_luminance_contrast_matches_jax():
    """A bright column on the image's right edge contrasts with the left
    edge's pixels through the wrap, as jnp.roll wraps: bit-equal."""
    rng = np.random.default_rng(4)
    lit = rng.uniform(0.0, 0.2, (16, 24, 3)).astype(np.float32)
    lit[:, -1] = 5.0
    lit[7, 9] = 2.0
    want = np.asarray(jax_vrsaa.luminance_contrast(j(lit)))
    got = vrsaa.luminance_contrast(t(lit)).numpy()
    assert want[:, 0].all()  # flagged only through the wrap
    assert np.array_equal(got, want)


@pytest.mark.parametrize("budget", [1, 37, 100, 500])
def test_fine_worklist_matches_jax(budget):
    """The quads kept, their scan order, the padding and ``dropped``, with and
    without an overflow: bit-equal."""
    rng = np.random.default_rng(5)
    fine = rng.uniform(size=(12, 20)) < 0.3
    want = [np.asarray(x) for x in _jax_worklist(j(fine), budget)]
    got = [x.numpy() for x in vrsaa.fine_worklist(t(fine), budget)]
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and np.array_equal(g, w_)
    assert int(got[3]) == max(int(fine.sum()) - budget, 0)
    assert got[3].dtype == np.int32


def test_resolve_quads_matches_jax():
    """Live quads averaged in place, dead entries (past the end) dropped:
    bit-equal."""
    rng = np.random.default_rng(6)
    lit = rng.uniform(0, 4, (10, 14, 3)).astype(np.float32)
    fine = rng.uniform(size=(10, 14)) < 0.4
    qy, qx, live, _ = _jax_worklist(j(fine), 80)
    assert not bool(np.asarray(live).all())
    fine_rgb = rng.uniform(0, 4, (80, 3, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax_vrsaa.resolve_quads)(j(lit), j(fine_rgb), qy, qx, live))
    got = vrsaa.resolve_quads(t(lit), t(fine_rgb), t(qy).long(), t(qx).long(), t(live)).numpy()
    assert np.array_equal(got, want)


# ------------------------------------------------- resolve_gbuffer(pixel_coords=)

@pytest.mark.parametrize("scene_name", ["cornell_scene", "alpha_test_scene"])
def test_resolve_gbuffer_pixel_coords_matches_jax(scene_name):
    """VRSAA's two resolves, the coarse grid's even coordinates and (B, 3) fine
    samples, from the JAX setup and the plain raster of it at 256x128: every
    field within rtol 1e-6 (atol 1e-6 for values near zero); measured
    bit-equal (the JAX side runs op by op, as the port does)."""
    jscene, _ = getattr(jax_procedural, scene_name)().build(with_bvh=False)
    scene = scene_arrays_from_numpy(jax_leaves(jscene), "cpu")
    view = _camera(scene_name, 256, 128)
    jsetup = _jax_setup(jscene, view, 256, 128)
    setup = TriangleSetup(*(t(x) for x in jsetup))
    depth, vis = (x.numpy() for x in rasterize_reference(setup, 128, 256))
    assert (vis >= 0).mean() > 0.15
    # Both cases are (B, 3) with B = 2,688, so the JAX side's op-by-op compiles
    # serve both: the coarse grid's first 126 columns, 3 to a row, and the 3
    # other samples of as many random quads.
    b = 64 * 42
    rng = np.random.default_rng(7)
    qy, qx = rng.integers(0, 64, b), rng.integers(0, 128, b)
    offs = np.array([[0, 1], [1, 0], [1, 1]])
    pys = (qy[:, None] * 2 + offs[None, :, 0]).astype(np.int32)
    pxs = (qx[:, None] * 2 + offs[None, :, 1]).astype(np.int32)
    gy, gx = np.meshgrid(np.arange(64) * 2, np.arange(126) * 2, indexing="ij")
    cases = [
        (vis[gy, gx].reshape(b, 3), depth[gy, gx].reshape(b, 3),
         gx.reshape(b, 3).astype(np.float32), gy.reshape(b, 3).astype(np.float32)),
        (vis[pys, pxs], depth[pys, pxs], pxs.astype(np.float32), pys.astype(np.float32)),
    ]
    for v, d, px, py in cases:
        want = jax_resolve_gbuffer(jscene, jsetup, j(v), j(d), pixel_coords=(j(px), j(py)))
        got = resolve_gbuffer(scene, setup, t(v), t(d), pixel_coords=(t(px), t(py)))
        assert got.base_color.shape == v.shape + (3,)
        for f in GBuffer._fields:
            g, w_ = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            np.testing.assert_allclose(g, w_, rtol=1e-6, atol=1e-6, err_msg=f)


# ---------------------------------------------------------------- the VRSAA frame

def vrsaa_config(**overrides) -> RenderConfig:
    """tests/test_vrsaa.py's config (cornell, 2 cascades of 256^2, no bloom,
    occlusion, translucency or alpha masking) at 128x64 output."""
    return RenderConfig(
        render_width=2 * W, render_height=2 * H, output_width=W, output_height=H,
        tile_height=32, tile_width=128, max_tris_per_tile=1024,
        shadow_mode=ShadowMode.CSM, shadow_cascade_resolution=256, num_shadow_cascades=2,
        bloom=False, occlusion_culling=False, translucency=False, alpha_masking=False,
        aa_mode=AAMode.VRSAA,
    ).replace(**overrides)


@pytest.fixture(scope="module")
def vrsaa_frames():
    """The VRSAA frame from the JAX package (XLA branch) and the port, with
    ``vrsaa_budget=0.02`` (163 quads), both sampling the port's cascade maps
    and recording the fine-quad mask they hand the worklist."""
    cfg = vrsaa_config(vrsaa_budget=0.02)
    jcfg = to_jax_config(cfg).replace(
        pallas_interpret=False, raster_backend=jax_config.RasterBackend.XLA)
    jscene, _ = jax_procedural.cornell_scene().build(with_bvh=False)
    scene = scene_arrays_from_numpy(jax_leaves(jscene), "cpu")
    view = _camera("cornell_scene", 2 * W, 2 * H)
    bins = jax.jit(bin_triangles, static_argnums=(1, 2, 3, 4, 5))(
        _jax_setup(jscene, view, 2 * W, 2 * H), 4, 2, 32, 128, cfg.max_tris_per_tile)
    peak = int(np.asarray(bins.counts).max())
    cascades = shadow.fit_cascades(
        t(view.inverse_view), float(view.projection[0, 0]), float(view.projection[1, 1]),
        scene.sun_direction, cfg.num_shadow_cascades, 256, cfg.z_near,
        cfg.shadow_max_distance, cfg.shadow_cascade_split_lambda,
    )
    maps = shadow.render_shadow_cascades(
        scene.positions, scene.tri_indices, scene.tri_valid, cascades, 256,
        double_sided=scene.tri_double_sided, proxy=scene.proxy,
        proxy_from_cascade=cfg.shadow_proxy_from_cascade, corners=scene.tri_corner_pos,
    )
    fine = {}
    jax_worklist, port_worklist = jax_vrsaa.fine_worklist, vrsaa.fine_worklist

    def jax_recorded(mask, budget):
        jax.debug.callback(lambda m: fine.__setitem__("jax", np.asarray(m)), mask)
        return jax_worklist(mask, budget)

    def port_recorded(mask, budget):
        fine["port"] = mask.numpy()
        return port_worklist(mask, budget)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_shadow, "render_shadow_cascades", lambda *a, **k: j(maps.numpy()))
        mp.setattr(frame_mod.shadow_ops, "render_shadow_cascades", lambda *a, **k: maps)
        mp.setattr(jax_vrsaa, "fine_worklist", jax_recorded)
        mp.setattr(vrsaa, "fine_worklist", port_recorded)
        jo, _ = jax_make_renderer(jcfg)(jscene, view, jax_config.RenderParams.default(),
                                        jax_temporal_state_for(jcfg))
        jax.block_until_ready(jo.image)
        to, _ = make_renderer(cfg)(scene, view, RenderParams.default(),
                                   temporal_state_for(cfg, device="cpu"))
    return dict(jax=jo, port=to, fine=fine, peak=peak, cfg=cfg)


def test_vrsaa_frame_quads_and_dropped(vrsaa_frames):
    """The fine-quad mask (id and depth edges at 2x, luminance contrast of the
    coarse shade) and the dropped count are equal: measured 4,432 fine quads,
    4,269 dropped past the 163-quad budget. The JAX raster's bins stay under
    the cap."""
    f = vrsaa_frames
    assert 0 < f["peak"] <= f["cfg"].max_tris_per_tile
    assert np.array_equal(f["fine"]["port"], f["fine"]["jax"])
    dropped = f["port"].vrsaa_dropped
    assert dropped.dtype == torch.int32 and dropped.dim() == 0
    assert int(dropped) == int(f["jax"].vrsaa_dropped) > 0
    assert int(dropped) == int(f["fine"]["port"].sum()) - int(0.02 * W * H)


def test_vrsaa_frame_image(vrsaa_frames):
    """The coarse visibility (the quads' top-left samples) equal, the coarse
    depth within 2e-5 relative (measured 8.7e-6: the jitted JAX setup rounds
    differently, as tests/test_torch_frame.py widens the raster contract), the
    resolved HDR within 1e-3 relative + 1e-5 (measured max |delta| 4.4e-5 of
    values up to 40, no value outside) and the u8 image within one step
    (measured: 2 pixels of 8,192 off by one)."""
    jo, to = vrsaa_frames["jax"], vrsaa_frames["port"]
    assert tuple(to.hdr.shape) == (H, W, 3) and tuple(to.image.shape) == (H, W, 3)
    assert tuple(to.depth.shape) == (H, W)
    assert np.array_equal(to.visibility.numpy(), np.asarray(jo.visibility))
    np.testing.assert_allclose(to.depth.numpy(), np.asarray(jo.depth), rtol=2e-5, atol=1e-9)
    hdr, ref = to.hdr.numpy(), np.asarray(jo.hdr)
    assert np.isfinite(hdr).all()
    np.testing.assert_allclose(hdr, ref, rtol=1e-3, atol=1e-5)
    img, ref_img = to.image.numpy().astype(int), np.asarray(jo.image).astype(int)
    assert np.abs(img - ref_img).max() <= 1


def test_vrsaa_frame_raises_as_jax_does():
    """VRSAA frames pass make_renderer; the two configs VRSAA cannot render
    raise the JAX frame's ValueErrors when rendered."""
    scene, _ = torch_procedural.cornell_scene().build(device="cpu", with_bvh=False)
    view = _camera("cornell_scene", 2 * W, 2 * H)
    for cfg, match in ((vrsaa_config(translucency=True), "translucency"),
                       (vrsaa_config(render_width=W, render_height=H), "2x")):
        renderer = make_renderer(cfg)
        with pytest.raises(ValueError, match=match):
            renderer(scene, view, RenderParams.default(), temporal_state_for(cfg, device="cpu"))


# ---------------------------------------------------------------- interpolation

@pytest.mark.parametrize("phase", [0.25, 0.5, 0.75])
def test_interpolate_frame_matches_jax(phase):
    """Flow that sends taps off screen on the left and bottom, and a divergent
    flow edge down the middle: within atol 1e-6 (measured 1.2e-7)."""
    rng = np.random.default_rng(8)
    h, w = 64, 64  # the visualizers' size: the JAX side's op-by-op compiles serve both
    prev = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    curr = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    mv = rng.normal(0, 0.01, (h, w, 2)).astype(np.float32)
    mv[:, : w // 2, 0] += 0.3  # this half's taps leave the screen
    mv[h // 2 :, :, 1] -= 0.4
    mv[:, w // 2 :] *= -3.0  # flow diverges across the middle column
    want = np.asarray(jax_interpolation.interpolate_frame(j(prev), j(curr), j(mv), t=phase))
    got = interpolation.interpolate_frame(t(prev), t(curr), t(mv), t=phase).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- visualizers

def _outputs(rng, h, w):
    """The same seeded FrameOutputs for both packages."""
    fields = dict(
        base_color=rng.uniform(0, 1, (h, w, 3)), normal=rng.normal(0, 1, (h, w, 3)),
        roughness=rng.uniform(0, 1, (h, w, 1)), metalness=rng.uniform(0, 1, (h, w, 1)),
        emission=rng.uniform(0, 3, (h, w, 3)), world_position=rng.normal(0, 5, (h, w, 3)),
    )
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    depth = np.where(rng.uniform(size=(h, w)) < 0.2, 0.0,
                     10.0 ** rng.uniform(-4, 0, (h, w))).astype(np.float32)
    vis = np.where(depth > 0, rng.integers(0, 2**31 - 1, (h, w)), -1).astype(np.int32)
    image = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    fields.update(depth=depth, valid=vis >= 0)
    jo = JaxFrameOutputs(image=j(image), hdr=None, depth=j(depth), visibility=j(vis),
                         gbuffer=JaxGBuffer(**{k: j(v) for k, v in fields.items()}))
    to = FrameOutputs(image=t(image), hdr=None, depth=t(depth), visibility=t(vis),
                      gbuffer=GBuffer(**{k: t(v) for k, v in fields.items()}))
    return jo, to


def test_visualize_matches_jax():
    """The eight handled modes on one seeded set of outputs: equal u8 images,
    but depth's log2 may round one step apart (measured equal); ``none``,
    ``overdraw`` and an unknown mode raise, as in JAX."""
    assert visualize.MODES == jax_visualize.MODES and visualize.GI_MODES == jax_visualize.GI_MODES
    jo, to = _outputs(np.random.default_rng(9), 64, 64)
    for mode in visualize.MODES:
        if mode in ("none", "overdraw"):
            for fn, o in ((jax_visualize.visualize, jo), (visualize.visualize, to)):
                with pytest.raises(ValueError, match="unknown visualizer"):
                    fn(o, mode)
            continue
        want = np.asarray(jax_visualize.visualize(jo, mode))
        got = visualize.visualize(to, mode).numpy()
        assert got.dtype == np.uint8 and got.shape == want.shape == (64, 64, 3), mode
        limit = 1 if mode == "depth" else 0
        assert np.abs(got.astype(int) - want.astype(int)).max() <= limit, mode
    with pytest.raises(ValueError, match="unknown visualizer"):
        visualize.visualize(to, "bogus")


def test_splat_overlaps_take_the_last_billboard():
    """32 billboards (the probe visualizer's count per cascade, so the JAX
    side's compiles serve both): three on one pixel apart from the rest, the
    rest clustered so their squares overlap, one behind the camera, a few
    masked. Each offset's
    duplicates resolve to the highest index, as JAX on the CPU applies them in
    order: equal to JAX."""
    view = _camera("cornell_scene", 64, 64)
    rng = np.random.default_rng(10)
    pos = rng.normal(0, 0.08, (32, 3)).astype(np.float32)
    pos[:3] = [0.5, 0.3, 0.0]  # apart from the cluster
    pos[31] = [0.0, 0.0, 9.0]  # behind the camera
    cols = rng.uniform(0, 1, (32, 3)).astype(np.float32)
    mask = rng.uniform(size=32) > 0.15
    mask[:3] = mask[31] = True
    base = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_visualize._splat(j(base), view, j(pos), j(cols), j(mask)))
    got = visualize._splat(t(base), view, t(pos), t(cols), t(mask)).numpy()
    assert np.array_equal(got, want)
    assert (got == cols[2]).all(-1).any() and not (got == cols[0]).all(-1).any()


@pytest.fixture(scope="module")
def gi_views():
    """Cornell (its BVH-free bake) at 64^2 with a small LPV and probe
    cascade, the config and outputs each visualizer reads, for both packages."""
    cfg = default_frame_config(
        gi_mode=GIMode.LPV, lpv_num_cascades=2, lpv_resolution=8, lpv_rsm_resolution=32,
        lpv_num_propagation_steps=3, lpv_cell_size=0.3, probe_cascades=2,
        probe_grid=(4, 2, 4), max_tris_per_tile=1024,
    ).replace(render_width=64, render_height=64, output_width=64, output_height=64,
              tile_width=64)
    jscene, _ = jax_procedural.cornell_scene().build(with_bvh=False)
    scene = scene_arrays_from_numpy(jax_leaves(jscene), "cpu")
    view = _camera("cornell_scene", 64, 64)
    rng = np.random.default_rng(11)
    jo, to = _outputs(rng, 64, 64)
    probes = make_probe_state(2, cfg.probe_grid, "cpu")
    n = probes.cell.shape[1]
    cell = np.stack([rng.integers(-3, 3, (2, n)), rng.integers(-2, 2, (2, n)),
                     rng.integers(-3, 3, (2, n))], -1).astype(np.int32)
    probes = probes._replace(
        cell=t(cell), age=t(rng.integers(0, 2000, (2, n)).astype(np.int32)),
        irradiance=t(rng.uniform(0, 5, tuple(probes.irradiance.shape)).astype(np.float32)))
    jtemporal = jax_temporal_state_for(to_jax_config(cfg))
    jtemporal = jtemporal._replace(probes=jtemporal.probes._replace(
        **{f: j(getattr(probes, f).numpy()) for f in ("cell", "age", "irradiance")}))
    tt = temporal_state_for(cfg, device="cpu")._replace(probes=probes)
    return dict(cfg=cfg, jscene=jscene, scene=scene, view=view, jo=jo, to=to,
                jtemporal=jtemporal, temporal=tt)


@pytest.mark.parametrize("mode", ["lpv-gv", "lpv-radiance", "vpl", "probes"])
def test_visualize_gi_matches_jax(gi_views, mode):
    """The GI views at 64^2, the JAX side eager as in its CLI with its XLA
    raster's bins under the cap (asserted), the port's through its own
    ``rasterize`` (the plain version here): u8 within one step on >= 99.9% of
    pixels (measured: every view equal)."""
    g = gi_views
    from androidrenderer_tpu.ops.raster import binning as jax_binning

    peaks = []
    real = jax_binning.bin_triangles

    def recorded(*a, **k):
        bins = real(*a, **k)
        peaks.append(int(np.asarray(bins.counts).max()))
        return bins

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_binning, "bin_triangles", recorded)
        want = np.asarray(jax_visualize.visualize_gi(
            g["jscene"], g["view"], to_jax_config(g["cfg"]), g["jtemporal"], g["jo"], mode))
    got = visualize.visualize_gi(g["scene"], g["view"], g["cfg"], g["temporal"], g["to"],
                                 mode).numpy()
    assert all(p <= g["cfg"].max_tris_per_tile for p in peaks)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert want.max() > 0 and (diff > 1).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


# ---------------------------------------------------------------- cvars

def _fields(cfg) -> dict:
    return {f.name: (getattr(cfg, f.name).name if isinstance(getattr(cfg, f.name), enum.Enum)
                     else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}


def test_cvar_registry_matches_jax():
    strip = [(d.name, d.kind, d.field, d.help) for d in jax_cvars.list_cvars()]
    assert [(d.name, d.kind, d.field, d.help) for d in cvars.list_cvars()] == strip
    assert set(cvars.REGISTRY) == set(jax_cvars.REGISTRY)


_VALUES = {"int": "3", "float": "0.1", "bool": "on", "enum": "2"}


def test_set_cvar_matches_jax():
    """Every definition set from a string gives the same config, the same
    params (float32-rounded as JAX stores them) and the same recompile flag;
    listeners fire with the parsed value."""
    seen = []
    cvars.add_listener(lambda name, value: seen.append((name, value)))
    try:
        for d in cvars.list_cvars():
            jd = jax_cvars.REGISTRY[d.name.lower()]
            cfg, jcfg = RenderConfig(), jax_config.RenderConfig()
            params, jparams = RenderParams.default(), jax_config.RenderParams.default()
            cur = getattr(cfg, d.field) if d.kind == "structural" else getattr(params, d.field)
            kind = ("enum" if isinstance(cur, enum.Enum) else "bool" if isinstance(cur, bool)
                    else "int" if isinstance(cur, int) else "float")
            value = "0.3" if d.field == "shadow_cascade_split_lambda" else _VALUES[kind]
            c2, p2, re2 = cvars.set_cvar(d.name, value, cfg, params)
            jc2, jp2, jre2 = jax_cvars.set_cvar(jd.name, value, jcfg, jparams)
            assert re2 == jre2 == (d.kind == "structural"), d.name
            assert _fields(c2) == _fields(jc2), d.name
            f32 = [float(np.float32(x)) for x in p2]
            assert f32 == [float(np.asarray(x, np.float32)) for x in jp2], d.name
            if d.kind == "runtime":
                assert getattr(p2, d.field) == float(np.asarray(getattr(jp2, d.field)))
            assert seen[-1][0] == d.name
            assert cvars.get_cvar(d.name, c2, p2) == (
                getattr(c2, d.field) if d.kind == "structural" else getattr(p2, d.field))
    finally:
        cvars._listeners.clear()
    assert len(seen) == len(cvars.list_cvars())


# ---------------------------------------------------------------- application

@pytest.mark.parametrize("scene_name", ["cornell_scene", "courtyard_scene", "alpha_test_scene"])
def test_application_config_matches_jax(scene_name):
    """The material-feature specialization of the CLI's config (the JAX
    Application's; no frame runs) and the Application's camera and state."""
    from androidrenderer_tpu.app.application import Application as JaxApplication

    cfg = RenderConfig(render_width=128, render_height=64, output_width=128, output_height=64)
    jhost = getattr(jax_procedural, scene_name)()
    jhost.build = functools.partial(jhost.build, with_bvh=False)  # the config needs no BVH
    japp = JaxApplication(to_jax_config(cfg).replace(pallas_interpret=False), jhost)
    host = getattr(torch_procedural, scene_name)()
    app = Application(cfg, host, device="cpu")
    assert _fields(app.config) == _fields(japp.config)
    assert specialize_config(cfg, host, app.scene_stats) == app.config
    assert app.scene.positions.device.type == "cpu"
    assert tuple(app.temporal.taa_history.shape) == (64, 128, 3)


# ---------------------------------------------------------------- the CLI

def _png_size(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    return struct.unpack(">II", data[16:24])


CLI = ["--width", "128", "--height", "64", "--platform", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--aa", "vrsaa"], ["--visualize", "depth"],
                                   ["--aa", "taa", "--frames", "2", "--interpolate"]])
def test_cli_writes_pngs(tmp_path, capsys, extra):
    out = tmp_path / "f.png"
    assert headless.main(CLI + ["--out", str(out)] + extra) == 0
    text = capsys.readouterr().out
    assert "frame 0:" in text and f"wrote {out}" in text
    assert _png_size(out) == (128, 64)
    if "--interpolate" in extra:
        assert _png_size(tmp_path / "f.png.mid.png") == (128, 64)


def test_cli_lists_cvars_and_exits_as_jax_does(tmp_path, capsys, monkeypatch):
    """``--set list`` prints the registry; a bad camera, an unknown scene and
    --interpolate without TAA exit 2 with the JAX messages; without a card and
    without ``--platform cpu`` the CLI exits 1 and renders nothing."""
    out = str(tmp_path / "f.png")
    assert headless.main(CLI + ["--set", "list"]) == 0
    assert "r.GI.LPV.Exposure" in capsys.readouterr().out
    for extra, message in ((["--camera", "1,2"], "--camera expects"),
                           (["--scene", "nowhere"], "unknown scene"),
                           (["--frames", "2", "--interpolate", "--no-occlusion"],
                            "--interpolate needs")):
        assert headless.main(CLI + ["--out", out] + extra) == 2
        assert message in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert headless.main(["--width", "128", "--height", "64", "--out", out]) == 1
    assert "is_available" in capsys.readouterr().err


# ---------------------------------------------------------------- the asset layer

def _textured_gltf(tmp_path, ktx2_module):
    """A one-quad glTF whose base-color texture is ETC1S KTX2 and whose
    metal-rough texture is UASTC KTX2 (no Zstd), written by ``ktx2_module``."""
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
    img[..., 3] = 255
    levels = [img, img[::2, ::2].copy(), img[::4, ::4].copy()]
    (tmp_path / "base.ktx2").write_bytes(ktx2_module.write_ktx2(levels, fmt="etc1s"))
    (tmp_path / "mr.ktx2").write_bytes(ktx2_module.write_ktx2(levels, fmt="uastc"))
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    buf = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes()
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
                                    "indices": 3, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                "metallicRoughnessTexture": {"index": 1}}}],
        "textures": [{"extensions": {"KHR_texture_basisu": {"source": 0}}},
                     {"extensions": {"KHR_texture_basisu": {"source": 1}}}],
        "images": [{"uri": "base.ktx2", "mimeType": "image/ktx2"},
                   {"uri": "mr.ktx2", "mimeType": "image/ktx2"}],
        "buffers": [{"byteLength": len(buf), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(buf).decode()}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 48},
                        {"buffer": 0, "byteOffset": 48, "byteLength": 48},
                        {"buffer": 0, "byteOffset": 96, "byteLength": 32},
                        {"buffer": 0, "byteOffset": 128, "byteLength": 12}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3",
             "min": [-1, -1, 0], "max": [1, 1, 0]},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
    }
    path = tmp_path / "scene.gltf"
    path.write_text(json.dumps(gltf))
    return path


def test_gltf_with_ktx2_textures_bakes_as_jax(tmp_path):
    """A glTF with ETC1S and UASTC KTX2 textures, written by the port's
    ktx2.write_ktx2, loads through both packages (the textures land in the
    pool, not the default white) and bakes leaf for leaf equal; the port's
    CLI renders it."""
    from androidrenderer_tpu.scene.gltf import load_gltf_scene as jax_load
    from androidrenderer_tpu_torch.scene import ktx2
    from androidrenderer_tpu_torch.scene.gltf import load_gltf_scene

    path = _textured_gltf(tmp_path, ktx2)
    jhost, host = jax_load(str(path)), load_gltf_scene(str(path))
    assert host.materials.num_textures == jhost.materials.num_textures == 4
    jscene, jstats = jhost.build(with_bvh=False)
    leaves, stats = host.bake(with_bvh=False)
    assert stats == jstats
    jl = jax_leaves(jscene, bvh=True)
    assert set(leaves) == set(jl)
    for k, want in jl.items():
        got = np.asarray(leaves[k])
        got = got.astype(want.dtype) if got.dtype in (np.float64, np.int64) else got
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    out = tmp_path / "g.png"
    assert headless.main(CLI + ["--scene", str(path), "--out", str(out), "--no-bloom"]) == 0
    assert _png_size(out) == (128, 64)
