"""The JAX frame's six profiling switches in the port, against the JAX package.

First each stub's output against the JAX expression it copies, evaluated
eagerly (no frame compile): the analytic raster, the analytic gbuffer, the
gather-only resolve, and the RSM stub's ids, which the port clamps to the
proxy's rows because JAX's gather reads a row past the end as the last row.
Then two 128^2 frames with compatible switches combined, against the JAX frame
(its XLA branch) with the same switches. Then, for each switch alone, the raster
calls each frame makes on the CPU path, against the counts chip_smoke.py gates
on the card, and a band of a frame under the stubs. Each tolerance is stated
beside its check, with its reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu import config as jax_config
from androidrenderer_tpu.ops import shadow as jax_shadow
from androidrenderer_tpu.ops.gbuffer import resolve_gbuffer as jax_resolve_gbuffer
from androidrenderer_tpu.ops.raster.setup import TriangleSetup as JaxTriangleSetup
from androidrenderer_tpu.render import make_renderer as jax_make_renderer
from androidrenderer_tpu.render import temporal_state_for as jax_temporal_state_for
from androidrenderer_tpu.utils.image import ssim
from androidrenderer_tpu_torch.config import (
    GIMode, RenderParams, parity_frame_config, raster_only_config,
)
from androidrenderer_tpu_torch.ops import shadow
from androidrenderer_tpu_torch.ops.gbuffer import pack_attribute_planes, resolve_gbuffer
from androidrenderer_tpu_torch.ops.raster import raster as raster_mod
from androidrenderer_tpu_torch.render import frame as frame_mod
from androidrenderer_tpu_torch.render import make_renderer, temporal_from_numpy, temporal_state_for
from androidrenderer_tpu_torch.scene.proxy import swap_in_proxy

from test_torch_frame import to_jax_config
from test_torch_parity import LPV, N, OUT, XLA_CAP, _views, courtyard, j, t  # noqa: F401
from test_torch_scene import jax_temporal_leaves

torch.set_num_threads(1)

SWITCHES = ("debug_stub_raster", "debug_stub_resolve", "debug_resolve_gather_only",
            "debug_stub_shadow_sample", "debug_stub_rsm", "debug_stub_lpv_apply")


def jax_stub_raster(h, w, n_tri):
    """The JAX frame's stub (androidrenderer_tpu/render/frame.py:203-214 and
    :523-536), as an expression: analytic depth and pseudo-random ids."""
    m = 1
    while m * 2 <= n_tri:
        m *= 2
    yy = jnp.arange(h, dtype=jnp.int32)[:, None]
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]
    vis = (yy * 7919 + xx * 104729) & (m - 1)
    depth = 0.05 + 0.9 * jnp.abs(jnp.sin((yy * 0.013 + xx * 0.007).astype(jnp.float32)))
    return np.array(depth), np.array(vis)


def jax_stub_gbuffer(vis, depth):
    """The JAX frame's resolve stub (frame.py:303-316) as an expression."""
    zz = depth[..., None]
    xyz = jnp.concatenate([zz * 3.0, zz * zz, jnp.cos(zz)], axis=-1)
    one = jnp.ones(depth.shape + (1,), jnp.float32)
    return dict(
        base_color=jnp.abs(jnp.sin(xyz)),
        normal=xyz / jnp.sqrt(jnp.sum(xyz * xyz, axis=-1, keepdims=True) + 1e-6),
        roughness=0.5 * one, metalness=0.1 * one,
        emission=jnp.zeros(depth.shape + (3,), jnp.float32),
        world_position=xyz * 4.0, depth=depth, valid=vis >= 0,
    )


@pytest.mark.parametrize("h,w,n_tri", [(128, 128, 321_517), (32, 3840, 1)])
def test_stub_raster_matches_jax(h, w, n_tri):
    """Ids equal (int32 arithmetic); depth within 1.2e-7 (6e-8 measured): the
    two libraries' float32 sin differ by an ulp."""
    depth_j, vis_j = jax_stub_raster(h, w, n_tri)
    depth, vis = frame_mod._stub_raster(h, w, n_tri, "cpu")
    assert vis.dtype == torch.int32 and depth.dtype == torch.float32
    assert np.array_equal(vis.numpy(), vis_j)
    assert vis.min() >= 0 and (n_tri == 1 or vis.max() > 0)
    np.testing.assert_allclose(depth.numpy(), depth_j, rtol=0, atol=1.2e-7)


def test_stub_gbuffer_matches_jax():
    """Over the stub raster's depth at 128^2: every field within 2.4e-7 of
    values of order one (sin, cos and sqrt of two libraries)."""
    depth_j, vis_j = jax_stub_raster(N, N, 1000)
    vis_j[:3, :5] = -1  # pixels no triangle covers
    want = jax_stub_gbuffer(jnp.asarray(vis_j), jnp.asarray(depth_j))
    got = frame_mod._stub_gbuffer(t(vis_j), t(depth_j))
    for f in got._fields:
        g_, w_ = getattr(got, f).numpy(), np.asarray(want[f])
        assert g_.shape == w_.shape and g_.dtype == w_.dtype, f
        np.testing.assert_allclose(g_, w_, rtol=0, atol=2.4e-7, err_msg=f)


@pytest.fixture(scope="module")
def main_setup(courtyard):
    """The courtyard's main-view setup at 128^2, computed by the port, with
    the stub raster's ids over it (a pixel of 40 uncovered)."""
    jscene, scene = courtyard
    view = _views()[0]
    cfg = parity_frame_config(OUT, OUT, N, N)
    setup, _, _ = frame_mod.main_view_setup(scene, view, cfg)
    depth, vis = frame_mod._stub_raster(N, N, scene.tri_indices.shape[0], "cpu")
    vis[::7, ::6] = -1
    return setup, depth, vis


def test_gather_only_resolve_matches_jax(courtyard, main_setup):
    """The resolve's gather-only pass against JAX's, both fed one setup and the
    stub's ids: bit-equal (the same adds and abs, op by op), but for the
    normal, within an ulp of its unit length (1.2e-7, measured 1.19e-7): the
    two libraries sum the normalisation's three squares in another order."""
    jscene, scene = courtyard
    setup, depth, vis = main_setup
    want = jax_resolve_gbuffer(jscene, JaxTriangleSetup(*(j(x) for x in setup)), j(vis),
                               j(depth), debug_gather_only=True)
    got = resolve_gbuffer(scene, setup, vis, depth, debug_gather_only=True)
    for f in got._fields:
        g_, w_ = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g_.shape == w_.shape and g_.dtype == w_.dtype, f
        if f == "normal":
            np.testing.assert_allclose(g_, w_, rtol=0, atol=1.2e-7)
        else:
            assert np.array_equal(g_, w_), f
    assert np.abs(got.base_color.numpy()).max() > 0


def test_stub_rsm_ids_read_what_jax_reads(courtyard):
    """The RSM stub's ids come from the frame scene's triangle count (321,517
    at bench scale), past the proxy's plane rows; JAX's gather reads an id
    past the end as the last row, and the port's stub clamps its ids to that
    row: the gathered rows are equal."""
    jscene, scene = courtyard
    proxy = swap_in_proxy(scene)
    n_proxy = proxy.tri_indices.shape[0]
    view = _views()[0]
    setup, _, _ = frame_mod.main_view_setup(proxy, view, parity_frame_config(N, N, N, N))
    table = pack_attribute_planes(proxy, setup)
    depth_j, vis_j = jax_stub_raster(N, N, 321_517)
    assert vis_j.max() >= n_proxy and vis_j.min() < n_proxy
    want = np.asarray(j(table)[j(vis_j)])
    got = table[t(vis_j).clamp(max=n_proxy - 1).long()].numpy()
    assert np.array_equal(got, want)


# ---------------------------------------------------------------- the frames

# Frame A: the raster-only frame with LPV GI and five switches; its image is
# the sun + the stub GI (base colour x 0.1) over the analytic gbuffer. Frame B:
# the raster-only frame with the gather-only resolve (the resolve stub would
# hide it) over the stub raster and the exact alpha peel, its shadows sampled.
FRAME_A = ("debug_stub_raster", "debug_stub_resolve", "debug_stub_shadow_sample",
           "debug_stub_rsm", "debug_stub_lpv_apply")
FRAME_B = ("debug_stub_raster", "debug_resolve_gather_only")


def _jax_config(cfg):
    return to_jax_config(cfg).replace(
        pallas_interpret=False, raster_backend=jax_config.RasterBackend.XLA,
        max_tris_per_tile=XLA_CAP,
    )


@pytest.fixture(scope="module")
def stub_frames(courtyard):
    """One frame of each at 128^2, from the JAX package (XLA branch, every
    cascade rastered each frame) and the port, from identical temporal state,
    the two renderers sampling one cascade cache: the port's maps of the view's
    fitted cascades (frame A's stubbed sample reads one texel of them). Sky
    and bloom, which no switch touches, are off, and frame A has no alpha
    masking (the masked peel is frame B's): that keeps the two JAX compiles
    at about 3 and 5 s."""
    jscene, scene = courtyard
    views = _views()
    out = {}
    common = dict(shadow_cascade_resolution=N, shadow_update_budget=0, sky=False, bloom=False)
    cfg_a = raster_only_config(N, N, gi_mode=GIMode.LPV, alpha_masking=False, **common, **LPV,
                               **{s: True for s in FRAME_A})
    cfg_b = raster_only_config(N, N, alpha_bitmap=False, **common, **{s: True for s in FRAME_B})
    view = views[0]
    cascades = shadow.fit_cascades(
        t(view.inverse_view), float(view.projection[0, 0]), float(view.projection[1, 1]),
        scene.sun_direction, cfg_b.num_shadow_cascades, N, cfg_b.z_near,
        cfg_b.shadow_max_distance, cfg_b.shadow_cascade_split_lambda,
    )
    maps = shadow.render_shadow_cascades(
        scene.positions, scene.tri_indices, scene.tri_valid, cascades, N,
        double_sided=scene.tri_double_sided, proxy=scene.proxy,
        proxy_from_cascade=cfg_b.shadow_proxy_from_cascade, corners=scene.tri_corner_pos,
    )
    for label, cfg, frames in (("A", cfg_a, views[:1]), ("B", cfg_b, views[:1])):
        jcfg = _jax_config(cfg)
        jt = jax_temporal_state_for(jcfg)
        tt = temporal_from_numpy(jax_temporal_leaves(jt), "cpu")
        pairs = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_shadow, "render_shadow_cascades", lambda *a, **k: j(maps))
            mp.setattr(frame_mod.shadow_ops, "render_shadow_cascades", lambda *a, **k: maps)
            jr, tr = jax_make_renderer(jcfg), make_renderer(cfg)
            for v in frames:
                jo, jt = jr(jscene, v, jax_config.RenderParams.default(), jt)
                to, tt = tr(scene, v, RenderParams.default(), tt)
                pairs.append((jo, to))
        out[label] = dict(pairs=pairs, jax_temporal=jt, port_temporal=tt)
    return out


def test_frame_a_matches_jax(stub_frames):
    """Frame A: the stub depth within 2.4e-7 (an ulp of sin), the ids equal,
    the analytic gbuffer within 5e-6 of values up to 12 (measured 2.9e-6: sin,
    cos and sqrt of two libraries); the HDR within 1e-4 relative (measured
    1.4e-6); the u8 image within one step everywhere (measured equal) and SSIM
    >= 0.999."""
    for jo, to in stub_frames["A"]["pairs"]:
        np.testing.assert_allclose(to.depth.numpy(), np.asarray(jo.depth), rtol=0, atol=2.4e-7)
        assert np.array_equal(to.visibility.numpy(), np.asarray(jo.visibility))
        for f in to.gbuffer._fields:
            g_, w_ = getattr(to.gbuffer, f).numpy(), np.asarray(getattr(jo.gbuffer, f))
            np.testing.assert_allclose(g_, w_, rtol=0, atol=5e-6, err_msg=f)
        h, hj = to.hdr.numpy(), np.asarray(jo.hdr)
        assert h.shape == hj.shape == (N, N, 3) and np.abs(hj).max() > 0.01
        assert (np.abs(h - hj) <= 1e-4 * np.abs(hj) + 1e-6).all()
        img, ref = to.image.numpy(), np.asarray(jo.image)
        assert np.abs(img.astype(int) - ref.astype(int)).max() <= 1
        assert ssim(img, ref) >= 0.999


def test_frame_a_state(stub_frames):
    """What frame A hands on: the LPV volumes were built (from the stub RSMs;
    the apply skipped) on both sides, with equal cascade origins and cells, and
    the visibility list untouched by the stubbed raster."""
    jt, tt = stub_frames["A"]["jax_temporal"], stub_frames["A"]["port_temporal"]
    assert np.array_equal(tt.lpv.mins.numpy(), np.asarray(jt.lpv.mins))
    assert np.array_equal(tt.lpv.cell_sizes.numpy(), np.asarray(jt.lpv.cell_sizes))
    for vol in (tt.lpv.gv, tt.lpv.radiance):
        assert float(vol.abs().max()) > 0
    assert (np.abs(np.asarray(jt.lpv.gv)) > 0).mean() > 0
    assert np.array_equal(tt.prev_visible_prims.numpy(), np.asarray(jt.prev_visible_prims))
    assert tt.frame_index == int(jt.frame_index) == 1


def test_frame_b_matches_jax(stub_frames):
    """Frame B: the gather-only planes sum per-triangle coefficients of whatever
    triangle an id names, sub-pixel and culled ones included, whose setups
    XLA's jit rounds differently (it contracts products into FMAs): base
    colour within 5% relative (measured 1.4% here, 3.7% on the parity frame),
    positions within 10% (measured 0.8%, 4.7%), the constant fields equal. The
    HDR (up to ~1e6: the planes' sums are not colours) within 5% relative
    (measured 1.6%); the u8 image within one step on >= 99.5% of pixels
    (measured all) and SSIM >= 0.99."""
    (jo, to), = stub_frames["B"]["pairs"]
    np.testing.assert_allclose(to.depth.numpy(), np.asarray(jo.depth), rtol=0, atol=2.4e-7)
    g, jg = to.gbuffer, jo.gbuffer
    for f in ("roughness", "metalness", "emission", "valid"):
        assert np.array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f))), f
    for f, tol in (("base_color", 0.05), ("world_position", 0.1)):
        w_ = np.asarray(getattr(jg, f))
        rel = np.abs(getattr(g, f).numpy() - w_) / (np.abs(w_) + 1e-3)
        assert rel.max() <= tol, (f, rel.max())
    h, hj = to.hdr.numpy(), np.asarray(jo.hdr)
    assert (np.abs(h - hj) <= 0.05 * np.abs(hj) + 1e-6).all()
    img, ref = to.image.numpy(), np.asarray(jo.image)
    assert img.shape == ref.shape == (N, N, 3)
    off = (np.abs(img.astype(int) - ref.astype(int)).max(axis=-1) > 1).mean()
    assert off <= 0.005, f"{off:.4%} of pixels off by > 1 step"
    assert ssim(img, ref) >= 0.99
    assert np.isfinite(to.hdr.numpy()).all()


# ---------------------------------------------------------------- raster calls

# Raster calls per frame with every switch off: raster-only = the main view and
# 2 cascades (shadow_update_budget=1); parity adds the one RSM its staggered
# LPV update rebuilds.
BASE_CALLS = {"raster-only": 3, "parity": 4}
CASES = [("raster-only", None), ("parity", None)] + [
    ("raster-only", s) for s in SWITCHES[:4]] + [("parity", s) for s in SWITCHES]


def expected_calls(frame: str, switch) -> int:
    """The count chip_smoke.py gates: the main-view raster stub removes one,
    and so does the RSM stub on the parity frame; every other switch none."""
    fewer = switch == "debug_stub_raster" or (frame == "parity" and switch == "debug_stub_rsm")
    return BASE_CALLS[frame] - fewer


@pytest.mark.parametrize("frame,switch", CASES)
def test_raster_calls_per_frame(courtyard, monkeypatch, frame, switch):
    """A 128x64 frame on the CPU path, every raster call counted where each
    entry point of the raster family ends (raster.raster_records) and answered
    with an empty target."""
    calls = []

    def counted(records, height, width, depth_only, *args, **kwargs):
        # Counted, and answered with an empty target: the count needs no raster.
        calls.append((height, width))
        depth = torch.zeros((height, width), dtype=torch.float32)
        return depth if depth_only else (depth, torch.full_like(depth, -1, dtype=torch.int32))

    monkeypatch.setattr(raster_mod, "raster_records", counted)
    flags = dict({switch: True} if switch else {}, shadow_cascade_resolution=64)
    if frame == "parity":
        cfg = parity_frame_config(128, 64, 128, 64, **LPV, **flags)
    else:
        cfg = raster_only_config(128, 64, **flags)
    out, _ = make_renderer(cfg)(courtyard[1], _views()[0], RenderParams.default(),
                                temporal_state_for(cfg, device="cpu"))
    assert np.isfinite(out.hdr.numpy()).all()
    assert len(calls) == expected_calls(frame, switch), calls


def test_band_frame_takes_the_stubs(courtyard, monkeypatch):
    """A band (rows 32-63 of a 128x64 frame, no process group) takes the stubs
    as the JAX frame does whatever its band mode: the stub raster over the
    band's own rows (its ids and depth are those of a 32-row frame) and the
    resolve stub over them; the one raster left is the cascades'."""
    calls = []

    def counted(records, height, width, depth_only, *args, **kwargs):
        calls.append(depth_only)
        depth = torch.zeros((height, width), dtype=torch.float32)
        return depth if depth_only else (depth, torch.full_like(depth, -1, dtype=torch.int32))

    monkeypatch.setattr(raster_mod, "raster_records", counted)
    cfg = raster_only_config(128, 64, shadow_cascade_resolution=64, debug_stub_raster=True,
                             debug_stub_resolve=True)
    scene = courtyard[1]
    out, _ = frame_mod.render_frame(scene, _views()[0], RenderParams.default(),
                                    temporal_state_for(cfg, device="cpu"), cfg,
                                    band_height=32, row_offset=32)
    depth, vis = frame_mod._stub_raster(32, 128, scene.tri_indices.shape[0], "cpu")
    assert torch.equal(out.depth, depth) and torch.equal(out.visibility, vis)
    want = frame_mod._stub_gbuffer(vis, depth)
    assert all(torch.equal(getattr(out.gbuffer, f), getattr(want, f)) for f in want._fields)
    assert calls and all(calls)  # depth-only cascade rasters, no main view
