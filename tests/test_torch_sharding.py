"""Band rendering and band sharding in the port against the JAX package's.

- The band raster: ``rasterize_reference(row_offset=)`` equals the same rows of
  the full raster bit for bit (2 and 4 bands, with and without the alpha grid,
  depth only, under a z limit), as does ``rasterize_spans`` (the plain mirror of
  the kernel's band walk), and the JAX XLA band raster within the raster
  contract (tests/test_raster_bitmask.py:33-36) while the bins stay under their
  cap.
- The pointwise band arguments at two row offsets: each band equals those rows
  of the port's full-frame call bit for bit, and the JAX function's band call
  within the tolerance its single-device test uses.
- The collectives on 2 and 4 gloo ranks, bit-equal to the JAX collectives under
  ``jax.shard_map`` on conftest's virtual CPU devices.
- The sharded frame: on 2 ranks equal to the port's single-device frame bit for
  bit (the dry run's feature set, TAAU alone, RT shadows + RTAO with TAA; the
  invariant tests/test_sharding.py holds for JAX), and to JAX's
  ``make_sharded_renderer`` on 2 devices within a stated tolerance. The RTGI
  frame differs from the single-device one near band edges, as JAX's does.
- The sharded cascades (plain and staggered) and the sharded probe update
  assemble exactly; a bad split raises JAX's ValueErrors; the legacy band path
  (no group) renders its rows.

Every rank scenario runs in one launch of 4 gloo ranks
(tests/torch_sharding_ranks.py), which rank 0 reports.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from androidrenderer_tpu import config as jax_config
from androidrenderer_tpu.camera import Camera as JaxCamera
from androidrenderer_tpu.ops import culling as jax_culling
from androidrenderer_tpu.ops import denoise as jax_denoise
from androidrenderer_tpu.ops import gbuffer as jax_gbuffer
from androidrenderer_tpu.ops import lighting as jax_lighting
from androidrenderer_tpu.ops import noise as jax_noise
from androidrenderer_tpu.ops import sky as jax_sky
from androidrenderer_tpu.ops import taa as jax_taa
from androidrenderer_tpu.ops import upsample as jax_upsample
from androidrenderer_tpu.ops.raster import binning as jax_binning
from androidrenderer_tpu.ops.raster import raster_xla as jax_xla
from androidrenderer_tpu.ops.raster import setup as jax_setup
from androidrenderer_tpu.parallel import collectives as jax_coll
from androidrenderer_tpu.parallel.mesh import make_sharded_renderer as jax_sharded_renderer
from androidrenderer_tpu.parallel.mesh import shard_temporal as jax_shard_temporal
from androidrenderer_tpu.render import initial_temporal_state as jax_initial_temporal_state
from androidrenderer_tpu.scene import procedural as jax_procedural
from androidrenderer_tpu.utils.image import ssim
from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.config import RenderParams, default_frame_config
from androidrenderer_tpu_torch.ops import culling, denoise, lighting, noise, sky, taa, upsample
from androidrenderer_tpu_torch.ops.gbuffer import GBuffer, resolve_gbuffer
from androidrenderer_tpu_torch.ops.raster import rasterize_reference
from androidrenderer_tpu_torch.ops.raster.raster import rasterize_spans
from androidrenderer_tpu_torch.ops.raster.masked import rasterize_masked_peeled
from androidrenderer_tpu_torch.parallel.dryrun import dryrun_config, dryrun_view
from androidrenderer_tpu_torch.parallel.mesh import check_split, run_ranks
from androidrenderer_tpu_torch.render import make_renderer, render_frame, temporal_state_for
from androidrenderer_tpu_torch.render.frame import main_view_setup
from androidrenderer_tpu_torch.scene import procedural as torch_procedural
from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

import torch_sharding_ranks as ranks_mod
from test_torch_frame import to_jax_config
from test_torch_parity import hdr_image, smooth_gbuffer
from test_torch_raster_xla import _assert_raster_contract
from test_torch_scene import jax_leaves

torch.set_num_threads(1)

H, W = 32, 48  # the pointwise ops' frame
BAND = 16
OFFSETS = (8, 16)  # rows [8, 24) and [16, 32) of the frame


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(ours, theirs, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank scenario, run once on 4 gloo ranks of the CPU."""
    store = tmp_path_factory.mktemp("ranks") / "store"
    return run_ranks(4, ranks_mod.scenarios, device="cpu", backend="gloo", init_file=str(store))


# ------------------------------------------------------------------ band raster

def _view(w, h):
    cam = Camera(fov_degrees=75.0, aspect=w / h, render_resolution=(w, h))
    cam.set_position([0.05, 0.03, 2.2])
    cam.yaw = np.pi + 0.02
    return cam.view_data()


@pytest.mark.parametrize("scene_name", ["cornell_scene", "alpha_test_scene"])
def test_band_raster_equals_full_rows_and_jax(scene_name):
    jscene, _ = getattr(jax_procedural, scene_name)().build(with_bvh=False)
    scene = scene_arrays_from_numpy(jax_leaves(jscene), "cpu")
    w, h = 128, 64
    cfg = default_frame_config(w, h)
    _, opaque, _ = main_view_setup(scene, _view(w, h), cfg)
    grid = scene.tri_alpha_grid
    full = rasterize_reference(opaque, h, w)
    zl = torch.where(full[0] > 0, full[0] * 0.999, torch.full_like(full[0], float("inf")))
    cases = [dict(), dict(alpha_grid=grid), dict(depth_only=True), dict(z_limit=zl)]
    for kw in cases:
        want = rasterize_reference(opaque, h, w, **kw)
        want = want if isinstance(want, tuple) else (want,)
        for n in (2, 4):
            b = h // n
            for i in range(n):
                rows = slice(i * b, (i + 1) * b)
                kwb = dict(kw, z_limit=zl[rows].contiguous()) if "z_limit" in kw else kw
                got = rasterize_reference(opaque, b, w, row_offset=i * b, **kwb)
                got = got if isinstance(got, tuple) else (got,)
                for g, f in zip(got, want):
                    assert torch.equal(g, f[rows]), (kw.keys(), n, i)
                # The plain mirror of the kernel's band walk (its clipped units and spans).
                spans = rasterize_spans(opaque, b, w, row_offset=i * b, **kwb)
                spans = spans if isinstance(spans, tuple) else (spans,)
                assert all(torch.equal(s, g) for s, g in zip(spans, got)), (kw.keys(), n, i)
    assert int((full[1] >= 0).sum()) > 1000
    # The JAX XLA band raster (binned, at tile_row_offset) on the same setup.
    js = jax_setup.TriangleSetup(*(jnp.asarray(x.numpy()) for x in opaque))
    th, tw, cap = 16, 128, 1024
    for i in range(2):
        b = h // 2
        bins = jax_binning.bin_triangles(js, b // th, w // tw, th, tw, cap=cap,
                                         tile_row_offset=i * b // th)
        assert int(np.asarray(bins.counts).max()) <= cap
        d_ref = jax_xla.rasterize_depth(js, bins, b, w, th, tw, row_offset=i * b)
        v_ref = jax_xla.rasterize_visibility(js, bins, d_ref, th, tw, row_offset=i * b)
        d, v = rasterize_reference(opaque, b, w, row_offset=i * b)
        _assert_raster_contract(d.numpy(), v.numpy(), np.asarray(d_ref), np.asarray(v_ref))


# ----------------------------------------------------------- pointwise band ops

@pytest.mark.parametrize("r0", OFFSETS)
def test_band_ops_equal_full_rows_and_match_jax(r0):
    """SSAO (11 halo rows, edge semantics), the upsample (one halo row), TAA
    and the RTGI accumulation (full history, one halo row), the sky rays and
    background, and the blue noise, on rows [r0, r0 + 16) of a 32 x 48 frame."""
    rng = np.random.default_rng(40 + r0)
    rows = slice(r0, r0 + BAND)
    g = smooth_gbuffer(rng, H, W)

    def edge_rows(a, halo, lo=r0, n=BAND):
        idx = np.clip(np.arange(lo - halo, lo + n + halo), 0, a.shape[0] - 1)
        return a[idx]

    # SSAO: the band with 11 edge-halo rows, masked by frame rows.
    cam = np.array([0.6, 1.5, 0.5], np.float32)
    g.update(base_color=np.ones((H, W, 3), np.float32), emission=np.zeros((H, W, 3), np.float32),
             roughness=np.ones((H, W, 1), np.float32), metalness=np.zeros((H, W, 1), np.float32))
    gb = GBuffer(**{k: t(v) for k, v in g.items()})
    full = lighting.ssao(gb, t(cam), 0.05).numpy()
    halo = 11
    gh = {k: edge_rows(v, halo) for k, v in g.items()}
    got = lighting.ssao(GBuffer(**{k: t(v) for k, v in gh.items()}), t(cam), 0.05,
                        row0=r0 - halo, full_height=H).numpy()[halo:-halo]
    assert np.array_equal(got, full[rows])
    want = np.asarray(jax.jit(lambda gg, c: jax_lighting.ssao(
        gg, c, 0.05, row0=r0 - halo, full_height=H))(
        jax_gbuffer.GBuffer(**{k: jnp.asarray(v) for k, v in gh.items()}), jnp.asarray(cam)))
    close(got, want[halo:-halo], rtol=0, atol=1e-6, msg="ssao")

    # The joint bilateral upsample of a half-grid band with one halo row.
    sig = rng.uniform(0, 5, (H // 2, W // 2, 3)).astype(np.float32)
    dh, nh = g["depth"][::2, ::2], g["normal"][::2, ::2]
    full = upsample.bilateral_upsample_2x(t(sig), t(dh), t(nh), t(g["depth"]),
                                          t(g["normal"])).numpy()
    hb = [edge_rows(a, 1, r0 // 2, BAND // 2) for a in (sig, dh, nh)]
    args = hb + [g["depth"][rows], g["normal"][rows]]
    got = upsample.bilateral_upsample_2x(*map(t, args), row_halo=1).numpy()
    assert np.array_equal(got, full[rows])
    want = np.asarray(jax.jit(lambda *a: jax_upsample.bilateral_upsample_2x(*a, row_halo=1))(
        *map(jnp.asarray, args)))
    close(got, want, rtol=1e-6, atol=1e-6, msg="upsample")

    # TAA and the RTGI accumulation: the full history, the band's current rows
    # and one edge-halo row of them.
    cur = hdr_image(rng, H, W) * 1e-3
    hist = hdr_image(rng, H, W) * 1e-3
    mv = rng.normal(0, 0.02, (H, W, 2)).astype(np.float32)
    valid = np.array(True)
    # The JAX functions run op by op, as tests/test_torch_parity.py runs the TAA
    # (jitted, XLA contracts the bilinear fetch's multiply-adds into FMAs).
    for name, fj, ft, tol, kw in (
        ("taa", jax_taa.taa_resolve, taa.taa_resolve, (1e-6, 0), "current_halo"),
        ("accumulate", jax_denoise.temporal_accumulate, denoise.temporal_accumulate,
         (1e-5, 1e-6), "signal_halo"),
    ):
        full, _ = ft(t(cur), t(hist), t(valid), t(mv))
        ch = edge_rows(cur, 1)
        got, _ = ft(t(cur[rows]), t(hist), t(valid), t(mv[rows]), row_offset=r0,
                    **{kw: t(ch)})
        assert np.array_equal(got.numpy(), full.numpy()[rows]), name
        want, _ = fj(*map(jnp.asarray, (cur[rows], hist, valid, mv[rows])), row_offset=r0,
                     **{kw: jnp.asarray(ch)})
        close(got, want, *tol, msg=name)

    # Sky rays and background.
    view = _view(W, H)
    inv, p00, p11 = view.inverse_view, float(view.projection[0, 0]), float(view.projection[1, 1])
    sun, col = np.array([0.3, -0.8, 0.2], np.float32), np.ones(3, np.float32)
    full = sky.sky_background(t(inv), p00, p11, t(sun), t(col), H, W).numpy()
    got = sky.sky_background(t(inv), p00, p11, t(sun), t(col), BAND, W, row_offset=r0,
                             full_height=H).numpy()
    assert np.array_equal(got, full[rows])
    want = jax_sky.sky_background(jnp.asarray(inv), p00, p11, jnp.asarray(sun),
                                  jnp.asarray(col), BAND, W, row_offset=r0, full_height=H)
    close(got, want, rtol=2e-3, atol=1e-6, msg="sky")  # tests/test_torch_stages.py's bound

    # Blue noise of the band's rows, bit-equal to JAX.
    got = noise.stbn_uniforms(BAND, W, 5, 2, "cpu", row_offset=r0).numpy()
    assert np.array_equal(got, noise.stbn_uniforms(H, W, 5, 2, "cpu").numpy()[rows])
    assert np.array_equal(got, np.asarray(jax_noise.stbn_uniforms(BAND, W, 5, 2,
                                                                 row_offset=r0)))


@pytest.mark.parametrize("r0", (32, 64))
def test_band_resolve_culling_and_peel(r0):
    """On the alpha fixture's 128 x 128 frame, rows [r0, r0 + 64): the gbuffer
    resolve (rtol 1e-5, atol 1e-6 against JAX, as tests/test_torch_stages.py),
    the exact alpha peel (the full peel's rows), and the band occlusion test:
    with an empty pyramid it keeps exactly the spheres JAX's band test keeps
    (the ones whose AABB meets the band), and with the band's own depth it culls
    no sphere that has a pixel in the band."""
    jscene, _ = jax_procedural.alpha_test_scene().build(with_bvh=False)
    scene = scene_arrays_from_numpy(jax_leaves(jscene), "cpu")
    n, b = 128, 64
    rows = slice(r0, r0 + b)
    view = _view(n, n)
    cfg = default_frame_config(n, n, alpha_bitmap=False)
    setup, opaque, _ = main_view_setup(scene, view, cfg)
    depth, vis = rasterize_reference(opaque, n, n)
    masked = setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 1))
    pd, pv = rasterize_masked_peeled(scene, masked, depth, vis, layers=2)
    bd, bv = rasterize_masked_peeled(scene, masked, depth[rows], vis[rows], layers=2,
                                     row_offset=r0)
    assert torch.equal(bd, pd[rows]) and torch.equal(bv, pv[rows])
    assert (pv != vis).any()

    js = jax_setup.TriangleSetup(*(jnp.asarray(x.numpy()) for x in setup))
    full = resolve_gbuffer(scene, setup, pv, pd)
    got = resolve_gbuffer(scene, setup, bv, bd, row_offset=r0)
    want = jax_gbuffer.resolve_gbuffer(jscene, js, jnp.asarray(bv.numpy()),
                                       jnp.asarray(bd.numpy()), row_offset=r0)
    for name in GBuffer._fields:
        ours = getattr(got, name).numpy()
        assert np.array_equal(ours, getattr(full, name).numpy()[rows]), name
        if name == "valid":
            assert np.array_equal(ours, np.asarray(getattr(want, name)))
        else:
            close(ours, getattr(want, name), rtol=1e-5, atol=1e-6, msg=name)

    vm = torch.from_numpy(view.view)
    p00, p11, zn = float(view.projection[0, 0]), float(view.projection[1, 1]), float(view.z_near)
    bounds = scene.prim_bounds[scene.prim_valid]
    args = (vm, zn, p00, p11)
    empty = culling.build_hiz_pyramid(torch.zeros(b, n), 4)
    kw = dict(row_offset=r0, full_height=n)
    ours = culling.occlusion_cull_spheres(bounds, *args, empty, **kw).numpy()
    theirs = np.asarray(jax_culling.occlusion_cull_spheres(
        jnp.asarray(bounds.numpy()), jnp.asarray(view.view), zn, p00, p11,
        [jnp.asarray(x.numpy()) for x in empty], **kw))
    assert np.array_equal(ours, theirs)
    assert 0 < ours.sum() < ours.size or ours.all()
    keep = culling.occlusion_cull_spheres(bounds, *args, culling.build_hiz_pyramid(
        depth[rows], 4), **kw)
    prim = scene.tri_primitive[vis[rows][vis[rows] >= 0].long()].long()
    shown = torch.zeros(scene.prim_valid.shape[0], dtype=torch.bool)
    shown[prim] = True
    assert not (~keep & shown[scene.prim_valid]).any()


# ------------------------------------------------------------------ collectives

@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_jax(ranks, n):
    per_rank = ranks[f"coll{n}"]
    full, masks = ranks_mod.collective_inputs(n)
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))

    def sharded(fn, x):
        out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                                    check_vma=False))(jnp.asarray(x))
        return np.split(np.asarray(out), n)

    for halo in ranks_mod.HALOS:
        for wrap in (True, False):
            want = sharded(lambda x: jax_coll.row_halo(x, halo, "x", wrap), full)
            key = f"halo{halo}_{'wrap' if wrap else 'edge'}"
            for r in range(n):
                assert np.array_equal(per_rank[r][key].view(np.int32), want[r].view(np.int32)), \
                    (key, r)
    want = sharded(lambda x: jax_coll.gather_rows(x, "x"), full)
    want_any = sharded(lambda m: jax_coll.any_across(m, "x"), masks)
    for r in range(n):
        assert np.array_equal(per_rank[r]["gather"].view(np.int32), want[r].view(np.int32))
        assert np.array_equal(per_rank[r]["any"], want_any[r][0])
    assert np.signbit(per_rank[0]["gather"][3, 1, 0])  # -0.0 travels as itself


# ------------------------------------------------------------- the sharded frame

def _single_images(config, frames=2):
    scene, _ = torch_procedural.cornell_scene().build(device="cpu")
    from androidrenderer_tpu_torch.render import initial_temporal_state

    temporal = initial_temporal_state(config.render_height, config.render_width,
                                      out_height=config.output_height,
                                      out_width=config.output_width, device="cpu")
    render, out = make_renderer(config), []
    for _ in range(frames):
        o, temporal = render(scene, dryrun_view(config), RenderParams.default(), temporal)
        out.append(o.image.numpy())
    return out


def test_sharded_frames_equal_single_device(ranks):
    """The dry run's frame (LPV, SSAO, TAAU, bloom, occlusion culling, 2
    divided cascades, the exact peel), TAAU alone with the jitter, and RT
    shadows + RTAO with TAA: 2 frames each on 2 ranks, bit-equal to one device
    in image, HDR, depth and visibility."""
    for got, want in zip(ranks["dryrun"], _single_images(dryrun_config(2))):
        assert got.shape == want.shape == (24, 192, 3)
        assert np.array_equal(got, want)
    for name, cfg in (("dryrun_jittered", dryrun_config(2)), ("taau", ranks_mod.taau_config()),
                      ("rt", ranks_mod.rt_config())):
        single = ranks_mod.jittered_frames(None, "cpu", cfg)
        for i, (got, want) in enumerate(zip(ranks[name], single)):
            for k, (a, b) in enumerate(zip(got, want)):
                assert a.shape == b.shape and np.array_equal(a, b), (name, i, k)
        assert ranks[name][0][0].shape == (cfg.output_height, cfg.output_width, 3)


def test_sharded_rtgi_is_band_local_as_in_jax(ranks):
    """The RTGI a-trous filter rolls within each band (the JAX frame runs it per
    band, with no halo), so the 2-band frame differs from the single-device
    frame within the filter's reach of the band edges (14 rows, one more for
    the TAA clamp and one for the reprojected history) and nowhere else; depth
    and visibility are equal. Measured: 860 and 1006 of 8192 image pixels
    (1225 and 1616 HDR pixels) differ in frames 1 and 2."""
    from androidrenderer_tpu_torch.config import GIMode

    single = ranks_mod.jittered_frames(None, "cpu", ranks_mod.rt_config(GIMode.RT))
    far = np.r_[15:17, 47:49]  # rows more than 14 + 2 from every band edge (0, 32, 64)
    for got, want in zip(ranks["rtgi"], single):
        diff = (got[1] != want[1]).any(-1)
        assert diff.any()
        assert not diff[far].any()
        assert np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3])


def test_sharded_frame_matches_jax(ranks):
    """The dry run's config, 2 jittered frames from off the box's symmetry axis
    (on it, the wall junctions pass through pixel centres, where either wall
    wins by an ulp), on 2 ranks against JAX's make_sharded_renderer on 2
    virtual devices (its XLA raster branch, pallas_interpret=False; one
    compile). Held as tests/test_torch_parity.py holds the parity frame: within
    one u8 step on >= 99.5% of pixels (measured 99.52% and 99.59%), SSIM >=
    0.99 (measured 0.9987), visibility equal (measured equal), depth within
    1e-5 (measured 7.6e-6)."""
    from androidrenderer_tpu.camera import taa_jitter as jax_taa_jitter

    cfg = dryrun_config(2)
    jcfg = to_jax_config(cfg).replace(pallas_interpret=False)
    jscene, _ = jax_procedural.cornell_scene().build()
    mesh = Mesh(np.array(jax.devices()[:2]), ("screen",))
    temporal = jax_shard_temporal(jax_initial_temporal_state(
        cfg.render_height, cfg.render_width, out_height=cfg.output_height,
        out_width=cfg.output_width), mesh)
    cam = JaxCamera(fov_degrees=cfg.fov_degrees, aspect=cfg.render_width / cfg.render_height,
                    z_near=cfg.z_near, render_resolution=(cfg.render_width, cfg.render_height))
    cam.set_position([0.05, 0.03, 2.2])
    cam.yaw = np.pi + 0.02
    renderer = jax_sharded_renderer(jcfg, mesh)
    for i, (img, _, depth, vis) in enumerate(ranks["dryrun_jittered"]):
        cam.set_jitter(jax_taa_jitter(i))
        out, temporal = renderer(jscene, cam.view_data(), jax_config.RenderParams.default(),
                                 temporal)
        cam.end_frame()
        ref = np.asarray(out.image)
        assert ref.shape == img.shape == (24, 192, 3)
        assert (np.abs(img.astype(int) - ref.astype(int)).max(-1) > 1).mean() <= 0.005
        assert ssim(img, ref) >= 0.99
        assert np.array_equal(vis, np.asarray(out.visibility))
        np.testing.assert_allclose(depth, np.asarray(out.depth), rtol=0, atol=1e-5)


def test_sharded_cascades_and_probes_combine_exactly(ranks):
    c = ranks["cascades"]
    assert np.array_equal(c["sharded"], c["replicated"]) and (c["replicated"] > 0).any()
    for a, b in zip(c["stagger_sharded"], c["stagger"]):
        assert np.array_equal(a, b)
    two, one = ranks["probes"]
    for a, b in zip(two, one):
        assert np.array_equal(a, b)
    assert np.abs(one[0]).max() > 0


def test_bad_band_split_raises():
    cfg = dryrun_config(2)
    assert check_split(cfg, 2) == 8
    with pytest.raises(ValueError, match="bands"):
        check_split(cfg.replace(render_height=24, output_height=36), 2)  # 3 tiles / 2 bands
    with pytest.raises(ValueError, match="bands"):
        check_split(cfg.replace(output_height=25), 2)


def test_legacy_band_path_renders_its_rows():
    """A band with no group: raster and shade only (the JAX frame's
    full_features=False path), its depth and visibility the rows of the
    single-device frame, its image at render resolution."""
    cfg = dryrun_config(2)
    scene, _ = torch_procedural.cornell_scene().build(device="cpu")
    view = dryrun_view(cfg)
    temporal = temporal_state_for(cfg, device="cpu")
    whole, _ = render_frame(scene, view, RenderParams.default(), temporal,
                            cfg.replace(occlusion_culling=False))
    out, nxt = render_frame(scene, view, RenderParams.default(), temporal, cfg,
                            band_height=8, row_offset=8)
    assert tuple(out.image.shape) == (8, cfg.render_width, 3)
    assert torch.equal(out.depth, whole.depth[8:16])
    assert torch.equal(out.visibility, whole.visibility[8:16])
    assert out.motion is None and nxt.frame_index == 1


def test_a_failing_rank_fails_the_launch(tmp_path):
    """run_ranks raises with the failing rank's traceback, without waiting for
    the collective the other rank is blocked in."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(2, ranks_mod.failing_rank, device="cpu", backend="gloo",
                  init_file=str(tmp_path / "store"))
