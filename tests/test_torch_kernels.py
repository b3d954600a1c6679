"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_kernels.py -m cuda

(``--noconftest``: tests/conftest.py configures JAX, which that machine lacks.)
The rasterizer is held bit-equal to ``rasterize_reference`` in every variant,
through every entry point of the raster family (the design studies' included),
and through the exact-alpha peel's z_limit layers on the bench scene at
1920x1088; the gather-sum kernel is held to its plain version within rtol 2e-5;
the ported raster microbench runs in each mode. The span-walk's adversarial
records (tests/test_torch_raster_spans.py) hold the kernel bit-equal to the
plain version, and its work counts equal to the plain mirror's. The traversal
kernel (csrc/traverse.cu) is held bit-equal to ``trace_rays_reference`` on
random triangles (any-hit and closest-hit), with per-ray bounds, an active
mask, a step cap that stops rays, the alpha fixture's bitmaps and its work
counts, and the masked any-hit rule of the exact alpha peel; the persistent
warps, with each refill policy, at active shares of 0-100%, ray counts of 1,
31, 33 and 1000, step caps, the refit BVH's layout and launches back to back,
with the counting instantiation's work counts equal to the plain version's; its wrapper's checks
(a BVH without the kernel layout raises), the exact peel on the card against
the CPU, and the RT, RTGI and probe frames' launches at 128^2 (the RT frame's
traversal kernels all of the instantiation that does not count). The rasterizer is also held bit-equal at VRSAA's
3840x2176 main view, and the VRSAA frame's launches and dropped count are
checked against the CPU frame's at 128^2. The band raster (``row_offset``) is
held bit-equal to the plain version and to the full frame's rows, the refit
(scene/dynamic.py) on the card to the refit on the CPU, and the collectives of
two gloo ranks sharing the card to their exact bits:

    python -m pytest --noconftest -q tests/test_torch_kernels.py -m cuda \
        -k 'traverse or rt_frame or peel or gi_frame'
"""

import numpy as np
import pytest
import torch

from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.ops.raster import (
    rasterize,
    rasterize_reference,
    transform_to_clip,
    triangle_setup,
)
from androidrenderer_tpu_torch.ops.raster.raster_binned import rasterize_binned
from androidrenderer_tpu_torch.ops.raster.raster_fused import rasterize_fused, rasterize_hybrid
from androidrenderer_tpu_torch.ops.raster.raster_pallas import rasterize_pallas
from androidrenderer_tpu_torch.scene.procedural import alpha_test_scene, courtyard_scene

W, H = 256, 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run the command in this module's docstring on one)")
    return torch.device("cuda")


def _random_setup(seed, n_tris, device, double_sided=True, ortho=False):
    """Seeded random triangles in front of a camera looking down -z."""
    rng = np.random.default_rng(seed)
    centers = np.stack([
        rng.uniform(-3, 3, n_tris), rng.uniform(-3, 3, n_tris), -rng.uniform(2, 12, n_tris),
    ], axis=1)
    verts = (centers[:, None, :] + rng.normal(0, 0.8, (n_tris, 3, 3))).reshape(-1, 3)
    tris = np.arange(n_tris * 3, dtype=np.int32).reshape(n_tris, 3)
    if ortho:
        m = np.array([[0.25, 0, 0, 0], [0, 0.25, 0, 0], [0, 0, 1 / 16.0, 1.0], [0, 0, 0, 1]],
                     np.float32)
    else:
        cam = Camera(fov_degrees=75.0, aspect=W / H, render_resolution=(W, H))
        cam.yaw = np.pi
        m = cam.view_data().view_proj
    clip = transform_to_clip(
        torch.from_numpy(verts.astype(np.float32)).to(device), torch.from_numpy(m).to(device)
    )
    dbl = torch.full((n_tris,), double_sided, dtype=torch.bool, device=device)
    return triangle_setup(clip, torch.from_numpy(tris).to(device), W, H, double_sided=dbl)


def _assert_bit_equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("double_sided", [True, False])
def test_raster_kernel_depth_and_vis(cuda_device, double_sided):
    setup = _random_setup(0, 400, cuda_device, double_sided)
    launches = rasterize.launches
    got = rasterize(setup, H, W)
    assert rasterize.launches == launches + 1
    assert (got[1] >= 0).any()
    _assert_bit_equal(got, rasterize_reference(setup, H, W))


@pytest.mark.cuda
def test_raster_kernel_depth_only_affine(cuda_device):
    setup = _random_setup(3, 400, cuda_device, ortho=True)
    kw = dict(depth_only=True, affine_z=True)
    _assert_bit_equal(rasterize(setup, H, W, **kw), rasterize_reference(setup, H, W, **kw))


@pytest.mark.cuda
def test_raster_kernel_z_limit_and_sparse(cuda_device):
    setup = _random_setup(4, 400, cuda_device)
    first, _ = rasterize_reference(setup, H, W)
    noise = torch.from_numpy(np.random.default_rng(4).uniform(0.5, 1.0, (H, W))).to(first)
    zlim = torch.where(first > 0, first * noise, torch.full_like(first, float("inf")))
    _assert_bit_equal(
        rasterize(setup, H, W, z_limit=zlim), rasterize_reference(setup, H, W, z_limit=zlim)
    )
    keep = torch.zeros_like(setup.valid)
    keep[[37, 63, 64, 100, 159]] = True
    sparse = setup._replace(valid=setup.valid & keep)
    _assert_bit_equal(rasterize(sparse, H, W), rasterize_reference(sparse, H, W))


@pytest.mark.cuda
def test_raster_kernel_alpha_grid(cuda_device):
    scene, _ = alpha_test_scene().build(device=cuda_device)
    w, h = 128, 96
    cam = Camera(fov_degrees=75.0, aspect=w / h, render_resolution=(w, h))
    cam.set_position([0.0, 1.0, -3.0])
    clip = transform_to_clip(scene.positions, torch.from_numpy(cam.view_data().view_proj).to(cuda_device))
    setup = triangle_setup(
        clip, scene.tri_indices, w, h,
        double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid,
    )
    grid = scene.tri_alpha_grid
    got = rasterize(setup, h, w, alpha_grid=grid)
    assert 0.02 < (got[1] >= 0).float().mean().item() < 0.98
    _assert_bit_equal(got, rasterize_reference(setup, h, w, alpha_grid=grid))


@pytest.mark.cuda
def test_raster_wrapper_rejects_bad_inputs(cuda_device):
    setup = _random_setup(1, 64, cuda_device)
    with pytest.raises(TypeError):
        rasterize(setup, H, W, z_limit=torch.zeros((H, W), dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        rasterize(setup, H, W, alpha_grid=torch.zeros((3, 8), dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        rasterize(setup, H, W, z_limit=torch.zeros((H, W), device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["binned", "fused", "hybrid", "pallas"])
def test_entry_point_kernel_matches_plain(cuda_device, entry):
    """Each entry point launches the kernel once and matches the plain version."""
    fn = {"binned": rasterize_binned, "fused": rasterize_fused,
          "hybrid": rasterize_hybrid, "pallas": rasterize_pallas}[entry]
    setup = _random_setup(5, 400, cuda_device)
    launches = fn.launches
    got = fn(setup, H, W)
    assert fn.launches == launches + 1
    _assert_bit_equal(got, rasterize_reference(setup, H, W))
    if entry in ("binned", "fused", "hybrid"):
        ortho = _random_setup(6, 400, cuda_device, ortho=True)
        kw = dict(depth_only=True, affine_z=True)
        _assert_bit_equal(fn(ortho, H, W, **kw), rasterize_reference(ortho, H, W, **kw))


@pytest.mark.cuda
def test_exact_alpha_peel_layers_at_bench_size(cuda_device):
    """The peel's z_limit layers on the bench scene's masked foliage at 1920x1088:
    every layer bit-equal to the plain version, and no layer re-admits the
    fragment its bound came from (z < z_limit is strict and exact)."""
    from androidrenderer_tpu_torch.config import default_frame_config
    from androidrenderer_tpu_torch.ops.raster.masked import _sample_alpha, pack_alpha_planes
    from androidrenderer_tpu_torch.render.frame import main_view_setup

    w, h = 1920, 1088
    cfg = default_frame_config(w, h, alpha_bitmap=False)
    scene, _ = courtyard_scene(column_rings=4, detail=13, curtains=True).build(device=cuda_device)
    cam = Camera(fov_degrees=cfg.fov_degrees, aspect=w / h, z_near=cfg.z_near,
                 render_resolution=(w, h))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    setup, _, _ = main_view_setup(scene, cam.view_data(), cfg)
    masked = setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 1))
    planes = pack_alpha_planes(scene, masked)
    zl = prev = prev_fail = None
    for _ in range(cfg.alpha_peel_layers):
        d, v = rasterize_binned(masked, h, w, z_limit=zl)
        _assert_bit_equal((d, v), rasterize_reference(masked, h, w, z_limit=zl))
        if prev is not None:
            # Where the last layer's fragment failed, the bound is its depth.
            assert prev_fail.any()
            assert not (prev_fail & (v == prev)).any()
        alpha, cutoff = _sample_alpha(scene, masked, v, alpha_planes=planes)
        fail = (v >= 0) & ~(alpha >= cutoff)
        zl = torch.where(fail, d, torch.full_like(d, float("inf")) if zl is None else zl)
        prev, prev_fail = v, fail


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", [(1000, 8), (1 << 18, 32), (1 << 18, 48), (4096, 300)])
def test_gather_kernel_matches_plain(cuda_device, rows, width):
    """The gather-sum kernel against its plain version within the tool's rtol
    2e-5 (C up to 300 runs the kernel's column loop), run to run bit-equal."""
    from androidrenderer_tpu_torch.ops.gather import gather_tile_sums, gather_tile_sums_reference
    from androidrenderer_tpu_torch.tools.microbench_pallas_gather import make_inputs

    table, idx = make_inputs(rows, width, cuda_device, lookups=64 * 2048, seed=rows + width)
    launches = gather_tile_sums.launches
    got = gather_tile_sums(table, idx)
    assert gather_tile_sums.launches == launches + 1
    want = gather_tile_sums_reference(table, idx)
    torch.cuda.synchronize()
    assert got.shape == (64, 8, width)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=0.0)
    assert torch.equal(got, gather_tile_sums(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["touch", "lanes", "subfold"])
def test_design_study_entry_points_match_plain(cuda_device, entry):
    """Each design study's entry point launches the kernel once per call and is
    bit-equal to the plain version in every variant it takes."""
    from androidrenderer_tpu_torch.tools.experiments.raster_lanes import rasterize_lanes
    from androidrenderer_tpu_torch.tools.experiments.raster_subfold import rasterize_subfold
    from androidrenderer_tpu_torch.tools.experiments.raster_touch import rasterize_touch

    fn = {"touch": rasterize_touch, "lanes": rasterize_lanes, "subfold": rasterize_subfold}[entry]
    for double_sided in (True, False):
        setup = _random_setup(7, 400, cuda_device, double_sided)
        launches = fn.launches
        got = fn(setup, H, W)
        assert fn.launches == launches + 1
        _assert_bit_equal(got, rasterize_reference(setup, H, W))
        _assert_bit_equal(fn(setup, H, W, depth_only=True),
                          rasterize_reference(setup, H, W, depth_only=True))
    if entry == "touch":
        return
    ortho = _random_setup(8, 400, cuda_device, ortho=True)
    kw = dict(depth_only=True, affine_z=True)
    _assert_bit_equal(fn(ortho, H, W, **kw), rasterize_reference(ortho, H, W, **kw))
    first, _ = rasterize_reference(setup, H, W)
    zlim = torch.where(first > 0, first * 0.75, torch.full_like(first, float("inf")))
    _assert_bit_equal(fn(setup, H, W, z_limit=zlim),
                      rasterize_reference(setup, H, W, z_limit=zlim))
    grid = torch.from_numpy(
        np.random.default_rng(9).integers(-(2**31), 2**31, (setup.valid.shape[0], 8))
        .astype(np.int32)).to(cuda_device)
    _assert_bit_equal(fn(setup, H, W, alpha_grid=grid),
                      rasterize_reference(setup, H, W, alpha_grid=grid))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["screen", "csm", "rsm"])
def test_bench_raster_runs_each_mode(cuda_device, mode):
    """The ported raster microbench on a small scene, chain 2: every name
    launches its entry point once per step (one warm-up and 3 timed chains)."""
    from androidrenderer_tpu_torch.ops.raster.raster_binned import rasterize_binned
    from androidrenderer_tpu_torch.scene.procedural import cornell_scene
    from androidrenderer_tpu_torch.tools import bench_raster
    from androidrenderer_tpu_torch.tools.experiments.raster_subfold import rasterize_subfold

    scene, _ = cornell_scene().build(device=cuda_device)
    fns = (rasterize, rasterize_fused, rasterize_binned, rasterize_subfold)
    before = [f.launches for f in fns]
    times = bench_raster.run(scene, mode, ["bitmask", "fused", "binned8", "subfold"], 2,
                             cuda_device)
    assert set(times) == {"bitmask", "fused(prod)", "binned8", "subfold"}
    assert all(np.isfinite(t) and t > 0 for t in times.values())
    assert [f.launches - b for f, b in zip(fns, before)] == [8, 8, 8, 8]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sliver", "near_zero_a", "huge", "crosser", "one_pixel",
                                  "one_pixel_stack", "planes"])
def test_raster_kernel_adversarial_records(cuda_device, kind):
    """The span walk's hard cases: the kernel bit-equal to the plain version, and
    its work counts (units, pixels evaluated) equal to the plain mirror's."""
    from androidrenderer_tpu_torch.ops.raster import pack_fused_records
    from androidrenderer_tpu_torch.ops.raster.raster import (
        prepare_raster, span_work, work_counts,
    )
    from test_torch_raster_spans import AH, AW, adversarial_setup

    for seed in (0, 1, 2):
        for double_sided in (True, False):
            setup = adversarial_setup(kind, seed, double_sided, device=cuda_device)
            for affine_z in (False, True):
                kw = dict(affine_z=affine_z)
                _assert_bit_equal(rasterize(setup, AH, AW, **kw),
                                  rasterize_reference(setup, AH, AW, **kw))
                rec = pack_fused_records(setup, affine_z=affine_z)
                call = prepare_raster(rec, AH, AW, False, affine_z, None, None)
                call.launch()
                _assert_bit_equal(call.outputs, rasterize_reference(setup, AH, AW, **kw))
                got = work_counts(call.counts)
                want = span_work(rec, AH, AW)
                assert got == want, (seed, double_sided, affine_z, got, want)


@pytest.mark.cuda
def test_raster_kernel_dead_and_empty_record_sets(cuda_device):
    """No live record (all dead, or none at all): the kernel still clears and
    resolves, in every variant."""
    from androidrenderer_tpu_torch.ops.raster import TriangleSetup
    from test_torch_raster_spans import AH, AW, adversarial_setup

    setup = adversarial_setup("planes", 5, True, device=cuda_device)
    dead = setup._replace(valid=torch.zeros_like(setup.valid))
    empty = TriangleSetup(*(x[:0] for x in setup))
    for s in (dead, empty):
        depth, vis = rasterize(s, AH, AW)
        torch.cuda.synchronize()
        assert not depth.any() and (vis == -1).all()
        assert not rasterize(s, AH, AW, depth_only=True, affine_z=True).any()
        zl = torch.full((AH, AW), 0.5, device=cuda_device)
        _assert_bit_equal(rasterize(s, AH, AW, z_limit=zl), rasterize_reference(s, AH, AW))


@pytest.mark.cuda
def test_gather_kernel_scalar_path_and_bad_index(cuda_device):
    """The 4-byte path (C not a multiple of 4, or a table off 16-byte alignment)
    against the plain version, run to run bit-equal; an index outside [0, M)
    makes its own tile NaN and leaves the others right."""
    from androidrenderer_tpu_torch.ops.gather import gather_tile_sums, gather_tile_sums_reference
    from androidrenderer_tpu_torch.tools.microbench_pallas_gather import make_inputs

    for rows, width, offset in ((1 << 18, 7, 0), (5000, 32, 1), (5000, 300, 1)):
        table, idx = make_inputs(rows, width, cuda_device, lookups=16 * 2048, seed=rows + width)
        if offset:  # the same values, 4 bytes off 16-byte alignment
            flat = torch.empty(rows * width + offset, device=cuda_device)
            flat[offset:] = table.reshape(-1)
            table = flat[offset:].view(rows, width)
        got = gather_tile_sums(table, idx)
        torch.testing.assert_close(got, gather_tile_sums_reference(table, idx), rtol=2e-5,
                                   atol=0.0)
        assert torch.equal(got, gather_tile_sums(table, idx))
    bad = idx.clone()
    bad[3 * 2048 + 17] = rows
    got = gather_tile_sums(table, bad)
    torch.cuda.synchronize()
    assert torch.isnan(got[3, 0]).all()
    keep = torch.ones(got.shape[0], dtype=torch.bool, device=cuda_device)
    keep[3] = False
    assert torch.equal(got[keep], gather_tile_sums(table, idx)[keep])
    assert not got[:, 1:].any()


@pytest.mark.cuda
def test_parity_frame_rsm_site_and_launches(cuda_device):
    """The LPV's RSMs on the default courtyard's proxy at 128^2 (each cascade's
    setup derived from the canonical one, as the frame derives it) bit-equal to
    the plain version; the 128^2 -> 192^2 parity frame launches the rasterizer
    4 times per frame (main view, cascade 0, one far cascade, one RSM)."""
    from androidrenderer_tpu_torch.config import RenderParams, parity_frame_config
    from androidrenderer_tpu_torch.ops import lpv
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
    from androidrenderer_tpu_torch.scene.proxy import swap_in_proxy

    cfg = parity_frame_config(192, 192, 128, 128, shadow_cascade_resolution=128)
    scene, _ = courtyard_scene().build(device=cuda_device)
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(128, 128))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    view = cam.view_data()
    gi = swap_in_proxy(scene)
    inv = torch.as_tensor(view.inverse_view, device=cuda_device)
    mins, cells = lpv.cascade_origins(torch.as_tensor(view.position, device=cuda_device),
                                      -inv[:3, 2], 4, 32, 0.25, 0.1)
    m_canon, setup_rsm, centers, radii = lpv._canonical_rsm_setup(gi, mins, cells, 32, 128)
    for k in range(4):
        setup = lpv.rsm_setup(gi, setup_rsm, m_canon, centers[k], radii[k], 128)
        got = rasterize(setup, 128, 128)
        want = rasterize_reference(setup, 128, 128)
        assert (want[1] >= 0).any()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    renderer, temporal = make_renderer(cfg), temporal_state_for(cfg, device=cuda_device)
    rasterize.launches = 0
    for _ in range(3):
        out, temporal = renderer(scene, view, RenderParams.default(), temporal)
    torch.cuda.synchronize()
    assert rasterize.launches == 12
    assert tuple(out.image.shape) == (192, 192, 3) and bool(torch.isfinite(out.hdr).all())


def _traverse_inputs(seed, device, n_tris=2000, n_rays=8192):
    """Seeded random triangles in a 12 m box (the port's bake of their BVH) and
    rays through it: origins inside, unit directions, one ray per case below
    with a zero or subnormal direction component."""
    from androidrenderer_tpu_torch import native
    from androidrenderer_tpu_torch.ops.rt.traverse import BVH_FIELDS, with_kernel_layout
    from androidrenderer_tpu_torch.scene.scene import _device_bvh

    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, (n_tris, 3))
    verts = (centers[:, None, :] + rng.normal(0, 0.4, (n_tris, 3, 3))).reshape(-1, 3)
    verts = verts.astype(np.float32)
    idx = np.arange(n_tris * 3, dtype=np.int32).reshape(n_tris, 3)
    bvh_np, _ = native.build_bvh(verts, idx)
    alpha_mode = np.zeros(n_tris, np.int32)
    grid = np.full((n_tris, 8), -1, np.int32)
    b = _device_bvh(bvh_np, verts, idx, alpha_mode, grid)
    b = with_kernel_layout(b._replace(**{f: getattr(b, f).to(device) for f in BVH_FIELDS}))
    o = rng.uniform(-7, 7, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0, 0], d[1, 1], d[2, 2] = 0.0, 1e-39, -3e-40
    return b, torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def _assert_hits_equal(got, want):
    torch.cuda.synchronize()
    for f in ("slot", "t", "u", "v", "ray_steps", "steps", "overflow"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_traverse_kernel_matches_plain(cuda_device, seed, any_hit):
    """The traversal kernel bit-equal to trace_rays_reference: t, slot, u, v,
    each ray's steps, the longest walk and the overflow flag."""
    from androidrenderer_tpu_torch.ops.rt.traverse import trace_rays, trace_rays_reference

    b, o, d = _traverse_inputs(seed, cuda_device)
    launches = trace_rays.launches
    got = trace_rays(b, o, d, 0.01, 1e30, any_hit=any_hit)
    assert trace_rays.launches == launches + 1
    want = trace_rays_reference(b, o, d, 0.01, 1e30, any_hit=any_hit)
    _assert_hits_equal(got, want)
    hit = got.slot >= 0
    assert bool(hit.any()) and not bool(hit.all()) and not bool(got.overflow)
    assert bool(torch.isfinite(got.t).all() and torch.isfinite(got.u).all())


@pytest.mark.cuda
def test_traverse_kernel_bounds_active_overflow_and_work(cuda_device):
    """Per-ray tmin and tmax, an active mask, a step cap that stops rays, and
    the kernel's work counts equal to the plain version's."""
    from androidrenderer_tpu_torch.ops.rt.traverse import (
        prepare_trace, trace_rays, trace_rays_reference, work_counts,
    )

    b, o, d = _traverse_inputs(3, cuda_device)
    g = torch.Generator(device="cpu").manual_seed(3)
    r = o.shape[0]
    tmin = torch.rand(r, generator=g).mul(4.0).to(cuda_device)
    tmax = (tmin + torch.rand(r, generator=g).mul(8.0).to(cuda_device)).contiguous()
    active = (torch.rand(r, generator=g) < 0.7).to(cuda_device)
    for kw in (dict(), dict(any_hit=True), dict(max_steps=7)):
        got = trace_rays(b, o, d, tmin, tmax, active=active, **kw)
        want = trace_rays_reference(b, o, d, tmin, tmax, active=active, **kw)
        _assert_hits_equal(got, want)
        assert not bool((got.ray_steps[~active] != 0).any())
        assert bool(got.overflow) == ("max_steps" in kw)
    call = prepare_trace(b, o, d, 0.01, 1e30, any_hit=True, counts=True)
    call.launch()
    _, work, touched = trace_rays_reference(b, o, d, 0.01, 1e30, any_hit=True, counts=True)
    torch.cuda.synchronize()
    assert torch.equal(call.work, work) and torch.equal(call.touched.bool(), touched)
    counts = work_counts(call)
    assert counts["steps"] == int(work[:, 0].sum()) and 0 < counts["rows"] <= b.node_rows.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_kernel_alpha_bitmap(cuda_device, any_hit):
    """The alpha fixture's fence through its 16x16 bitmaps: holes and hits,
    bit-equal to the plain version."""
    from androidrenderer_tpu_torch.ops.rt.traverse import (
        prepare_trace, trace_rays, trace_rays_reference,
    )

    scene, _ = alpha_test_scene().build(device=cuda_device)
    gx, gy = np.meshgrid(np.linspace(-1.5, 1.5, 64), np.linspace(0.3, 1.9, 64))
    o = np.stack([gx, gy, np.full_like(gx, -1.0)], -1).reshape(-1, 3).astype(np.float32)
    d = np.broadcast_to(np.array([0.05, 0.02, 1.0], np.float32), o.shape).copy()
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    kw = dict(any_hit=any_hit, alpha_bitmap_test=True)
    got = trace_rays(scene.bvh, o, d, 0.01, 2.0, **kw)
    _assert_hits_equal(got, trace_rays_reference(scene.bvh, o, d, 0.01, 2.0, **kw))
    hit = got.slot >= 0
    assert bool(hit.any()) and not bool(hit.all())
    solid = trace_rays(scene.bvh, o, d, 0.01, 2.0, any_hit=any_hit)
    assert bool((solid.slot >= 0).all())
    # The work counts of the bitmap walk, lookups and lookahead tests included.
    call = prepare_trace(scene.bvh, o, d, 0.01, 2.0, counts=True, **kw)
    call.launch()
    _, work, touched = trace_rays_reference(scene.bvh, o, d, 0.01, 2.0, counts=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(call.work, work) and torch.equal(call.touched.bool(), touched)
    assert int(work[:, 5].sum()) > 0


@pytest.mark.cuda
def test_traverse_wrapper_rejects_bad_inputs(cuda_device):
    from androidrenderer_tpu_torch.ops.rt import traverse

    b, o, d = _traverse_inputs(4, cuda_device, n_tris=64, n_rays=256)
    with pytest.raises(ValueError):
        traverse.trace_rays(b, o, d.cpu(), 0.01, 1e30)
    with pytest.raises(TypeError):
        traverse.trace_rays(b, o.double(), d, 0.01, 1e30)
    with pytest.raises(ValueError):
        traverse.trace_rays(b, o[:, :2].contiguous(), d, 0.01, 1e30)
    with pytest.raises(ValueError):
        traverse.trace_rays(b, o.t().contiguous().t(), d, 0.01, 1e30)
    with pytest.raises(ValueError):
        traverse.trace_rays(b, o, d, torch.zeros(3, device=cuda_device), 1e30)
    with pytest.raises(TypeError):
        traverse.trace_rays(b, o, d, 0.01, 1e30, active=torch.ones(256, device=cuda_device))

    class Failing:
        def load(self):
            return self

        def traverse_launch(self, *args):
            return 700  # cudaErrorIllegalAddress

    call = traverse.prepare_trace(b, o, d, 0.01, 1e30, library=Failing())
    with pytest.raises(RuntimeError, match="700"):
        call.launch()


def _check_trace(b, o, d, tmin, tmax, **kw):
    """trace_rays (the frame's instantiation) and the counting instantiation,
    with each refill policy (coherent: whole batches; scattered: refills of a
    warp's idle lanes), against trace_rays_reference: every output bit-equal,
    the work counts and the rows read equal. Returns the kernel's Hits."""
    from androidrenderer_tpu_torch.ops.rt.traverse import (
        prepare_trace, trace_rays, trace_rays_reference,
    )

    want, work, touched = trace_rays_reference(b, o, d, tmin, tmax, counts=True, **kw)
    for scattered in (False, True):
        got = trace_rays(b, o, d, tmin, tmax, scattered=scattered, **kw)
        call = prepare_trace(b, o, d, tmin, tmax, counts=True, scattered=scattered, **kw)
        call.launch()
        _assert_hits_equal(got, want)
        _assert_hits_equal(call.outputs, want)
        assert torch.equal(call.work, work) and torch.equal(call.touched.bool(), touched)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("share", [0.0, 0.018, 0.27, 1.0])
def test_traverse_kernel_active_shares(cuda_device, share, any_hit):
    """The persistent warps hand out only active rays (the probe, peel and
    hit-sun sites' shares: 1.8%, 27%, and none or all) and write the inactive
    rays' misses: bit-equal to the plain version, work counts included."""
    b, o, d = _traverse_inputs(6, cuda_device)
    rng = np.random.default_rng(int(share * 1000) + 7)
    active = torch.from_numpy(rng.random(o.shape[0]) < share).to(cuda_device)
    got = _check_trace(b, o, d, 0.01, 1e30, any_hit=any_hit, active=active)
    assert not bool((got.slot[~active] >= 0).any()) and not bool((got.ray_steps[~active] != 0).any())
    assert bool((got.t[~active] == 1e30).all())
    if share > 0:
        assert bool((got.slot[active] >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [1, 31, 33, 1000])
def test_traverse_kernel_ray_counts(cuda_device, n_rays):
    """Ray counts that fill no warp, or no whole chunk of 128: bit-equal,
    closest-hit and any-hit, with per-ray bounds."""
    b, o, d = _traverse_inputs(7, cuda_device)
    o, d = o[-n_rays:].contiguous(), d[-n_rays:].contiguous()
    tmax = torch.linspace(2.0, 12.0, n_rays, device=cuda_device)
    for any_hit in (False, True):
        _check_trace(b, o, d, 0.01, tmax, any_hit=any_hit)


@pytest.mark.cuda
@pytest.mark.parametrize("max_steps", [0, 1, 7, 20])
def test_traverse_kernel_step_cap(cuda_device, max_steps):
    """A step cap that stops rays: overflow set, each ray's steps at most the
    cap, bit-equal to the plain version (a cap of 0 walks no step and stops
    every active ray)."""
    b, o, d = _traverse_inputs(8, cuda_device)
    active = (torch.arange(o.shape[0], device=cuda_device) % 3) != 0
    got = _check_trace(b, o, d, 0.01, 1e30, max_steps=max_steps, active=active)
    assert bool(got.overflow) and int(got.steps) == max_steps
    assert int(got.ray_steps.max()) <= max_steps


@pytest.mark.cuda
@pytest.mark.parametrize("bitmap", [False, True])
def test_traverse_kernel_masked_shares(cuda_device, bitmap):
    """The masked any-hit walk (the exact peel's) with the peel site's small
    active share and per-ray tmin, with and without the bitmaps."""
    scene, _ = alpha_test_scene().build(device=cuda_device)
    gx, gy = np.meshgrid(np.linspace(-1.5, 1.5, 80), np.linspace(0.3, 1.9, 80))
    o = np.stack([gx, gy, np.full_like(gx, -1.0)], -1).reshape(-1, 3).astype(np.float32)
    d = np.broadcast_to(np.array([0.05, 0.02, 1.0], np.float32), o.shape).copy()
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    rng = np.random.default_rng(9)
    tmin = torch.from_numpy(rng.uniform(0.0, 1.2, o.shape[0]).astype(np.float32)).to(cuda_device)
    for share in (0.018, 0.27):
        active = torch.from_numpy(rng.random(o.shape[0]) < share).to(cuda_device)
        _check_trace(scene.bvh, o, d, tmin, 3.0, any_hit=True, masked_any_hit=True,
                     alpha_bitmap_test=bitmap, active=active)


@pytest.mark.cuda
def test_traverse_kernel_on_the_refit_bvh(cuda_device):
    """The layout the refit builds (scene/dynamic.py: a column lifted, a
    primitive scaled) on the curtained courtyard, under rays through the
    columns: bit-equal, closest-hit with the bitmaps and any-hit."""
    from androidrenderer_tpu_torch.scene import dynamic

    rs = courtyard_scene(curtains=True)
    scene, _ = rs.build(device=cuda_device)
    dyn = dynamic.make_dynamic_data(rs, scene)
    tr = dynamic.initial_transforms(rs, cuda_device)
    tr[5, 1, 3] += 6.0
    tr[6, :3, :3] = tr[6, :3, :3] * 1.5
    moved = dynamic.update_primitive_transforms(scene, dyn, tr).bvh
    rng = np.random.default_rng(10)
    o = rng.uniform([-12, 0.2, -8], [12, 6, 8], (20000, 3)).astype(np.float32)
    d = rng.normal(size=(20000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    _check_trace(moved, o, d, 0.01, 1e30, alpha_bitmap_test=True)
    got = _check_trace(moved, o, d, 0.01, 1e30, any_hit=True)
    assert bool((got.slot >= 0).any()) and not bool((got.slot >= 0).all())


@pytest.mark.cuda
def test_traverse_kernel_back_to_back(cuda_device):
    """Launches back to back on one stream, no sync between them: each clears
    its own claim counter, so every call walks all its rays (two calls, one of
    each refill policy, then one call launched twice)."""
    from androidrenderer_tpu_torch.ops.rt.traverse import prepare_trace, trace_rays_reference

    b, o, d = _traverse_inputs(11, cuda_device)
    half = o.shape[0] // 2
    calls = [prepare_trace(b, o[:half], d[:half], 0.01, 1e30, scattered=True),
             prepare_trace(b, o[half:], d[half:], 0.01, 1e30, any_hit=True)]
    for c in calls:
        c.launch()
    calls[0].launch()
    _assert_hits_equal(calls[0].outputs, trace_rays_reference(b, o[:half], d[:half], 0.01, 1e30))
    _assert_hits_equal(calls[1].outputs,
                       trace_rays_reference(b, o[half:], d[half:], 0.01, 1e30, any_hit=True))


@pytest.mark.cuda
def test_traverse_kernel_needs_the_layout(cuda_device):
    """A CUDA BVH without the kernel's layout raises; nothing falls back."""
    from androidrenderer_tpu_torch.ops.rt import traverse

    b, o, d = _traverse_inputs(12, cuda_device, n_tris=64, n_rays=256)
    bare = b._replace(**{f: None for f in traverse.LAYOUT_FIELDS})
    launches = traverse.trace_rays.launches
    with pytest.raises(ValueError, match="no kernel layout"):
        traverse.trace_rays(bare, o, d, 0.01, 1e30)
    assert traverse.trace_rays.launches == launches
    occ = [traverse.occupancy(counts=c) for c in (False, True)]
    assert all(x["registers"] > 0 and x["blocks_per_sm"] > 0 and x["sms"] > 0 for x in occ)


@pytest.mark.cuda
def test_rt_frame_launches_the_frame_instantiation(cuda_device):
    """The RT frame at 128^2 under the profiler: every traversal kernel it runs
    is an instantiation that does not count (the last template argument)."""
    from androidrenderer_tpu_torch.config import (
        AOMode, RenderParams, ShadowMode, default_frame_config,
    )
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for

    cfg = default_frame_config(128, 128, shadow_cascade_resolution=128,
                               shadow_mode=ShadowMode.RT, ao_mode=AOMode.RT)
    scene, _ = courtyard_scene(curtains=True).build(device=cuda_device)
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(128, 128))
    cam.set_position([0.0, 1.7, 6.0])
    renderer, temporal = make_renderer(cfg), temporal_state_for(cfg, device=cuda_device)
    renderer(scene, cam.view_data(), RenderParams.default(), temporal)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        renderer(scene, cam.view_data(), RenderParams.default(), temporal)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "traverse_kernel" in e.key]
    assert names and all(n.replace(" ", "").split("traverse_kernel<")[1].split(">")[0]
                         .endswith("false") for n in names), names


@pytest.mark.cuda
def test_rt_frame_traces_through_the_kernel(cuda_device):
    """Frame A with RT shadows and RTAO at 128^2: 5 traversal launches and 4
    raster launches per frame (two occlusion phases, two translucent layers; RT
    shadows replace the cascades), and the frame equals the same frame on the
    CPU (the plain versions) to within one u8 step."""
    from androidrenderer_tpu_torch.config import (
        AOMode, RenderParams, ShadowMode, default_frame_config,
    )
    from androidrenderer_tpu_torch.ops.rt.traverse import trace_rays
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
    from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

    cfg = default_frame_config(128, 128, shadow_cascade_resolution=128,
                               shadow_mode=ShadowMode.RT, ao_mode=AOMode.RT)
    leaves, _ = courtyard_scene(curtains=True).bake()
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(128, 128))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    images = {}
    for dev in (cuda_device, torch.device("cpu")):
        scene = scene_arrays_from_numpy(leaves, dev)
        renderer, temporal = make_renderer(cfg), temporal_state_for(cfg, device=dev)
        trace_rays.launches = rasterize.launches = 0
        for _ in range(2):
            out, temporal = renderer(scene, cam.view_data(), RenderParams.default(), temporal)
        images[dev.type] = out.image.cpu().numpy().astype(int)
        if dev.type == "cuda":
            assert trace_rays.launches == 10 and rasterize.launches == 8
    assert np.abs(images["cuda"] - images["cpu"]).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("bitmap", [False, True])
def test_traverse_kernel_masked_any_hit(cuda_device, bitmap):
    """The masked any-hit rule (the exact alpha peel's park test) on the alpha
    fixture's fence, with per-ray tmin and an active mask: bit-equal to the
    plain version, work counts included."""
    from androidrenderer_tpu_torch.ops.rt.traverse import (
        prepare_trace, trace_rays, trace_rays_reference,
    )

    scene, _ = alpha_test_scene().build(device=cuda_device)
    gx, gy = np.meshgrid(np.linspace(-1.5, 1.5, 64), np.linspace(0.3, 1.9, 64))
    o = np.stack([gx, gy, np.full_like(gx, -1.0)], -1).reshape(-1, 3).astype(np.float32)
    d = np.broadcast_to(np.array([0.05, 0.02, 1.0], np.float32), o.shape).copy()
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    g = torch.Generator(device="cpu").manual_seed(5)
    tmin = torch.rand(o.shape[0], generator=g).mul(1.2).to(cuda_device)
    active = (torch.rand(o.shape[0], generator=g) < 0.8).to(cuda_device)
    kw = dict(any_hit=True, masked_any_hit=True, alpha_bitmap_test=bitmap, active=active)
    got = trace_rays(scene.bvh, o, d, tmin, 3.0, **kw)
    _assert_hits_equal(got, trace_rays_reference(scene.bvh, o, d, tmin, 3.0, **kw))
    assert bool((got.slot >= 0).any()) and not bool((got.slot[~active] >= 0).any())
    call = prepare_trace(scene.bvh, o, d, tmin, 3.0, counts=True, **kw)
    call.launch()
    _, work, touched = trace_rays_reference(scene.bvh, o, d, tmin, 3.0, counts=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(call.work, work) and torch.equal(call.touched.bool(), touched)


@pytest.mark.cuda
def test_exact_alpha_peel_on_the_card(cuda_device):
    """trace_rays_masked and occlusion_masked on their exact path (use_bitmap=
    False: masked any-hit traces, each re-traced from the ignored hit's own t)
    through the kernel equal the same calls on the CPU, bit for bit."""
    from androidrenderer_tpu_torch.ops.rt import effects
    from androidrenderer_tpu_torch.ops.rt.traverse import trace_rays
    from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

    leaves, _ = alpha_test_scene().bake()
    gx, gy = np.meshgrid(np.linspace(-1.5, 1.5, 96), np.linspace(0.3, 1.9, 96))
    o = np.stack([gx, gy, np.full_like(gx, -1.0)], -1).reshape(-1, 3).astype(np.float32)
    d = np.broadcast_to(np.array([0.05, 0.02, 1.0], np.float32), o.shape).copy()
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        scene = scene_arrays_from_numpy(leaves, dev)
        ot, dt = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
        launches = trace_rays.launches
        hits = effects.trace_rays_masked(scene.bvh, scene, ot, dt, 0.01, 3.0, use_bitmap=False)
        occ = effects.occlusion_masked(scene.bvh, scene, ot, dt, 0.01, 3.0, use_bitmap=False)
        if dev.type == "cuda":
            assert trace_rays.launches == launches + 2 * effects.ALPHA_PEELS
        out[dev.type] = [x.cpu() for x in (hits.slot, hits.t, hits.u, hits.v, occ)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)
    assert bool(out["cuda"][4].any()) and not bool(out["cuda"][4].all())


@pytest.mark.cuda
@pytest.mark.parametrize("gi", ["rt", "probes"])
def test_gi_frame_traces_through_the_kernel(cuda_device, gi):
    """Frame A with RT GI (and RT shadows and AO) or with probe GI (a cache of
    4 x (8, 4, 8) probes, budget 32, 64 rays) at 128^2, 3 frames: 7 traversal
    and 4 raster launches per RTGI frame (1 shadow, 4 RTAO, a GI ray and a sun
    ray per pixel), 2 traversal and 6 raster launches per probe frame; the
    image equals the CPU's (the plain versions) but for at most 1% of pixels
    off by more than one u8 step (the GI rays' directions come from each
    device's sin/cos, apart by ulps)."""
    from androidrenderer_tpu_torch.config import (
        AOMode, GIMode, RenderParams, ShadowMode, default_frame_config,
    )
    from androidrenderer_tpu_torch.ops.rt.traverse import trace_rays
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
    from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

    if gi == "rt":
        cfg = default_frame_config(128, 128, shadow_mode=ShadowMode.RT, ao_mode=AOMode.RT,
                                   gi_mode=GIMode.RT)
        traces, rasters = 7, 4
    else:
        cfg = default_frame_config(128, 128, shadow_cascade_resolution=128,
                                   gi_mode=GIMode.PROBES, probe_grid=(8, 4, 8),
                                   probe_budget=32, probe_rays=64)
        traces, rasters = 2, 6
    leaves, _ = courtyard_scene(curtains=True).bake()
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(128, 128))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    images = {}
    for dev in (cuda_device, torch.device("cpu")):
        scene = scene_arrays_from_numpy(leaves, dev)
        renderer, temporal = make_renderer(cfg), temporal_state_for(cfg, device=dev)
        trace_rays.launches = rasterize.launches = 0
        for _ in range(3):
            out, temporal = renderer(scene, cam.view_data(), RenderParams.default(), temporal)
        images[dev.type] = out.image.cpu().numpy().astype(int)
        if dev.type == "cuda":
            assert trace_rays.launches == 3 * traces and rasterize.launches == 3 * rasters
    assert (np.abs(images["cuda"] - images["cpu"]).max(-1) > 1).mean() <= 0.01


@pytest.mark.cuda
def test_raster_kernel_at_the_vrsaa_size(cuda_device):
    """The main view at VRSAA's 3840x2176 (twice the CLI's 1920x1088 output),
    with the alpha grid, on the default courtyard: bit-equal to the plain
    version, its work counts equal to the plain mirror's."""
    from androidrenderer_tpu_torch.config import AAMode, raster_only_config
    from androidrenderer_tpu_torch.ops.raster import pack_fused_records
    from androidrenderer_tpu_torch.ops.raster.raster import prepare_raster, span_work, work_counts
    from androidrenderer_tpu_torch.render.frame import main_view_setup

    cfg = raster_only_config(1920, 1088, aa_mode=AAMode.VRSAA).replace(
        render_width=3840, render_height=2176)
    scene, _ = courtyard_scene().build(device=cuda_device, with_bvh=False)
    cam = Camera(fov_degrees=75.0, aspect=3840 / 2176, render_resolution=(3840, 2176))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    _, opaque, grid = main_view_setup(scene, cam.view_data(), cfg)
    got = rasterize(opaque, 2176, 3840, alpha_grid=grid)
    want = rasterize_reference(opaque, 2176, 3840, alpha_grid=grid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1] >= 0).float().mean().item() > 0.5
    rec = pack_fused_records(opaque)
    call = prepare_raster(rec, 2176, 3840, False, False, None, grid)
    call.launch()
    work = work_counts(call.counts)
    assert all(work[k] == v for k, v in span_work(rec, 2176, 3840).items())


@pytest.mark.cuda
def test_vrsaa_frame_on_the_card(cuda_device):
    """The CLI's --aa vrsaa frame (no translucency) at 128^2 output, 256^2
    render, on the curtained courtyard: 4 raster launches per frame (two
    occlusion phases, cascade 0 and one far cascade) and none of the traversal;
    the dropped count equals the CPU frame's, and the image the CPU's within
    one u8 step."""
    from androidrenderer_tpu_torch.config import AAMode, RenderParams, default_frame_config
    from androidrenderer_tpu_torch.ops.rt.traverse import trace_rays
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
    from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

    cfg = default_frame_config(128, 128, shadow_cascade_resolution=128, translucency=False,
                               aa_mode=AAMode.VRSAA, vrsaa_budget=0.05).replace(
        render_width=256, render_height=256)
    leaves, _ = courtyard_scene(curtains=True).bake()
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(256, 256))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        scene = scene_arrays_from_numpy(leaves, dev)
        renderer, temporal = make_renderer(cfg), temporal_state_for(cfg, device=dev)
        trace_rays.launches = rasterize.launches = 0
        for _ in range(2):
            out, temporal = renderer(scene, cam.view_data(), RenderParams.default(), temporal)
        outs[dev.type] = out
        if dev.type == "cuda":
            assert rasterize.launches == 8 and trace_rays.launches == 0
    assert int(outs["cuda"].vrsaa_dropped) == int(outs["cpu"].vrsaa_dropped) > 0
    assert torch.equal(outs["cuda"].depth.cpu(), outs["cpu"].depth)
    img = {k: o.image.cpu().numpy().astype(int) for k, o in outs.items()}
    assert np.abs(img["cuda"] - img["cpu"]).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("bands", [2, 4])
def test_band_raster_kernel_matches_plain_and_full_rows(cuda_device, bands):
    """The kernel with ``row_offset`` at every band: bit-equal to the plain
    version's band and to those rows of the full-frame kernel output, with the
    alpha grid, depth only, and under a z limit."""
    scene, _ = alpha_test_scene().build(device=cuda_device)
    w, h = 128, 96
    cam = Camera(fov_degrees=75.0, aspect=w / h, render_resolution=(w, h))
    cam.set_position([0.0, 1.0, -3.0])
    clip = transform_to_clip(scene.positions,
                             torch.from_numpy(cam.view_data().view_proj).to(cuda_device))
    setup = triangle_setup(clip, scene.tri_indices, w, h,
                           double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid)
    first, _ = rasterize(setup, h, w)
    zl = torch.where(first > 0, first * 0.999, torch.full_like(first, float("inf")))
    b = h // bands
    for kw in (dict(alpha_grid=scene.tri_alpha_grid), dict(depth_only=True), dict(z_limit=zl)):
        full = rasterize(setup, h, w, **kw)
        full = full if isinstance(full, tuple) else (full,)
        for i in range(bands):
            rows = slice(i * b, (i + 1) * b)
            band_kw = dict(kw, row_offset=i * b)
            if "z_limit" in kw:
                band_kw["z_limit"] = zl[rows].contiguous()
            got = rasterize(setup, b, w, **band_kw)
            _assert_bit_equal(got, rasterize_reference(setup, b, w, **band_kw))
            _assert_bit_equal(got, tuple(f[rows] for f in full))


@pytest.mark.cuda
def test_refit_on_the_card_equals_the_cpu(cuda_device):
    """update_primitive_transforms on the card against the CPU on the courtyard:
    positions, bounds, corner tables and every BVH tensor bit-equal, normals
    and tangents within 1e-6; a ray through a lifted column follows it."""
    from androidrenderer_tpu_torch.ops.rt.traverse import occlusion
    from androidrenderer_tpu_torch.scene import dynamic
    from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

    rs = courtyard_scene()
    leaves, _ = rs.bake()
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        scene = scene_arrays_from_numpy(leaves, dev)
        dyn = dynamic.make_dynamic_data(rs, scene)
        tr = dynamic.initial_transforms(rs, dev)
        tr[5, 1, 3] += 6.0  # the first column (y 0-5 m at x = -10.5, z = -6), up 6 m
        tr[6, :3, :3] = tr[6, :3, :3] * 1.5
        out[dev.type] = moved = dynamic.update_primitive_transforms(scene, dyn, tr)
        o = torch.tensor([[-11.5, 2.5, -6.0], [-11.5, 8.5, -6.0]], device=dev)
        d = torch.tensor([[1.0, 0.0, 0.0]] * 2, device=dev)
        hit = occlusion(moved.bvh, o, d, 1e-3, 1.5).cpu()
        assert not hit[0] and hit[1]
    card, host = out["cuda"], out["cpu"]

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    for name in ("positions", "prim_bounds", "tri_corner_pos"):
        assert torch.equal(bits(getattr(card, name)).cpu(), bits(getattr(host, name))), name
    for name in card.bvh._fields:
        assert torch.equal(bits(getattr(card.bvh, name)).cpu(), bits(getattr(host.bvh, name))), name
    for name in ("normals", "tangents", "tri_attr_corners"):
        assert (getattr(card, name).cpu() - getattr(host, name)).abs().max().item() <= 1e-6


def _card_collectives(group, device):
    from androidrenderer_tpu_torch.parallel import collectives as coll

    rank, n = coll.band_index(group)
    full = torch.arange(8 * 3 * 2, dtype=torch.float32).reshape(8, 3, 2) - 20.0
    full[2, 1, 0] = -0.0
    x = full[rank * 4:(rank + 1) * 4].to(device)
    got = dict(gather=coll.gather_rows(x, group), halo=coll.row_halo(x, 2, group, wrap=True),
               edge=coll.row_halo(x, 6, group, wrap=False),
               any=coll.any_across(torch.tensor([rank == 0, False, rank == 1], device=device),
                                   group))
    assert all(v.device == device for v in got.values())
    return {k: v.cpu() for k, v in got.items()} if rank == 0 else None


@pytest.mark.cuda
def test_collectives_on_the_card_with_gloo(cuda_device, tmp_path):
    """Two gloo ranks sharing the card: the collectives of CUDA tensors stay on
    the card and give rank 0 the exact bits (-0.0 included)."""
    from androidrenderer_tpu_torch.parallel.mesh import run_ranks

    got = run_ranks(2, _card_collectives, device="cuda", backend="gloo",
                    init_file=str(tmp_path / "store"))
    full = torch.arange(8 * 3 * 2, dtype=torch.float32).reshape(8, 3, 2) - 20.0
    full[2, 1, 0] = -0.0
    assert torch.equal(got["gather"].view(torch.int32), full.view(torch.int32))
    assert torch.equal(got["halo"], torch.cat([full[-2:], full[:4], full[4:6]]))
    assert torch.equal(got["edge"], full[[0] * 6 + [0, 1, 2, 3] + [4, 5, 6, 7, 7, 7]])
    assert got["any"].tolist() == [True, False, True]
