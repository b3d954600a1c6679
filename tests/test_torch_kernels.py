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
plain version, and its work counts equal to the plain mirror's.
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
