#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (androidrenderer_tpu_torch) runs on an NVIDIA card.

    python3 chip_smoke.py            # from the repository root, on a machine with one card
    python3 chip_smoke.py --profile  # also prints per-stage times of 3 profiled frames and
                                     # writes the torch.profiler table beside the kernel
                                     # build (build/torch_kernels/torch_frame_profile.txt)
    python3 chip_smoke.py --parent-csrc DIR  # also times the kernels of another tree's
                                     # csrc/ (raster.cu, gather.cu: e.g. the parent commit's,
                                     # unpacked with git archive) beside this tree's, in
                                     # turns (old, new, new, old) at every timed call site

Kernel-only times (``kernel_ms``, tools/kernel_timing.py): the launch function
alone, its buffers and records prepared beforehand, 50 launches back to back
between one CUDA event pair behind a device-side sleep (so the host has
enqueued them all before the first starts), divided by 50. The per-call ``ms``
beside them also holds the record pack, the allocations and the host's enqueue.

Phases, in order; any failure ends the run with a non-zero exit code:

1. the card: torch's device name, and nvidia-smi's name and power limit;
2. build csrc/raster.cu and csrc/gather.cu for sm_90a, one nvcc for each, both
   started together (seconds, and ptxas' register report);
3. the kernel against its plain PyTorch version at the main path's shapes on
   the bench scene and camera (bench.py:134-144): the 1088x1920 main view with
   the alpha grid, and one 1024^2 cascade (depth_only + affine_z). Both must be
   bit-equal; times are CUDA-event medians of 5, and kernel-only; the kernel's
   work counts (live records, work units, pixels evaluated against bbox
   pixels) from its scratch counters, beside the plain mirror's;
4. the raster-only bench frame at 1920x1088: 3 warm-up frames, then 4 chains of
   10 frames timed around torch.cuda.synchronize(); median ms/frame; checks on
   the image and HDR; the raster launch count must grow by exactly 3 per frame
   (main view, cascade 0, one far cascade);
5. the same raster-only frame at 128^2 on the default courtyard, rendered on the
   card (kernel) and on the CPU (plain version), 3 chained frames: max |delta|
   of the u8 image and of the depth;
6. the raster family's entry points against the plain version at their call
   sites' shapes on the bench scene, bit-equal, CUDA-event medians of 5:
   rasterize_binned for the exact-alpha peel's layers 0 and 1 (1088x1920, the
   masked triangles, layer 1 under the z_limit layer 0 leaves), rasterize for
   the translucency peel's layer 1 (the blend triangles under layer 0's depth),
   rasterize_fused and rasterize_pallas at the 1088x1920 main view, and
   rasterize_hybrid at the 1024^2 cascade (depth_only + affine_z); each with its
   kernel-only time and work counts;
7. the headless CLI's default frame (A, config.default_frame_config: two-phase
   HiZ occlusion, alpha bitmaps, translucency) and its exact-alpha twin (B,
   alpha_bitmap=False) at 1920x1088, timed as phase 4: raster launches must be
   exactly 6 per frame for A (occlusion phases 1 and 2, 2 translucent layers,
   cascade 0, one far cascade) and 9 for B (3 more, the peel's rasterize_binned);
   after warm-up A's depth and visibility must equal A's without occlusion;
8. the gather microbench (tools/microbench_pallas_gather.py's main) at its
   default shape (M = 2^18, C = 32, P = 942,080 seeded indices): the kernel,
   its plain version and embedding_bag, CUDA-event medians of 5; then the
   kernel against the plain version within rtol 2e-5, deterministic run to
   run, its kernel-only time and its bound;
9. the raster design studies' entry points (tools/experiments) at the bench
   scene's shapes: rasterize_touch at the 1088x1920 main view, rasterize_lanes
   and rasterize_subfold at the main view with the alpha grid and at the 1024^2
   cascade (depth_only + affine_z); each output bit-equal to the plain version,
   CUDA-event medians of 5;
10. the raster microbench (tools/bench_raster.py's run) on the bench scene in
   each mode (screen, csm, rsm) with fused, binned8 and subfold, chain 3; then
   each mode's step split: transform + setup, and the raster per call and
   kernel-only, with its work counts;
11. A and B at 128^2, card against CPU, with phase 5's thresholds;
12. one JSON line of kernel results (the eight TPU kernels: #1-#4 and #6-#8 of
   the raster family, #5 the gather, each with its call time ``ms``, its
   kernel-only time ``kernel_ms`` and its bound), the card line, and the final
   JSON line.

Launch counts are read per path (the frames of phases 4 and 7, the gather tool
of phase 8, the entry-point calls of phase 9, the microbench of phase 10): every
count is set to 0 just before a path runs and read just after, so the launches
of the comparisons never count.

It needs torch with CUDA and the repository beside it; it imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# Kernels of another tree's csrc/ (--parent-csrc), timed beside this tree's.
PARENT = {}


def parent_raster_launch(records, height, width, depth_only, affine_z, z_limit, alpha_grid):
    """A launch of the other tree's raster_launch (its signature: no scratch
    but the key buffer) on buffers allocated here, or None without one."""
    import torch

    lib = PARENT.get("raster")
    if lib is None:
        return None
    dev = records.device
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    keys = None if depth_only else torch.empty((height, width), dtype=torch.int64, device=dev)
    vis = None if depth_only else torch.empty((height, width), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = lib.load().raster_launch
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(records.data_ptr(), records.shape[0], height, width, ptr(z_limit),
              ptr(alpha_grid), int(depth_only), int(affine_z), ptr(keys), depth.data_ptr(),
              ptr(vis), stream) != 0:
            raise RuntimeError("the other tree's raster_launch failed")

    return launch


def raster_site(label, setup, height, width, depth_only=False, affine_z=False, z_limit=None,
                alpha_grid=None, mirror=False):
    """Kernel-only time (and the other tree's, in turns) of one raster call
    site, and the kernel's work counts read from its scratch counters (and the
    plain mirror's, with ``mirror``); printed, and returned as a dict."""
    from androidrenderer_tpu_torch.ops.raster import pack_fused_records
    from androidrenderer_tpu_torch.ops.raster.raster import (
        prepare_raster, span_work, work_counts,
    )

    from androidrenderer_tpu_torch.tools.kernel_timing import in_turns

    rec = pack_fused_records(setup, affine_z=affine_z)
    args = (rec, height, width, depth_only, affine_z, z_limit, alpha_grid)
    call = prepare_raster(*args)
    call.launch()
    work = work_counts(call.counts)
    kernel_ms, parent_ms = in_turns(call.launch, parent_raster_launch(*args))
    text = (f"  {label} kernel-only {kernel_ms * 1e3:.2f} us"
            + ("" if parent_ms is None else f" (other tree's kernel {parent_ms * 1e3:.2f} us)")
            + f"; work: {work['live']} live records, {work['units']} units "
            f"({work['small']} small records, {work['large_units']} tiles of {work['large']} "
            f"large), {work['evaluated']} pixels evaluated of {work['bbox_pixels']} bbox pixels")
    if mirror:
        plain = span_work(rec, height, width)
        text += f"; plain mirror's counts equal: {all(work[k] == v for k, v in plain.items())}"
    print(text)
    return dict(kernel_ms=kernel_ms, parent_kernel_ms=parent_ms, work=work)


def bench_setup(device):
    """The bench scene, camera and raster-only config (bench.py:83-195)."""
    import numpy as np

    from androidrenderer_tpu_torch.camera import Camera
    from androidrenderer_tpu_torch.config import raster_only_config
    from androidrenderer_tpu_torch.scene.procedural import courtyard_scene

    width, height = 1920, 1088
    cfg = raster_only_config(width, height)
    t0 = time.perf_counter()
    scene, stats = courtyard_scene(column_rings=4, detail=13, curtains=True).build(device=device)
    print(f"scene: {stats} (bake + upload {time.perf_counter() - t0:.1f} s)")
    cam = Camera(
        fov_degrees=cfg.fov_degrees, aspect=width / height,
        z_near=cfg.z_near, render_resolution=(width, height),
    )
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    return cfg, scene, cam.view_data()


# The card's peaks for the bound (NVIDIA's H100 SXM data sheet: HBM3 rate, and
# float32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def raster_bound(setup, height, width, depth_only=False, affine_z=False, z_limit=None,
                 alpha_grid=None):
    """(least ms the card could take for one raster call, "bytes" or "operations",
    the counts as text), from the work this call's data needs, counted with the
    plain version's fragment walk over each live record's clipped bbox.

    Bytes, each input read once and each output written once: 96 B for each
    live record (sid != 0 and a non-empty clipped bbox), 4 B (its sid) for each
    dead one; 4 B of z_limit for each distinct pixel a fragment in depth range
    tests; 4 B for each distinct alpha word a fragment tests; depth (f32) and
    vis (i32) written for every pixel. The kernel's key buffer is scratch and
    not counted. Operations, in float32, per covered pixel (all three edge
    tests passed): 12 for the edge tests (3 planes of 2 mul + 2 add) and the z
    (1 plane, 4, with affine_z; else 2 planes and a divide, 9); 7 per alpha test
    (2 add, a divide, 4 mul). A pixel that no edge test passes needs no work: a
    schedule that evaluates it pays for its own walk. The text also gives the
    operation time of the earlier count, 12 per bbox pixel, which charged the
    walk of every bbox pixel to the bound."""
    import torch

    from androidrenderer_tpu_torch.ops.raster import pack_fused_records
    from androidrenderer_tpu_torch.ops.raster.raster import (
        alpha_bit_index, patch_fragments, record_bboxes,
    )

    rec = pack_fused_records(setup, affine_z=affine_z)
    n = rec.shape[0]
    bx0, by0, bx1, by1, live = record_bboxes(rec, height, width)
    n_live = int(live.sum())
    bbox_px = int(((bx1 - bx0 + 1) * (by1 - by0 + 1))[live].sum())
    zl = None if z_limit is None else z_limit.reshape(-1)
    zl_read = torch.zeros(height * width, dtype=torch.bool, device=rec.device)
    words = torch.zeros(n * 8, dtype=torch.bool, device=rec.device)
    covered = alpha_tests = 0
    for tri, frag in patch_fragments(rec, height, width, affine_z):
        covered += int(frag.covered.sum())
        tested = frag.covered & (frag.z > 0.0) & (frag.z <= 1.0)
        if zl is not None:
            zl_read[frag.pix[tested]] = True
            tested = tested & (frag.z < zl[frag.pix])
        if alpha_grid is not None:
            word = tri[:, None, None] * 8 + (alpha_bit_index(frag) >> 5)
            words[word[tested]] = True
            alpha_tests += int(tested.sum())
    nbytes = (n_live * 96 + (n - n_live) * 4 + height * width * 4 * (1 if depth_only else 2)
              + int(zl_read.sum()) * 4 + int(words.sum()) * 4)
    ops = covered * (12 + (4 if affine_z else 9)) + alpha_tests * 7
    bbox_ops = ops + (bbox_px - covered) * 12
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    work = (f"{n_live} of {n} records live, {bbox_px} bbox pixels, {covered} covered, "
            f"{alpha_tests} alpha tests; {nbytes / 1e6:.3f} MB = {t_bytes * 1e3:.2f} us, "
            f"{ops / 1e6:.3f} M ops = {t_ops * 1e3:.2f} us (counted per bbox pixel as before: "
            f"{bbox_ops / 1e6:.3f} M ops = {bbox_ops / FP32_OPS_PER_S * 1e6:.2f} us)")
    return (t_bytes, "bytes", work) if t_bytes >= t_ops else (t_ops, "operations", work)


def kernel_checks(cfg, scene, view):
    """Phase 3: (result dict, ok, cascade-0 setup) for the main view and one cascade."""
    import torch

    from androidrenderer_tpu_torch.ops import shadow as shadow_ops
    from androidrenderer_tpu_torch.ops.raster import (
        rasterize, rasterize_reference, triangle_setup_corners,
    )
    from androidrenderer_tpu_torch.render.frame import main_view_setup

    h, w = cfg.render_height, cfg.render_width
    _, opaque, grid = main_view_setup(scene, view, cfg)
    got = rasterize(opaque, h, w, alpha_grid=grid)
    want = rasterize_reference(opaque, h, w, alpha_grid=grid)
    torch.cuda.synchronize()
    main_eq = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    main_err = (got[0] - want[0]).abs().max().item()
    vis_diff = int((got[1] != want[1]).sum())
    covered = (got[1] >= 0).float().mean().item()
    ms = cuda_ms(lambda: rasterize(opaque, h, w, alpha_grid=grid))
    plain_ms = cuda_ms(lambda: rasterize_reference(opaque, h, w, alpha_grid=grid))
    print(f"main view {h}x{w} + alpha grid: bit-equal={main_eq} max|d depth|={main_err} "
          f"vis differing={vis_diff} covered={covered:.4f} "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    main_site = raster_site("main view + alpha grid", opaque, h, w, alpha_grid=grid, mirror=True)

    res = cfg.shadow_cascade_resolution
    inv_view = torch.as_tensor(view.inverse_view, device=scene.positions.device)
    cascades = shadow_ops.fit_cascades(
        inv_view, float(view.projection[0, 0]), float(view.projection[1, 1]),
        scene.sun_direction, cfg.num_shadow_cascades, res, cfg.z_near,
        cfg.shadow_max_distance, cfg.shadow_cascade_split_lambda,
    )
    setup_c = triangle_setup_corners(
        scene.tri_corner_pos, cascades.canonical, res, res,
        double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid,
    )
    c0 = shadow_ops.derive_ortho_setup(setup_c, cascades.canonical, cascades.matrices[0], res)
    kw = dict(depth_only=True, affine_z=True)
    dk = rasterize(c0, res, res, **kw)
    dr = rasterize_reference(c0, res, res, **kw)
    torch.cuda.synchronize()
    csm_eq = torch.equal(dk, dr)
    csm_err = (dk - dr).abs().max().item()
    csm_ms = cuda_ms(lambda: rasterize(c0, res, res, **kw))
    csm_plain_ms = cuda_ms(lambda: rasterize_reference(c0, res, res, **kw))
    print(f"cascade 0 {res}^2 depth_only+affine_z: bit-equal={csm_eq} max|d depth|={csm_err} "
          f"covered={(dk > 0).float().mean().item():.4f} "
          f"kernel {csm_ms:.3f} ms, plain {csm_plain_ms:.3f} ms")
    csm_site = raster_site("cascade 0", c0, res, res, mirror=True, **kw)
    bound_ms, bound_by, work = raster_bound(opaque, h, w, alpha_grid=grid)
    print(f"  main view bound {bound_ms * 1e3:.2f} us ({bound_by}): {work}")
    csm_bound_ms, csm_bound_by, work = raster_bound(c0, res, res, depth_only=True, affine_z=True)
    print(f"  cascade 0 bound {csm_bound_ms * 1e3:.2f} us ({csm_bound_by}): {work}")
    result = {
        "name": "raster",
        "route": "cuda",
        "source": "androidrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "androidrenderer_tpu/ops/raster/raster_bitmask.py:82",
        "max_abs_err": max(main_err, csm_err),
        "ms": ms,
        "kernel_ms": main_site["kernel_ms"],
        "parent_kernel_ms": main_site["parent_kernel_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call rasterizes
        "work": main_site["work"],
        "cascade_ms": csm_ms,
        "cascade_kernel_ms": csm_site["kernel_ms"],
        "cascade_parent_kernel_ms": csm_site["parent_kernel_ms"],
        "cascade_plain_ms": csm_plain_ms,
        "cascade_bound_ms": csm_bound_ms,
        "cascade_bound_by": csm_bound_by,
        "cascade_work": csm_site["work"],
    }
    return result, main_eq and csm_eq and covered > 0.5, c0


def compare(label, fn, setup, height, width, **kw):
    """Kernel (through entry point ``fn``) against the plain version on the same
    inputs: (outputs, {eq, err, ms, kernel_ms, parent_kernel_ms, plain_ms,
    bound_ms, bound_by, work})."""
    import torch

    from androidrenderer_tpu_torch.ops.raster import rasterize_reference

    plain_kw = {k: v for k, v in kw.items() if k in ("depth_only", "affine_z", "z_limit",
                                                     "alpha_grid")}
    got = fn(setup, height, width, **kw)
    want = rasterize_reference(setup, height, width, **plain_kw)
    torch.cuda.synchronize()
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    eq = all(torch.equal(g, r) for g, r in zip(got_t, want_t))
    err = (got_t[0] - want_t[0]).abs().max().item()
    ms = cuda_ms(lambda: fn(setup, height, width, **kw))
    plain_ms = cuda_ms(lambda: rasterize_reference(setup, height, width, **plain_kw))
    bound_ms, bound_by, work = raster_bound(
        setup, height, width, depth_only=kw.get("depth_only", False),
        affine_z=kw.get("affine_z", False), z_limit=kw.get("z_limit"),
        alpha_grid=kw.get("alpha_grid"),
    )
    live = int(setup.valid.sum())
    print(f"{label} {height}x{width}, {live} live triangles: bit-equal={eq} "
          f"max|d depth|={err} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound_ms * 1e3:.2f} us ({bound_by}: {work})")
    site = raster_site(label, setup, height, width, **plain_kw)
    return got, dict(eq=eq, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, **site)


def entry_point_checks(scene, view, width, height, cascade0, res):
    """Phase 6: (results by entry point, ok)."""
    import torch

    from androidrenderer_tpu_torch.config import default_frame_config
    from androidrenderer_tpu_torch.ops.raster.masked import _sample_alpha, pack_alpha_planes
    from androidrenderer_tpu_torch.render.frame import main_view_setup

    eps = entry_points()
    cfg = default_frame_config(width, height, alpha_bitmap=False)
    h, w = height, width
    setup, opaque, _ = main_view_setup(scene, view, cfg)
    inf = torch.full((h, w), float("inf"), device=scene.positions.device)
    out, ok = {}, True

    # The exact-alpha peel: layer 0, then layer 1 under the bound layer 0 leaves
    # where the winning fragment failed its alpha test.
    masked = setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 1))
    (d0, v0), r0 = compare("rasterize_binned peel layer 0", eps["rasterize_binned"],
                           masked, h, w)
    alpha, cutoff = _sample_alpha(scene, masked, v0, alpha_planes=pack_alpha_planes(scene, masked))
    zl = torch.where((v0 >= 0) & ~(alpha >= cutoff), d0, inf)
    (d1, v1), r1 = compare("rasterize_binned peel layer 1", eps["rasterize_binned"],
                           masked, h, w, z_limit=zl)
    peeled = torch.isfinite(zl)
    readmitted = int((peeled & (v1 == v0)).sum())
    print(f"  peel layer 1: {int(peeled.sum())} pixels under a z_limit, "
          f"{readmitted} re-admit layer 0's triangle")
    ok &= r0["eq"] and r1["eq"] and readmitted == 0 and int(peeled.sum()) > 0
    out["rasterize_binned"] = dict(r0, err=max(r0["err"], r1["err"]), layer1_ms=r1["ms"],
                                   layer1_kernel_ms=r1["kernel_ms"],
                                   layer1_parent_kernel_ms=r1["parent_kernel_ms"],
                                   layer1_plain_ms=r1["plain_ms"],
                                   layer1_bound_ms=r1["bound_ms"])

    # The translucency peel's layer 1 through rasterize (kernel #1 with z_limit).
    blend = setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 2))
    (b0, bv0), _ = compare("rasterize translucency layer 0", eps["rasterize"], blend, h, w)
    (b1, bv1), rb = compare("rasterize translucency layer 1", eps["rasterize"], blend, h, w,
                            z_limit=torch.where(bv0 >= 0, b0, inf))
    ok &= rb["eq"] and bool((bv0 >= 0).any())
    out["rasterize"] = rb

    for name in ("rasterize_fused", "rasterize_pallas"):
        _, r = compare(f"{name} main view", eps[name], opaque, h, w)
        ok &= r["eq"]
        out[name] = r
    _, r = compare("rasterize_hybrid cascade 0", eps["rasterize_hybrid"], cascade0, res, res,
                   depth_only=True, affine_z=True)
    ok &= r["eq"]
    out["rasterize_hybrid"] = r
    return out, ok


def entry_points():
    """The raster family's entry points by name, the design studies' included;
    each counts its own launches."""
    from androidrenderer_tpu_torch.ops.raster import rasterize
    from androidrenderer_tpu_torch.ops.raster.raster_binned import rasterize_binned
    from androidrenderer_tpu_torch.ops.raster.raster_fused import (
        rasterize_fused, rasterize_hybrid,
    )
    from androidrenderer_tpu_torch.ops.raster.raster_pallas import rasterize_pallas
    from androidrenderer_tpu_torch.tools.experiments.raster_lanes import rasterize_lanes
    from androidrenderer_tpu_torch.tools.experiments.raster_subfold import rasterize_subfold
    from androidrenderer_tpu_torch.tools.experiments.raster_touch import rasterize_touch

    return {f.__name__: f for f in (
        rasterize, rasterize_binned, rasterize_fused, rasterize_hybrid, rasterize_pallas,
        rasterize_touch, rasterize_lanes, rasterize_subfold)}


def gather_checks():
    """Phase 8: (result dict, ok). The path is the gather tool's main() at its
    default shape; its launches are counted, the comparison's are not."""
    import torch

    from androidrenderer_tpu_torch.ops.gather import (
        LIBRARY as GATHER_LIBRARY, TILE, gather_tile_sums, gather_tile_sums_reference,
    )
    from androidrenderer_tpu_torch.tools import microbench_pallas_gather as tool
    from androidrenderer_tpu_torch.tools.kernel_timing import in_turns

    rows, width = 1 << 18, 32
    gather_tile_sums.launches = 0
    times = tool.main(["--rows", str(rows), "--width", str(width)])
    launches = gather_tile_sums.launches

    table, idx = tool.make_inputs(rows, width, "cuda")
    parent = PARENT.get("gather")
    kernel_ms, parent_ms = in_turns(gather_launch(GATHER_LIBRARY, table, idx),
                                    None if parent is None else gather_launch(parent, table, idx))
    got = gather_tile_sums(table, idx)
    again = gather_tile_sums(table, idx)
    want = gather_tile_sums_reference(table, idx)
    torch.cuda.synchronize()
    p, tiles = idx.numel(), idx.numel() // TILE
    err = (got - want).abs().max().item()
    rel = ((got - want).abs() / want.abs().clamp(min=1e-30)).max().item()
    ok = (tuple(got.shape) == (tiles, 8, width) and bool(torch.isfinite(got).all())
          and torch.allclose(got, want, rtol=2e-5, atol=0.0) and not bool(got[:, 1:].any())
          and torch.equal(got, again) and launches > 0)
    # Bytes: each index once, each distinct row once (the 33.5 MB table fits the
    # 50 MB L2, so a repeated row need not come from device memory again), the
    # output once. The sum's adds are too few to bound it.
    distinct = int(torch.unique(idx).numel())
    out_bytes = tiles * 8 * width * 4
    nbytes = 4 * p + distinct * width * 4 + out_bytes
    all_bytes = 4 * p + p * width * 4 + out_bytes
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    all_ms = all_bytes / HBM_BYTES_PER_S * 1e3
    print(f"gather {p} lookups into {rows}x{width}: kernel vs plain max|d|={err} max rel={rel:.3g} "
          f"(rtol 2e-5), deterministic={torch.equal(got, again)}; launches on the tool's path "
          f"{launches}; kernel {times['kernel']:.4f} ms, plain {times['plain']:.4f} ms, "
          f"embedding_bag {times['embedding_bag']:.4f} ms; kernel-only {kernel_ms * 1e3:.2f} us"
          + ("" if parent_ms is None else f" (other tree's kernel {parent_ms * 1e3:.2f} us)"))
    print(f"  gather bound {bound_ms * 1e3:.2f} us (bytes: {distinct} distinct rows of {rows}, "
          f"{nbytes / 1e6:.3f} MB); every lookup from device memory {all_bytes / 1e6:.3f} MB = "
          f"{all_ms * 1e3:.2f} us")
    result = dict(
        name="gather", route="cuda", source="androidrenderer_tpu_torch/csrc/gather.cu",
        replaces="tools/microbench_pallas_gather.py:52", launches=launches, max_abs_err=err,
        ms=times["kernel"], kernel_ms=kernel_ms, parent_kernel_ms=parent_ms,
        plain_ms=times["plain"], bound_ms=bound_ms, bound_by="bytes",
        library_ms=times["embedding_bag"], max_rel_err=rel, bound_all_from_memory_ms=all_ms,
    )
    return result, ok


def gather_launch(library, table, idx):
    """A launch of ``library``'s gather_tile_sums_launch on buffers allocated
    here: the output, and the partial-sum scratch where its signature takes one."""
    import torch

    from androidrenderer_tpu_torch.ops.gather import OUT_ROWS, SPLIT, TILE

    (m, c), p = table.shape, idx.numel()
    out = torch.empty((p // TILE, OUT_ROWS, c), dtype=torch.float32, device=table.device)
    scratch = ([torch.empty(p // TILE * SPLIT * c, dtype=torch.float32, device=table.device)]
               if len(library.functions["gather_tile_sums_launch"]) == 8 else [])
    stream = torch.cuda.current_stream().cuda_stream
    fn = library.load().gather_tile_sums_launch

    def launch():
        if fn(table.data_ptr(), m, c, idx.data_ptr(), p, out.data_ptr(),
              *(t.data_ptr() for t in scratch), stream) != 0:
            raise RuntimeError(f"{library.source} gather_tile_sums_launch failed")

    return launch


def experiment_checks(cfg, scene, view, cascade0):
    """Phase 9: (results by entry point, launches by entry point, ok). The path
    is one call of each entry point at its shapes, with every count set to 0
    just before; the comparison and the timing come after the counts are read."""
    import torch

    from androidrenderer_tpu_torch.render.frame import main_view_setup

    h, w, res = cfg.render_height, cfg.render_width, cfg.shadow_cascade_resolution
    _, opaque, grid = main_view_setup(scene, view, cfg)
    csm = dict(depth_only=True, affine_z=True)
    calls = [("rasterize_touch", "main view", opaque, h, w, {})]
    for name in ("rasterize_lanes", "rasterize_subfold"):
        calls += [(name, "main view + alpha grid", opaque, h, w, {"alpha_grid": grid}),
                  (name, "cascade 0", cascade0, res, res, csm)]
    eps = entry_points()
    for f in eps.values():
        f.launches = 0
    outs = [eps[name](setup, hh, ww, **kw) for name, _, setup, hh, ww, kw in calls]
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in eps.items()}
    expected = {name: sum(c[0] == name for c in calls) for name, *_ in calls}
    ok = all(launches[n] == expected.get(n, 0) for n in launches)
    print(f"design-study entry points, one call each: launches {launches}")
    results = {}
    for (name, where, setup, hh, ww, kw), out in zip(calls, outs):
        got, r = compare(f"{name} {where}", eps[name], setup, hh, ww, **kw)
        out_t = out if isinstance(out, tuple) else (out,)
        got_t = got if isinstance(got, tuple) else (got,)
        ok &= r["eq"] and all(torch.equal(a, b) for a, b in zip(out_t, got_t))
        results.setdefault(name, []).append(r)
    return results, launches, ok


def bench_raster_path(scene):
    """Phase 10: (ms per raster by mode and label, the step split by mode,
    launches by entry point, problems) of tools/bench_raster's run() on the
    bench scene."""
    import math

    from androidrenderer_tpu_torch.tools import bench_raster

    names, chain, modes = ["fused", "binned8", "subfold"], 3, ("screen", "csm", "rsm")
    eps = entry_points()
    for f in eps.values():
        f.launches = 0
    times = {mode: bench_raster.run(scene, mode, names, chain, "cuda") for mode in modes}
    launches = {n: f.launches for n, f in eps.items()}
    # One warm-up chain and 3 timed chains per name and mode.
    per_name = len(modes) * 4 * chain
    expected = {"rasterize_fused": per_name, "rasterize_binned": per_name,
                "rasterize_subfold": per_name}
    problems = [f"{n} launches {v} != {expected.get(n, 0)}" for n, v in launches.items()
                if v != expected.get(n, 0)]
    problems += [f"{mode} {label}: {ms} ms" for mode, t in times.items() for label, ms in t.items()
                 if not (math.isfinite(ms) and ms > 0)]
    print(f"bench_raster launches: {launches}")

    # Where a step's time goes: its transform + setup and its raster (fused),
    # timed apart, and the bbox work the raster walks (no frustum cull here, so
    # triangles that cross the camera plane keep full-screen boxes).
    from androidrenderer_tpu_torch.ops.raster import (
        pack_fused_records, transform_to_clip, triangle_setup,
    )
    from androidrenderer_tpu_torch.ops.raster.raster import record_bboxes

    split = {}
    for mode in modes:
        mat, w, h, depth_only, affine = bench_raster.bench_view(scene, mode)

        def setup():
            return triangle_setup(transform_to_clip(scene.positions, mat), scene.tri_indices, w,
                                  h, double_sided=scene.tri_double_sided,
                                  tri_valid=scene.tri_valid)

        su = setup()
        _, raster = bench_raster.make_raster("fused", h, w, depth_only, affine)
        setup_ms, raster_ms = cuda_ms(setup), cuda_ms(lambda: raster(su))
        bx0, by0, bx1, by1, live = record_bboxes(pack_fused_records(su, affine), h, w)
        area = ((bx1 - bx0 + 1) * (by1 - by0 + 1))[live]
        print(f"  bench_raster {mode} {w}x{h} step: transform + setup {setup_ms:.3f} ms, "
              f"raster (fused) {raster_ms:.3f} ms; {int(live.sum())} live records, "
              f"{int(area.sum())} bbox pixels, {int((area >= h * w // 4).sum())} records with a "
              f"bbox of a quarter of the target or more")
        site = raster_site(f"bench_raster {mode} raster", su, h, w, depth_only=depth_only,
                           affine_z=affine)
        split[mode] = dict(setup_ms=setup_ms, raster_ms=raster_ms, **site)
    return times, split, launches, problems


def run_frames(label, cfg, scene, view, profile: bool, per_frame: dict):
    """Phases 4 and 7: (median ms/frame, launches by entry point, frames, failed
    checks, last outputs, temporal state). ``per_frame`` is the launches each
    entry point must make per frame; every other entry point must make none."""
    import numpy as np
    import torch

    from androidrenderer_tpu_torch.config import RenderParams
    from androidrenderer_tpu_torch.ops.cuda_build import BUILD_DIR
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for

    renderer = make_renderer(cfg)
    params = RenderParams.default()
    temp = temporal_state_for(cfg, device=scene.positions.device)
    eps = entry_points()
    for f in eps.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, temp = renderer(scene, view, params, temp)
    torch.cuda.synchronize()
    print(f"{label} first frame: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    for _ in range(2):
        out, temp = renderer(scene, view, params, temp)
    torch.cuda.synchronize()
    chain, times = 10, []
    for _ in range(4):
        t0 = time.perf_counter()
        for _ in range(chain):
            out, temp = renderer(scene, view, params, temp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / chain)
    launches = {name: f.launches for name, f in eps.items()}
    frames = 3 + 4 * chain
    total = sum(launches.values())
    ms = float(np.median(times))
    print(f"{label} {cfg.render_width}x{cfg.render_height} chained frame times (ms): "
          f"{[round(t, 3) for t in times]}; median {ms:.3f} ms/frame")
    print(f"{label} raster launches: {total} over {frames} frames = {total / frames} per frame "
          f"({', '.join(f'{k} {v}' for k, v in launches.items() if v)})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} peak device memory: {peak:.2f} GiB")

    img = out.image
    problems = []
    if tuple(img.shape) != (cfg.output_height, cfg.output_width, 3) or img.dtype != torch.uint8:
        problems.append(f"image is {tuple(img.shape)} {img.dtype}")
    if not bool(torch.isfinite(out.hdr).all()):
        problems.append("HDR has non-finite values")
    if int(img.amax()) == int(img.amin()):
        problems.append("image is uniform")
    for name, n in launches.items():
        if n != per_frame.get(name, 0) * frames:
            problems.append(f"{name} launches {n} != {per_frame.get(name, 0)} x {frames} frames")
    print(f"{label} image: mean {img.float().mean().item():.3f}, min {int(img.amin())}, "
          f"max {int(img.amax())}; pixels covered {(out.visibility >= 0).float().mean().item():.4f}")

    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                out, temp = renderer(scene, view, params, temp)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        events = prof.key_averages()

        def device_us(e, total):
            name = ("" if total else "self_") + "device_time_total"
            alt = ("" if total else "self_") + "cuda_time_total"
            return getattr(e, name, None) or getattr(e, alt, 0.0)

        # Kernels have device time and no host time of their own; frame/* ranges
        # appear twice, once with the host-side span (device total = the time of
        # the kernels they launched) and once as the span on the device's timeline.
        kernels = [e for e in events if e.cpu_time_total == 0 and device_us(e, False) > 0
                   and not e.key.startswith("frame/")]
        busy_ms = sum(device_us(e, False) for e in kernels) / 1e3 / 3
        table = events.table(sort_by="cuda_time_total", row_limit=80)
        dest = BUILD_DIR / f"torch_frame_profile_{label.replace(' ', '_')}.txt"
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(table)
        print(f"{label} profile of 3 frames written to {dest.relative_to(REPO)}")
        print(f"{label} profiled frame: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"({busy_ms / wall_ms:.1%}), {sum(e.count for e in kernels) / 3:.0f} kernels")
        for e in sorted(events, key=lambda e: -e.cpu_time_total):
            if e.key.startswith("frame/") and e.cpu_time_total > 0:
                print(f"  {e.key:18s} host {e.cpu_time_total / 1e3 / 3:8.3f} ms, "
                      f"kernels {device_us(e, True) / 1e3 / 3:8.3f} ms per frame")
    return ms, launches, frames, problems, out, temp


def card_vs_cpu(label="raster-only", overrides=None, curtains=False):
    """Phases 5 and 8: a 128^2 courtyard frame on the card and on the CPU.
    ``overrides`` (RenderConfig fields) turn the raster-only config into A or B."""
    import numpy as np
    import torch

    from androidrenderer_tpu_torch.camera import Camera
    from androidrenderer_tpu_torch.config import RenderParams, raster_only_config
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
    from androidrenderer_tpu_torch.scene.procedural import courtyard_scene

    n = 128
    cfg = raster_only_config(n, n, shadow_cascade_resolution=128, **(overrides or {}))
    cam = Camera(fov_degrees=cfg.fov_degrees, aspect=1.0, z_near=cfg.z_near,
                 render_resolution=(n, n))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    view = cam.view_data()
    leaves, _ = courtyard_scene(curtains=curtains).bake()
    from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

    outs = {}
    for dev in ("cuda", "cpu"):
        scene = scene_arrays_from_numpy(leaves, dev)
        renderer = make_renderer(cfg)
        temp = temporal_state_for(cfg, device=dev)
        frames = []
        for _ in range(3):
            out, temp = renderer(scene, view, RenderParams.default(), temp)
            frames.append((out.image.cpu().numpy(), out.depth.cpu().numpy()))
        outs[dev] = frames
    pairs = list(zip(outs["cuda"], outs["cpu"]))
    img_d = max(int(np.abs(a[0].astype(int) - b[0].astype(int)).max()) for a, b in pairs)
    far = max(float((np.abs(a[0].astype(int) - b[0].astype(int)) > 1).mean()) for a, b in pairs)
    dep_d = max(float(np.abs(a[1] - b[1]).max()) for a, b in pairs)
    dep_share = max(float((a[1] != b[1]).mean()) for a, b in pairs)
    print(f"card vs CPU, {label} 128^2 courtyard, 3 frames: max|d image|={img_d} "
          f"(share > 1 step {far:.5f}), max|d depth|={dep_d} (share differing {dep_share:.5f})")
    return far <= 0.005 and dep_share <= 0.005


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script runs on an NVIDIA card")
    if not (REPO / "androidrenderer_tpu_torch" / "csrc" / "raster.cu").is_file():
        return fail(f"androidrenderer_tpu_torch/ is not beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    from ctypes import c_int, c_longlong, c_void_p

    from androidrenderer_tpu_torch import init_device
    from androidrenderer_tpu_torch.ops.cuda_build import Library, load_all
    from androidrenderer_tpu_torch.ops.gather import LIBRARY as GATHER_LIBRARY
    from androidrenderer_tpu_torch.ops.raster.raster import LIBRARY

    # 1. the card
    dev = init_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"nvidia-smi: {smi}")

    # 2. build, one nvcc for each source, all started together
    if "--parent-csrc" in argv:
        parent = Path(argv[argv.index("--parent-csrc") + 1]).resolve()
        PARENT["raster"] = Library(parent / "raster.cu", {"raster_launch": [
            c_void_p, c_int, c_int, c_int, c_void_p, c_void_p, c_int, c_int, c_void_p, c_void_p,
            c_void_p, c_void_p]})
        PARENT["gather"] = Library(parent / "gather.cu", {"gather_tile_sums_launch": [
            c_void_p, c_longlong, c_int, c_void_p, c_longlong, c_void_p, c_void_p]})
    load_all(LIBRARY, GATHER_LIBRARY, *PARENT.values())
    for lib in (LIBRARY, GATHER_LIBRARY, *PARENT.values()):
        print(f"built {lib.source} for sm_90a in {lib.build_seconds:.1f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain version at the main path's shapes
    cfg, scene, view = bench_setup(dev)
    result, ok, cascade0 = kernel_checks(cfg, scene, view)
    if not ok:
        return fail("kernel and plain version disagree at the bench shapes")
    profile = "--profile" in argv

    # 4. the raster-only frame
    ms, launches, frames, problems, _, _ = run_frames(
        "raster-only", cfg, scene, view, profile, {"rasterize": 3})
    if problems:
        return fail("raster-only frame: " + "; ".join(problems))
    path_launches = {"raster-only": launches}
    print(f"raster_only_frame_ms: {ms:.3f} ({kind}; {smi})")

    # 5. card vs CPU
    if not card_vs_cpu():
        return fail("card and CPU frames disagree")

    # 6. the entry points at their call sites' shapes
    entry, ok = entry_point_checks(scene, view, cfg.render_width, cfg.render_height, cascade0,
                                   cfg.shadow_cascade_resolution)
    if not ok:
        return fail("an entry point's kernel and the plain version disagree at the bench shapes")

    # 7. frames A and B
    from androidrenderer_tpu_torch.config import RenderParams, default_frame_config
    from androidrenderer_tpu_torch.render import make_renderer

    for label, overrides, per_frame in (
        ("A", {}, {"rasterize": 6}),
        ("B", {"alpha_bitmap": False}, {"rasterize": 6, "rasterize_binned": 3}),
    ):
        cfg_p = default_frame_config(cfg.render_width, cfg.render_height, **overrides)
        ms, launches, frames, problems, out, temp = run_frames(
            f"frame {label}", cfg_p, scene, view, profile, per_frame)
        if label == "A":
            plain, _ = make_renderer(cfg_p.replace(occlusion_culling=False))(
                scene, view, RenderParams.default(), temp)
            same = (torch.equal(plain.depth, out.depth)
                    and torch.equal(plain.visibility, out.visibility))
            print(f"frame A, occlusion on vs off after warm-up: depth and vis equal={same}")
            if not same:
                problems.append("occlusion culling changed depth or visibility")
        if problems:
            return fail(f"frame {label}: " + "; ".join(problems))
        path_launches[label] = launches
        print(f"frame_{label}_ms: {ms:.3f} ({kind}; {smi})")

    # 8. the gather microbench
    gather, ok = gather_checks()
    if not ok:
        return fail("the gather kernel and its plain version disagree at the tool's shape")

    # 9. the design studies' entry points at the bench shapes
    studies, path_launches["experiments"], ok = experiment_checks(cfg, scene, view, cascade0)
    if not ok:
        return fail("a design study's entry point and the plain version disagree, "
                    "or launched other than once per call")

    # 10. the raster microbench in each mode
    bench_ms, bench_split, path_launches["bench_raster"], problems = bench_raster_path(scene)
    if problems:
        return fail("bench_raster: " + "; ".join(problems))
    del scene
    torch.cuda.empty_cache()

    # 11. A and B at 128^2, card vs CPU
    for label, overrides in (("A", {}), ("B", {"alpha_bitmap": False})):
        overrides = dict(occlusion_culling=True, translucency=True, **overrides)
        if not card_vs_cpu(f"frame {label}", overrides, curtains=True):
            return fail(f"frame {label}: card and CPU frames disagree")

    # 12. results
    def launched(*names):
        return sum(path[n] for path in path_launches.values() for n in names)

    fused, hybrid = entry["rasterize_fused"], entry["rasterize_hybrid"]
    kernels = [
        dict(result, launches=launched("rasterize"),
             max_abs_err=max(result["max_abs_err"], entry["rasterize"]["err"]),
             translucency_layer1_ms=entry["rasterize"]["ms"],
             translucency_layer1_kernel_ms=entry["rasterize"]["kernel_ms"],
             translucency_layer1_parent_kernel_ms=entry["rasterize"]["parent_kernel_ms"],
             translucency_layer1_plain_ms=entry["rasterize"]["plain_ms"],
             translucency_layer1_bound_ms=entry["rasterize"]["bound_ms"]),
    ]
    def bench(label):
        return {mode: t[label] for mode, t in bench_ms.items()}

    bench_split = {mode: {k: v for k, v in t.items() if k != "work"}
                   for mode, t in bench_split.items()}

    def cascade(r):
        return dict(cascade_ms=r["ms"], cascade_kernel_ms=r["kernel_ms"],
                    cascade_parent_kernel_ms=r["parent_kernel_ms"], cascade_plain_ms=r["plain_ms"],
                    cascade_bound_ms=r["bound_ms"], cascade_bound_by=r["bound_by"])

    touch, = studies["rasterize_touch"]
    lanes, lanes_csm = studies["rasterize_lanes"]
    subfold, subfold_csm = studies["rasterize_subfold"]
    rows = (
        ("raster_binned", ("rasterize_binned",), entry["rasterize_binned"],
         "androidrenderer_tpu/ops/raster/raster_binned.py:63",
         dict(bench_raster_ms=bench("binned8"))),
        ("raster_fused", ("rasterize_fused", "rasterize_hybrid"), fused,
         "androidrenderer_tpu/ops/raster/raster_fused.py:99",
         dict(hybrid_ms=hybrid["ms"], hybrid_kernel_ms=hybrid["kernel_ms"],
              hybrid_parent_kernel_ms=hybrid["parent_kernel_ms"],
              hybrid_plain_ms=hybrid["plain_ms"], hybrid_bound_ms=hybrid["bound_ms"],
              bench_raster_ms=bench("fused(prod)"), bench_raster_split=bench_split)),
        ("raster_pallas", ("rasterize_pallas",), entry["rasterize_pallas"],
         "androidrenderer_tpu/ops/raster/raster_pallas.py:97", {}),
        ("raster_touch", ("rasterize_touch",), touch,
         "tools/experiments/raster_touch.py:189", {}),
        ("raster_lanes", ("rasterize_lanes",), lanes,
         "tools/experiments/raster_lanes.py:71", cascade(lanes_csm)),
        ("raster_subfold", ("rasterize_subfold",), subfold,
         "tools/experiments/raster_subfold.py:81",
         dict(cascade(subfold_csm), bench_raster_ms=bench("subfold"))),
    )
    errs = {"raster_fused": hybrid["err"], "raster_lanes": lanes_csm["err"],
            "raster_subfold": subfold_csm["err"]}
    for name, names, r, replaces, extra in rows:
        kernels.append(dict(
            name=name, route="cuda", source="androidrenderer_tpu_torch/csrc/raster.cu",
            replaces=replaces, launches=launched(*names),
            max_abs_err=max(r["err"], errs.get(name, 0.0)),
            ms=r["ms"], kernel_ms=r["kernel_ms"], parent_kernel_ms=r["parent_kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, **extra,
        ))
    kernels.insert(4, gather)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
