#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (androidrenderer_tpu_torch) runs on an NVIDIA card.

    python3 chip_smoke.py            # from the repository root, on a machine with one card
    python3 chip_smoke.py --profile  # also prints per-stage times of 3 profiled frames and
                                     # writes the torch.profiler table beside the kernel
                                     # build (build/torch_kernels/torch_frame_profile.txt)
    python3 chip_smoke.py --parent-csrc DIR  # also times the kernels of another tree's
                                     # csrc/ (raster.cu, gather.cu, traverse.cu: e.g. the
                                     # parent commit's, unpacked with git archive) beside
                                     # this tree's, in turns (old, new, new, old) at every
                                     # timed call site
    python3 chip_smoke.py --traversal  # only the card, the builds and the traversal
                                     # phases (12-14, 19), with their gates; no results
                                     # line
    python3 chip_smoke.py --stubs    # only the card, the builds and phases 21-23, with
                                     # phase 21's switches timed and profiled in
                                     # mirrored turns; no results line
    python3 chip_smoke.py --parent-tree DIR  # also phase 24: the unstubbed frames of the
                                     # package in DIR (e.g. the parent commit's,
                                     # unpacked with git archive) and of this tree as
                                     # --tree-frames processes in turns (DIR, this, this,
                                     # DIR), their kernel counts and device ms gated
    python3 chip_smoke.py --tree-frames DIR  # that process: DIR's raster-only and
                                     # parity frames timed and profiled, one JSON line

Kernel-only times (``kernel_ms``, tools/kernel_timing.py): the launch function
alone, its buffers and records prepared beforehand, 50 launches back to back
between one CUDA event pair behind a device-side sleep (so the host has
enqueued them all before the first starts), divided by 50. The per-call ``ms``
beside them also holds the record pack, the allocations and the host's enqueue.

Phases, in order; any failure ends the run with a non-zero exit code:

1. the card: torch's device name, and nvidia-smi's name and power limit;
2. build csrc/raster.cu, csrc/gather.cu and csrc/traverse.cu for sm_90a, one
   nvcc for each, all started together (seconds, and ptxas' register report);
   the traversal kernel's registers per thread and resident blocks per SM, for
   the frame's instantiations and the counting ones;
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
8. the parity frame, the frame bench.py times (config.parity_frame_config: LPV GI
   with one 128^2 RSM per frame on the proxy mesh, half-rate SSAO, TAAU from
   1280x736 to 1920x1088): first each LPV cascade's RSM through rasterize
   against the plain version (bit-equal, the derived ortho setup on the proxy,
   with call ms, kernel-only time, bound and work counts as in phase 3); then
   the frame timed as phase 4, with exactly 4 raster launches per frame (main
   view, cascade 0, one far cascade, one RSM), a finite non-constant image and
   HDR, and an HDR that differs from the same frame with GI off; then the
   parity frame at 128^2 (192^2 output) on the card and on the CPU, 3 chained
   frames, within the thresholds written beside the call;
9. the gather microbench (tools/microbench_pallas_gather.py's main) at its
   default shape (M = 2^18, C = 32, P = 942,080 seeded indices): the kernel,
   its plain version and embedding_bag, CUDA-event medians of 5; then the
   kernel against the plain version within rtol 2e-5, deterministic run to
   run, its kernel-only time and its bound;
10. the raster design studies' entry points (tools/experiments) at the bench
   scene's shapes: rasterize_touch at the 1088x1920 main view, rasterize_lanes
   and rasterize_subfold at the main view with the alpha grid and at the 1024^2
   cascade (depth_only + affine_z); each output bit-equal to the plain version,
   CUDA-event medians of 5;
11. the raster microbench (tools/bench_raster.py's run) on the bench scene in
   each mode (screen, csm, rsm) with fused, binned8 and subfold, chain 3; then
   each mode's step split: transform + setup, and the raster per call and
   kernel-only, with its work counts;
12. the RT frame (the headless CLI's --shadow rt --ao rt: frame A with one
   jittered any-hit sun ray and rtao_num_samples=4 AO rays per pixel, all
   through csrc/traverse.cu, built beside the others in phase 2): (a) the
   bench scene's BVH (builder, seconds, nodes, slots, node_rows MB) and the
   kernel's layout of it (MB per field, the time and peak memory of building
   it anew); (b) the
   traversal kernel against its plain version at the frame's call sites, from
   the RT frame's first gbuffer — the shadow rays and RTAO sample 0 (any-hit,
   alpha bitmaps) and primary rays through the same view (closest-hit, the
   mode of RTGI's and the probes' traces): on a 65,536-ray subset sampled with
   a fixed seed (sky pixels included) slot, t, u, v and each ray's steps
   bit-equal and the longest walk and overflow equal; call ms, kernel-only us and
   ps per step (with --parent-csrc the other tree's kernel in turns, and whether
   its outputs are the same), the layout's MB, the bound (``traverse_bound``,
   which counts 436 B per distinct node row whatever the layout) and the plain
   version's ms on the subset; (c) the frame
   timed as phase 4, with exactly 5 traversal and 4 raster launches per frame
   (RT shadows replace the cascades); (d) the frame at 128^2 on the card and on
   the CPU, within the thresholds written beside the call;
13. the RTGI frame (the CLI's --shadow rt --ao rt --gi rt: the RT frame with one
   cosine GI ray per pixel and one sun ray from each front-face hit, the a-trous
   filter and the temporal accumulation): (a) the traversal kernel against its
   plain version, as in 12(b), at RTGI's two sites from the frame's first
   gbuffer: the GI rays (closest-hit, alpha bitmaps, active = valid pixels) and
   the sun rays from their hits (any-hit, bitmaps, active = front-face hits);
   (b) at one exact-alpha-peel site: the RT frame's shadow rays in their second
   peel (masked any-hit, no bitmaps, each ray's tmin its first peel's ignored
   hit, active = the rays that hit a masked slot whose texture failed); (c)
   the frame timed as phase 4, with exactly 7 traversal (1 shadow, 4 RTAO, 2 GI)
   and 4 raster launches per frame; GI changes the HDR; (d) the frame at 128^2
   over 3 frames (the temporal accumulation runs) on the card and on the CPU;
14. the probe frame (the CLI's --gi probes: frame A with the reference-scale
   probe cache, 4 cascades of 32x8x32, 256 probes each refreshed per frame, 400
   rays each: 409,600 probe rays per frame): (a) the traversal kernel against
   its plain version at the probe-ray site (closest-hit, bitmaps) and the sun
   rays from their hits (any-hit, active = hits); (b) the frame timed as phase
   4, with exactly 6 raster (as A) and 2 traversal launches per frame and its
   peak device memory; GI changes the HDR; (c) the frame at 128^2 with a
   smaller cache on the card and on the CPU;
15. the VRSAA frame (the CLI's --aa vrsaa: frame A rendered at 3840x2176 into a
   1920x1088 output, translucency off): (a) the kernel against its plain
   version at the frame's 3840x2176 main view with the alpha grid, bit-equal,
   with call ms, kernel-only time, bound and work counts as in phase 3; (b) the
   frame timed as phase 4, with exactly 4 raster launches per frame (occlusion
   phases 1 and 2 at 3840x2176, cascade 0, one far cascade) and no traversal
   launch; (c) the fine-quad count, the budget (vrsaa_budget 0.25 of the
   coarse grid), vrsaa_dropped and the peak device memory, the HDR finite; (d)
   the frame at 128^2 output (256^2 render) on the card and on the CPU, with
   phase 5's thresholds and equal dropped counts;
16. the headless CLI, ``headless.main([...])`` in this process on the card at
   1920x1088 on courtyard-big, the PNGs under build/cli/: --aa taa --frames 3
   --orbit 0.02 --interpolate (both PNGs), --aa vrsaa --frames 2, --set
   r.GI.Mode=1 --set r.GI.LPV.Exposure=40 --visualize lpv-gv, --gi lpv
   --visualize lpv-radiance and vpl, --gi probes --visualize probes, --set list,
   and --scene of a glTF with ETC1S and UASTC KTX2 textures written by the
   port's ktx2.write_ktx2; each run must exit 0 with exactly its launches
   (counted from the code beside the runs) and print its per-frame ms; then the
   eight frame visualizers through visualize() on the TAA run's outputs, with
   none and overdraw raising;
17. A and B at 128^2, card against CPU, with phase 5's thresholds;
18. the band raster: the kernel with ``row_offset`` against its plain version at
   the band call sites, and each band against the same rows of the full-frame
   kernel output, all bit for bit: the parity main view (1280x736, alpha grid)
   in the sharded parity frame's 2 bands of 368 rows, the 1024^2 cascade 0 in 4
   bands (depth_only + affine_z), and the exact peel's layer 1 (rasterize_binned
   with its z_limit) on the lower of 2 bands at 1088x1920; call ms, kernel-only
   time, bound (``raster_bound`` on the band's own inputs), work counts and
   plain ms per band;
19. dynamic scenes (scene/dynamic.py) on the bench scene: (a) the build
   transforms reproduce the bake (positions, node boxes, sphere centres within
   tests/test_dynamic.py's 2e-5); (b) for 3 frames' transforms (the first
   ring's columns and capitals lifted and turned) the update on the card equals
   the update on the CPU: positions, bounds, corner tables, node boxes, slot
   tables and packed rows bit-equal, normals and tangents within 1e-6; the
   update and refit times; (c) the traversal kernel against its plain version
   on the refit BVH at the RT frame's shadow site, as in 12(b); (d) a column
   lifted 6 m: a ray across its old place misses, one across its new place
   hits; (e) the RT frame (phase 12's) with the update before each of 3
   frames: ms/frame, and exactly 5 traversal and 4 raster launches per frame;
20. bands over 2 ranks on the one card (``parallel.mesh.run_ranks``, gloo; a
   multi-card NCCL run is not attempted): (a) ``dryrun_multichip(2)``, two
   frames; (b) the parity frame with tile_height=16 (2 bands of 368 rows) over
   3 moving jittered frames against the single-device parity frame, within
   phase 5's thresholds and at most one u8 step on at most 0.01% of pixels;
   (c) ms/frame of both, the ``frame/collectives`` ranges' host and device
   time, and each rank's raster launches per frame (its main-view band, its
   share of the frame's cascades, the RSM); (d) peak device memory per rank;
21. the profiling switches (render/frame.py's docstring) on the two frames
   bench.py times at full width: the raster-only frame (1920x1088) with each
   of debug_stub_raster, debug_stub_resolve, debug_resolve_gather_only and
   debug_stub_shadow_sample alone, the parity frame with each of the six alone,
   each after the unstubbed frame, 3 warm-up frames and a chain of 10: raster
   launches gated at exactly the unstubbed frame's (3 and 4) less one for the
   raster stub, and less one for the RSM stub on the parity frame; a finite
   HDR, and a non-uniform image unstubbed. With --stubs each is also timed as
   phase 4 (2 chains of 10) and profiled over 3 frames in mirrored turns with
   the unstubbed frame (unstubbed, every switch, every switch again in
   reverse, unstubbed): ms/frame, device ms and kernels per profiled frame and
   their deltas from the unstubbed frame;
22. the 128^2 parity frame (192^2 output) with each switch alone, card against
   CPU over 3 moving jittered frames, with phase 5's thresholds (under the
   raster stub a depth differs beyond 2.4e-7: the analytic depth's sin);
23. tools/make_goldens.py's six cases on the card
   (androidrenderer_tpu_torch/tools/golden_cases.py): SSIM >= 0.98 against
   tests/goldens/*.png with the goldens' 38 holes on the cornell view taken
   from the golden, and the plain SSIM, printed per case;
24. with --parent-tree only: the unstubbed raster-only and parity frames of
   both trees in turns, kernels per profiled frame within one of the other
   tree's and device ms within 2% of its mean;
25. one JSON line of kernel results (the eight TPU kernels: #1-#4 and #6-#8 of
   the raster family, #5 the gather, each with its call time ``ms``, its
   kernel-only time ``kernel_ms`` and its bound; #1 also at the RSM call site,
   ``rsm_*``, at the VRSAA main view, ``vrsaa_*``, and at the band sites,
   ``band_*`` and ``band_cascade_*``; #2 at the band peel, ``band_peel_*``; then
   the port-queue traversal kernel, at the shadow site with the other sites as
   ``rtao_*``, ``primary_*``, ``rtgi_*``, ``rtgi_shadow_*``, ``peel_*``,
   ``probe_*``, ``probe_shadow_*`` and the refit BVH's ``refit_shadow_*``, with
   the dynamic phase's ``dynamic_*`` times), the card line, and the final JSON
   line.

Launch counts are read per path (the frames of phases 4, 7, 8, 12-15, 19 and 21, the
gather tool of phase 9, the entry-point calls of phase 10, the microbench of
phase 11, each CLI run of phase 16, each rank's frames in phase 20): every count
is set to 0 just before a path runs and read just after, so the launches of the
comparisons never count; every path but phases 12-14's and 19's and the CLI's
probe run must make no traversal launch.

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
    """A launch of the other tree's raster_launch (this tree's signature, as
    since the band mode) on buffers allocated here, or None without one."""
    from androidrenderer_tpu_torch.ops.raster.raster import prepare_raster

    lib = PARENT.get("raster")
    if lib is None:
        return None
    return prepare_raster(records, height, width, depth_only, affine_z, z_limit, alpha_grid,
                          library=lib).launch


def raster_site(label, setup, height, width, depth_only=False, affine_z=False, z_limit=None,
                alpha_grid=None, mirror=False, row_offset=0):
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
    call = prepare_raster(*args, row_offset=row_offset)
    call.launch()
    work = work_counts(call.counts)
    # The other tree's kernel has no row offset: it is timed at full frames only.
    parent = parent_raster_launch(*args) if row_offset == 0 else None
    kernel_ms, parent_ms = in_turns(call.launch, parent)
    text = (f"  {label} kernel-only {kernel_ms * 1e3:.2f} us"
            + ("" if parent_ms is None else f" (other tree's kernel {parent_ms * 1e3:.2f} us)")
            + f"; work: {work['live']} live records, {work['units']} units "
            f"({work['small']} small records, {work['large_units']} tiles of {work['large']} "
            f"large), {work['evaluated']} pixels evaluated of {work['bbox_pixels']} bbox pixels")
    if mirror:
        plain = span_work(rec, height, width, row_offset)
        text += f"; plain mirror's counts equal: {all(work[k] == v for k, v in plain.items())}"
    print(text)
    return dict(kernel_ms=kernel_ms, parent_kernel_ms=parent_ms, work=work)


def parent_trace_launch(bvh, origins, directions, tmin, tmax, any_hit=False, active=None,
                        alpha_bitmap_test=False, masked_any_hit=False, max_steps=1024):
    """A launch of the other tree's traverse_launch (its signature: one thread
    per ray over ``node_rows``) on buffers allocated here, and its outputs; or
    (None, None) without one."""
    import torch

    from androidrenderer_tpu_torch.ops.rt.traverse import _bound

    lib = PARENT.get("traverse")
    if lib is None:
        return None, None
    dev, r = origins.device, origins.shape[0]
    (tmin_s, tmin_t), (tmax_s, tmax_t) = _bound(tmin, "tmin", r, dev), _bound(tmax, "tmax", r, dev)
    out = {k: torch.empty(r, dtype=dt, device=dev) for k, dt in (
        ("t", torch.float32), ("slot", torch.int32), ("u", torch.float32), ("v", torch.float32),
        ("ray_steps", torch.int32))}
    steps = torch.empty(1, dtype=torch.int32, device=dev)
    overflow = torch.empty(1, dtype=torch.bool, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = lib.load().traverse_launch
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(bvh.node_rows.data_ptr(), bvh.node_rows.shape[0], origins.data_ptr(),
              directions.data_ptr(), r, ptr(tmin_t), tmin_s or 0.0, ptr(tmax_t), tmax_s or 0.0,
              ptr(active), int(any_hit), int(masked_any_hit), int(alpha_bitmap_test),
              int(max_steps), *(out[k].data_ptr() for k in ("t", "slot", "u", "v", "ray_steps")),
              steps.data_ptr(), overflow.data_ptr(), None, None, stream) != 0:
            raise RuntimeError("the other tree's traverse_launch failed")

    return launch, out


def bench_camera():
    """The bench camera at 1920x1088 (bench.py:134-144)."""
    import numpy as np

    from androidrenderer_tpu_torch.camera import Camera

    cam = Camera(fov_degrees=75.0, aspect=1920 / 1088, z_near=0.05,
                 render_resolution=(1920, 1088))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    return cam.view_data()


def bench_setup(device):
    """The bench scene (with its BVH), its bake stats, camera and raster-only
    config (bench.py:83-195)."""
    from androidrenderer_tpu_torch.config import raster_only_config
    from androidrenderer_tpu_torch.scene.procedural import courtyard_scene

    cfg = raster_only_config()
    t0 = time.perf_counter()
    BENCH["render_scene"] = courtyard_scene(column_rings=4, detail=13, curtains=True)
    scene, stats = BENCH["render_scene"].build(device=device)
    print(f"scene: {stats} (bake + upload {time.perf_counter() - t0:.1f} s)")
    return cfg, scene, stats, bench_camera()


# A traversal site's keys in the results line.
SITE_KEYS = ("ms", "kernel_ms", "parent_kernel_ms", "ps_per_step", "plain_ms", "bound_ms",
             "bound_by", "rays")
# The band sites' keys in the results line.
BAND_KEYS = ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "index", "work")
# The bench scene's RenderScene (bench_setup), which the dynamic phase reads.
BENCH = {}

# The kernels of csrc/*.cu, by name, for the profile's per-kernel times.
HAND_KERNELS = ("prep_kernel", "scan_kernel", "raster_kernel", "resolve_kernel",
                "gather_partial_kernel", "gather_finish_kernel", "traverse_kernel")

# The card's peaks for the bound (NVIDIA's H100 SXM data sheet: HBM3 rate, and
# float32 outside the tensor cores). The data sheet's 67 TFLOP/s counts a fused
# multiply-add as two operations; the hand kernels are built with -fmad=false
# and issue none, so one float32 instruction does one operation, at half that
# rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2


def raster_bound(setup, height, width, depth_only=False, affine_z=False, z_limit=None,
                 alpha_grid=None, row_offset=0):
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
    bx0, by0, bx1, by1, live = record_bboxes(rec, height, width, row_offset)
    n_live = int(live.sum())
    bbox_px = int(((bx1 - bx0 + 1) * (by1 - by0 + 1))[live].sum())
    zl = None if z_limit is None else z_limit.reshape(-1)
    zl_read = torch.zeros(height * width, dtype=torch.bool, device=rec.device)
    words = torch.zeros(n * 8, dtype=torch.bool, device=rec.device)
    covered = alpha_tests = 0
    for tri, frag in patch_fragments(rec, height, width, affine_z, row_offset=row_offset):
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


# Operations of one test, as csrc/traverse.cu does them: a slab test is 6
# subtractions, 6 products, 6 pairwise min/max, 4 min/max folds and 3 compares
# (25); a Moller-Trumbore test is two cross products (2 x 9), three dot
# products and the determinant's (4 x 5), the guard, divide and 3 scalings (6),
# the tvec differences (3), u + v (1) and 7 compares (55); the bitmap lookup 2
# products, 4 clamps, 2 conversions and 6 integer operations (14); examining a
# lookahead target, its slot compare (1), and its slab test where the slot is
# a node (25).
SLAB_OPS, MT_OPS, BITMAP_OPS, TARGET_OPS = 25, 55, 14, 1
ROW_BYTES = 109 * 4


def traverse_bound(work, rays, active_rays=None, per_ray_tmin=False):
    """(least ms the card could take for one trace, "bytes" or "operations", the
    counts as text), from the work this trace's walk made, counted by the
    kernel (``traverse.work_counts``).

    Operations, each charged where the walk makes it: a slab test per step, 4
    Moller-Trumbore tests per leaf visit (the kernel tests every slot), a
    bitmap lookup per slot that passed, and per inner visit the lookahead
    targets examined up to the first hit and the slab tests run on them, over
    float32's unfused rate (33.5 T/s). Bytes: each distinct node row read once
    (109 x 4 B); for every ray its outputs t, slot, u, v, steps (20 B) and its
    active flag (1 B, where the call passes a mask of ``active_rays``) once;
    for each ray that walks its origin and direction (24 B) and its tmin (4 B,
    where the call passes one per ray) once; over 3.35 TB/s."""
    ops = (work["steps"] * SLAB_OPS + work["leaf_visits"] * 4 * MT_OPS
           + work["bitmap_lookups"] * BITMAP_OPS + work["lookahead_targets"] * TARGET_OPS
           + work["lookahead_slabs"] * SLAB_OPS)
    masked = active_rays is not None
    walking = active_rays if masked else rays
    nbytes = (work["rows"] * ROW_BYTES + rays * (20 + masked)
              + walking * (24 + 4 * per_ray_tmin) + 5)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    text = (f"{work['steps']} steps ({work['steps'] / rays:.1f} per ray), {work['leaf_visits']} "
            f"leaf and {work['inner_visits']} inner visits, {work['lookahead_targets']} "
            f"lookahead targets and {work['lookahead_slabs']} of their slab tests, "
            f"{work['bitmap_lookups']} bitmap lookups, {work['rows']} distinct rows; "
            f"{nbytes / 1e6:.3f} MB = {t_bytes * 1e3:.2f} us, {ops / 1e9:.3f} G ops = "
            f"{t_ops * 1e3:.2f} us")
    return (t_bytes, "bytes", text) if t_bytes >= t_ops else (t_ops, "operations", text)


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
                                                     "alpha_grid", "row_offset")}
    got = fn(setup, height, width, **kw)
    want = rasterize_reference(setup, height, width, **plain_kw)
    torch.cuda.synchronize()
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    eq = all(torch.equal(g, r) for g, r in zip(got_t, want_t))
    err = (got_t[0] - want_t[0]).abs().max().item()
    ms = cuda_ms(lambda: fn(setup, height, width, **kw))
    plain_ms = cuda_ms(lambda: rasterize_reference(setup, height, width, **plain_kw))
    bound_ms, bound_by, work = raster_bound(setup, height, width, **plain_kw)
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
    """Every kernel entry point by name: the raster family's, the design
    studies' included, and the traversal's; each counts its own launches."""
    from androidrenderer_tpu_torch.ops.raster import rasterize
    from androidrenderer_tpu_torch.ops.raster.raster_binned import rasterize_binned
    from androidrenderer_tpu_torch.ops.raster.raster_fused import (
        rasterize_fused, rasterize_hybrid,
    )
    from androidrenderer_tpu_torch.ops.raster.raster_pallas import rasterize_pallas
    from androidrenderer_tpu_torch.tools.experiments.raster_lanes import rasterize_lanes
    from androidrenderer_tpu_torch.tools.experiments.raster_subfold import rasterize_subfold
    from androidrenderer_tpu_torch.ops.rt.traverse import trace_rays
    from androidrenderer_tpu_torch.tools.experiments.raster_touch import rasterize_touch

    return {f.__name__: f for f in (
        rasterize, rasterize_binned, rasterize_fused, rasterize_hybrid, rasterize_pallas,
        rasterize_touch, rasterize_lanes, rasterize_subfold, trace_rays)}


def gather_checks():
    """Phase 9: (result dict, ok). The path is the gather tool's main() at its
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
    """Phase 10: (results by entry point, launches by entry point, ok). The path
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
    """Phase 11: (ms per raster by mode and label, the step split by mode,
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


def run_frames(label, cfg, scene, view, profile: bool, per_frame: dict, chains: int = 4):
    """Phases 4, 7 and 8: (median ms/frame, launches by entry point, frames, failed
    checks, last outputs, temporal state): 3 warm-up frames, then ``chains``
    chains of 10. ``per_frame`` is the launches each entry point must make per
    frame; every other entry point must make none."""
    import numpy as np
    import torch

    from androidrenderer_tpu_torch.config import RenderParams
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
    for _ in range(chains):
        t0 = time.perf_counter()
        for _ in range(chain):
            out, temp = renderer(scene, view, params, temp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / chain)
    launches = {name: f.launches for name, f in eps.items()}
    frames = 3 + chains * chain
    total = sum(launches.values())
    ms = float(np.median(times))
    print(f"{label} {cfg.render_width}x{cfg.render_height} chained frame times (ms): "
          f"{[round(t, 3) for t in times]}; median {ms:.3f} ms/frame")
    print(f"{label} kernel launches: {total} over {frames} frames = {total / frames} per frame "
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
        out, temp = profile_frames(label, renderer, scene, view, params, temp, stages=True)
    return ms, launches, frames, problems, out, temp


# The last profile of each label (profile_frames): wall and device busy ms and
# kernels per profiled frame.
PROFILES = {}


def profile_frames(label, renderer, scene, view, params, temp, stages: bool):
    """3 frames under torch.profiler: prints the wall and device busy ms and the
    kernels per frame (kept in ``PROFILES[label]``) and, with ``stages``, the
    table of 80 rows (written beside the kernel build), each ``frame/*`` range's
    host and device time and the hand kernels per frame. Returns the last
    (outputs, temporal state)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from androidrenderer_tpu_torch.ops.cuda_build import BUILD_DIR

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
    n_kernels = sum(e.count for e in kernels) / 3
    PROFILES[label] = dict(wall_ms=wall_ms, device_ms=busy_ms, kernels=n_kernels)
    print(f"{label} profiled frame: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.1%}), {n_kernels:.0f} kernels")
    if not stages:
        return out, temp
    dest = BUILD_DIR / f"torch_frame_profile_{label.replace(' ', '_')}.txt"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(events.table(sort_by="cuda_time_total", row_limit=80))
    print(f"{label} profile of 3 frames written to {dest.relative_to(REPO)}")
    # A range's "torch kernels" are those of the PyTorch ops inside it; the
    # hand kernels, launched through ctypes, are not attributed to a range:
    # they count in the busy total and are listed by name below. The device
    # span is the range's extent on the device's timeline, gaps included.
    spans = {e.key: device_us(e, False) for e in events
             if e.key.startswith("frame/") and e.cpu_time_total == 0}
    for e in sorted(events, key=lambda e: -e.cpu_time_total):
        if e.key.startswith("frame/") and e.cpu_time_total > 0:
            print(f"  {e.key:18s} host {e.cpu_time_total / 1e3 / 3:8.3f} ms, "
                  f"torch kernels {device_us(e, True) / 1e3 / 3:8.3f} ms, "
                  f"device span {spans.get(e.key, 0.0) / 1e3 / 3:8.3f} ms per frame")
    hand = [(name, sum(device_us(e, False) for e in kernels if f"::{name}" in e.key),
             sum(e.count for e in kernels if f"::{name}" in e.key)) for name in HAND_KERNELS]
    print("  hand kernels per frame: " + ", ".join(
        f"{name} {n / 3:.0f}x {us / 1e3 / 3:.3f} ms" for name, us, n in hand if n))
    return out, temp


def card_vs_cpu(label="raster-only", overrides=None, curtains=False, cfg=None,
                max_far=0.005, max_depth=0.005, moving=False, depth_atol=0.0):
    """Phases 5, 8 and 12-15: a 128^2 courtyard frame on the card and on the CPU,
    3 chained frames: (the largest share of pixels off by more than one u8 step,
    the largest share of depths differing, each within its bound; under VRSAA
    also the dropped counts, equal).
    ``overrides`` (RenderConfig fields) turn the raster-only config into A or B;
    ``cfg`` replaces it (the parity frame renders 128^2 into a 192^2 output).
    ``moving``: the camera steps and turns each frame with that frame's TAA
    jitter, so the motion vectors and the history reprojection do work.
    ``depth_atol``: a depth counts as differing when it differs by more (0:
    any difference)."""
    import numpy as np

    from androidrenderer_tpu_torch.camera import Camera, taa_jitter
    from androidrenderer_tpu_torch.config import RenderParams, raster_only_config
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
    from androidrenderer_tpu_torch.scene.procedural import courtyard_scene
    from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

    n = 128
    if cfg is None:
        cfg = raster_only_config(n, n, shadow_cascade_resolution=128, **(overrides or {}))
    cam = Camera(fov_degrees=cfg.fov_degrees, aspect=cfg.output_width / cfg.output_height,
                 z_near=cfg.z_near, render_resolution=(cfg.render_width, cfg.render_height))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    views = []
    for i in range(3):
        if moving:
            cam.set_jitter(taa_jitter(i + 1))
        views.append(cam.view_data())
        if moving:
            cam.end_frame()
            cam.translate_local([0.04, 0.0, -0.15])
            cam.rotate(0.004, -0.01)
    leaves, _ = courtyard_scene(curtains=curtains).bake()

    outs = {}
    for dev in ("cuda", "cpu"):
        scene = scene_arrays_from_numpy(leaves, dev)
        renderer = make_renderer(cfg)
        temp = temporal_state_for(cfg, device=dev)
        frames = []
        for view in views:
            out, temp = renderer(scene, view, RenderParams.default(), temp)
            dropped = None if out.vrsaa_dropped is None else int(out.vrsaa_dropped)
            frames.append((out.image.cpu().numpy(), out.depth.cpu().numpy(), dropped))
        outs[dev] = frames
    pairs = list(zip(outs["cuda"], outs["cpu"]))
    img_d = max(int(np.abs(a[0].astype(int) - b[0].astype(int)).max()) for a, b in pairs)
    far = max(float((np.abs(a[0].astype(int) - b[0].astype(int)) > 1).mean()) for a, b in pairs)
    dep_d = max(float(np.abs(a[1] - b[1]).max()) for a, b in pairs)
    dep_share = max(float((~(np.abs(a[1] - b[1]) <= depth_atol)).mean()) for a, b in pairs)
    dropped = [(a[2], b[2]) for a, b in pairs]
    print(f"card vs CPU, {label} {cfg.render_width}^2 courtyard, 3 frames: max|d image|={img_d} "
          f"(share > 1 step {far:.5f}, bound {max_far}), max|d depth|={dep_d} "
          f"(share differing {dep_share:.5f}, bound {max_depth})"
          + (f"; VRSAA dropped (card, CPU) {dropped}" if dropped[0][0] is not None else ""))
    return far <= max_far and dep_share <= max_depth and all(a == b for a, b in dropped)


def parity_view(cfg):
    """The bench camera (bench.py:134-144) at the parity frame's render resolution."""
    import numpy as np

    from androidrenderer_tpu_torch.camera import Camera

    cam = Camera(fov_degrees=cfg.fov_degrees, aspect=cfg.output_width / cfg.output_height,
                 z_near=cfg.z_near, render_resolution=(cfg.render_width, cfg.render_height))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    return cam.view_data()


def rsm_checks(cfg, scene, view):
    """Phase 8's RSM call site: every LPV cascade's RSM of the proxy mesh, its
    setup derived from the canonical one as the frame derives it, through
    rasterize against the plain version: (cascade 0's results, ok)."""
    import torch

    from androidrenderer_tpu_torch.ops import lpv
    from androidrenderer_tpu_torch.scene.proxy import swap_in_proxy

    dev = scene.positions.device
    gi_scene = swap_in_proxy(scene)
    inv_view = torch.as_tensor(view.inverse_view, device=dev)
    mins, cells = lpv.cascade_origins(
        torch.as_tensor(view.position, device=dev), -inv_view[:3, 2], cfg.lpv_num_cascades,
        cfg.lpv_resolution, cfg.lpv_cell_size, cfg.lpv_behind_camera_percent,
    )
    res = cfg.lpv_rsm_resolution
    m_canon, setup_rsm, centers, radii = lpv._canonical_rsm_setup(
        gi_scene, mins, cells, cfg.lpv_resolution, res)
    rasterize = entry_points()["rasterize"]
    results, ok = [], True
    for k in range(cfg.lpv_num_cascades):
        setup = lpv.rsm_setup(gi_scene, setup_rsm, m_canon, centers[k], radii[k], res)
        (_, vis), r = compare(f"rasterize RSM cascade {k} (proxy)", rasterize, setup, res, res)
        ok &= r["eq"] and bool((vis >= 0).any())
        results.append(r)
    return results[0], ok


def gi_changes_hdr(label, cfg, scene, view, temp):
    """A failed check's text, or None when the frame with GI differs in HDR
    from the same frame with GI off, both from one state."""
    from androidrenderer_tpu_torch.config import GIMode, RenderParams
    from androidrenderer_tpu_torch.render import make_renderer

    lit, _ = make_renderer(cfg)(scene, view, RenderParams.default(), temp)
    unlit, _ = make_renderer(cfg.replace(gi_mode=GIMode.OFF))(
        scene, view, RenderParams.default(), temp)
    gi_d = (lit.hdr - unlit.hdr).abs()
    print(f"{label} with GI against without, from one state: max|d hdr|="
          f"{gi_d.max().item():.6g}, mean {gi_d.mean().item():.6g}; hdr mean "
          f"{lit.hdr.mean().item():.6g}, hdr {tuple(lit.hdr.shape)}")
    return None if gi_d.max().item() > 0 else f"{label}: GI changes nothing in the HDR"


def parity_phase(scene, profile: bool, card: str):
    """Phase 8: (the RSM call site's results, launches by entry point, failed
    checks) of the parity frame on the bench scene."""
    from androidrenderer_tpu_torch.config import parity_frame_config

    cfg = parity_frame_config()
    view = parity_view(cfg)
    rsm, ok = rsm_checks(cfg, scene, view)
    if not ok:
        return rsm, {}, ["the kernel and the plain version disagree at the RSM call site"]
    ms, launches, _, problems, out, temp = run_frames(
        "parity", cfg, scene, view, profile, {"rasterize": 4})
    problems += [x for x in [gi_changes_hdr("parity frame", cfg, scene, view, temp)] if x]
    if float(out.hdr.amax()) == float(out.hdr.amin()):
        problems.append("HDR is constant")
    print(f"parity_frame_ms: {ms:.3f} ({card})")
    # Phase 5's bounds, the camera moving and jittered. Measured on an H100
    # with a static camera: no pixel off by more than one u8 step and no depth
    # differing (the SSAO, LPV and TAAU stages are float math that rounds alike
    # on both devices at this size; PERF.md).
    n = 128
    small = parity_frame_config(192, 192, n, n, shadow_cascade_resolution=n)
    if not card_vs_cpu("parity (camera moving, jittered)", cfg=small, max_far=0.005,
                       max_depth=0.005, moving=True):
        problems.append("the 128^2 parity frames on the card and the CPU disagree")
    return rsm, launches, problems


def subset(n: int, seed: int):
    """The sorted 65,536 of ``n`` rays a site's plain comparison runs on."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.sort(rng.choice(n, 65536, replace=False))).cuda()


def layout_mb(bvh) -> float:
    """MB of the traversal kernel's layout of ``bvh``."""
    from androidrenderer_tpu_torch.ops.rt.traverse import LAYOUT_FIELDS

    return sum(getattr(bvh, f).numel() * 4 for f in LAYOUT_FIELDS) / 1e6


def trace_site(label, bvh, origins, directions, tmin, tmax, any_hit, sample, active=None,
               masked_any_hit=False, bitmap=True, site="rt_shadow"):
    """The traversal kernel against its plain version at one call site: the
    kernel on every ray and on the ``sample`` subset, the plain version on the
    subset (bit-equal), times and the bound; the other tree's kernel
    (--parent-csrc) in turns on every ray. ``tmin`` may be per ray, as
    ``active``; ``masked_any_hit`` and ``bitmap`` (the alpha bitmap test) as
    the call site passes them, and the refill policy of ``site``
    (traverse.SCATTERED). Returns a dict with ``eq``."""
    import torch

    from androidrenderer_tpu_torch.ops.rt.traverse import (
        SCATTERED, prepare_trace, trace_rays, trace_rays_reference, work_counts,
    )
    from androidrenderer_tpu_torch.tools.kernel_timing import in_turns

    kw = dict(any_hit=any_hit, alpha_bitmap_test=bitmap, masked_any_hit=masked_any_hit,
              active=active)
    scattered = SCATTERED[site]
    per_ray_tmin = isinstance(tmin, torch.Tensor)
    kw_s = dict(kw, active=None if active is None else active[sample].contiguous())
    tmin_s = tmin[sample].contiguous() if per_ray_tmin else tmin
    fields = ("slot", "t", "u", "v", "ray_steps")
    full = trace_rays(bvh, origins, directions, tmin, tmax, scattered=scattered, **kw)
    o_s, d_s = origins[sample].contiguous(), directions[sample].contiguous()
    got = trace_rays(bvh, o_s, d_s, tmin_s, tmax, scattered=scattered, **kw_s)
    want = trace_rays_reference(bvh, o_s, d_s, tmin_s, tmax, **kw_s)
    torch.cuda.synchronize()
    eq = all(torch.equal(getattr(got, f), getattr(want, f))
             for f in fields + ("steps", "overflow"))
    same_rays = all(torch.equal(getattr(full, f)[sample], getattr(got, f)) for f in fields)
    err = max((getattr(got, f).double() - getattr(want, f).double()).abs().max().item()
              for f in ("t", "u", "v"))
    finite = all(bool(torch.isfinite(getattr(full, f)).all()) for f in ("t", "u", "v"))
    ms = cuda_ms(lambda: trace_rays(bvh, origins, directions, tmin, tmax, scattered=scattered,
                                    **kw))
    call = prepare_trace(bvh, origins, directions, tmin, tmax, scattered=scattered, **kw)
    parent, parent_out = parent_trace_launch(bvh, origins, directions, tmin, tmax, **kw)
    kernel_ms, parent_ms = in_turns(call.launch, parent)
    counted = prepare_trace(bvh, origins, directions, tmin, tmax, counts=True,
                            scattered=scattered, **kw)
    counted.launch()
    work = work_counts(counted)
    r = origins.shape[0]
    n_active = None if active is None else int(active.sum())
    bound_ms, bound_by, text = traverse_bound(work, r, n_active, per_ray_tmin)
    plain_ms = cuda_ms(lambda: trace_rays_reference(bvh, o_s, d_s, tmin_s, tmax, **kw_s), reps=1)
    hits = (full.slot >= 0).float().mean().item()
    mode = ("masked any" if masked_any_hit else "any" if any_hit else "closest") + "-hit"
    mode += ", alpha bitmaps" if bitmap else ", no bitmaps"
    mode += ", per-ray tmin" if per_ray_tmin else ""
    mode += ", scattered" if scattered else ""
    if active is not None:
        mode += f", {n_active} active"
    ps_step = kernel_ms * 1e9 / max(work["steps"], 1)
    other = ""
    if parent is not None:
        torch.cuda.synchronize()
        agree = all(torch.equal(parent_out[f], getattr(full, f)) for f in fields)
        other = (f" (other tree's kernel {parent_ms * 1e3:.1f} us, "
                 f"{parent_ms * 1e9 / max(work['steps'], 1):.1f} ps/step, same outputs: {agree})")
    print(f"traverse {label}: {r} rays ({mode}), "
          f"hit {hits:.4f}, longest walk {int(full.steps)}, overflow {bool(full.overflow)}; "
          f"{sample.numel()}-ray subset bit-equal={eq} (max|d t,u,v|={err}), kernel on all rays "
          f"= kernel on the subset: {same_rays}, finite: {finite}; call {ms:.3f} ms, "
          f"kernel-only {kernel_ms * 1e3:.1f} us, {ps_step:.1f} ps/step{other}, "
          f"layout {layout_mb(bvh):.1f} MB, plain (subset) {plain_ms:.1f} ms, "
          f"bound {bound_ms * 1e3:.2f} us ({bound_by}: {text}); library: none")
    return dict(eq=eq and same_rays and finite and not bool(full.overflow), err=err, ms=ms,
                kernel_ms=kernel_ms, parent_kernel_ms=parent_ms, ps_per_step=ps_step,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, hit_share=hits,
                longest_walk=int(full.steps), work=work, rays=r, plain_rays=sample.numel())


def rt_phase(scene, stats, view, profile: bool, card: str):
    """Phase 12: (the three call sites' results, launches by entry point, failed
    checks) of the RT frame on the bench scene."""
    import torch

    from androidrenderer_tpu_torch.config import (
        AOMode, RenderParams, ShadowMode, default_frame_config,
    )
    from androidrenderer_tpu_torch.ops import sky
    from androidrenderer_tpu_torch.ops.rt import effects
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for

    bvh = scene.bvh
    m, slots = bvh.node_rows.shape[0], bvh.slot_tri.shape[0]
    print(f"BVH: builder {stats['bvh_builder']}, {stats['bvh_s']:.2f} s; {m} nodes, {slots} slots, "
          f"node_rows {tuple(bvh.node_rows.shape)} = {bvh.node_rows.numel() * 4 / 1e6:.1f} MB")
    # The kernel's layout beside the rows, and what building it anew costs.
    from androidrenderer_tpu_torch.ops.rt.traverse import LAYOUT_FIELDS, with_kernel_layout

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build_ms = cuda_ms(lambda: with_kernel_layout(bvh), reps=3)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"kernel layout {layout_mb(bvh):.1f} MB ("
          + ", ".join(f"{f} {tuple(getattr(bvh, f).shape)} {getattr(bvh, f).numel() * 4 / 1e6:.1f} MB"
                      for f in LAYOUT_FIELDS)
          + f"); building it anew: {build_ms:.3f} ms, peak {peak / 1e6:.1f} MB above the "
          f"scene's {base / 1e6:.1f} MB ({card})")
    cfg = default_frame_config(1920, 1088, shadow_mode=ShadowMode.RT, ao_mode=AOMode.RT)
    params = RenderParams.default()
    first, _ = make_renderer(cfg)(scene, view, params, temporal_state_for(cfg, device="cuda"))
    g = first.gbuffer
    h, w = g.valid.shape
    sample = subset(h * w, 6)
    sky_share = (~g.valid.reshape(-1)[sample]).float().mean().item()
    print(f"RT frame's first gbuffer {h}x{w}: subset of 65536 rays, {sky_share:.4f} of them sky")
    o_s, d_s = effects.sun_shadow_rays(g.world_position, g.normal, scene.sun_direction,
                                       scene.sun_angular_size, 0)
    d_ao = effects.rtao_directions(g.normal, 0, cfg.rtao_num_samples, 0)
    inv_view = torch.as_tensor(view.inverse_view, device="cuda")
    d_p = sky.view_ray_directions(inv_view, float(view.projection[0, 0]),
                                  float(view.projection[1, 1]), h, w).reshape(-1, 3).contiguous()
    o_p = inv_view[:3, 3].expand(h * w, 3).contiguous()
    sites = {
        "shadow": trace_site("shadow rays", bvh, o_s, d_s, effects.RAY_EPS, 1e30, True, sample),
        "rtao": trace_site("RTAO sample 0", bvh, o_s, d_ao, effects.RAY_EPS,
                           params.rtao_max_distance, True, sample, site="rtao"),
        "primary": trace_site("primary rays", bvh, o_p, d_p, 0.0, 1e30, False, sample,
                              site="primary"),
    }
    problems = [f"the kernel and the plain version disagree at the {k} site"
                for k, r in sites.items() if not r["eq"]]
    if sky_share == 0.0:
        problems.append("the subset holds no sky pixel")
    if problems:
        return sites, {}, problems
    ms, launches, _, problems, out, _ = run_frames(
        "frame RT", cfg, scene, view, profile, {"rasterize": 4, "trace_rays": 5})
    print(f"frame_RT_ms: {ms:.3f} ({card})")
    # Phase 5's bounds. Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W), first
    # run: max |d u8| 0, no depth differing. The traversal is bit-equal on both
    # devices; what may differ is the rays' noise directions (libm's sin/cos on
    # the CPU, CUDA's on the card, apart by ulps), which can flip a grazing ray.
    overrides = dict(occlusion_culling=True, translucency=True, shadow_mode=ShadowMode.RT,
                     ao_mode=AOMode.RT)
    if not card_vs_cpu("frame RT", overrides, curtains=True, max_far=0.005, max_depth=0.005):
        problems.append("the 128^2 RT frames on the card and the CPU disagree")
    return sites, launches, problems


def rtgi_phase(scene, view, profile: bool, card: str):
    """Phase 13: (the RTGI and exact-peel sites' results, launches by entry
    point, failed checks) of the RTGI frame on the bench scene."""
    import torch

    from androidrenderer_tpu_torch.config import (
        AOMode, GIMode, RenderParams, ShadowMode, default_frame_config,
    )
    from androidrenderer_tpu_torch.ops.rt import effects
    from androidrenderer_tpu_torch.ops.rt.traverse import SCATTERED, trace_rays
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for

    bvh = scene.bvh
    cfg = default_frame_config(1920, 1088, shadow_mode=ShadowMode.RT, ao_mode=AOMode.RT,
                               gi_mode=GIMode.RT)
    params = RenderParams.default()
    first, _ = make_renderer(cfg)(scene, view, params, temporal_state_for(cfg, device="cuda"))
    g = first.gbuffer
    h, w = g.valid.shape
    sample = subset(h * w, 6)
    eps = effects.RAY_EPS
    # RTGI's first bounce: the GI rays of valid pixels, then a sun ray from
    # each front-face hit.
    valid = g.valid.reshape(-1).contiguous()
    o, d = effects.gi_rays(g.world_position, g.normal, 0)
    hits = trace_rays(bvh, o, d, eps, 1e30, active=valid, alpha_bitmap_test=True,
                      scattered=SCATTERED["rtgi_rays"])
    hp, hn, front = effects.hit_geometry(scene, bvh, o, d, hits)
    sun = scene.sun_direction
    to_sun = -sun / torch.sqrt((sun * sun).sum())
    lit = ((hits.slot >= 0) & valid & front).contiguous()
    # The exact alpha peel: the shadow rays' first peel (masked any-hit), then
    # the second from each ignored hit's own t, for the rays it left unresolved.
    o_s, d_s = effects.sun_shadow_rays(g.world_position, g.normal, sun, scene.sun_angular_size, 0)
    peel1 = trace_rays(bvh, o_s, d_s, eps, 1e30, any_hit=True, masked_any_hit=True)
    slot = peel1.slot.clamp(min=0).long()
    opaque = scene.tri_alpha_mode[bvh.slot_tri[slot].clamp(min=0).long()] != 1
    unresolved = ((peel1.slot >= 0) & ~opaque
                  & ~effects._hit_alpha_passes(scene, bvh, peel1)).contiguous()
    t0 = torch.where(unresolved, peel1.t, torch.full_like(peel1.t, eps)).contiguous()
    sites = {
        "rtgi": trace_site("RTGI rays", bvh, o, d, eps, 1e30, False, sample, active=valid,
                           site="rtgi_rays"),
        "rtgi_shadow": trace_site("RTGI hit-point sun rays", bvh, (hp + hn * 0.02).contiguous(),
                                  to_sun.expand(hp.shape).contiguous(), eps, 1e30, True, sample,
                                  active=lit, site="rtgi_sun"),
        "peel": trace_site("exact alpha peel, shadow rays' second peel", bvh, o_s, d_s, t0, 1e30,
                           True, sample, active=unresolved, masked_any_hit=True, bitmap=False),
    }
    problems = [f"the kernel and the plain version disagree at the {k} site"
                for k, r in sites.items() if not r["eq"]]
    if not bool(unresolved.any()):
        problems.append("no shadow ray's first peel ignored a masked hit")
    if problems:
        return sites, {}, problems
    # 1 shadow + 4 RTAO traces, then per GI bounce one closest-hit and one sun
    # trace (effects.rtgi, rtgi_num_bounces=1; the bitmap paths trace once
    # each); the rasters of A less the cascades (occlusion 2, translucency 2).
    per_frame = {"rasterize": 4, "trace_rays": 5 + 2 * cfg.rtgi_num_bounces}
    ms, launches, _, problems, out, temp = run_frames("frame RTGI", cfg, scene, view, profile,
                                                      per_frame)
    print(f"frame_RTGI_ms: {ms:.3f} ({card})")
    problems += [x for x in [gi_changes_hdr("frame RTGI", cfg, scene, view, temp)] if x]
    # 3 chained frames, so the temporal accumulation runs. Bounds: no more than
    # 1% of pixels off by more than one u8 step (the GI rays' cosine directions
    # come from libm's sin/cos on the CPU and CUDA's on the card, apart by ulps:
    # a grazing ray can flip between hit and sky, and the a-trous filter
    # spreads it), depths as phase 5.
    overrides = dict(occlusion_culling=True, translucency=True, shadow_mode=ShadowMode.RT,
                     ao_mode=AOMode.RT, gi_mode=GIMode.RT)
    if not card_vs_cpu("frame RTGI", overrides, curtains=True, max_far=0.01, max_depth=0.005):
        problems.append("the 128^2 RTGI frames on the card and the CPU disagree")
    return sites, launches, problems


def probes_phase(scene, view, profile: bool, card: str):
    """Phase 14: (the probe sites' results, launches by entry point, failed
    checks) of the probe frame on the bench scene."""
    import torch

    from androidrenderer_tpu_torch.config import GIMode, default_frame_config
    from androidrenderer_tpu_torch.ops import probes
    from androidrenderer_tpu_torch.ops.rt import effects
    from androidrenderer_tpu_torch.ops.rt.traverse import SCATTERED, trace_rays
    from androidrenderer_tpu_torch.render import temporal_state_for

    bvh = scene.bvh
    cfg = default_frame_config(1920, 1088, gi_mode=GIMode.PROBES)
    state = temporal_state_for(cfg, device="cuda").probes
    cam = torch.as_tensor(view.position, dtype=torch.float32, device="cuda")
    plan = probes.probe_rays(state, cam, cfg.probe_grid, cfg.probe_spacing, cfg.probe_budget,
                             cfg.probe_rays, 0, cfg.probe_spacing_ladder)
    o, d = plan.origins, plan.directions
    n = o.shape[0]
    print(f"probe update: {cfg.probe_cascades} cascades of {cfg.probe_grid}, budget "
          f"{cfg.probe_budget}, {cfg.probe_rays} rays: {n} probe rays per frame")
    sample = subset(n, 7)
    hits = trace_rays(bvh, o, d, 0.01, 1e30, alpha_bitmap_test=True,
                      scattered=SCATTERED["probe_rays"])
    hp, hn, _ = effects.hit_geometry(scene, bvh, o, d, hits)
    sun = scene.sun_direction
    to_sun = -sun / torch.sqrt((sun * sun).sum())
    sites = {
        "probe": trace_site("probe rays", bvh, o, d, 0.01, 1e30, False, sample,
                            site="probe_rays"),
        "probe_shadow": trace_site("probe hit-point sun rays", bvh, (hp + hn * 0.02).contiguous(),
                                   to_sun.expand(hp.shape).contiguous(), 0.01, 1e30, True,
                                   sample, active=(hits.slot >= 0).contiguous(),
                                   site="probe_sun"),
    }
    problems = [f"the kernel and the plain version disagree at the {k} site"
                for k, r in sites.items() if not r["eq"]]
    if problems:
        return sites, {}, problems
    # A's rasters (occlusion 2, translucency 2, cascade 0, one far cascade) and
    # the probe update's two traces (every cascade's rays in one closest-hit
    # trace, their sun rays in one any-hit trace).
    ms, launches, _, problems, out, temp = run_frames(
        "frame probes", cfg, scene, view, profile, {"rasterize": 6, "trace_rays": 2})
    print(f"frame_probes_ms: {ms:.3f} ({card})")
    problems += [x for x in [gi_changes_hdr("frame probes", cfg, scene, view, temp)] if x]
    # A smaller cache than the frame's: the plain walk of 409,600 rays per frame
    # is too slow on the CPU for this script's limit. 3 chained frames (the
    # hysteresis blend runs); phase 5's bounds (the probe rays' directions
    # differ by ulps of sin/cos between the two devices).
    overrides = dict(occlusion_culling=True, translucency=True, gi_mode=GIMode.PROBES,
                     probe_grid=(8, 4, 8), probe_budget=32, probe_rays=64)
    if not card_vs_cpu("frame probes (cache 4 x (8, 4, 8), budget 32, 64 rays)", overrides,
                       curtains=True, max_far=0.005, max_depth=0.005):
        problems.append("the 128^2 probe frames on the card and the CPU disagree")
    return sites, launches, problems


def vrsaa_phase(scene, profile: bool, card: str):
    """Phase 15: (the 3840x2176 main view's results, launches by entry point,
    failed checks) of the CLI's --aa vrsaa frame on the bench scene."""
    from androidrenderer_tpu_torch.config import AAMode, RenderParams, default_frame_config
    from androidrenderer_tpu_torch.render import frame as frame_mod
    from androidrenderer_tpu_torch.render import make_renderer
    from androidrenderer_tpu_torch.render.frame import main_view_setup

    # Frame A as the CLI's --aa vrsaa builds it (headless.py: geometry at twice
    # the output, translucency off).
    cfg = default_frame_config(1920, 1088, aa_mode=AAMode.VRSAA, translucency=False).replace(
        render_width=3840, render_height=2176)
    view = parity_view(cfg)
    _, opaque, grid = main_view_setup(scene, view, cfg)
    (_, vis), site = compare("rasterize VRSAA main view + alpha grid", entry_points()["rasterize"],
                             opaque, cfg.render_height, cfg.render_width, alpha_grid=grid)
    covered = (vis >= 0).float().mean().item()
    if not site["eq"] or covered < 0.5:
        return site, {}, [f"the 2x main view: bit-equal={site['eq']}, covered {covered:.4f}"]
    # render/frame.py under VRSAA: _occlusion_raster's two phases at 3840x2176,
    # then _shadows' staggered cascades (cascade 0 and one far cascade with
    # shadow_update_budget=1); no translucency, no traced switch.
    ms, launches, _, problems, out, temp = run_frames(
        "frame VRSAA", cfg, scene, view, profile, {"rasterize": 4})
    print(f"frame_vrsaa_ms: {ms:.3f} ({card})")
    # One more frame, recording the fine-quad mask the worklist compacts.
    seen = {}
    worklist = frame_mod.vrsaa_ops.fine_worklist

    def recorded(fine, budget):
        seen.update(fine=int(fine.sum()), budget=budget)
        return worklist(fine, budget)

    frame_mod.vrsaa_ops.fine_worklist = recorded
    try:
        out, _ = make_renderer(cfg)(scene, view, RenderParams.default(), temp)
    finally:
        frame_mod.vrsaa_ops.fine_worklist = worklist
    dropped = int(out.vrsaa_dropped)
    print(f"frame VRSAA: {seen['fine']} fine quads of {cfg.output_width * cfg.output_height}, "
          f"budget {seen['budget']}, vrsaa_dropped {dropped}; coarse grid "
          f"{tuple(out.depth.shape)}, HDR finite {bool(out.hdr.isfinite().all())}")
    if dropped != max(seen["fine"] - seen["budget"], 0):
        problems.append(f"vrsaa_dropped {dropped} != {seen['fine']} fine quads - budget")
    if tuple(out.depth.shape) != (cfg.output_height, cfg.output_width):
        problems.append(f"the coarse grid is {tuple(out.depth.shape)}")
    n = 128
    small = default_frame_config(n, n, shadow_cascade_resolution=n, aa_mode=AAMode.VRSAA,
                                 translucency=False).replace(render_width=2 * n,
                                                             render_height=2 * n)
    if not card_vs_cpu("frame VRSAA (128^2 output, 256^2 render)", cfg=small, curtains=True):
        problems.append("the 128^2 VRSAA frames on the card and the CPU disagree")
    return site, launches, problems


def write_textured_gltf(folder: Path) -> Path:
    """A one-quad glTF whose base-color texture is ETC1S KTX2 and whose
    metal-rough texture is UASTC KTX2 (neither Zstd), written by the port's
    ktx2.write_ktx2, as tests/test_torch_app.py writes one."""
    import base64

    import numpy as np

    from androidrenderer_tpu_torch.scene import ktx2

    folder.mkdir(parents=True, exist_ok=True)
    img = np.random.default_rng(12).integers(0, 256, (16, 16, 4)).astype(np.uint8)
    img[..., 3] = 255
    levels = [img, img[::2, ::2].copy(), img[::4, ::4].copy()]
    (folder / "base.ktx2").write_bytes(ktx2.write_ktx2(levels, fmt="etc1s"))
    (folder / "mr.ktx2").write_bytes(ktx2.write_ktx2(levels, fmt="uastc"))
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    buf = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes()
    views = [(0, 48), (48, 48), (96, 32), (128, 12)]
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
                                    "indices": 3, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                "metallicRoughnessTexture": {"index": 1}}}],
        "textures": [{"extensions": {"KHR_texture_basisu": {"source": k}}} for k in (0, 1)],
        "images": [{"uri": f"{name}.ktx2", "mimeType": "image/ktx2"} for name in ("base", "mr")],
        "buffers": [{"byteLength": len(buf), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(buf).decode()}],
        "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": n} for o, n in views],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3",
             "min": [-1, -1, 0], "max": [1, 1, 0]},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
    }
    path = folder / "scene.gltf"
    path.write_text(json.dumps(gltf))
    return path


def cli_phase(card: str):
    """Phase 16: (launches by entry point summed over the runs, failed checks)
    of the headless CLI run in this process on the card, at 1920x1088 on
    courtyard-big (the PNGs under build/cli/), one run per switch."""
    import torch

    from androidrenderer_tpu_torch.app import application, headless
    from androidrenderer_tpu_torch.ops.visualize import MODES, visualize

    out_dir = REPO / "build" / "cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    size = ["--width", "1920", "--height", "1088"]
    big = ["--scene", "courtyard-big"] + size
    gltf = write_textured_gltf(out_dir / "gltf")
    # Raster launches per frame of the CLI's config on courtyard-big (no blend
    # triangles, so no translucency; shadow_update_budget=0, so all 4 cascades
    # every frame): 2 occlusion phases + 4 cascades = 6. LPV GI
    # (lpv_update_budget=0) rebuilds all 4 cascades' RSMs every frame: + 4; each
    # LPV visualizer rebuilds them once more (+ 4) and vpl renders one more RSM
    # (+ 1). The probe update traces twice per frame (probe rays, their sun
    # rays). The glTF quad: 2 + 4.
    runs = (  # (label, PNG, arguments, launches per run)
        ("--aa taa --frames 3 --interpolate", "taa", big + [
            "--aa", "taa", "--frames", "3", "--orbit", "0.02", "--interpolate"],
         {"rasterize": 3 * 6}),
        ("--aa vrsaa --frames 2", "vrsaa", big + ["--aa", "vrsaa", "--frames", "2"],
         {"rasterize": 2 * 6}),
        ("--set r.GI.Mode=1 --set r.GI.LPV.Exposure=40 --visualize lpv-gv", "lpv-gv",
         big + ["--set", "r.GI.Mode=1", "--set", "r.GI.LPV.Exposure=40", "--visualize",
                "lpv-gv"], {"rasterize": 10 + 4}),
        ("--gi lpv --visualize lpv-radiance", "lpv-radiance",
         big + ["--gi", "lpv", "--visualize", "lpv-radiance"], {"rasterize": 10 + 4}),
        ("--gi lpv --visualize vpl", "vpl", big + ["--gi", "lpv", "--visualize", "vpl"],
         {"rasterize": 10 + 5}),
        ("--gi probes --visualize probes", "probes",
         big + ["--gi", "probes", "--visualize", "probes"], {"rasterize": 6, "trace_rays": 2}),
        ("--set list", None, ["--set", "list"], {}),
        ("--scene <ETC1S + UASTC KTX2 glTF>", "gltf", ["--scene", str(gltf)] + size,
         {"rasterize": 6}),
    )
    apps = []

    class Recorded(application.Application):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            apps.append(self)

    eps = entry_points()
    totals = {name: 0 for name in eps}
    problems = []
    original = application.Application
    application.Application = Recorded  # headless.main imports it when it runs
    try:
        for label, name, args, per_run in runs:
            png = out_dir / f"{name or 'list'}.png"
            for f in eps.values():
                f.launches = 0
            t0 = time.perf_counter()
            rc = headless.main(args + ["--out", str(png)])
            torch.cuda.synchronize()
            launches = {name: f.launches for name, f in eps.items()}
            print(f"CLI {label}: exit {rc} in {time.perf_counter() - t0:.1f} s; launches "
                  f"{', '.join(f'{k} {v}' for k, v in launches.items() if v) or 'none'}")
            if rc != 0:
                problems.append(f"CLI {label} exited {rc}")
            for entry, n in launches.items():
                totals[entry] += n
                if n != per_run.get(entry, 0):
                    problems.append(f"CLI {label}: {entry} launches {n} != {per_run.get(entry, 0)}")
            written = [png] + ([Path(f"{png}.mid.png")] if "--interpolate" in args else [])
            if name and not all(p.is_file() for p in written):
                problems.append(f"CLI {label} wrote no {written}")
    finally:
        application.Application = original
    # The eight frame visualizers on the first run's last outputs (its TAA frame);
    # "none" and "overdraw" raise, as in the JAX package.
    out = apps[0]._last_outputs
    for mode in MODES:
        try:
            img = visualize(out, mode)
        except ValueError:
            if mode not in ("none", "overdraw"):
                problems.append(f"visualize {mode} raised")
            continue
        if mode in ("none", "overdraw"):
            problems.append(f"visualize {mode} did not raise")
        elif tuple(img.shape) != (1088, 1920, 3) or img.dtype != torch.uint8:
            problems.append(f"visualize {mode}: {tuple(img.shape)} {img.dtype}")
    print(f"visualize on the TAA run's outputs: {', '.join(MODES[1:-1])} drawn; none and "
          f"overdraw raise ({card})")
    return totals, problems


def band_raster_phase(scene, view, cascade0, res):
    """Phase 17: the kernel with ``row_offset`` against its plain version at the
    band call sites, each band also against the same rows of the full-frame
    kernel output, bit for bit: (sites by name, ok)."""
    import torch

    from androidrenderer_tpu_torch.config import default_frame_config, parity_frame_config
    from androidrenderer_tpu_torch.ops.raster.masked import _sample_alpha, pack_alpha_planes
    from androidrenderer_tpu_torch.render.frame import main_view_setup

    eps = entry_points()
    sites, ok = {}, True

    def bands(label, fn, setup, h, w, n, full, **kw):
        """Each of ``n`` bands through ``fn`` against the plain version and the
        rows of ``full``: the results of the band with the longest kernel time."""
        nonlocal ok
        b, worst = h // n, None
        full = full if isinstance(full, tuple) else (full,)
        for i in range(n):
            rows = slice(i * b, (i + 1) * b)
            band_kw = dict(kw, row_offset=i * b)
            if kw.get("z_limit") is not None:
                band_kw["z_limit"] = kw["z_limit"][rows].contiguous()
            got, r = compare(f"{label} band {i} of {n} (rows {i * b}-{(i + 1) * b - 1})", fn,
                             setup, b, w, **band_kw)
            got = got if isinstance(got, tuple) else (got,)
            rows_eq = all(torch.equal(g, f[rows]) for g, f in zip(got, full))
            print(f"  band {i}: equal to those rows of the full-frame kernel output: {rows_eq}")
            ok &= r["eq"] and rows_eq
            if worst is None or r["kernel_ms"] > worst["kernel_ms"]:
                worst = dict(r, index=i)
        return worst

    # The parity frame's main view (1280x736) in the sharded parity frame's 2 bands.
    pcfg = parity_frame_config()
    pview = parity_view(pcfg)
    h, w = pcfg.render_height, pcfg.render_width
    _, opaque, grid = main_view_setup(scene, pview, pcfg)
    full = eps["rasterize"](opaque, h, w, alpha_grid=grid)
    raster_site(f"rasterize parity main view + alpha grid, the full {h}x{w} frame", opaque, h, w,
                alpha_grid=grid)
    sites["main"] = bands("rasterize parity main view + alpha grid", eps["rasterize"], opaque,
                          h, w, 2, full, alpha_grid=grid)
    # One 1024^2 cascade in 4 bands (depth_only + affine_z).
    kw = dict(depth_only=True, affine_z=True)
    full = eps["rasterize"](cascade0, res, res, **kw)
    sites["cascade"] = bands("rasterize cascade 0", eps["rasterize"], cascade0, res, res, 4,
                             full, **kw)
    # The exact-alpha peel's layer 1 (its z_limit) on the lower band of 2 at 1088x1920.
    h, w = 1088, 1920
    setup, _, _ = main_view_setup(scene, view, default_frame_config(w, h, alpha_bitmap=False))
    masked = setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 1))
    d0, v0 = eps["rasterize_binned"](masked, h, w)
    alpha, cutoff = _sample_alpha(scene, masked, v0, alpha_planes=pack_alpha_planes(scene, masked))
    zl = torch.where((v0 >= 0) & ~(alpha >= cutoff), d0,
                     torch.full_like(d0, float("inf")))
    full = eps["rasterize_binned"](masked, h, w, z_limit=zl)
    b = h // 2
    got, r = compare(f"rasterize_binned peel layer 1 band 1 of 2 (rows {b}-{h - 1})",
                     eps["rasterize_binned"], masked, b, w, z_limit=zl[b:].contiguous(),
                     row_offset=b)
    rows_eq = torch.equal(got[0], full[0][b:]) and torch.equal(got[1], full[1][b:])
    print(f"  equal to those rows of the full-frame kernel output: {rows_eq}")
    ok &= r["eq"] and rows_eq and bool(torch.isfinite(zl[b:]).any())
    sites["peel"] = dict(r, index=1)
    return sites, ok


# The bench scene's primitives 5 + 3k and 6 + 3k: the first ring's columns and
# capitals (scene/procedural.py::courtyard_scene).
RING0 = [5 + 3 * k for k in range(8)] + [6 + 3 * k for k in range(8)]


def moved_transforms(base, i: int, lift: float = 0.3, turn: float = 0.2):
    """(P, 4, 4) transforms of frame ``i``: the first ring lifted by
    lift * (i + 1) metres and turned by turn * (i + 1) radians about its own
    vertical axis; every other primitive where it was built."""
    import numpy as np
    import torch

    tr = base.cpu().numpy().copy()
    a = turn * (i + 1)
    ry = np.eye(4, dtype=np.float32)
    ry[0, 0], ry[0, 2], ry[2, 0], ry[2, 2] = np.cos(a), np.sin(a), -np.sin(a), np.cos(a)
    for p in RING0:
        tr[p] = tr[p] @ ry
        tr[p, 1, 3] += lift * (i + 1)
    return torch.from_numpy(tr).to(base.device)


def dynamic_phase(scene, render_scene, view, profile: bool, card: str):
    """Phase 18: (the refit BVH's shadow site, launches by entry point, failed
    checks) of the RT frame over moving primitives on the bench scene."""
    import numpy as np
    import torch

    from androidrenderer_tpu_torch.config import (
        AOMode, RenderParams, ShadowMode, default_frame_config,
    )
    from androidrenderer_tpu_torch.ops.rt import effects
    from androidrenderer_tpu_torch.ops.rt.traverse import occlusion
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
    from androidrenderer_tpu_torch.scene import dynamic
    from androidrenderer_tpu_torch.scene.scene import (
        scene_arrays_from_numpy, scene_arrays_to_numpy,
    )

    problems = []
    t0 = time.perf_counter()
    dyn = dynamic.make_dynamic_data(render_scene, scene)
    base = dynamic.initial_transforms(render_scene, "cuda")
    print(f"dynamic data: {time.perf_counter() - t0:.2f} s, {base.shape[0]} primitives, "
          f"{len(dyn.level_slots)} BVH levels")
    # (a) The build transforms against the bake (float32 here, float64 there).
    same = dynamic.update_primitive_transforms(scene, dyn, base)
    n = sum(render_scene.meshes.meshes[p.mesh_id].num_vertices for p in render_scene.primitives)
    d_pos = (same.positions[:n] - scene.positions[:n]).abs().max().item()
    eq_pos = (same.positions[:n] == scene.positions[:n]).all(-1).float().mean().item()
    lo, hi = -1e30, 1e30
    d_box = max((getattr(same.bvh, f).clamp(lo, hi) - getattr(scene.bvh, f).clamp(lo, hi))
                .abs().max().item() for f in ("node_min", "node_max"))
    np_ = len(render_scene.primitives)
    d_ctr = (same.prim_bounds[:np_, :3] - scene.prim_bounds[:np_, :3]).abs().max().item()
    print(f"(a) build transforms vs the bake: max|d position| {d_pos:.3g} ({eq_pos:.4f} of "
          f"vertices bit-equal), max|d node box| {d_box:.3g}, max|d sphere centre| {d_ctr:.3g} "
          f"(bound 2e-5, tests/test_dynamic.py); radii are the Frobenius bound by design")
    if max(d_pos, d_box, d_ctr) > 2e-5:
        problems.append("the build transforms do not reproduce the bake")
    # (b) The update on the card against the update on the CPU, every frame's transforms.
    cpu_scene = scene_arrays_from_numpy(scene_arrays_to_numpy(scene), "cpu")
    cpu_dyn = dynamic.make_dynamic_data(render_scene, cpu_scene)

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    worst = 0.0
    for i in range(3):
        tr = moved_transforms(base, i)
        dev_s = dynamic.update_primitive_transforms(scene, dyn, tr)
        host = dynamic.update_primitive_transforms(cpu_scene, cpu_dyn, tr.cpu())
        exact = [("positions", dev_s.positions, host.positions),
                 ("prim_bounds", dev_s.prim_bounds, host.prim_bounds),
                 ("tri_corner_pos", dev_s.tri_corner_pos, host.tri_corner_pos),
                 ("proxy.corners", dev_s.proxy.corners, host.proxy.corners)]
        exact += [(f"bvh.{f}", getattr(dev_s.bvh, f), getattr(host.bvh, f))
                  for f in ("node_min", "node_max", "slot_v0", "slot_e1", "slot_e2", "node_rows",
                            "node_header", "node_lookahead", "slot_block", "slot_alpha")]
        bad = [k for k, a, b in exact if not torch.equal(bits(a).cpu(), bits(b))]
        d_n = max((a.cpu() - b).abs().max().item() for a, b in (
            (dev_s.normals, host.normals), (dev_s.tangents, host.tangents),
            (dev_s.tri_attr_corners, host.tri_attr_corners),
            (dev_s.proxy.normals, host.proxy.normals)))
        worst = max(worst, d_n)
        print(f"(b) frame {i} transforms, card vs CPU: positions, bounds, corner tables, node "
              f"boxes, slot tables, rows and the kernel layout bit-equal: {not bad}{'' if not bad else f' ({bad})'}; "
              f"max|d normal, tangent| {d_n:.3g} (bound 1e-6)")
        if bad or d_n > 1e-6:
            problems.append(f"frame {i}: the card's update differs from the CPU's ({bad}, {d_n})")
    del cpu_scene, cpu_dyn
    tr = moved_transforms(base, 0)
    update_ms = cuda_ms(lambda: dynamic.update_primitive_transforms(scene, dyn, tr))
    moved = dynamic.update_primitive_transforms(scene, dyn, tr)
    refit_ms = cuda_ms(lambda: dynamic.refit_bvh(scene.bvh, moved.positions, scene.tri_indices,
                                                 dyn.level_slots))
    print(f"(e) update_primitive_transforms {update_ms:.3f} ms (refit_bvh alone {refit_ms:.3f} ms), "
          f"CUDA-event medians of 5 ({card})")

    # (c) The traversal kernel on the refit BVH at the RT frame's shadow site.
    cfg = default_frame_config(1920, 1088, shadow_mode=ShadowMode.RT, ao_mode=AOMode.RT)
    params = RenderParams.default()
    first, _ = make_renderer(cfg)(moved, view, params, temporal_state_for(cfg, device="cuda"))
    g = first.gbuffer
    h, w = g.valid.shape
    o_s, d_s = effects.sun_shadow_rays(g.world_position, g.normal, moved.sun_direction,
                                       moved.sun_angular_size, 0)
    site = trace_site("shadow rays (refit BVH)", moved.bvh, o_s, d_s, effects.RAY_EPS, 1e30,
                      True, subset(h * w, 18))
    if not site["eq"]:
        problems.append("the kernel and the plain version disagree on the refit BVH")
    # (d) tests/test_dynamic.py's check: column 0 of the first ring (y 0-5 m at
    # x = -10.5, z = -6) lifted 6 m; a ray across its old place misses, one
    # across its new place hits.
    lift = base.clone()
    lift[RING0[0], 1, 3] += 6.0
    lifted = dynamic.update_primitive_transforms(scene, dyn, lift)
    o = torch.tensor([[-11.5, 2.5, -6.0], [-11.5, 8.5, -6.0]], device="cuda")
    d = torch.tensor([[1.0, 0.0, 0.0]] * 2, device="cuda")
    before, after = occlusion(scene.bvh, o, d, 1e-3, 1.5), occlusion(lifted.bvh, o, d, 1e-3, 1.5)
    print(f"(d) column lifted 6 m: old-place ray hit before {bool(before[0])}, after "
          f"{bool(after[0])}; new-place ray hit before {bool(before[1])}, after {bool(after[1])}")
    if not (bool(before[0]) and not bool(after[0]) and bool(after[1]) and not bool(before[1])):
        problems.append("the refit BVH does not follow the lifted column")

    # (e) The RT frame with the update before each frame: 5 traversal launches
    # (the shadow rays and rtao_num_samples = 4 AO rays) and 4 raster launches
    # (occlusion phases 1 and 2, 2 translucent layers; RT shadows replace the
    # cascades) per frame, as in phase 12; the update and the refit launch no
    # kernel of csrc/ (PyTorch ops only).
    render = make_renderer(cfg)
    temp = temporal_state_for(cfg, device="cuda")
    for i in range(2):  # warm-up
        _, temp = render(dynamic.update_primitive_transforms(scene, dyn, moved_transforms(base, i)),
                         view, params, temp)
    eps = entry_points()
    for f in eps.values():
        f.launches = 0
    frames = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(frames):
        s_i = dynamic.update_primitive_transforms(scene, dyn, moved_transforms(base, i))
        out, temp = render(s_i, view, params, temp)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / frames
    launches = {name: f.launches for name, f in eps.items()}
    print(f"dynamic RT frame (update + refit + frame) {frame_ms:.3f} ms/frame over {frames} "
          f"frames ({card}); launches per frame: "
          + ", ".join(f"{k} {v / frames:g}" for k, v in launches.items() if v))
    for name, n in launches.items():
        want = {"rasterize": 4, "trace_rays": 5}.get(name, 0) * frames
        if n != want:
            problems.append(f"dynamic frame: {name} launches {n} != {want}")
    if not bool(torch.isfinite(out.hdr).all()) or int(out.image.amax()) == int(out.image.amin()):
        problems.append("dynamic frame: the image is not a frame")
    state = {"temp": temp, "i": 0}

    def step():
        with torch.profiler.record_function("frame/dynamic_update"):
            s_i = dynamic.update_primitive_transforms(
                scene, dyn, moved_transforms(base, state["i"] % 3))
        _, state["temp"] = render(s_i, view, params, state["temp"])
        state["i"] += 1

    print_split("dynamic RT frame", *stage_split(step))
    site.update(update_ms=update_ms, refit_ms=refit_ms, frame_ms=frame_ms,
                normal_err=worst)
    return site, launches, problems


def stage_split(step, frames: int = 2):
    """Profile ``frames`` calls of ``step()``: (wall ms, device-busy ms, {range:
    (host ms, device ms)}) per frame, for every ``frame/*`` range (device ms:
    the PyTorch kernels the range launched; the hand kernels, launched through
    ctypes, count in the busy time only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / frames
    busy, stages = 0.0, {}
    for e in prof.key_averages():
        self_dev = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        total_dev = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if e.key.startswith("frame/") and e.cpu_time_total > 0:
            stages[e.key] = (e.cpu_time_total / 1e3 / frames, total_dev / 1e3 / frames)
        elif e.cpu_time_total == 0 and self_dev > 0 and not e.key.startswith("frame/"):
            busy += self_dev / 1e3 / frames
    return wall, busy, stages


def print_split(label, wall, busy, stages):
    print(f"{label}: profiled {wall:.3f} ms/frame, device busy {busy:.3f} ms ({busy / wall:.1%}); "
          "host / device ms per frame: " + ", ".join(
              f"{k[6:]} {h:.1f} / {d:.1f}" for k, (h, d) in sorted(stages.items(), key=lambda x: -x[1][0])))


def _bands_rank(group, device, cfg, views, timed):
    """One rank of phase 19: the bench scene's parity frames over ``views`` on
    its band, then ``timed`` chained frames timed and 2 profiled; returns
    (gathered images, its stats) on rank 0."""
    import torch
    import torch.distributed as dist

    from androidrenderer_tpu_torch.config import RenderParams
    from androidrenderer_tpu_torch.parallel import collectives as coll
    from androidrenderer_tpu_torch.parallel.mesh import make_sharded_renderer, shard_temporal
    from androidrenderer_tpu_torch.render import temporal_state_for
    from androidrenderer_tpu_torch.scene.procedural import courtyard_scene

    scene, _ = courtyard_scene(column_rings=4, detail=13, curtains=True).build(
        device=device, with_bvh=False)
    render = make_sharded_renderer(cfg, group)
    params = RenderParams.default()
    temp = shard_temporal(temporal_state_for(cfg, device=device), group)
    eps = entry_points()
    for f in eps.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    images = []
    for v in views:
        out, temp = render(scene, v, params, temp)
        images.append(coll.gather_rows(out.image, group).cpu().numpy())
    launches = {k: f.launches / len(views) for k, f in eps.items() if f.launches}
    torch.cuda.synchronize()
    dist.barrier(group)
    t0 = time.perf_counter()
    for _ in range(timed):
        out, temp = render(scene, views[-1], params, temp)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed
    state = {"temp": temp}

    def step():
        _, state["temp"] = render(scene, views[-1], params, state["temp"])

    wall, busy, stages = stage_split(step)
    host, dev_ms = stages.get("frame/collectives", (0.0, 0.0))
    stats = dict(rank=dist.get_rank(group), launches=launches, ms=ms, wall=wall,
                 collectives_host_ms=host, collectives_device_ms=dev_ms, busy_ms=busy,
                 stages=stages, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, stats, group=group)
    return (images, every) if dist.get_rank(group) == 0 else None


def bands_phase(scene, profile: bool, card: str):
    """Phase 19: (ms by path, failed checks) of band sharding over 2 ranks on the
    card (gloo: NCCL takes one card per rank)."""
    import numpy as np
    import torch

    from androidrenderer_tpu_torch.camera import Camera, taa_jitter
    from androidrenderer_tpu_torch.config import RenderParams, parity_frame_config
    from androidrenderer_tpu_torch.parallel.dryrun import dryrun_multichip
    from androidrenderer_tpu_torch.parallel.mesh import check_split, run_ranks
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for

    problems = []
    store = REPO / "build" / "torch_kernels" / "bands_store"
    print(f"bands: backend gloo, 2 ranks on torch.cuda.device_count() = "
          f"{torch.cuda.device_count()} card(s); a multi-card NCCL run is not attempted")
    # (a) The dry run: two frames on 2 ranks.
    t0 = time.perf_counter()
    shapes = dryrun_multichip(2, "cuda", backend="gloo", init_file=str(store))
    print(f"(a) dryrun_multichip(2, cuda, gloo): frames {shapes} in {time.perf_counter() - t0:.1f} s")
    # (b) The parity frame over 2 bands (tile_height 16: 736 = 2 x 23 x 16)
    # against the single-device parity frame, 3 moving jittered frames.
    cfg = parity_frame_config().replace(tile_height=16)
    print(f"(b) parity frame with tile_height=16 (the only change from parity_frame_config), "
          f"bands of {check_split(cfg, 2)} render and {cfg.output_height // 2} output rows")
    cam = Camera(fov_degrees=cfg.fov_degrees, aspect=cfg.output_width / cfg.output_height,
                 z_near=cfg.z_near, render_resolution=(cfg.render_width, cfg.render_height))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    views = []
    for i in range(3):
        cam.set_jitter(taa_jitter(i + 1))
        views.append(cam.view_data())
        cam.end_frame()
        cam.translate_local([0.04, 0.0, -0.15])
        cam.rotate(0.004, -0.01)
    t0 = time.perf_counter()
    images, stats = run_ranks(2, _bands_rank, cfg, views, 10, device="cuda", backend="gloo",
                              init_file=str(store))
    print(f"  2 ranks ran in {time.perf_counter() - t0:.1f} s")
    render = make_renderer(cfg)
    temp = temporal_state_for(cfg, device="cuda")
    singles = []
    for v in views:
        out, temp = render(scene, v, RenderParams.default(), temp)
        singles.append(out.image.cpu().numpy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        out, temp = render(scene, views[-1], RenderParams.default(), temp)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3 / 10
    worst_share = worst_far = 0.0
    worst_d = 0
    for i, (a, b) in enumerate(zip(images, singles)):
        d = np.abs(a.astype(int) - b.astype(int)).max(-1)
        share, far = float((d > 0).mean()), float((d > 1).mean())
        worst_share, worst_far, worst_d = max(worst_share, share), max(worst_far, far), max(worst_d, int(d.max()))
        print(f"  frame {i}: 2 bands vs one device: {int((d > 0).sum())} of {d.size} pixels "
              f"differ (share {share:.6f}), {int((d > 1).sum())} by more than one u8 step, "
              f"max {int(d.max())}")
    if a.shape != b.shape or worst_far > 0.005 or worst_share > 1e-4 or worst_d > 1:
        problems.append(f"the 2-band parity frame is not within the bounds of the single-device "
                        f"frame (share {worst_share}, > 1 step {worst_far}, max {worst_d})")
    # (c), (d) Times, the collectives' share, launches and memory per rank.
    main_view, cascades, rsm = 1, 2, 1  # per frame: occlusion off; budget 1 -> cascades 0 and k
    for s in stats:
        want = main_view + (cascades + 1 - s["rank"]) // 2 + rsm
        print(f"  rank {s['rank']}: {s['ms']:.3f} ms/frame over 10 chained frames ({card}); "
              f"profiled {s['wall']:.3f} ms/frame, frame/collectives host {s['collectives_host_ms']:.3f} ms "
              f"({s['collectives_host_ms'] / s['wall']:.1%}), its device time "
              f"{s['collectives_device_ms']:.3f} ms of {s['busy_ms']:.3f} ms busy; launches per frame "
              f"{s['launches']} (expected rasterize {want}: main view band, "
              f"{(cascades + 1 - s['rank']) // 2} of the frame's {cascades} cascades, the RSM); "
              f"peak device memory {s['peak_gib']:.2f} GiB")
        print_split(f"  rank {s['rank']}", s["wall"], s["busy_ms"], s["stages"])
        if s["launches"] != {"rasterize": float(want)}:
            problems.append(f"rank {s['rank']} launches {s['launches']} != rasterize {want}")
    print(f"parity_2band_ms: {max(s['ms'] for s in stats):.3f}, single device "
          f"{single_ms:.3f} ms/frame ({card})")
    return dict(band_ms=max(s["ms"] for s in stats), single_ms=single_ms,
                pixels_differing=worst_share), problems


# The frame's profiling switches (render/frame.py), and those each timed frame
# honours: the raster-only frame has no LPV.
SWITCHES = ("debug_stub_raster", "debug_stub_resolve", "debug_resolve_gather_only",
            "debug_stub_shadow_sample", "debug_stub_rsm", "debug_stub_lpv_apply")
STUB_FRAMES = {"raster-only": SWITCHES[:4], "parity": SWITCHES}
# Raster launches per unstubbed frame: raster-only = the main view and 2
# cascades (shadow_update_budget=1); parity adds one RSM (lpv_update_budget=1).
BASE_RASTERS = {"raster-only": 3, "parity": 4}


def stub_rasters(frame: str, switch) -> int:
    """Raster launches per frame with ``switch`` alone: the main view's stub
    takes one away, and so does the RSM's on the parity frame."""
    fewer = switch == "debug_stub_raster" or (frame == "parity" and switch == "debug_stub_rsm")
    return BASE_RASTERS[frame] - fewer


def stub_frame_configs(view):
    """(frame, unstubbed config, view) of the two frames bench.py times."""
    from androidrenderer_tpu_torch.config import parity_frame_config, raster_only_config

    parity = parity_frame_config()
    return (("raster-only", raster_only_config(), view), ("parity", parity, parity_view(parity)))


def stubs_phase(scene, view, timed: bool, card: str):
    """Phase 21: failed checks. Each frame, unstubbed and with each switch it
    honours alone: 3 warm-up frames and a chain of 10, raster launches gated.
    ``timed`` (--stubs): each timed as phase 4 with 2 chains of 10 and profiled
    over 3 frames, in mirrored turns (unstubbed, each switch, each switch again
    in reverse, unstubbed), with the deltas from the unstubbed frame."""
    from androidrenderer_tpu_torch.config import RenderParams
    from androidrenderer_tpu_torch.render import make_renderer

    problems = []
    for frame, base, v in stub_frame_configs(view):
        switches = STUB_FRAMES[frame]
        turns = (None, *switches, *reversed(switches), None) if timed else (None, *switches)
        readings = {}
        for switch in turns:
            cfg = base.replace(**({switch: True} if switch else {}))
            label = f"{frame} {switch or 'unstubbed'}"
            ms, _, _, failed, out, temp = run_frames(
                label, cfg, scene, v, False, {"rasterize": stub_rasters(frame, switch)},
                chains=2 if timed else 1)
            # A stub's image may be uniform (the gather-only resolve saturates
            # it, as in the JAX frame); it must be finite.
            problems += [f"{label}: {x}" for x in failed if switch is None or x != "image is uniform"]
            if not timed:
                continue
            profile_frames(label, make_renderer(cfg), scene, v, RenderParams.default(), temp,
                           stages=False)
            readings.setdefault(switch, []).append(dict(PROFILES[label], ms=ms))
        if not timed:
            continue

        def mean(switch, key):
            return statistics.fmean(r[key] for r in readings[switch])

        print(f"stub phase, {frame} unstubbed: {mean(None, 'ms'):.3f} ms/frame, device "
              f"{mean(None, 'device_ms'):.3f} ms, {mean(None, 'kernels'):.0f} kernels per "
              f"profiled frame, {BASE_RASTERS[frame]} raster launches per frame ({card})")
        for switch in switches:
            d = {k: mean(switch, k) - mean(None, k) for k in ("ms", "device_ms", "kernels")}
            print(f"stub phase, {frame} {switch}: {mean(switch, 'ms'):.3f} ms/frame "
                  f"({d['ms']:+.3f}), device {mean(switch, 'device_ms'):.3f} ms "
                  f"({d['device_ms']:+.3f}), {mean(switch, 'kernels'):.0f} kernels "
                  f"({d['kernels']:+.0f}), {stub_rasters(frame, switch)} raster launches per "
                  f"frame; readings (ms, device ms) "
                  f"{[(round(r['ms'], 3), round(r['device_ms'], 3)) for r in readings[switch]]}")
    return problems


def stub_card_vs_cpu():
    """Phase 22: the 128^2 parity frame (192^2 output) with each switch alone,
    card against CPU over 3 moving jittered frames, within phase 5's
    thresholds; under the raster stub, whose depth is analytic, a depth
    counts as differing beyond 4 ulps of 1 (the two devices' float32 sin)."""
    from androidrenderer_tpu_torch.config import parity_frame_config

    small = parity_frame_config(192, 192, 128, 128, shadow_cascade_resolution=128)
    failed = []
    for switch in SWITCHES:
        atol = 2.4e-7 if switch == "debug_stub_raster" else 0.0
        if not card_vs_cpu(f"parity {switch}", cfg=small.replace(**{switch: True}), moving=True,
                           depth_atol=atol):
            failed.append(f"the 128^2 parity frames with {switch} on the card and the CPU disagree")
    return failed


def goldens_phase(card: str):
    """Phase 23: tools/make_goldens.py's six cases rendered on the card
    (androidrenderer_tpu_torch/tools/golden_cases.py) against the committed
    goldens: SSIM >= 0.98 with the goldens' 38 holes on the cornell view from
    the golden (golden_cases.py says why), and the plain SSIM beside it."""
    from androidrenderer_tpu_torch.tools import golden_cases

    failed = []
    for name in golden_cases.CASES:
        t0 = time.perf_counter()
        r = golden_cases.compare(name, "cuda")
        print(f"golden {name} on the card: SSIM {r['ssim_holes_from_golden']:.5f} with the "
              f"golden's {r['holes']} holes from the golden (plain {r['ssim']:.5f}; gate "
              f"{golden_cases.MIN_SSIM}; {time.perf_counter() - t0:.1f} s; {card})")
        want = 38 if name in golden_cases.CORNELL_CASES else 0
        if not (r["ssim_holes_from_golden"] >= golden_cases.MIN_SSIM and r["holes"] == want):
            failed.append(f"{name}: SSIM {r['ssim_holes_from_golden']:.5f}, {r['holes']} holes")
    return failed


def tree_frames(tree: Path) -> int:
    """``--tree-frames DIR``: the unstubbed raster-only and parity frames of the
    package in DIR (this tree's or another's, unpacked with git archive) on
    the bench scene, 3 warm-up frames, 2 chains of 10 and 3 profiled frames
    each; prints one JSON line of ms/frame, device ms and kernels per profiled
    frame by frame."""
    import torch

    sys.path.insert(0, str(tree))
    import androidrenderer_tpu_torch
    from androidrenderer_tpu_torch.config import RenderParams
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
    from androidrenderer_tpu_torch.scene.procedural import courtyard_scene

    if Path(androidrenderer_tpu_torch.__file__).resolve().parents[1] != tree.resolve():
        return fail(f"androidrenderer_tpu_torch was not imported from {tree}")
    scene, _ = courtyard_scene(column_rings=4, detail=13, curtains=True).build(
        device="cuda", with_bvh=False)
    result = {}
    for frame, cfg, view in stub_frame_configs(bench_camera()):
        renderer, params = make_renderer(cfg), RenderParams.default()
        temp = temporal_state_for(cfg, device="cuda")
        for _ in range(3):
            out, temp = renderer(scene, view, params, temp)
        torch.cuda.synchronize()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(10):
                out, temp = renderer(scene, view, params, temp)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e2)
        profile_frames(f"{tree.name} {frame}", renderer, scene, view, params, temp, stages=False)
        result[frame] = dict(PROFILES[f"{tree.name} {frame}"], ms=statistics.median(times))
    print(json.dumps(result))
    return 0


def parent_frames_phase(parent, card: str):
    """Phase 24 (--parent-tree): failed checks. The unstubbed frames of this
    tree and of ``parent`` (a tree unpacked by git archive) as --tree-frames
    processes in turns (parent, this, this, parent); each frame must launch as
    many kernels per profiled frame as the parent's, within the one kernel by
    which a frame's count varies between runs, at device ms within 2% of the
    parent's mean."""
    readings, failed = {}, []
    for which, tree in (("parent", parent), ("this", REPO), ("this", REPO), ("parent", parent)):
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--tree-frames",
                               str(tree)], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            return [f"--tree-frames {tree} exited {proc.returncode}: "
                    f"{proc.stderr.strip()[-2000:]}"]
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        readings.setdefault(which, []).append(r)
        print(f"turns, {which} tree ({tree}): " + "; ".join(
            f"{frame} {v['ms']:.3f} ms/frame, device {v['device_ms']:.3f} ms, "
            f"{v['kernels']:.0f} kernels" for frame, v in r.items()))
    for frame in BASE_RASTERS:
        got = {which: ([round(r[frame]["kernels"]) for r in rs],
                       [r[frame]["device_ms"] for r in rs]) for which, rs in readings.items()}
        for which, (kernels, device) in got.items():
            print(f"turns, {frame} frame, {which} tree: kernels per profiled frame {kernels}, "
                  f"device ms {[round(x, 3) for x in device]}, ms/frame "
                  f"{[round(r[frame]['ms'], 3) for r in readings[which]]} ({card})")
        counts = got["parent"][0] + got["this"][0]
        if max(counts) - min(counts) > 1:
            failed.append(f"{frame} frame: kernels per profiled frame {got['this'][0]} against "
                          f"the parent's {got['parent'][0]}")
        ours, theirs = (statistics.fmean(got[w][1]) for w in ("this", "parent"))
        if abs(ours - theirs) > 0.02 * theirs:
            failed.append(f"{frame} frame: device {ours:.3f} ms against the parent's "
                          f"{theirs:.3f} ms")
    return failed


def slice_phases(scene, view, parent_tree, timed: bool, card: str) -> int:
    """Phases 21-24, each timed; 1 after printing what failed, else 0."""
    phases = [
        ("stub", lambda: stubs_phase(scene, view, timed, card)),
        ("stub card vs CPU", stub_card_vs_cpu),
        ("goldens", lambda: goldens_phase(card)),
    ]
    if parent_tree is not None:
        phases.append(("parent frames", lambda: parent_frames_phase(parent_tree, card)))
    for label, run in phases:
        t0 = time.perf_counter()
        problems = run()
        print(f"{label} phase: {time.perf_counter() - t0:.1f} s")
        if problems:
            return fail(f"{label}: " + "; ".join(problems))
    return 0


def traversal_phases(scene, stats, view, profile: bool, card: str) -> int:
    """Phases 12-14 and 19 alone (--traversal): every traversal site, with its
    gates, and the four frames that trace; no results line."""
    for label, run in (
        ("RT frame", lambda: rt_phase(scene, stats, view, profile, card)),
        ("RTGI frame", lambda: rtgi_phase(scene, view, profile, card)),
        ("probe frame", lambda: probes_phase(scene, view, profile, card)),
        ("dynamic scene", lambda: dynamic_phase(scene, BENCH["render_scene"], view, profile,
                                                card)),
    ):
        problems = run()[-1]
        if problems:
            return fail(f"{label}: " + "; ".join(problems))
    print(f"chip_smoke: the traversal phases passed ({card})")
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script runs on an NVIDIA card")
    if "--tree-frames" in argv:
        return tree_frames(Path(argv[argv.index("--tree-frames") + 1]))
    if not (REPO / "androidrenderer_tpu_torch" / "csrc" / "raster.cu").is_file():
        return fail(f"androidrenderer_tpu_torch/ is not beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    from ctypes import c_float, c_int, c_longlong, c_void_p

    from androidrenderer_tpu_torch import init_device
    from androidrenderer_tpu_torch.ops.cuda_build import Library, load_all
    from androidrenderer_tpu_torch.ops.gather import LIBRARY as GATHER_LIBRARY
    from androidrenderer_tpu_torch.ops.raster.raster import LIBRARY
    from androidrenderer_tpu_torch.ops.rt.traverse import LIBRARY as TRAVERSE_LIBRARY

    # 1. the card
    started = time.perf_counter()
    dev = init_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"nvidia-smi: {smi}")

    # 2. build, one nvcc for each source, all started together (before any rank
    # of phase 20 starts: the ranks load these builds)
    if "--parent-csrc" in argv:
        parent = Path(argv[argv.index("--parent-csrc") + 1]).resolve()
        others = {
            "raster": (LIBRARY, LIBRARY.functions),
            "gather": (GATHER_LIBRARY, {"gather_tile_sums_launch": [
                c_void_p, c_longlong, c_int, c_void_p, c_longlong, c_void_p, c_void_p]}),
            # The signature before the kernel layout: node_rows, no scattered, no counter.
            "traverse": (TRAVERSE_LIBRARY, {"traverse_launch": [
                c_void_p, c_int, c_void_p, c_void_p, c_int, c_void_p, c_float, c_void_p,
                c_float, c_void_p, c_int, c_int, c_int, c_int, *[c_void_p] * 10]}),
        }
        for name, (ours, functions) in others.items():
            source = parent / f"{name}.cu"
            if source.read_bytes() == ours.source.read_bytes():
                print(f"the other tree's {name}.cu is this tree's: not timed twice")
            else:
                PARENT[name] = Library(source, functions)
    libraries = (LIBRARY, GATHER_LIBRARY, TRAVERSE_LIBRARY, *PARENT.values())
    load_all(*libraries)
    for lib in libraries:
        print(f"built {lib.source} for sm_90a in {lib.build_seconds:.1f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    from androidrenderer_tpu_torch.ops.rt.traverse import occupancy

    for counts in (False, True):
        occ = {f"{mode}{', bitmaps' if bitmap else ''}": occupancy(any_hit, masked, bitmap, counts)
               for mode, any_hit, masked in (("closest", False, False), ("any", True, False),
                                             ("masked any", True, True))
               for bitmap in (False, True)}
        print(f"traverse_kernel, the {'counting' if counts else 'frame'} instantiations: "
              + "; ".join(f"{k}-hit {o['registers']} registers/thread, {o['blocks_per_sm']} "
                          f"blocks of 128/SM" for k, o in occ.items())
              + f" ({next(iter(occ.values()))['sms']} SMs)")

    # 3. kernel vs plain version at the main path's shapes
    cfg, scene, scene_stats, view = bench_setup(dev)
    profile = "--profile" in argv
    if "--traversal" in argv:
        return traversal_phases(scene, scene_stats, view, profile, f"{kind}; {smi}")
    parent_tree = None
    if "--parent-tree" in argv:
        parent_tree = Path(argv[argv.index("--parent-tree") + 1]).resolve()
    if "--stubs" in argv:
        return slice_phases(scene, view, parent_tree, True, f"{kind}; {smi}")
    result, ok, cascade0 = kernel_checks(cfg, scene, view)
    if not ok:
        return fail("kernel and plain version disagree at the bench shapes")

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

    # 8. the parity frame
    rsm, path_launches["parity"], problems = parity_phase(scene, profile, f"{kind}; {smi}")
    if problems:
        return fail("parity frame: " + "; ".join(problems))

    # 9. the gather microbench
    gather, ok = gather_checks()
    if not ok:
        return fail("the gather kernel and its plain version disagree at the tool's shape")

    # 10. the design studies' entry points at the bench shapes
    studies, path_launches["experiments"], ok = experiment_checks(cfg, scene, view, cascade0)
    if not ok:
        return fail("a design study's entry point and the plain version disagree, "
                    "or launched other than once per call")

    # 11. the raster microbench in each mode
    bench_ms, bench_split, path_launches["bench_raster"], problems = bench_raster_path(scene)
    if problems:
        return fail("bench_raster: " + "; ".join(problems))

    # 12. the RT frame
    rt_sites, path_launches["rt"], problems = rt_phase(
        scene, scene_stats, view, profile, f"{kind}; {smi}")
    if problems:
        return fail("RT frame: " + "; ".join(problems))

    # 13. the RTGI frame
    gi_sites, path_launches["rtgi"], problems = rtgi_phase(scene, view, profile, f"{kind}; {smi}")
    if problems:
        return fail("RTGI frame: " + "; ".join(problems))
    rt_sites.update(gi_sites)

    # 14. the probe frame
    probe_sites, path_launches["probes"], problems = probes_phase(
        scene, view, profile, f"{kind}; {smi}")
    if problems:
        return fail("probe frame: " + "; ".join(problems))
    rt_sites.update(probe_sites)

    # 15. the VRSAA frame
    vrsaa, path_launches["vrsaa"], problems = vrsaa_phase(scene, profile, f"{kind}; {smi}")
    if problems:
        return fail("VRSAA frame: " + "; ".join(problems))

    # 16. the headless CLI
    t0 = time.perf_counter()
    path_launches["cli"], problems = cli_phase(f"{kind}; {smi}")
    if problems:
        return fail("CLI: " + "; ".join(problems))
    print(f"CLI phase: {time.perf_counter() - t0:.1f} s")

    # 17. A and B at 128^2, card vs CPU
    for label, overrides in (("A", {}), ("B", {"alpha_bitmap": False})):
        overrides = dict(occlusion_culling=True, translucency=True, **overrides)
        if not card_vs_cpu(f"frame {label}", overrides, curtains=True):
            return fail(f"frame {label}: card and CPU frames disagree")

    # 18. the band raster
    t0 = time.perf_counter()
    band, ok = band_raster_phase(scene, view, cascade0, cfg.shadow_cascade_resolution)
    if not ok:
        return fail("the band raster: the kernel, the plain version or the full frame's rows "
                    "disagree")
    print(f"band raster phase: {time.perf_counter() - t0:.1f} s")

    # 19. dynamic scenes
    t0 = time.perf_counter()
    refit, path_launches["dynamic"], problems = dynamic_phase(
        scene, BENCH["render_scene"], view, profile, f"{kind}; {smi}")
    if problems:
        return fail("dynamic scene: " + "; ".join(problems))
    print(f"dynamic phase: {time.perf_counter() - t0:.1f} s")

    # 20. bands over 2 ranks
    t0 = time.perf_counter()
    bands, problems = bands_phase(scene, profile, f"{kind}; {smi}")
    if problems:
        return fail("bands: " + "; ".join(problems))
    print(f"bands phase: {time.perf_counter() - t0:.1f} s")

    # 21-24. the profiling switches, the goldens, and with --parent-tree the parent's frames
    if slice_phases(scene, view, parent_tree, False, f"{kind}; {smi}") != 0:
        return 1
    del scene
    torch.cuda.empty_cache()

    # 25. results
    def launched(*names):
        return sum(path[n] for path in path_launches.values() for n in names)

    fused, hybrid = entry["rasterize_fused"], entry["rasterize_hybrid"]
    kernels = [
        dict(result, launches=launched("rasterize"),
             max_abs_err=max(result["max_abs_err"], entry["rasterize"]["err"], rsm["err"],
                             vrsaa["err"]),
             translucency_layer1_ms=entry["rasterize"]["ms"],
             translucency_layer1_kernel_ms=entry["rasterize"]["kernel_ms"],
             translucency_layer1_parent_kernel_ms=entry["rasterize"]["parent_kernel_ms"],
             translucency_layer1_plain_ms=entry["rasterize"]["plain_ms"],
             translucency_layer1_bound_ms=entry["rasterize"]["bound_ms"],
             rsm_ms=rsm["ms"], rsm_kernel_ms=rsm["kernel_ms"],
             rsm_parent_kernel_ms=rsm["parent_kernel_ms"], rsm_plain_ms=rsm["plain_ms"],
             rsm_bound_ms=rsm["bound_ms"], rsm_bound_by=rsm["bound_by"],
             **{f"vrsaa_{k}": vrsaa[k] for k in ("ms", "kernel_ms", "parent_kernel_ms",
                                                 "plain_ms", "bound_ms", "bound_by", "work")},
             **{f"band_{k}": band["main"][k] for k in BAND_KEYS},
             **{f"band_cascade_{k}": band["cascade"][k] for k in BAND_KEYS}),
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
         dict(bench_raster_ms=bench("binned8"),
              **{f"band_peel_{k}": band["peel"][k] for k in BAND_KEYS})),
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
            "raster_subfold": subfold_csm["err"], "raster_binned": band["peel"]["err"]}
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
    shadow = rt_sites["shadow"]
    kernels.append(dict(
        name="traverse", route="cuda", source="androidrenderer_tpu_torch/csrc/traverse.cu",
        replaces="androidrenderer_tpu/ops/rt/traverse.py:190", launches=launched("trace_rays"),
        max_abs_err=max(refit["err"], *(r["err"] for r in rt_sites.values())), ms=shadow["ms"],
        kernel_ms=shadow["kernel_ms"], plain_ms=shadow["plain_ms"], bound_ms=shadow["bound_ms"],
        bound_by=shadow["bound_by"], library_ms=None,  # no PyTorch call traverses a BVH
        # ms, kernel_ms and bound_ms cover every ray of the site; plain_ms the subset.
        rays=shadow["rays"], plain_rays=shadow["plain_rays"],
        parent_kernel_ms=shadow["parent_kernel_ms"], ps_per_step=shadow["ps_per_step"],
        **{f"{site}_{k}": rt_sites[site][k]
           for site in ("rtao", "primary", "rtgi", "rtgi_shadow", "peel", "probe", "probe_shadow")
           for k in SITE_KEYS},
        **{f"refit_shadow_{k}": refit[k] for k in SITE_KEYS},
        dynamic_update_ms=refit["update_ms"], dynamic_refit_ms=refit["refit_ms"],
        dynamic_frame_ms=refit["frame_ms"],
    ))
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s from the card's check to the "
          f"results")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
