#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (androidrenderer_tpu_torch) runs on an NVIDIA card.

    python3 chip_smoke.py            # from the repository root, on a machine with one card
    python3 chip_smoke.py --profile  # also prints per-stage times of 3 profiled frames and
                                     # writes the torch.profiler table beside the kernel
                                     # build (build/torch_kernels/torch_frame_profile.txt)

Phases, in order; any failure ends the run with a non-zero exit code:

1. the card: torch's device name, and nvidia-smi's name and power limit;
2. build csrc/raster.cu for sm_90a (seconds, and ptxas' register report);
3. the kernel against its plain PyTorch version at the main path's shapes on
   the bench scene and camera (bench.py:134-144): the 1088x1920 main view with
   the alpha grid, and one 1024^2 cascade (depth_only + affine_z). Both must be
   bit-equal; times are CUDA-event medians of 5;
4. the raster-only bench frame at 1920x1088: 3 warm-up frames, then 4 chains of
   10 frames timed around torch.cuda.synchronize(); median ms/frame; checks on
   the image and HDR; the raster launch count must grow by exactly 3 per frame
   (main view, cascade 0, one far cascade);
5. the same raster-only frame at 128^2 on the default courtyard, rendered on the
   card (kernel) and on the CPU (plain version), 3 chained frames: max |delta|
   of the u8 image and of the depth;
6. one JSON line of kernel results, the card line, and the final JSON line.

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


def kernel_checks(cfg, scene, view):
    """Phase 3: (result dict, ok) for the main view and one cascade."""
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
    result = {
        "name": "raster",
        "route": "cuda",
        "source": "androidrenderer_tpu_torch/csrc/raster.cu",
        "replaces": "androidrenderer_tpu/ops/raster/raster_bitmask.py:82",
        "max_abs_err": max(main_err, csm_err),
        "ms": ms,
        "plain_ms": plain_ms,
        "cascade_ms": csm_ms,
        "cascade_plain_ms": csm_plain_ms,
    }
    return result, main_eq and csm_eq and covered > 0.5


def run_slice(cfg, scene, view, profile: bool):
    """Phase 4: (median ms/frame, raster launches in the run, frames, failed checks)."""
    import numpy as np
    import torch

    from androidrenderer_tpu_torch.config import RenderParams
    from androidrenderer_tpu_torch.ops.raster import rasterize
    from androidrenderer_tpu_torch.ops.raster.raster import BUILD_DIR
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for

    renderer = make_renderer(cfg)
    params = RenderParams.default()
    temp = temporal_state_for(cfg, device=scene.positions.device)
    rasterize.launches = 0
    t0 = time.perf_counter()
    out, temp = renderer(scene, view, params, temp)
    torch.cuda.synchronize()
    print(f"first frame: {(time.perf_counter() - t0) * 1e3:.1f} ms")
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
    launches, frames = rasterize.launches, 3 + 4 * chain
    ms = float(np.median(times))
    print(f"raster-only {cfg.render_width}x{cfg.render_height} chained frame times (ms): "
          f"{[round(t, 3) for t in times]}; median {ms:.3f} ms/frame")
    print(f"raster launches: {launches} over {frames} frames = {launches / frames} per frame")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"peak device memory: {peak:.2f} GiB")

    img = out.image
    problems = []
    if tuple(img.shape) != (cfg.output_height, cfg.output_width, 3) or img.dtype != torch.uint8:
        problems.append(f"image is {tuple(img.shape)} {img.dtype}")
    if not bool(torch.isfinite(out.hdr).all()):
        problems.append("HDR has non-finite values")
    if int(img.amax()) == int(img.amin()):
        problems.append("image is uniform")
    if launches != 3 * frames:
        problems.append(f"raster launches {launches} != 3 x {frames} frames")
    print(f"image: mean {img.float().mean().item():.3f}, min {int(img.amin())}, "
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
        dest = BUILD_DIR / "torch_frame_profile.txt"
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(table)
        print(f"profile of 3 frames written to {dest.relative_to(REPO)}")
        print(f"profiled frame: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"({busy_ms / wall_ms:.1%}), {sum(e.count for e in kernels) / 3:.0f} kernels")
        for e in sorted(events, key=lambda e: -e.cpu_time_total):
            if e.key.startswith("frame/") and e.cpu_time_total > 0:
                print(f"  {e.key:18s} host {e.cpu_time_total / 1e3 / 3:8.3f} ms, "
                      f"kernels {device_us(e, True) / 1e3 / 3:8.3f} ms per frame")
    return ms, launches, frames, problems


def card_vs_cpu():
    """Phase 5: the 128^2 courtyard frame on the card and on the CPU."""
    import numpy as np
    import torch

    from androidrenderer_tpu_torch.camera import Camera
    from androidrenderer_tpu_torch.config import RenderParams, raster_only_config
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
    from androidrenderer_tpu_torch.scene.procedural import courtyard_scene

    n = 128
    cfg = raster_only_config(n, n, shadow_cascade_resolution=128)
    cam = Camera(fov_degrees=cfg.fov_degrees, aspect=1.0, z_near=cfg.z_near,
                 render_resolution=(n, n))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    view = cam.view_data()
    leaves, _ = courtyard_scene().bake()
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
    print(f"card vs CPU, 128^2 courtyard, 3 frames: max|d image|={img_d} "
          f"(share > 1 step {far:.5f}), max|d depth|={dep_d} (share differing {dep_share:.5f})")
    return far <= 0.005 and dep_share <= 0.005


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script runs on an NVIDIA card")
    if not (REPO / "androidrenderer_tpu_torch" / "csrc" / "raster.cu").is_file():
        return fail(f"androidrenderer_tpu_torch/ is not beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    from androidrenderer_tpu_torch import init_device
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

    # 2. build
    LIBRARY.load()
    print(f"built {LIBRARY.path.relative_to(REPO)} for sm_90a in {LIBRARY.build_seconds:.1f} s")
    for line in LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain version at the main path's shapes
    cfg, scene, view = bench_setup(dev)
    result, ok = kernel_checks(cfg, scene, view)
    if not ok:
        return fail("kernel and plain version disagree at the bench shapes")

    # 4. the slice
    ms, launches, frames, problems = run_slice(cfg, scene, view, "--profile" in argv)
    if problems:
        return fail("raster-only frame: " + "; ".join(problems))
    result["launches"] = launches
    print(f"raster_only_frame_ms: {ms:.3f} ({kind}; {smi})")
    del scene
    torch.cuda.empty_cache()

    # 5. card vs CPU
    if not card_vs_cpu():
        return fail("card and CPU frames disagree")

    # 6. results
    print(json.dumps({"kernels": [result]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
