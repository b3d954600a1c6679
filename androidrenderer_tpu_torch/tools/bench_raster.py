"""Raster microbench: the raster family's entry points, chained, at bench scale.

The port of tools/bench_raster.py. Each step transforms the bench scene's
vertices, sets the triangles up and rasterizes them; the steps are chained
through a scalar of the previous depth (it perturbs the clip positions by
~1e-30: numerically nothing, but the next step depends on the last), so the
time is that of in-frame rasters and not of an idle loop. Modes, camera and
cascade fit are the JAX tool's:

- ``screen``: the 1920x1088 main view, depth + vis;
- ``csm``: cascade 1 of a 4-cascade fit, 1024^2 (``--res``), depth-only with
  the affine z plane;
- ``rsm``: the same cascade at 128^2 (``--res``).

Kernel names are the JAX tool's: ``fused``, ``hybrid``, ``hybrid32``,
``fusedkbN``, ``bitmask[WH[:KB[:UR[:...]]]]``, ``subfold[...]`` and
``binnedWH[:CAP[:KB[:UR[:dN]]]]``. On Hopper every name launches the one
hand-written raster kernel (csrc/raster.cu) through the entry point of the same
JAX name (``bitmask`` through ``rasterize``), so the TPU tunables in a name are
parsed and have no effect; a timing stub (``dN`` with N != 0) raises.

    python -m androidrenderer_tpu_torch.tools.bench_raster [--mode screen|csm|rsm] \\
        [--chain 10] [--kernels fused,binned8,subfold] [--res 0] [--device cuda]

Times are per raster (chain step), the least of 3 timed chains after one
warm-up chain: CUDA events on the card, the host clock on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.ops import shadow as shadow_ops
from androidrenderer_tpu_torch.ops.raster import rasterize, transform_to_clip, triangle_setup
from androidrenderer_tpu_torch.ops.raster.raster_binned import rasterize_binned
from androidrenderer_tpu_torch.ops.raster.raster_fused import rasterize_fused, rasterize_hybrid
from androidrenderer_tpu_torch.tools.experiments.raster_subfold import rasterize_subfold


def bench_view(scene, mode: str, res: int = 0):
    """(view-projection (4, 4) on the scene's device, width, height, depth_only,
    affine_z) of a mode, as the JAX tool sets them (bench_raster.py:45-75)."""
    dev = scene.positions.device
    if mode == "screen":
        w, h = 1920, 1088
        cam = Camera(fov_degrees=75.0, aspect=w / h, render_resolution=(w, h))
        cam.set_position([0.0, 1.7, 6.0])
        cam.pitch, cam.yaw = -0.05, np.pi
        return torch.as_tensor(cam.view_data().view_proj, device=dev), w, h, False, False
    if mode not in ("csm", "rsm"):
        raise ValueError(f"mode must be screen, csm or rsm, got {mode!r}")
    w = h = res or (1024 if mode == "csm" else 128)
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(w, h))
    cam.set_position([0.0, 1.7, 6.0])
    vd = cam.view_data()
    casc = shadow_ops.fit_cascades(
        torch.as_tensor(vd.inverse_view, device=dev), float(vd.projection[0, 0]),
        float(vd.projection[1, 1]), scene.sun_direction, 4, w, 0.05, 128.0, 0.95,
    )
    return casc.matrices[1], w, h, True, True


def _parse_ints(parts, defaults):
    """The leading integer fields of a kernel name, each ``defaults[i]`` when
    absent or empty."""
    return [int(parts[i]) if i < len(parts) and parts[i] else d for i, d in enumerate(defaults)]


def _no_stub(name, parts):
    for p in parts:
        if p.startswith("d") and int(p[1:]) != 0:
            raise ValueError(f"{name}: the TPU kernel's timing stubs (dN) are not ported")


def make_raster(name: str, h: int, w: int, depth_only: bool, affine: bool):
    """(label, fn(setup)) for one kernel name of the JAX tool."""
    kw = dict(depth_only=depth_only, affine_z=affine)
    if name == "fused":
        return "fused(prod)", lambda su: rasterize_fused(su, h, w, **kw)
    if name == "hybrid":
        return name, lambda su: rasterize_hybrid(su, h, w, backend="binned", win_h=16, cap=64,
                                                 **kw)
    if name == "hybrid32":
        return name, lambda su: rasterize_hybrid(su, h, w, backend="binned", win_h=32, cap=8,
                                                 kb=4, unroll=2, **kw)
    if name.startswith("fusedkb"):
        kb = int(name[7:])
        return name, lambda su: rasterize_fused(su, h, w, kb=kb, **kw)
    if name.startswith("bitmask"):
        parts = name[7:].split(":")
        _parse_ints(parts[:3], [32, 8, 4])  # win_h, kb, unroll: checked, then unused
        _no_stub(name, parts[3:])
        return name, lambda su: rasterize(su, h, w, **kw)
    if name.startswith("subfold"):
        parts = name[7:].split(":")
        _, kb, ur = _parse_ints(parts[:3], [0, 4, 1])
        _no_stub(name, parts[3:])
        return name, lambda su: rasterize_subfold(su, h, w, kb=kb, unroll=ur, **kw)
    if name.startswith("binned"):
        parts = name[6:].split(":")
        wh, cap, kb, ur = int(parts[0]), *_parse_ints(parts[1:4], [14, 8, 4])
        _no_stub(name, parts[4:5])
        return name, lambda su: rasterize_binned(su, h, w, win_h=wh, cap=cap, kb=kb, unroll=ur,
                                                 **kw)
    raise ValueError(f"unknown kernel name {name!r}")


def _chain(scene, mat, w, h, depth_only, raster, steps):
    carry = torch.zeros((), dtype=torch.float32, device=scene.positions.device)
    for _ in range(steps):
        clip = transform_to_clip(scene.positions + carry * 1e-30, mat)
        su = triangle_setup(clip, scene.tri_indices, w, h,
                            double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid)
        out = raster(su)
        d = out if depth_only else out[0]
        # Chain through a scalar only, as the JAX tool does.
        carry = d[0, 0] + d[h // 2, w // 2] * 1e-30
    return carry


def run(scene, mode: str, names, chain: int, device="cuda", res: int = 0) -> dict:
    """ms per raster of each kernel name, the least of 3 timed chains of
    ``chain`` steps after one warm-up chain, by label (printed as it goes)."""
    dev = torch.device(device)
    if scene.positions.device.type != dev.type:
        raise ValueError(f"the scene is on {scene.positions.device}, not on {device}")
    mat, w, h, depth_only, affine = bench_view(scene, mode, res)
    rasters = dict(make_raster(n, h, w, depth_only, affine) for n in names)
    results = {}
    for label, raster in rasters.items():
        t0 = time.perf_counter()
        _chain(scene, mat, w, h, depth_only, raster, chain).item()
        warm_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            if dev.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                _chain(scene, mat, w, h, depth_only, raster, chain)
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b) / chain)
            else:
                t0 = time.perf_counter()
                _chain(scene, mat, w, h, depth_only, raster, chain).item()
                times.append((time.perf_counter() - t0) * 1e3 / chain)
        results[label] = min(times)
        print(f"{label:>16}: {min(times):8.3f} ms/raster  (warm-up {warm_s:.1f} s, "
              f"runs {[round(t, 3) for t in times]}; {mode} {w}x{h} on {dev.type})")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="screen", choices=["screen", "csm", "rsm"])
    ap.add_argument("--chain", type=int, default=10)
    ap.add_argument("--kernels", default="fused,binned8,binned16")
    ap.add_argument("--res", type=int, default=0,
                    help="override target resolution (csm/rsm modes)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from androidrenderer_tpu_torch import init_device
    from androidrenderer_tpu_torch.scene.procedural import courtyard_scene

    dev = init_device(args.device)
    scene, stats = courtyard_scene(column_rings=4, detail=13).build(device=dev)
    print(f"# scene: {stats['num_triangles']} tris")
    return run(scene, args.mode, args.kernels.split(","), args.chain, dev, args.res)


if __name__ == "__main__":
    main()
