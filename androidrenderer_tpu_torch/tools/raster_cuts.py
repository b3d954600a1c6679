"""Where the Hopper rasterizer's time goes: csrc/raster.cu cut after each step.

Each cut is a copy of csrc/raster.cu with a few source lines replaced so that
the kernel stops after one more step of its work; every cut keeps the entry
point, the buffers and the grid. Timed kernel-only (tools/kernel_timing.py, as
chip_smoke.py times kernels) at the bench scene's raster call sites, in turns,
the difference between two successive cuts is the device time of the step
between them:

- ``frame``: clear, compaction, scan and resolve; the raster pass walks no unit;
- ``prologue``: + each unit's record read, row spans and warp scan;
- ``edges``: + the span pixels' edge tests;
- ``z``: + z, its range and z_limit;
- ``alpha``: + the alpha test (no key read, no atomic);
- ``full``: the kernel as it is.

Two variants, which must stay bit-equal to the plain version like ``full``:
``no_early_out`` (an atomic for every accepted fragment, no key read first) and
``no_pixel_margin`` (the span margin without its 1 pixel).

    python -m androidrenderer_tpu_torch.tools.raster_cuts       # on the card

Cut sources are built under build/torch_kernels/cuts/. A replaced line that is
not found exactly once in csrc/raster.cu raises: the cuts follow the source and
change with it.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from androidrenderer_tpu_torch.ops.cuda_build import BUILD_DIR, Library, load_all
from androidrenderer_tpu_torch.ops.raster import raster as R

_FIRST_UNIT = "  for (long long u = u0; u < total; u += stride) {"
_PIXEL_LOOP = "    for (int i0 = lane; i0 < npx; i0 += 32 * kPerLane) {"
_EDGE_TEST = "  if (!(front || back)) return false;\n"
_Z_TEST = "  if (kZLimit && !(z < zlim[pix])) return false;\n"
_KEY_READ = ("        if (ok[p]) cur[p] = kDepthOnly ? __ldcg(depth_bits + pix[p]) : "
             "__ldcg(keys + pix[p]);")
_ATOMIC_IF = "        if (ok[p] && key[p] > cur[p]) {"
_MARGIN = "  const float margin = __fadd_rn(1.0f, __fmul_rn(kSpanRel, __fadd_rn(xmag, m)));"

# name -> source replacements; the dead compares keep each step's values live.
CUTS = {
    "frame": [(_FIRST_UNIT, _FIRST_UNIT.replace("u < total", "u < 0"))],
    "prologue": [(_PIXEL_LOOP, _PIXEL_LOOP.replace("i0 < npx", "i0 < 0"))],
    "edges": [(_EDGE_TEST, _EDGE_TEST + "  if (px >= 0) return d0 == 12345.0f;\n")],
    "z": [(_Z_TEST, _Z_TEST + "  if (px >= 0) return z == 12345.0f;\n")],
    "alpha": [(_KEY_READ, "        if (ok[p]) cur[p] = ~0ull;"),
              (_ATOMIC_IF, "        if (ok[p] && key[p] == 12345ull) {")],
    "full": [],
    "no_early_out": [(_KEY_READ, "        if (ok[p]) cur[p] = 0ull;")],
    "no_pixel_margin": [(_MARGIN, _MARGIN.replace("__fadd_rn(1.0f, ", "("))],
}
STEPS = ("frame", "prologue", "edges", "z", "alpha", "full")
EXACT = ("full", "no_early_out", "no_pixel_margin")


def cut_libraries() -> dict:
    """A Library (raster_launch's signature) for each cut, its source written
    under build/torch_kernels/cuts/."""
    src = R.LIBRARY.source.read_text()
    out = BUILD_DIR / "cuts"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, reps in CUTS.items():
        text = src
        for old, new in reps:
            if text.count(old) != 1:
                raise ValueError(f"cut {name}: {old.strip()!r} is not in csrc/raster.cu once")
            text = text.replace(old, new)
        path = out / f"raster_{name}.cu"
        path.write_text(text)
        libs[name] = Library(path, R.LIBRARY.functions)
    return libs


def call_sites(device):
    """(label, setup, height, width, kwargs) of the bench scene's raster calls:
    the main view with the alpha grid, cascade 0, the exact peel's layer 0,
    the translucency peel's layer 0, no live record, and bench_raster's screen
    and csm steps."""
    from androidrenderer_tpu_torch.camera import Camera
    from androidrenderer_tpu_torch.config import default_frame_config, raster_only_config
    from androidrenderer_tpu_torch.ops import shadow as shadow_ops
    from androidrenderer_tpu_torch.ops.raster import (
        transform_to_clip, triangle_setup, triangle_setup_corners,
    )
    from androidrenderer_tpu_torch.render.frame import main_view_setup
    from androidrenderer_tpu_torch.scene.procedural import courtyard_scene
    from androidrenderer_tpu_torch.tools import bench_raster

    w, h = 1920, 1088
    cfg = raster_only_config(w, h)
    scene, _ = courtyard_scene(column_rings=4, detail=13, curtains=True).build(device=device)
    cam = Camera(fov_degrees=cfg.fov_degrees, aspect=w / h, z_near=cfg.z_near,
                 render_resolution=(w, h))
    cam.set_position([0.0, 1.7, 6.0])
    cam.pitch, cam.yaw = -0.05, np.pi
    view = cam.view_data()
    _, opaque, grid = main_view_setup(scene, view, cfg)
    res = cfg.shadow_cascade_resolution
    casc = shadow_ops.fit_cascades(
        torch.as_tensor(view.inverse_view, device=device), float(view.projection[0, 0]),
        float(view.projection[1, 1]), scene.sun_direction, cfg.num_shadow_cascades, res,
        cfg.z_near, cfg.shadow_max_distance, cfg.shadow_cascade_split_lambda,
    )
    setup_c = triangle_setup_corners(scene.tri_corner_pos, casc.canonical, res, res,
                                     double_sided=scene.tri_double_sided,
                                     tri_valid=scene.tri_valid)
    c0 = shadow_ops.derive_ortho_setup(setup_c, casc.canonical, casc.matrices[0], res)
    setup, _, _ = main_view_setup(scene, view, default_frame_config(w, h, alpha_bitmap=False))
    csm = dict(depth_only=True, affine_z=True)
    sites = [
        ("main view + alpha grid", opaque, h, w, dict(alpha_grid=grid)),
        ("cascade 0", c0, res, res, csm),
        ("peel layer 0", setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 1)), h, w,
         {}),
        ("translucency layer 0",
         setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 2)), h, w, {}),
        ("no live record", setup._replace(valid=torch.zeros_like(setup.valid)), h, w, {}),
    ]
    for mode in ("screen", "csm"):
        mat, bw, bh, depth_only, affine = bench_raster.bench_view(scene, mode)
        su = triangle_setup(transform_to_clip(scene.positions, mat), scene.tri_indices, bw, bh,
                            double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid)
        sites.append((f"bench_raster {mode}", su, bh, bw,
                      dict(depth_only=depth_only, affine_z=affine)))
    return sites


def main(argv=None) -> int:
    from androidrenderer_tpu_torch import init_device
    from androidrenderer_tpu_torch.tools.kernel_timing import kernel_only_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--cuts", default=",".join(CUTS), help="comma-separated cut names")
    args = ap.parse_args(argv)
    names = args.cuts.split(",")
    dev = init_device("cuda")
    libs = {n: lib for n, lib in cut_libraries().items() if n in names}
    t0 = time.perf_counter()
    load_all(*libs.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{smi or torch.cuda.get_device_name(dev)}: built {len(libs)} cuts in "
          f"{time.perf_counter() - t0:.1f} s")
    ok = True
    for label, setup, h, w, kw in call_sites(dev):
        kw = dict(dict(depth_only=False, affine_z=False, z_limit=None, alpha_grid=None), **kw)
        rec = R.pack_fused_records(setup, affine_z=kw["affine_z"])
        want = R._reference_from_records(rec, h, w, kw["depth_only"], kw["affine_z"],
                                         kw["z_limit"], kw["alpha_grid"])
        want = want if isinstance(want, tuple) else (want,)
        calls, exact = {}, []
        for name in names:
            call = R.prepare_raster(rec, h, w, kw["depth_only"], kw["affine_z"], kw["z_limit"],
                                    kw["alpha_grid"], library=libs[name])
            call.launch()
            torch.cuda.synchronize()
            got = call.outputs if isinstance(call.outputs, tuple) else (call.outputs,)
            if name in EXACT:
                exact.append((name, all(torch.equal(a, b) for a, b in zip(got, want))))
            calls[name] = call
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(kernel_only_ms(calls[name].launch))
        us = {name: 500.0 * sum(t) for name, t in times.items()}
        steps = [f"{b} {us[b] - us[a]:+.1f}" for a, b in zip(STEPS, STEPS[1:])
                 if a in us and b in us]
        steps += [f"{v} vs full {us[v] - us['full']:+.1f}" for v in EXACT[1:]
                  if v in us and "full" in us]
        print(f"{label}: " + ", ".join(f"{n} {us[n]:.2f} us" for n in names)
              + f"; steps: {', '.join(steps)}; bit-equal: {exact}")
        ok &= all(e for _, e in exact)
    print("raster cuts: exact variants bit-equal" if ok else "raster cuts: FAILED bit-equality")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
