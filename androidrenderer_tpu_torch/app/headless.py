"""Headless render CLI — the windows_application.cpp / AndroidMain.cpp equivalent.
The port of the JAX package's app/headless.py: the same arguments, messages and
exit codes.

Usage:
    python -m androidrenderer_tpu_torch.app.headless --scene cornell --size 256 \
        --frames 2 --out frame.png [--platform cpu]

Renders N frames of a fixture scene or a .gltf/.glb file and writes the last
frame as PNG, printing per-frame timings. It renders on the card unless
``--platform cpu`` asks for the CPU; without a card it exits with an error and
never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="androidrenderer_tpu_torch headless renderer")
    ap.add_argument("--scene", default="cornell",
                    help="fixture name: cornell | courtyard | courtyard-big | alpha, "
                         "or a .gltf/.glb path")
    ap.add_argument("--size", type=int, default=256, help="square render size (px)")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "androidrenderer_tpu_torch_frame.png"))
    ap.add_argument("--camera", default=None,
                    help="x,y,z[,pitch,yaw] camera placement override")
    ap.add_argument("--platform", default=None,
                    help="torch device override (cpu); the card when omitted")
    ap.add_argument("--orbit", type=float, default=0.0,
                    help="yaw delta per frame (radians) for motion")
    ap.add_argument("--visualize", default=None,
                    help="debug view: depth|normals|ids|albedo|roughness|metalness|"
                         "emission|position|lpv-gv|lpv-radiance|vpl|probes")
    # Live feature cvars (r.GI.Mode / r.AO / r.Shadow.SunShadowMode /
    # r.AntiAliasing equivalents — each flips one static config field).
    ap.add_argument("--gi", default="off", choices=["off", "lpv", "rt", "probes"])
    ap.add_argument("--ao", default="off", choices=["off", "ssao", "rt"])
    ap.add_argument("--shadow", default="csm", choices=["off", "csm", "rt"])
    ap.add_argument("--aa", default="off", choices=["off", "taa", "vrsaa"])
    ap.add_argument("--no-bloom", action="store_true")
    ap.add_argument("--no-occlusion", action="store_true")
    ap.add_argument("--render-scale", type=float, default=1.0,
                    help="render-res = scale * output-res (upscaler contract)")
    ap.add_argument("--aa-quality", default=None,
                    choices=["native", "quality", "balanced", "performance",
                             "ultra-performance"],
                    help="upscaler quality mode (FSR3 r.FSR3.Quality analog; "
                         "fsr3.cpp:220-232): sets --render-scale to 1/1.0, "
                         "1/1.5, 1/1.7, 1/2, 1/3; implies --aa taa")
    ap.add_argument("--interpolate", action="store_true",
                    help="also write <out>.mid.png, the synthesized midpoint "
                         "between the last two frames (FSR3 frame-generation "
                         "analog; requires --aa taa and --frames >= 2)")
    ap.add_argument("--set", action="append", default=[], metavar="CVAR=VALUE",
                    dest="cvars",
                    help="set a cvar by its reference name, e.g. "
                         "--set r.GI.LPV.Exposure=40 (repeatable; "
                         "--set list prints the registry)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from androidrenderer_tpu_torch import init_device
    from androidrenderer_tpu_torch.app.application import Application
    from androidrenderer_tpu_torch.config import RenderConfig
    from androidrenderer_tpu_torch.scene import procedural
    from androidrenderer_tpu_torch.utils.image import save_png

    w = args.width or args.size
    h = args.height or args.size
    if w % 128 or h % 32:
        print(f"error: size must be a multiple of 128x32 tiles (got {w}x{h})",
              file=sys.stderr)
        return 2

    name = args.scene
    default_cam = ([0.0, 0.0, 2.2], 0.0, 3.14159265)
    if name == "cornell":
        scene = procedural.cornell_scene()
    elif name == "courtyard":
        scene = procedural.courtyard_scene()
        default_cam = ([0.0, 1.7, 6.0], -0.05, 3.14159265)
    elif name == "courtyard-big":
        scene = procedural.courtyard_scene(column_rings=4, detail=13)
        default_cam = ([0.0, 1.7, 6.0], -0.05, 3.14159265)
    elif name == "alpha":
        scene = procedural.alpha_test_scene()
        default_cam = ([0.0, 0.0, -4.0], 0.0, 0.0)
    elif name.endswith((".gltf", ".glb")):
        from androidrenderer_tpu_torch.scene.gltf import load_gltf_scene

        scene = load_gltf_scene(name)
        default_cam = ([0.0, 1.0, 4.0], 0.0, 3.14159265)
    else:
        print(f"error: unknown scene '{name}'", file=sys.stderr)
        return 2

    from androidrenderer_tpu_torch.config import AAMode, AOMode, GIMode, ShadowMode

    if args.aa_quality:
        args.aa = "taa"
        args.render_scale = {
            "native": 1.0, "quality": 1 / 1.5, "balanced": 1 / 1.7,
            "performance": 0.5, "ultra-performance": 1 / 3.0,
        }[args.aa_quality]
    rw, rh = w, h
    if args.aa == "vrsaa":
        rw, rh = 2 * w, 2 * h  # VRSAA contract: geometry at 2x output res
    elif args.render_scale != 1.0:
        rw = max(128, int(round(w * args.render_scale / 128)) * 128)
        rh = max(32, int(round(h * args.render_scale / 32)) * 32)
    cfg = RenderConfig(
        render_width=rw, render_height=rh, output_width=w, output_height=h,
        gi_mode={"off": GIMode.OFF, "lpv": GIMode.LPV, "rt": GIMode.RT,
                 "probes": GIMode.PROBES}[args.gi],
        ao_mode={"off": AOMode.OFF, "ssao": AOMode.SSAO, "rt": AOMode.RT}[args.ao],
        shadow_mode={"off": ShadowMode.OFF, "csm": ShadowMode.CSM,
                     "rt": ShadowMode.RT}[args.shadow],
        aa_mode={"off": AAMode.OFF, "taa": AAMode.TAA,
                 "vrsaa": AAMode.VRSAA}[args.aa],
        bloom=not args.no_bloom,
        occlusion_culling=not args.no_occlusion,
        translucency=args.aa != "vrsaa",
    )
    if args.cvars:
        from androidrenderer_tpu_torch.app import cvars as cvar_mod

        if any(c.lower() == "list" for c in args.cvars):
            for d in cvar_mod.list_cvars():
                print(f"{d.name:40s} [{d.kind}] {d.help}")
            return 0

    try:
        device = init_device(args.platform or "cuda")
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    app = Application(cfg, scene, device=device)
    for spec in args.cvars:
        name, _, value = spec.partition("=")
        cfg2, params2, recompile = cvar_mod.set_cvar(
            name, value, app.config, app.params
        )
        app.params = params2
        if recompile:
            # Structural cvar: swap the frozen config and rebuild the renderer,
            # the reference's pipeline-rebuild path (scene_renderer.cpp:134-211).
            app.reconfigure(cfg2)
    print(f"scene: {app.scene_stats}")

    pos, pitch, yaw = default_cam
    if args.camera:
        try:
            parts = [float(x) for x in args.camera.split(",")]
        except ValueError:
            parts = []
        if len(parts) not in (3, 5):
            print(
                f"error: --camera expects 'x,y,z' or 'x,y,z,pitch,yaw' (got "
                f"{args.camera!r})",
                file=sys.stderr,
            )
            return 2
        pos = parts[:3]
        if len(parts) == 5:
            pitch, yaw = parts[3], parts[4]
    app.camera.set_position(pos)
    app.camera.pitch, app.camera.yaw = pitch, yaw

    img = None
    prev_img = None
    for i in range(args.frames):
        prev_img = img
        img = app.tick()
        print(f"frame {i}: {app.last_frame_seconds * 1e3:.2f} ms")
        if args.orbit:
            app.rotate(0.0, args.orbit)

    if args.interpolate:
        if prev_img is None or app._last_outputs.motion is None:
            print("error: --interpolate needs --frames >= 2 and --aa taa",
                  file=sys.stderr)
            return 2
        from androidrenderer_tpu_torch.ops.interpolation import interpolate_frame
        from androidrenderer_tpu_torch.ops.taa import upscale_bilinear

        # The flow field is this frame's reprojection motion (render res);
        # frames interpolate at display res, so upscale the flow alongside.
        motion = app._last_outputs.motion
        mv = upscale_bilinear(motion, h, w)
        mid = interpolate_frame(
            torch.as_tensor(prev_img, dtype=torch.float32, device=motion.device) / 255.0,
            torch.as_tensor(img, dtype=torch.float32, device=motion.device) / 255.0,
            mv, t=0.5,
        )
        mid_u8 = np.clip(mid.cpu().numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
        mid_path = args.out + ".mid.png"
        save_png(mid_path, mid_u8)
        print(f"wrote {mid_path}")

    if args.visualize:
        from androidrenderer_tpu_torch.ops.visualize import GI_MODES, visualize, visualize_gi

        if args.visualize in GI_MODES:
            img = visualize_gi(
                app.scene, app.camera.view_data(), app.config, app.temporal,
                app._last_outputs, args.visualize,
            ).cpu().numpy()
        else:
            img = visualize(app._last_outputs, args.visualize).cpu().numpy()

    save_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
