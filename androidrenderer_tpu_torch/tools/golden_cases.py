"""The golden-image cases of tools/make_goldens.py, rendered by the port.

The same six cases (cornell direct, LPV, RTGI and probes over 3 frames,
courtyard CSM, and VRSAA at 2x), with the same scenes, cameras, configs
(``max_tris_per_tile=4096``, occlusion culling off) and frame counts, through
the port's entry points on the device the caller names. The committed goldens
(tests/goldens/<name>.png) are the JAX package's renders; tests/test_torch_goldens.py
on the CPU and chip_smoke.py on the card hold these renders against them at
SSIM >= 0.98 (``compare``). This module only renders: it writes no golden.

The goldens' holes. A pixel whose centre lies exactly on an edge of the
triangle that covers it (the edge function is exactly 0) is covered or not by
the last bit of a program's arithmetic. The cornell view puts 92 pixel
centres on the box's diagonal wall junctions. The port's raster, antisymmetric
in every operation, covers every one of them, as the JAX frame run op by op
does; the jitted JAX frame that rendered the goldens contracted the setup's
products into fused multiply-adds and left 38 of them uncovered (black in
every cornell golden). ``compare`` reports the plain SSIM, and the SSIM with
those holes alone (tie pixels black in every cornell golden) taken from the
golden; the gate reads the second.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.config import (
    AAMode, AOMode, GIMode, RenderConfig, RenderParams, ShadowMode,
)
from androidrenderer_tpu_torch.ops.raster.binning import bin_triangles
from androidrenderer_tpu_torch.ops.raster.setup import triangle_setup_corners
from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
from androidrenderer_tpu_torch.scene.procedural import cornell_scene, courtyard_scene

GOLDEN_DIR = Path(__file__).resolve().parents[2] / "tests" / "goldens"
W = H = 128
# The gate of tests/test_goldens.py.
MIN_SSIM = 0.98


def render(scene_fn, cam_pos, cam_pitch_yaw, device, frames=1, render_scale=1, **cfg):
    """(the (H, W, 3) u8 image of the last of ``frames`` chained frames, its
    edge-tie pixels (H, W) bool, or None when the frame renders at another
    resolution than its output)."""
    rw, rh = W * render_scale, H * render_scale
    config = RenderConfig(
        render_width=rw, render_height=rh, output_width=W, output_height=H,
        max_tris_per_tile=4096, occlusion_culling=False, **cfg,
    )
    # Only the ray-traced switches read the BVH.
    rays = (config.gi_mode in (GIMode.RT, GIMode.PROBES) or config.shadow_mode == ShadowMode.RT
            or config.ao_mode == AOMode.RT)
    scene, _ = scene_fn().build(device=device, with_bvh=rays)
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(rw, rh))
    cam.set_position(cam_pos)
    cam.pitch, cam.yaw = cam_pitch_yaw
    _assert_no_bin_overflow(scene, cam.view_data(), config)
    renderer = make_renderer(config)
    temporal = temporal_state_for(config, device=scene.positions.device)
    for _ in range(frames):
        out, temporal = renderer(scene, cam.view_data(), RenderParams.default(), temporal)
    ties = None
    if (rw, rh) == (W, H):
        ties = edge_ties(scene, cam.view_data(), config, out.visibility).cpu().numpy()
    return out.image.cpu().numpy(), ties


def edge_ties(scene, view, config, vis):
    """(H, W) bool: the pixels whose centre lies exactly on an edge of the
    triangle ``vis`` names (an edge function of the main view's setup is 0)."""
    import torch

    from androidrenderer_tpu_torch.render.frame import main_view_setup

    setup, _, _ = main_view_setup(scene, view, config)
    edge = setup.edge[vis.clamp(min=0).to(torch.int64)]  # (H, W, 3 edges, 3)
    h, w = vis.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=vis.device),
                            torch.arange(w, dtype=torch.float32, device=vis.device),
                            indexing="ij")
    value = edge[..., 0] * xx[..., None] + edge[..., 1] * yy[..., None] + edge[..., 2]
    return (value == 0).any(dim=-1) & (vis >= 0)


def golden_holes(ties: np.ndarray) -> np.ndarray:
    """(H, W) bool: the edge-tie pixels of the cornell view that the goldens
    left uncovered, black in every cornell golden."""
    black = np.logical_and.reduce([golden(n).max(axis=-1) == 0 for n in CORNELL_CASES])
    return ties & black


def compare(name: str, device) -> dict:
    """Render case ``name`` on ``device`` and hold it against its golden:
    {"ssim": plain, "ssim_holes_from_golden": the gate's, "holes": the pixels
    taken from the golden}."""
    from androidrenderer_tpu_torch.utils.image import ssim

    image, ties = CASES[name](device)
    gold = golden(name)
    gated = image.copy()
    holes = 0
    if name in CORNELL_CASES:
        mask = golden_holes(ties)
        gated[mask] = gold[mask]
        holes = int(mask.sum())
    return dict(ssim=ssim(image, gold), ssim_holes_from_golden=ssim(gated, gold), holes=holes)


def _assert_no_bin_overflow(scene, view, config):
    """The goldens were rendered with no tile's bin truncated (make_goldens.py's
    check of the same name): the case's scene and view must still bin under
    ``max_tris_per_tile``, counted over every valid triangle."""
    import torch

    h, w = config.render_height, config.render_width
    dev = scene.positions.device
    su = triangle_setup_corners(
        scene.tri_corner_pos, torch.as_tensor(np.asarray(view.view_proj, np.float32), device=dev),
        w, h, double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid,
    )
    bins = bin_triangles(su, h // config.tile_height, w // config.tile_width,
                         config.tile_height, config.tile_width, cap=16)
    peak = int(bins.counts.max())
    if peak > config.max_tris_per_tile:
        raise ValueError(
            f"golden scene peaks at {peak} triangles in one {config.tile_height}x"
            f"{config.tile_width} tile but max_tris_per_tile={config.max_tris_per_tile}"
        )


_CORNELL = dict(sky=False, bloom=False, shadow_cascade_resolution=256)
CASES = {
    "cornell_direct": lambda device: render(
        cornell_scene, [0, 0, 2.2], (0.0, np.pi), device, **_CORNELL,
    ),
    # The cell size lies off cornell's wall lattice (make_goldens.py:90-99).
    "cornell_lpv": lambda device: render(
        cornell_scene, [0, 0, 2.2], (0.0, np.pi), device, **_CORNELL,
        gi_mode=GIMode.LPV, lpv_num_cascades=2, lpv_resolution=16,
        lpv_rsm_resolution=64, lpv_num_propagation_steps=8, lpv_cell_size=0.2261,
    ),
    "courtyard_csm": lambda device: render(
        courtyard_scene, [0, 1.7, 6.0], (-0.05, np.pi), device,
        shadow_cascade_resolution=256,
    ),
    "cornell_rtgi": lambda device: render(
        cornell_scene, [0, 0, 2.2], (0.0, np.pi), device, **_CORNELL,
        gi_mode=GIMode.RT, rtgi_num_bounces=1,
    ),
    # The budgeted updates need a few frames to fill the cache.
    "cornell_probes": lambda device: render(
        cornell_scene, [0, 0, 2.2], (0.0, np.pi), device, frames=3, **_CORNELL,
        gi_mode=GIMode.PROBES, probe_grid=(8, 8, 8), probe_spacing=0.4,
        probe_budget=256, probe_rays=32,
    ),
    "courtyard_vrsaa": lambda device: render(
        courtyard_scene, [0, 1.7, 6.0], (-0.05, np.pi), device,
        shadow_cascade_resolution=256, render_scale=2,
        aa_mode=AAMode.VRSAA, translucency=False,
    ),
}
# The cases that share the cornell view, and with it its 38 holes.
CORNELL_CASES = ("cornell_direct", "cornell_lpv", "cornell_rtgi", "cornell_probes")


def golden(name: str) -> np.ndarray:
    """The committed golden of a case, (H, W, 3) u8."""
    return load_png(GOLDEN_DIR / f"{name}.png")


def load_png(path) -> np.ndarray:
    """Read an 8-bit, non-interlaced RGB or RGBA PNG as (H, W, 3) u8, with zlib
    alone (the card's host has no Pillow)."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + length
    w, h, depth, color_type, _, _, interlace = ihdr
    if depth != 8 or color_type not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are read")
    c = 3 if color_type == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            row = line
        elif f == 2:
            row = (line + prev) & 255
        elif f in (1, 3, 4):  # Sub, Average, Paeth: each byte reads its left neighbour
            row = np.zeros_like(line)
            for x in range(w * c):
                a = row[x - c] if x >= c else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + prev[x]) // 2
                else:
                    b, d = prev[x], prev[x - c] if x >= c else 0
                    pa, pb, pc = abs(b - d), abs(a - d), abs(a + b - 2 * d)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else d)
                row[x] = (line[x] + pred) & 255
        else:
            raise ValueError(f"{path}: filter type {f}")
        out[y] = prev = row
    return out.reshape(h, w, c)[..., :3].astype(np.uint8)
