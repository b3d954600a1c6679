"""Debug visualizers — RenderVisualization and the GI debug overlays as image
dumps. The port of the JAX package's ops/visualize.py.

The reference draws GI debug geometry in-scene (GV raymarch, VPL billboards,
probe spheres — light_propagation_volume.cpp:1130-1212,
irradiance_cache.cpp:308-349) and offers a visualizer picker in its debug menu
(debug_menu.cpp:325-335). The headless equivalent renders any intermediate as a
false-color image (``--visualize`` in the CLI).
"""

from __future__ import annotations

import torch

from androidrenderer_tpu_torch.ops.post import to_uint8
from androidrenderer_tpu_torch.render.frame import FrameOutputs, _f32

MODES = ("none", "depth", "normals", "ids", "albedo", "roughness", "metalness",
         "emission", "position", "overdraw")
GI_MODES = ("lpv-gv", "lpv-radiance", "vpl", "probes")


def visualize(outputs: FrameOutputs, mode: str) -> torch.Tensor:
    """(H, W, 3) u8 false-color view of an intermediate buffer."""
    g = outputs.gbuffer
    if mode == "depth":
        # Reversed-Z: log-scale for readability.
        d = outputs.depth
        img = torch.where(d > 0, torch.log2(1.0 + d * 4095.0) / 12.0, torch.zeros_like(d))
        return to_uint8(torch.stack([img] * 3, dim=-1))
    if mode == "normals":
        return to_uint8(g.normal * 0.5 + 0.5)
    if mode == "ids":
        # Hash triangle ids to colors: the product modulo 2^32, as uint32 wraps.
        v = outputs.visibility.to(torch.int64)
        h = ((v & 0xFFFFFFFF) * 2654435761) & 0xFFFFFF
        r = ((h >> 16) & 255).to(torch.float32) / 255.0
        gg = ((h >> 8) & 255).to(torch.float32) / 255.0
        b = (h & 255).to(torch.float32) / 255.0
        img = torch.stack([r, gg, b], dim=-1)
        return to_uint8(torch.where((v >= 0)[..., None], img, torch.zeros_like(img)))
    if mode == "albedo":
        return to_uint8(g.base_color)
    if mode == "roughness":
        return to_uint8(g.roughness.repeat_interleave(3, dim=-1))
    if mode == "metalness":
        return to_uint8(g.metalness.repeat_interleave(3, dim=-1))
    if mode == "emission":
        return to_uint8(g.emission / (1.0 + g.emission))
    if mode == "position":
        p = g.world_position
        return to_uint8(torch.abs(p - torch.floor(p)))
    raise ValueError(f"unknown visualizer '{mode}' (choose from {MODES})")


# --- GI debug visualizers (light_propagation_volume.cpp:1130-1212,
# --- irradiance_cache.cpp:308-349), rendered as standalone debug dumps.


def _camera_rays(view, h: int, w: int, dev):
    """(H, W, 3) world-space ray directions + (3,) origin."""
    inv_view = _f32(view.inverse_view, dev)
    p00 = float(view.projection[0, 0])
    p11 = float(view.projection[1, 1])
    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w * 2.0 - 1.0
    py = 1.0 - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * 2.0
    dirs_v = torch.stack(
        [(px[None, :] / p00).expand(h, w), (py[:, None] / p11).expand(h, w),
         -torch.ones((h, w), dtype=torch.float32, device=dev)],
        dim=-1,
    )
    d = dirs_v @ inv_view[:3, :3].T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d, inv_view[:3, 3]


def _march_lpv(volumes, view, h: int, w: int, channel: str) -> torch.Tensor:
    """Fixed-step raymarch through the LPV cascades: 'gv' shows the geometry
    volume's occlusion amplitude, 'radiance' the propagated SH DC energy."""
    dev = volumes.radiance.device
    d, o = _camera_rays(view, h, w, dev)
    c = volumes.radiance.shape[0]
    r = volumes.radiance.shape[-1]
    steps = 96
    extent = volumes.cell_sizes[-1] * r
    dt = extent / steps
    gv_dc = volumes.gv[:, 0].reshape(-1)  # (C*R^3,)
    rad_dc = volumes.radiance[:, :, 0].permute(0, 2, 3, 4, 1).reshape(-1, 3)
    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    trans = torch.ones((h, w, 1), dtype=torch.float32, device=dev)
    for s in range(steps):
        p = o[None, None, :] + d * (dt * (s + 0.5))
        # The finest cascade containing p (cascade 0 where none does).
        cellf = (p[None] - volumes.mins[:, None, None, :]) / volumes.cell_sizes[:, None, None, None]
        inside = ((cellf >= 0.0) & (cellf <= r - 1.0)).all(dim=-1)  # (C, H, W)
        ci = torch.zeros((h, w), dtype=torch.int64, device=dev)
        for k in reversed(range(c)):
            ci = torch.where(inside[k], k, ci)
        any_in = inside.any(dim=0).to(torch.float32)
        sel = cellf[0]
        for k in range(1, c):
            sel = torch.where((ci == k)[..., None], cellf[k], sel)
        cell = torch.clamp(sel.to(torch.int64), 0, r - 1)
        flat = ((ci * r + cell[..., 2]) * r + cell[..., 1]) * r + cell[..., 0]
        if channel == "gv":
            a = torch.clamp(gv_dc[flat], 0.0, 1.0) * any_in
            col = torch.stack([a, a, a], dim=-1)
        else:
            col = torch.clamp(rad_dc[flat], min=0.0) * any_in[..., None]
            a = torch.clamp(col.amax(dim=-1), 0.0, 1.0)
        a = (a * 0.25)[..., None]
        acc = acc + trans * col * a
        trans = trans * (1.0 - a)
    return to_uint8(acc / (1.0 + acc))


def _splat(img: torch.Tensor, view, positions: torch.Tensor, colors: torch.Tensor,
           mask: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Scatter colored square billboards at projected world positions.

    The (2r+1)^2 offsets are written one after another, as the JAX function
    writes them; within one offset, a pixel that several billboards reach takes
    the last one's color (the highest index), as JAX on the CPU applies
    duplicate indices in order. The winner is an ``amax`` over indices, so the
    card gives the same image."""
    h, w, _ = img.shape
    dev = img.device
    m = _f32(view.view_proj, dev)
    clip = positions @ m[:3, :3].T + m[:3, 3]
    wc = positions @ m[3, :3] + m[3, 3]
    ok = mask & (wc > 1e-6)
    ndc = clip[:, :2] / torch.clamp(wc[:, None], min=1e-6)
    # Clamped before the int32 conversion, far outside any image: only what
    # overflow would make of a point is fixed.
    x = torch.clamp((ndc[:, 0] * 0.5 + 0.5) * w, -2.0**30, 2.0**30).to(torch.int32)
    y = torch.clamp((0.5 - ndc[:, 1] * 0.5) * h, -2.0**30, 2.0**30).to(torch.int32)
    flat = img.reshape(-1, 3)
    order = torch.arange(positions.shape[0], dtype=torch.int64, device=dev)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            xi = x + dx
            yi = y + dy
            inb = ok & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = torch.where(inb, yi.to(torch.int64) * w + xi, h * w)
            last = torch.full((h * w + 1,), -1, dtype=torch.int64, device=dev)
            last = last.scatter_reduce(0, idx, torch.where(inb, order, -1), "amax")[: h * w]
            flat = torch.where((last >= 0)[:, None], colors[last.clamp(min=0)], flat)
    return flat.reshape(h, w, 3)


def visualize_gi(scene, view, config, temporal, outputs, mode: str) -> torch.Tensor:
    """GI debug dumps: rebuilds the requested GI structure outside the frame (a
    debug path) and renders it over or instead of the scene. The rasters go
    through the port's ``rasterize``: the CUDA kernel on the card, its plain
    version on the CPU."""
    from androidrenderer_tpu_torch.ops import lpv as lpv_ops
    from androidrenderer_tpu_torch.ops.probes import cascade_spacings
    from androidrenderer_tpu_torch.ops.raster import rasterize

    h, w = config.render_height, config.render_width
    dev = scene.positions.device
    if mode in ("lpv-gv", "lpv-radiance", "vpl"):
        inv_view = _f32(view.inverse_view, dev)
        volumes = lpv_ops.build_lpv(
            scene, _f32(view.position, dev), -inv_view[:3, 2], rasterize,
            config.lpv_num_cascades, config.lpv_resolution, config.lpv_cell_size,
            config.lpv_rsm_resolution, config.lpv_num_propagation_steps,
            config.lpv_behind_camera_percent,
        )
        if mode in ("lpv-gv", "lpv-radiance"):
            return _march_lpv(volumes, view, h, w, mode.split("-")[1])
        # VPL billboards: cascade 0's VPLs, splatted in their flux colors.
        mins, cells = volumes.mins, volumes.cell_sizes
        m = lpv_ops._ortho_from_sphere(
            mins[0] + 0.5 * cells[0] * config.lpv_resolution,
            0.866026 * cells[0] * config.lpv_resolution, scene.sun_direction,
        )
        albedo, nrm, wpos, val = lpv_ops.render_rsm(scene, m, config.lpv_rsm_resolution,
                                                    rasterize)
        p, _, flux, mask = lpv_ops.extract_vpls(albedo, nrm, wpos, val, scene.sun_color)
        base = outputs.image.to(torch.float32) / 255.0 * 0.25
        fl = flux / torch.clamp(flux.amax(dim=-1, keepdim=True), min=1e-6)
        return to_uint8(_splat(base, view, p, fl, mask, radius=1))
    if mode == "probes":
        probes = temporal.probes
        imgs = outputs.image.to(torch.float32) / 255.0 * 0.25
        n = probes.irradiance.shape[0]
        spacings = cascade_spacings(config.probe_spacing, n, config.probe_spacing_ladder)
        for ci in range(n):
            pos = (probes.cell[ci].to(torch.float32) + 0.5) * spacings[ci]
            col = probes.irradiance[ci].mean(dim=1)  # (P, 3)
            col = col / torch.clamp(col.amax(), min=1e-6)
            imgs = _splat(imgs, view, pos, col, probes.age[ci] < 1000, radius=2)
        return to_uint8(imgs)
    raise ValueError(f"unknown GI visualizer '{mode}' (choose from {GI_MODES})")
