"""Cascaded shadow maps — DirectionalLight (directional_light.cpp:84-230,
directional_light.frag:62-94): cascade fitting, ortho depth rasters, 2x2 PCF.

The port of the JAX package's ops/shadow.py for the raster-only frame:
- 4 cascades, practical split scheme (lambda 0.95, 128 m), sphere fit with
  texel snapping, all in float32 on the scene's device;
- every cascade's triangle setup made under its own matrix, or, in the
  staggered update, derived from ONE canonical setup in the union light frame
  by affine coefficient transforms (``derive_ortho_setup``); rastered
  depth-only with the affine z plane by ``ops.raster.rasterize``;
- staggered updates: cascade 0 every frame plus ``update_budget`` far cascades
  round-robin against the packed-PCF cache in TemporalState; the round-robin
  index is a host integer;
- packed u16 2x2 PCF taps and the slope-scaled + normal-offset sampling;
- in a sharded frame, the cascade rasters divided across a process group's ranks
  and assembled exactly (``render_shadow_cascades_sharded``, and the staggered
  update's ``group``).

Far cascades (>= ``proxy_from_cascade``) rasterize the vertex-clustered proxy.
Beyond the last cascade the result is lit (1.0), the JAX package's documented
divergence from the reference's forced shadow.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from androidrenderer_tpu_torch.ops.raster import (
    rasterize,
    transform_to_clip,
    triangle_setup,
    triangle_setup_corners,
)
from androidrenderer_tpu_torch.parallel.collectives import assemble, band_index


class CascadeData(NamedTuple):
    matrices: torch.Tensor  # (C, 4, 4) world -> light clip (ortho, reversed-Z)
    splits: torch.Tensor  # (C,) far distance of each cascade (view-space meters)
    canonical: torch.Tensor  # (4, 4) union ortho frame covering every cascade


def cascade_splits(
    num_cascades: int, z_near: float, max_distance: float, lam: float
) -> Tuple[float, ...]:
    """Practical split scheme (static — config only)."""
    splits = []
    for i in range(1, num_cascades + 1):
        f = i / num_cascades
        uniform = z_near + (max_distance - z_near) * f
        logarithmic = z_near * (max_distance / z_near) ** f
        splits.append(lam * logarithmic + (1.0 - lam) * uniform)
    return tuple(splits)


def _norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=dim))


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def fit_cascades(
    inverse_view: torch.Tensor,  # (4, 4)
    p00: float,
    p11: float,
    sun_direction: torch.Tensor,  # (3,) travel direction
    num_cascades: int,
    resolution: int,
    z_near: float,
    max_distance: float,
    split_lambda: float,
) -> CascadeData:
    """Sphere-fit + texel-snapped ortho matrices for every cascade."""
    dev = inverse_view.device
    f32 = dict(dtype=torch.float32, device=dev)
    splits = cascade_splits(num_cascades, z_near, max_distance, split_lambda)
    sun = sun_direction / _norm(sun_direction)

    # Stable light basis, right-handed with view-z = -sun (see the JAX module).
    up_y = torch.abs(sun[1]) < 0.99
    up = torch.where(up_y, torch.tensor([0.0, 1.0, 0.0], **f32), torch.tensor([1.0, 0.0, 0.0], **f32))
    right = torch.linalg.cross(up, sun)
    right = right / _norm(right)
    lup = torch.linalg.cross(right, sun)

    def row(axis, offset):
        return torch.cat([axis, offset.reshape(1)])

    w_row = torch.tensor([0.0, 0.0, 0.0, 1.0], **f32)
    mats, centers, radii, origins, ranges = [], [], [], [], []
    near_d = z_near
    for i in range(num_cascades):
        far_d = splits[i]
        corners = []
        for d in (near_d, far_d):
            # float32 host arithmetic, as the JAX frame divides f32(d) / p00.
            hx = np.float32(d) / np.float32(p00)
            hy = np.float32(d) / np.float32(p11)
            for sx in (-1.0, 1.0):
                for sy in (-1.0, 1.0):
                    corners.append([np.float32(sx) * hx, np.float32(sy) * hy, np.float32(-d)])
        cv = torch.tensor(np.array(corners, np.float32), device=dev)  # (8, 3)
        rot = inverse_view[:3, :3]
        cw = torch.stack(
            [cv[:, 0] * rot[j, 0] + cv[:, 1] * rot[j, 1] + cv[:, 2] * rot[j, 2]
             + inverse_view[j, 3] for j in range(3)],
            dim=1,
        )
        center = cw.mean(dim=0)
        radius = _norm(cw - center, dim=1).max()
        # Texel snap in light space (full-texel snap of the sphere center).
        texel = 2.0 * radius / resolution
        cx = torch.floor(_dot3(center, right) / texel) * texel
        cy = torch.floor(_dot3(center, lup) / texel) * texel
        cz = _dot3(center, sun)
        center = right * cx + lup * cy + sun * cz

        backup = 2.0 * radius + 1.0
        origin = center - sun * backup
        depth_range = 2.0 * backup
        rowx = right / radius
        rowy = lup / radius
        rowz = -sun / depth_range
        m = torch.stack([
            row(rowx, -_dot3(rowx, origin)),
            row(rowy, -_dot3(rowy, origin)),
            row(rowz, 1.0 + _dot3(sun, origin) / depth_range),
            w_row,
        ])
        mats.append(m)
        centers.append(center)
        radii.append(radius)
        origins.append(origin)
        ranges.append(depth_range)
        near_d = far_d

    # Canonical union frame (same basis; covers every cascade's box + depth range).
    cs = torch.stack(centers)
    rs = torch.stack(radii)
    cu = cs.mean(dim=0)
    r_u = (_norm(cs - cu, dim=1) + rs).max()
    starts = torch.stack([_dot3(sun, o) for o in origins])
    ends = starts + torch.stack(ranges)
    s0 = starts.min()
    range_u = ends.max() - s0
    origin_u = cu + sun * (s0 - _dot3(sun, cu))
    rowx = right / r_u
    rowy = lup / r_u
    rowz = -sun / range_u
    canonical = torch.stack([
        row(rowx, -_dot3(rowx, origin_u)),
        row(rowy, -_dot3(rowy, origin_u)),
        row(rowz, 1.0 + _dot3(sun, origin_u) / range_u),
        w_row,
    ])
    return CascadeData(
        matrices=torch.stack(mats).to(torch.float32),
        splits=torch.tensor(splits, **f32),
        canonical=canonical.to(torch.float32),
    )


def derive_ortho_setup(setup_c, mc: torch.Tensor, mi: torch.Tensor, resolution: int):
    """Per-view triangle setup from a canonical ortho setup: ``mc``/``mi`` share
    the light basis (scaled rows), so edge, z and bbox transforms are affine.
    Triangles whose transformed bbox misses the target are invalidated."""
    half = resolution * 0.5
    ax = _norm(mi[0, :3]) / _norm(mc[0, :3])
    ay = _norm(mi[1, :3]) / _norm(mc[1, :3])
    az = _norm(mi[2, :3]) / _norm(mc[2, :3])
    bx = mi[0, 3] - ax * mc[0, 3]
    by = mi[1, 3] - ay * mc[1, 3]
    bz = mi[2, 3] - az * mc[2, 3]
    # ndc affine -> pixel affine (y flips in clip_to_pixel_h).
    cx = half * bx + (half - 0.5) * (1.0 - ax)
    cy = -half * by + (half - 0.5) * (1.0 - ay)

    e = setup_c.edge
    a_div = e[:, :, 0] / ax
    b_div = e[:, :, 1] / ay
    c_new = e[:, :, 2] - a_div * cx - b_div * cy
    edge_i = torch.stack([a_div, b_div, c_new], dim=-1)
    q_i = edge_i.sum(dim=1)  # ortho: W == 1 for every vertex
    r = setup_c.r
    ra = r[:, 0] / ax
    rb = r[:, 1] / ay
    rc_ = r[:, 2] - ra * cx - rb * cy
    r_t = torch.stack([ra, rb, rc_], dim=-1)
    r_i = az * r_t + bz * q_i
    b0 = setup_c.bbox
    hi = resolution - 1.0
    x0 = torch.clamp(ax * b0[:, 0] + cx, 0.0, hi)
    y0 = torch.clamp(ay * b0[:, 1] + cy, 0.0, hi)
    x1 = torch.clamp(ax * b0[:, 2] + cx, 0.0, hi)
    y1 = torch.clamp(ay * b0[:, 3] + cy, 0.0, hi)
    on = (
        (ax * b0[:, 2] + cx >= 0.0)
        & (ax * b0[:, 0] + cx <= hi)
        & (ay * b0[:, 3] + cy >= 0.0)
        & (ay * b0[:, 1] + cy <= hi)
    )
    return setup_c._replace(
        edge=edge_i.to(torch.float32),
        q=q_i.to(torch.float32),
        r=r_i.to(torch.float32),
        bbox=torch.stack([x0, y0, x1, y1], dim=-1).to(torch.float32),
        valid=setup_c.valid & on,
    )


def _setup(mat, resolution, positions, tri_indices, tri_valid, double_sided, corners):
    """The full geometry's triangle setup under ``mat``."""
    if corners is not None:
        return triangle_setup_corners(
            corners, mat, resolution, resolution,
            double_sided=double_sided, tri_valid=tri_valid,
        )
    clip = transform_to_clip(positions, mat)
    return triangle_setup(
        clip, tri_indices, resolution, resolution,
        double_sided=double_sided, tri_valid=tri_valid,
    )


def _proxy_setup(mat, resolution, proxy):
    return triangle_setup_corners(
        proxy.corners, mat, resolution, resolution,
        double_sided=proxy.tri_double_sided, tri_valid=proxy.tri_valid,
    )


def _raster_cascade(src, mc, mi, resolution):
    setup_i = derive_ortho_setup(src, mc, mi, resolution)
    return rasterize(setup_i, resolution, resolution, depth_only=True, affine_z=True)


def _raster_direct(mat, on_proxy, resolution, positions, tri_indices, tri_valid,
                   double_sided, proxy, corners):
    """One cascade rastered from a setup made under its own matrix."""
    setup = (
        _proxy_setup(mat, resolution, proxy) if on_proxy
        else _setup(mat, resolution, positions, tri_indices, tri_valid, double_sided, corners)
    )
    return rasterize(setup, resolution, resolution, depth_only=True, affine_z=True)


def render_shadow_cascades(
    positions: torch.Tensor,  # (V, 3) world
    tri_indices: torch.Tensor,  # (N, 3)
    tri_valid: torch.Tensor,  # (N,) bool
    cascades: CascadeData,
    resolution: int,
    double_sided: torch.Tensor | None = None,  # (N,) — material sidedness
    proxy=None,  # scene.proxy.ProxyMesh | None — decimated far-cascade geometry
    proxy_from_cascade: int = 10**9,  # cascades >= this index rasterize the proxy
    corners: torch.Tensor | None = None,  # (N, 3, 3) baked corner table
) -> torch.Tensor:
    """(C, R, R) reversed-Z shadow depth maps, every cascade rastered from a
    setup made under its own matrix, as the JAX package's XLA path does (its
    Pallas path derives them from the canonical setup, whose cross products
    cancel on small triangles; the staggered update below derives, as its
    only JAX version does)."""
    if double_sided is None:
        double_sided = torch.ones(tri_indices.shape[0], dtype=torch.bool, device=tri_valid.device)
    num_cascades = int(cascades.matrices.shape[0])
    k_proxy = min(max(int(proxy_from_cascade), 0), num_cascades)
    on_proxy = proxy is not None and k_proxy < num_cascades
    return torch.stack([
        _raster_direct(cascades.matrices[i], on_proxy and i >= k_proxy, resolution, positions,
                       tri_indices, tri_valid, double_sided, proxy, corners)
        for i in range(num_cascades)
    ])


def render_shadow_cascades_sharded(
    positions: torch.Tensor,
    tri_indices: torch.Tensor,
    tri_valid: torch.Tensor,
    cascades: CascadeData,
    resolution: int,
    group,  # torch.distributed process group of the frame's bands
    double_sided: torch.Tensor | None = None,
    proxy=None,
    proxy_from_cascade: int = 10**9,
    corners: torch.Tensor | None = None,
) -> torch.Tensor:
    """(C, R, R) cascade maps with the per-cascade rasters DIVIDED across the
    ranks of ``group``: rank d rasterizes cascades {i : i % n == d} into a zero
    stack and one all-reduce assembles the set (each map has one owner, so the
    result is the single-device stack bit for bit; the JAX package's version
    derives each cascade inside a lax.cond; this one makes each setup under the
    cascade's own matrix, as the JAX frame's XLA branch does).
    With n >= C each rank runs one cascade raster instead of C."""
    if double_sided is None:
        double_sided = torch.ones(tri_indices.shape[0], dtype=torch.bool, device=tri_valid.device)
    num_cascades = int(cascades.matrices.shape[0])
    k_proxy = min(max(int(proxy_from_cascade), 0), num_cascades)
    on_proxy = proxy is not None and k_proxy < num_cascades
    rank, n = band_index(group)
    maps = torch.zeros((num_cascades, resolution, resolution), dtype=torch.float32,
                       device=tri_valid.device)
    for i in range(rank, num_cascades, n):
        maps[i] = _raster_direct(cascades.matrices[i], on_proxy and i >= k_proxy, resolution,
                                 positions, tri_indices, tri_valid, double_sided, proxy, corners)
    return assemble(maps, group)


def render_shadow_cascades_staggered(
    positions: torch.Tensor,
    tri_indices: torch.Tensor,
    tri_valid: torch.Tensor,
    cascades: CascadeData,
    resolution: int,
    cached_packed: torch.Tensor,  # (C, R, R, 2) i32 packed-PCF atlas (TemporalState)
    cached_matrices: torch.Tensor,  # (C, 4, 4) matrices the cache was built with
    frame_index: int,
    update_budget: int = 1,  # far cascades re-rastered per frame (besides c0)
    double_sided: torch.Tensor | None = None,
    proxy=None,
    proxy_from_cascade: int = 10**9,
    corners: torch.Tensor | None = None,
    group=None,  # torch.distributed group: divide this frame's rasters across its ranks
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Budgeted cascade updates: cascade 0 every frame plus ``update_budget``
    far cascades round-robin; the rest keep their cached packed maps and the
    matrices they were rastered with. Returns the effective (packed atlas
    (C, R, R, 2) i32, matrices (C, 4, 4)) as new tensors; the cache passed in
    is not modified. A static scene and sun reach the rebuild-all maps exactly
    after ceil((C-1)/budget) frames.

    With ``group`` the frame's updates are divided across its ranks as in
    ``render_shadow_cascades_sharded`` (update j on rank j % n) and assembled
    by one all-reduce, so every rank ends with the single-device atlas."""
    if double_sided is None:
        double_sided = torch.ones(tri_indices.shape[0], dtype=torch.bool, device=tri_valid.device)
    num_cascades = int(cascades.matrices.shape[0])
    k_proxy = min(max(int(proxy_from_cascade), 1), num_cascades)
    use_proxy = proxy is not None and k_proxy < num_cascades
    mc = cascades.canonical
    setup_c = _setup(mc, resolution, positions, tri_indices, tri_valid, double_sided, corners)
    setup_p = _proxy_setup(mc, resolution, proxy) if use_proxy else None
    new_packed = cached_packed.clone()
    new_matrices = cached_matrices.clone()

    # Cascade 0 (nearest; the most camera-sensitive) re-rasters every frame,
    # then ``update_budget`` far cascades round-robin.
    n_far = num_cascades - 1
    b = min(max(int(update_budget), 1), n_far)
    updates = [0] + [1 + (int(frame_index) * b + j) % n_far for j in range(b)]

    def packed(k):
        src = setup_p if (use_proxy and k >= k_proxy) else setup_c
        return pack_pcf_taps(_raster_cascade(src, mc, cascades.matrices[k], resolution))

    if group is None:
        for k in updates:
            new_packed[k] = packed(k)
    else:
        rank, n = band_index(group)
        tiles = torch.zeros((len(updates), *new_packed.shape[1:]), dtype=new_packed.dtype,
                            device=new_packed.device)
        for j in range(rank, len(updates), n):
            tiles[j] = packed(updates[j])
        tiles = assemble(tiles, group)
        for j, k in enumerate(updates):
            new_packed[k] = tiles[j]
    for k in updates:
        new_matrices[k] = cascades.matrices[k]
    return new_packed, new_matrices


def pack_pcf_taps(shadow_maps: torch.Tensor) -> torch.Tensor:
    """(..., R, R) depth -> (..., R, R, 2) i32 packed 2x2 PCF taps: channel 0
    holds [self | +x << 16], channel 1 [+y | +x+y << 16], as u16 fixed point
    with edge-clamped neighbours (the reference's shadow maps are D16)."""
    r = shadow_maps.shape[-1]
    p = torch.cat([shadow_maps, shadow_maps[..., -1:, :]], dim=-2)
    p = torch.cat([p, p[..., :, -1:]], dim=-1)
    q = torch.round(torch.clamp(p, 0.0, 1.0) * 65535.0).to(torch.int32)
    w0 = q[..., :r, :r] | (q[..., :r, 1:] << 16)
    w1 = q[..., 1:, :r] | (q[..., 1:, 1:] << 16)
    return torch.stack([w0, w1], dim=-1)


def sample_csm(
    world_position: torch.Tensor,  # (H, W, 3)
    view_distance: torch.Tensor,  # (H, W) positive forward distance (-view z)
    ndotl: torch.Tensor,  # (H, W, 1)
    cascades: CascadeData,
    shadow_maps: torch.Tensor | None,  # (C, R, R); None with packed_taps
    bias_scale: float,  # 0.0005 (RenderParams.shadow_bias)
    normal: torch.Tensor | None = None,  # (H, W, 3) — enables normal-offset
    packed_taps: torch.Tensor | None = None,  # (C, R, R, 2) i32 pre-packed atlas
) -> torch.Tensor:
    """(H, W, 1) shadow factor in [0, 1] — sample_csm (frag:62-110) with 2x2 PCF
    and a normal offset of ~one cascade texel."""
    if packed_taps is None:
        packed_taps = pack_pcf_taps(shadow_maps)
    c, r = packed_taps.shape[0], packed_taps.shape[1]
    idx = (view_distance[..., None] > cascades.splits[None, None, :]).to(torch.int32).sum(dim=-1)
    in_range = idx < c
    ci = torch.clamp(idx, max=c - 1)

    wx, wy, wz = (world_position[..., k] for k in range(3))
    if normal is not None:
        nl0 = torch.clamp(ndotl[..., 0], 0.0, 1.0)
        slope = torch.sqrt(torch.clamp(1.0 - nl0 * nl0, min=0.0))
    px_ = torch.zeros_like(wx)
    py_ = torch.zeros_like(wx)
    pz_ = torch.zeros_like(wx)
    for k in range(c):
        mk = cascades.matrices[k]
        sel = ci == k
        ox, oy, oz = wx, wy, wz
        if normal is not None:
            # World texel size of this cascade: |row0| = 1/radius, texel = 2r/R.
            texel = 2.0 / (_norm(mk[0, :3]) * r)
            off = texel * (1.0 + 1.5 * slope)
            ox = wx + normal[..., 0] * off
            oy = wy + normal[..., 1] * off
            oz = wz + normal[..., 2] * off
        px_ = torch.where(sel, mk[0, 0] * ox + mk[0, 1] * oy + mk[0, 2] * oz + mk[0, 3], px_)
        py_ = torch.where(sel, mk[1, 0] * ox + mk[1, 1] * oy + mk[1, 2] * oz + mk[1, 3], py_)
        pz_ = torch.where(sel, mk[2, 0] * ox + mk[2, 1] * oy + mk[2, 2] * oz + mk[2, 3], pz_)
    u = px_ * 0.5 + 0.5
    v = 0.5 - py_ * 0.5
    z = pz_
    inside = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0) & (z > 0.0) & (z <= 1.0)

    nl = torch.clamp(ndotl[..., 0], 1e-3, 1.0)
    bias = bias_scale * torch.sqrt(torch.clamp(1.0 - nl * nl, min=0.0)) / nl + 2e-5
    zref = z + bias

    x = u * r - 0.5
    y = v * r - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    packed = packed_taps.reshape(-1, 2)
    xi = torch.clamp(x0.to(torch.int32), 0, r - 1)
    yi = torch.clamp(y0.to(torch.int32), 0, r - 1)
    words = packed[(ci * (r * r) + yi * r + xi).to(torch.int64)]  # (H, W, 2)
    taps = torch.stack(
        [
            words[..., 0] & 0xFFFF,
            (words[..., 0] >> 16) & 0xFFFF,
            words[..., 1] & 0xFFFF,
            (words[..., 1] >> 16) & 0xFFFF,
        ],
        dim=-1,
    ).to(torch.float32)
    # Reversed-Z: lit when the receiver is at least as near the sun as the occluder.
    lit4 = (zref[..., None] * 65535.0 >= taps).to(torch.float32)
    lit = (
        lit4[..., 0] * (1 - fx) * (1 - fy)
        + lit4[..., 1] * fx * (1 - fy)
        + lit4[..., 2] * (1 - fx) * fy
        + lit4[..., 3] * fx * fy
    )
    shadow = torch.where(inside & in_range, lit, torch.ones_like(lit))
    return shadow[..., None]
