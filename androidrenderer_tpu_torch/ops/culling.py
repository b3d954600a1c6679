"""GPU-driven culling — frustum + HiZ occlusion, as masks over the primitive table.

The port of the JAX package's ``ops/culling.py`` (hi_z_culling.comp: frustum
plane test :85-99, Mara-McGuire sphere projection :58-77, HiZ pyramid test
:101-131; DepthCullingPhase's two-pass scheme, depth_culling_phase.cpp:182-241).
Sign conventions: view-space forward distance d = -z_view > 0, reversed-Z depth
= z_near / d. The HiZ pyramid is a min-reduction mip chain (reversed-Z
"farthest" is the minimum depth); a sphere is occluded when its nearest depth is
below the pyramid's min over its screen AABB. ``occlusion_cull_spheres`` reads
a footprint that covers the whole AABB, where the JAX package's reads one at
its centre (see there).

Band rendering (``row_offset``/``full_height``): the pyramid covers rows
[row_offset, row_offset + band) of the frame; each sphere reads the texels of
its AABB's rows within the band, and a sphere whose AABB misses the band is
culled for that band (the sharded frame ORs the bands' visibility,
parallel/collectives.any_across); one that crosses the near plane stays visible
in every band.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def _view_space(bounds: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """Sphere centres in view space: the (P, 3) @ (3, 3) product plus the
    translation, as the JAX package writes it (a full-float32 matmul: the
    package switches TF32 off on the card, androidrenderer_tpu_torch.init_device)."""
    return bounds[:, :3] @ view[:3, :3].T + view[:3, 3]


def frustum_cull_spheres(
    bounds: torch.Tensor,  # (P, 4) world [center, radius]
    view: torch.Tensor,  # (4, 4)
    frustum: torch.Tensor,  # (4,) [fx.x, fx.z, fy.y, fy.z] (camera.py)
    z_near,
    radius_pad: float = 0.0,
) -> torch.Tensor:
    """(P,) bool — True = potentially visible (hi_z_culling.comp:85-99)."""
    c = _view_space(bounds, view)
    r = bounds[:, 3] + radius_pad
    # Symmetric frustum: the |x| form tests the left and right planes at once.
    vis = c[:, 2] * frustum[1] - torch.abs(c[:, 0]) * frustum[0] > -r
    vis &= c[:, 2] * frustum[3] - torch.abs(c[:, 1]) * frustum[2] > -r
    # Near plane: some part of the sphere is beyond z_near ahead (d = -z).
    vis &= (-c[:, 2]) + r > z_near
    return vis


def project_sphere_aabb(
    center_view: torch.Tensor,  # (P, 3) view space
    radius: torch.Tensor,  # (P,)
    z_near,
    p00,
    p11,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mara-McGuire 2013 projected sphere bounds -> uv AABB (P, 4) [u0, v0, u1, v1]
    (0,0 = top-left) + validity mask (the sphere lies wholly beyond the near plane)."""
    d = -center_view[:, 2]
    ok = d - radius > z_near

    def axis_bounds(cx: torch.Tensor, cz: torch.Tensor):
        # cz = forward distance (positive), cx = lateral offset; the slopes x/z of
        # (cx, cz) rotated by +-asin(r/|c|).
        t2 = cx * cx + cz * cz - radius * radius
        t = torch.sqrt(torch.clamp(t2, min=1e-12))
        mn = (cx * t - cz * radius) / torch.clamp(cx * radius + cz * t, min=1e-12)
        mx = (cx * t + cz * radius) / torch.clamp(-cx * radius + cz * t, min=1e-12)
        return mn, mx

    minx, maxx = axis_bounds(center_view[:, 0], d)
    miny, maxy = axis_bounds(center_view[:, 1], d)
    # ndc = slope * p00 (x) / slope * p11 (y); u = ndc*0.5+0.5, v = 0.5-ndc*0.5.
    u0 = minx * p00 * 0.5 + 0.5
    u1 = maxx * p00 * 0.5 + 0.5
    v0 = 0.5 - maxy * p11 * 0.5
    v1 = 0.5 - miny * p11 * 0.5
    aabb = torch.stack([u0, v0, u1, v1], dim=-1)
    return torch.clamp(aabb, 0.0, 1.0), ok


def build_hiz_pyramid(depth: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Min-reduction depth pyramid (levels[0] = full res): the FFX SPD
    downsampler's role (mip_chain_generator.cpp:5-48)."""
    levels = [depth]
    cur = depth
    for _ in range(num_levels - 1):
        h, w = cur.shape
        cur = cur.reshape(h // 2, 2, w // 2, 2).amin(dim=(1, 3))
        levels.append(cur)
    return levels


def occlusion_cull_spheres(
    bounds: torch.Tensor,  # (P, 4) world
    view: torch.Tensor,
    z_near,
    p00,
    p11,
    hiz_levels: List[torch.Tensor],
    radius_pad: float = 2.0,  # the reference inflates by +2 (hi_z_culling.comp:150)
    row_offset: int = 0,  # band rendering: first frame row covered by hiz_levels[0]
    full_height: int | None = None,  # the frame's height (defaults to the pyramid's)
) -> torch.Tensor:
    """(P,) bool — True = NOT occluded. Spheres crossing the near plane pass.

    Each sphere reads the min of a 2x2 texel footprint of the pyramid, chosen
    per sphere over the levels — the finest level whose footprint, anchored at
    the texel holding the AABB's top-left corner, covers the whole AABB; a sphere
    that no 2x2 footprint covers reads the min over its AABB's texels at the top
    level. So the test is conservative: a culled sphere has no pixel in front
    of the depth it was tested against.

    This diverges from the JAX package on purpose. Its footprint sits at the
    AABB's centre, at level floor(log2(extent)) clamped to the top, so it
    covers only part of the AABB, and it culls primitives that have visible
    pixels: on the bench scene and camera at 1024x544, JAX's
    occlusion_cull_spheres culls 4 primitives that the unculled raster shows,
    and two-phase culling then changes the frame (1556 pixels at 1024x544)."""
    c = _view_space(bounds, view)
    r = bounds[:, 3] + radius_pad
    aabb, projectable = project_sphere_aabb(c, r, z_near, p00, p11)

    h0, w0 = hiz_levels[0].shape
    fh = full_height if full_height is not None else h0
    # The AABB in pixel units (rows relative to the band); pixel i spans [i, i + 1).
    x0, x1 = aabb[:, 0] * w0, aabb[:, 2] * w0
    y0, y1 = aabb[:, 1] * fh - row_offset, aabb[:, 3] * fh - row_offset

    def texels(a, b, li, n):
        """First and last texel of [a, b] at level li, of n."""
        lo = torch.clamp(torch.floor(a / (1 << li)).to(torch.int64), 0, n - 1)
        hi = torch.clamp(torch.floor(b / (1 << li)).to(torch.int64), 0, n - 1)
        return lo, hi

    samples, covers = [], []
    for li, lv in enumerate(hiz_levels):
        lh, lw = lv.shape
        x, xe = texels(x0, x1, li, lw)
        y, ye = texels(y0, y1, li, lh)
        xn = torch.clamp(x + 1, max=lw - 1)
        yn = torch.clamp(y + 1, max=lh - 1)
        samples.append(torch.minimum(
            torch.minimum(lv[y, x], lv[y, xn]), torch.minimum(lv[yn, x], lv[yn, xn])
        ))
        covers.append((xe - x <= 1) & (ye - y <= 1))
    covers = torch.stack(covers)
    level = torch.argmax(covers.to(torch.int8), dim=0)  # the finest covering level
    pyramid_min = torch.stack(samples).gather(0, level[None]).squeeze(0)
    covered = covers.gather(0, level[None]).squeeze(0)
    # Spheres wider than the top level's 2x2: the min over all their texels.
    # Computed for every sphere (P x the top level's texels), so the host never
    # waits on the device to ask whether any sphere needs it.
    lv = hiz_levels[-1]
    lh, lw = lv.shape
    x, xe = texels(x0, x1, len(hiz_levels) - 1, lw)
    y, ye = texels(y0, y1, len(hiz_levels) - 1, lh)
    iy = torch.arange(lh, device=lv.device)[None, :, None]
    ix = torch.arange(lw, device=lv.device)[None, None, :]
    inside = ((iy >= y[:, None, None]) & (iy <= ye[:, None, None])
              & (ix >= x[:, None, None]) & (ix <= xe[:, None, None]))
    rect = torch.where(inside, lv[None], torch.full_like(lv[None], float("inf")))
    pyramid_min = torch.where(covered, pyramid_min, rect.amin(dim=(1, 2)))

    # Nearest depth of the sphere (reversed-Z): z_near / (d - r), a true
    # division (a Python number over a tensor is reciprocal-times in PyTorch).
    d = -c[:, 2]
    sphere_depth = torch.clamp(
        torch.full_like(d, z_near) / torch.clamp(d - r, min=1e-6), 0.0, 1.0
    )
    visible = (sphere_depth >= pyramid_min) | ~projectable
    if full_height is not None and full_height != h0:
        # A sphere that crosses the near plane has no meaningful AABB: it stays
        # visible in every band (JAX's band test drops it where its AABB misses).
        in_band = ((aabb[:, 3] * fh) >= row_offset) & ((aabb[:, 1] * fh) <= row_offset + h0)
        visible = visible & (in_band | ~projectable)
    return visible


def primitive_mask_to_triangle_mask(
    prim_visible: torch.Tensor,  # (P,) bool
    tri_primitive: torch.Tensor,  # (N,) i32
    tri_valid: torch.Tensor,  # (N,) bool
) -> torch.Tensor:
    return tri_valid & prim_visible[tri_primitive.to(torch.int64)]


def frustum_cull_triangles(
    corners: torch.Tensor,  # (N, 3, 3) world-space baked corner table
    view: torch.Tensor,  # (4, 4)
    frustum: torch.Tensor,  # (4,) [fx.x, fx.z, fy.y, fy.z]
    z_near,
    tri_valid: torch.Tensor,  # (N,) bool
) -> torch.Tensor:
    """(N,) bool — conservative separating-plane test: a triangle is culled only
    when all three corners lie outside ONE frustum plane (or all are nearer than
    the near plane), so it removes only triangles that can cover no pixel."""
    wx = corners[:, :, 0]
    wy = corners[:, :, 1]
    wz = corners[:, :, 2]
    x = view[0, 0] * wx + view[0, 1] * wy + view[0, 2] * wz + view[0, 3]
    y = view[1, 0] * wx + view[1, 1] * wy + view[1, 2] * wz + view[1, 3]
    z = view[2, 0] * wx + view[2, 1] * wy + view[2, 2] * wz + view[2, 3]
    lt = z * frustum[1] - x * frustum[0]  # > 0 = inside the left plane
    rt = z * frustum[1] + x * frustum[0]
    tp = z * frustum[3] - y * frustum[2]
    bt = z * frustum[3] + y * frustum[2]
    out = (
        (lt <= 0.0).all(dim=1)
        | (rt <= 0.0).all(dim=1)
        | (tp <= 0.0).all(dim=1)
        | (bt <= 0.0).all(dim=1)
        | (-z < z_near).all(dim=1)  # all corners nearer than the near plane
    )
    return tri_valid & ~out
