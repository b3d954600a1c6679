"""Texture pool sampling (the port of the JAX package's ops/texture.py).

The pool is ONE flat mip-packed texel array (R, 117) u8 holding every material
triple (base + normal + metal-rough) at its native power-of-two resolution
(material_storage.pack_texture_pool): texel (entry, level, y, x) lives at flat
row ``start_t + (4*b^2 - 4*s^2)/3 + y*s + x`` (b = entry base size, s = b >> level).
Channels 0:16 carry the base 2x2 wrap footprint, 16:52 the next level's 3x3,
52:64/64:91 the normal map's pair and 91:99/99:117 the metal-rough pair, so one
row lookup resolves a whole material trilinearly.

Gather indices are clamped into the pool, as XLA clamps them: only pixels the
caller masks out (no triangle) can carry out-of-range rows.
"""

from __future__ import annotations

import torch


def _fetch(pool: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    row = row.to(torch.int64).clamp(0, pool.shape[0] - 1)
    return pool[row].to(torch.float32) * (1.0 / 255.0)


def _level_geometry(log2b: torch.Tensor, level: torch.Tensor):
    """(size, size as f32, mip row offset) of ``level`` in entries of base 2^log2b."""
    b = torch.ones_like(log2b) << log2b
    size = b >> level
    mip_off = torch.div((b * b - size * size) * 4, 3, rounding_mode="floor")
    return size, size.to(torch.float32), mip_off


def _footprint(uv: torch.Tensor, size: torch.Tensor, sizef: torch.Tensor):
    """Wrapped uv, the 2x2 footprint origin (x0i, y0i) and weights (fx, fy)."""
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * sizef - 0.5
    y = v * sizef - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int32) & (size - 1)
    y0i = y0.to(torch.int32) & (size - 1)
    return u, v, x0i, y0i, fx, fy


def sample_bilinear(
    pool: torch.Tensor,  # (R, >=16) u8 — rows carry the level's 2x2 wrap footprint
    start: torch.Tensor,  # (...,) i32 per-sample texture start row
    log2b: torch.Tensor,  # (...,) i32 per-sample log2(base size)
    uv: torch.Tensor,  # (..., 2) f32, repeat-wrapped
    level: torch.Tensor,  # (...,) i32 mip level (clamped per texture)
) -> torch.Tensor:
    """Bilinear sample at an integer mip level from ONE flat row gather:
    (..., 4) f32 in [0, 1]. Repeat wrap is a bitwise AND (sizes are powers of
    two); the level's rows start (4b^2 - 4s^2) // 3 into the entry."""
    log2b = log2b.to(torch.int32)
    level = torch.minimum(level.to(torch.int32).clamp(min=0), log2b)
    size, sizef, mip_off = _level_geometry(log2b, level)
    _, _, x0i, y0i, fx, fy = _footprint(uv, size, sizef)
    taps = _fetch(pool, start + mip_off + y0i * size + x0i)
    return _bilerp(taps[..., 0:4], taps[..., 4:8], taps[..., 8:12], taps[..., 12:16], fx, fy)


def sample_mr_bilinear(
    pool: torch.Tensor,  # (R, 117) u8 material-triple pool
    start: torch.Tensor,
    log2b: torch.Tensor,
    uv: torch.Tensor,
    level: torch.Tensor,  # (...,) i32 mip level
) -> torch.Tensor:
    """Metal-rough bilinear from the triple row's 91:99 channels: (..., 2)
    [G = roughness, B = metalness] (glTF metallicRoughness channel order), at an
    integer LOD (RT hit shading, where rays carry no derivatives; the
    reference's hit shaders sample level 0 likewise)."""
    log2b = log2b.to(torch.int32)
    level = torch.minimum(level.to(torch.int32).clamp(min=0), log2b)
    size, sizef, mip_off = _level_geometry(log2b, level)
    _, _, x0i, y0i, fx, fy = _footprint(uv, size, sizef)
    taps = _fetch(pool, start + mip_off + y0i * size + x0i)
    return _bilerp(taps[..., 91:93], taps[..., 93:95], taps[..., 95:97], taps[..., 97:99], fx, fy)


class _Coarse:
    """Selection of the next level's 2x2 footprint inside a row's 3x3 blocks."""

    def __init__(self, u, v, x0i, y0i, size, level, log2b):
        s1 = torch.clamp(size >> 1, min=1)
        s1f = s1.to(torch.float32)
        xc = u * s1f - 0.5
        yc = v * s1f - 0.5
        xc0 = torch.floor(xc)
        yc0 = torch.floor(yc)
        self.fxc = (xc - xc0)[..., None]
        self.fyc = (yc - yc0)[..., None]
        last = level >= log2b
        kx = torch.where(last, x0i, x0i >> 1)
        ky = torch.where(last, y0i, y0i >> 1)
        sc = torch.where(last, size, s1)
        xc0i = xc0.to(torch.int32) & (sc - 1)
        yc0i = yc0.to(torch.int32) & (sc - 1)
        self.ox1 = (((xc0i - kx + 1) & (sc - 1)) == 1)[..., None]
        self.oy1 = (((yc0i - ky + 1) & (sc - 1)) == 1)[..., None]

    def bilerp(self, taps, block_off: int, ch: int):
        def cell(i, j):
            o = block_off + (i * 3 + j) * ch
            return taps[..., o : o + ch]

        def pick(di, dj):
            r0 = torch.where(self.ox1, cell(0 + di, 1 + dj), cell(0 + di, 0 + dj))
            r1 = torch.where(self.ox1, cell(1 + di, 1 + dj), cell(1 + di, 0 + dj))
            return torch.where(self.oy1, r1, r0)

        ctop = pick(0, 0) + (pick(0, 1) - pick(0, 0)) * self.fxc
        cbot = pick(1, 0) + (pick(1, 1) - pick(1, 0)) * self.fxc
        return ctop + (cbot - ctop) * self.fyc


def _trilinear_setup(pool, start, log2b, uv, lod):
    log2b = log2b.to(torch.int32)
    lodc = torch.minimum(lod.clamp(min=0.0), log2b.to(torch.float32))
    level = torch.floor(lodc).to(torch.int32)
    fl = (lodc - level.to(torch.float32))[..., None]
    size, sizef, mip_off = _level_geometry(log2b, level)
    u, v, x0i, y0i, fx, fy = _footprint(uv, size, sizef)
    taps = _fetch(pool, start + mip_off + y0i * size + x0i)
    coarse = _Coarse(u, v, x0i, y0i, size, level, log2b)
    return taps, fx, fy, fl, coarse


def _bilerp(c00, c01, c10, c11, fx, fy):
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    return top + (bot - top) * fy


def sample_trilinear(
    pool: torch.Tensor,  # (R, >=16) u8
    start: torch.Tensor,
    log2b: torch.Tensor,
    uv: torch.Tensor,
    lod: torch.Tensor,  # (...,) f32 fractional level of detail
) -> torch.Tensor:
    """Two-fetch trilinear (..., 4): a bilinear sample at each of the two levels
    around ``lod``, blended; the reference path that sample_trilinear_fused's
    one-fetch result equals bit for bit."""
    lodc = torch.minimum(lod.clamp(min=0.0), log2b.to(torch.float32))
    l0 = torch.floor(lodc).to(torch.int32)
    l1 = torch.minimum(l0 + 1, log2b.to(torch.int32))
    f = (lodc - l0.to(torch.float32))[..., None]
    a = sample_bilinear(pool, start, log2b, uv, l0)
    b = sample_bilinear(pool, start, log2b, uv, l1)
    return a + (b - a) * f


def sample_trilinear_fused(
    pool: torch.Tensor,  # (R, >=52) u8 — rows carry level L 2x2 + level L+1 3x3
    start: torch.Tensor,
    log2b: torch.Tensor,
    uv: torch.Tensor,
    lod: torch.Tensor,  # (...,) f32 fractional level of detail
) -> torch.Tensor:
    """Trilinear filtering of the base channels from ONE row fetch (..., 4)."""
    taps, fx, fy, fl, coarse = _trilinear_setup(pool, start, log2b, uv, lod)
    fine = _bilerp(taps[..., 0:4], taps[..., 4:8], taps[..., 8:12], taps[..., 12:16], fx, fy)
    return fine + (coarse.bilerp(taps, 16, 4) - fine) * fl


def sample_material_fused(
    pool: torch.Tensor,  # (R, 117) u8 material-triple pool
    start: torch.Tensor,
    log2b: torch.Tensor,
    uv: torch.Tensor,
    lod: torch.Tensor,  # (...,) f32 fractional level of detail
):
    """(base (..., 4), normal (..., 3), metal_rough (..., 2)), every slot
    trilinear, from ONE row fetch."""
    taps, fx, fy, fl, coarse = _trilinear_setup(pool, start, log2b, uv, lod)
    fine = _bilerp(taps[..., 0:4], taps[..., 4:8], taps[..., 8:12], taps[..., 12:16], fx, fy)
    base = fine + (coarse.bilerp(taps, 16, 4) - fine) * fl
    nrm_fine = _bilerp(
        taps[..., 52:55], taps[..., 55:58], taps[..., 58:61], taps[..., 61:64], fx, fy
    )
    nrm = nrm_fine + (coarse.bilerp(taps, 64, 3) - nrm_fine) * fl
    mr_fine = _bilerp(
        taps[..., 91:93], taps[..., 93:95], taps[..., 95:97], taps[..., 97:99], fx, fy
    )
    mr = mr_fine + (coarse.bilerp(taps, 99, 2) - mr_fine) * fl
    return base, nrm, mr


def compute_lod_uv(
    duv_dx: torch.Tensor,  # (..., 2) analytic UV derivative wrt pixel x
    duv_dy: torch.Tensor,  # (..., 2)
    mip_bias: float = 0.0,
) -> torch.Tensor:
    """Size-free LOD: log2 of the max screen-space footprint in UV units."""
    fx = (duv_dx * duv_dx).sum(dim=-1)
    fy = (duv_dy * duv_dy).sum(dim=-1)
    rho2 = torch.maximum(torch.maximum(fx, fy), torch.full_like(fx, 1e-24))
    return 0.5 * torch.log2(rho2) + mip_bias
