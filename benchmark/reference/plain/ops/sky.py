# Frozen copy of androidrenderer_tpu_torch/ops/sky.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed; no band mode.
"""Procedural sky — Hillaire 2020 atmosphere (procedural_sky.cpp:75-172).

The port of the JAX package's ops/sky.py background path: a per-pixel 12-step
march with closed-form single scattering plus Hillaire's multiple-scattering
term Psi_ms, tabulated host-side once (``multiscatter_lut``, numpy) and applied
through a polynomial fit (``psi_ms``). Constants are the reference shader's
(ARPC-modified rayleigh/ozone, sky/common.glsl:25-33).

The LUT pipeline (procedural_sky.cpp:75-149), which the probe updates read for
their missed rays: the static transmittance LUT (baked in numpy at first use),
the per-frame sky-view LUT (a single-scattering march through it) and a
bilinear LUT sample for arbitrary directions; ``sky_background_lut`` is the
LUT-driven background, which no frame path calls, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.plain.ops.brdf import normalize

GROUND_RADIUS_MM = 6.360  # megameters
ATMO_RADIUS_MM = 6.460
RAYLEIGH_SCATTER = np.array([6.6, 12.3, 29.4], np.float32)  # per Mm (ARPC)
RAYLEIGH_ABSORB = 0.0
MIE_SCATTER = 3.996
MIE_ABSORB = 4.4
OZONE_ABSORB = np.array([2.26, 1.54, 0.0], np.float32)  # (ARPC)
GROUND_ALBEDO = 0.3


def _rayleigh_phase(cos_theta):
    return 3.0 * (1.0 + cos_theta**2) / (16.0 * math.pi)


def _mie_phase(cos_theta, g=0.8):
    g2 = g * g
    num = (1.0 - g2) * (1.0 + cos_theta**2)
    den = (2.0 + g2) * (1.0 + g2 - 2.0 * g * cos_theta) ** 1.5
    return 3.0 / (8.0 * math.pi) * num / torch.clamp(den, min=1e-6)


def _densities(h_km):
    """Rayleigh / Mie / ozone density at altitude h (km)."""
    rho_r = torch.exp(-h_km / 8.0)
    rho_m = torch.exp(-h_km / 1.2)
    rho_o = torch.clamp(1.0 - torch.abs(h_km - 25.0) / 15.0, min=0.0)
    return rho_r, rho_m, rho_o


def _ray_sphere_exit(o_mm, d, radius):
    """Distance to sphere exit for origin inside sphere (o in Mm)."""
    b = (o_mm * d).sum(dim=-1)
    c = (o_mm * o_mm).sum(dim=-1) - radius * radius
    disc = torch.clamp(b * b - c, min=0.0)
    return -b + torch.sqrt(disc)


# --- Multiple scattering (procedural_sky.cpp:75-149, multiscattering_lut.comp) ----
#
# Hillaire's Psi_ms factor, tabulated over (sun zenith cosine, altitude) in a
# 32x32 LUT host-side once and fitted with a low-order 2D polynomial whose
# evaluation is plain elementwise math. Identical to the JAX package's numpy.

_MS_CACHE = {}


def multiscatter_lut(res: int = 32, dirs: int = 64, steps: int = 20):
    """(res, res) x 3 numpy LUT: Psi_ms over (mu_s in [-1,1], h in [0, atmo])."""
    key = (res, dirs, steps)
    if key in _MS_CACHE:
        return _MS_CACHE[key]
    rs = np.asarray(RAYLEIGH_SCATTER)
    oz = np.asarray(OZONE_ABSORB)

    mu_s = np.linspace(-1.0, 1.0, res)
    h_km = np.linspace(0.01, (ATMO_RADIUS_MM - GROUND_RADIUS_MM) * 1e3 - 1.0, res)
    # Fibonacci sphere directions.
    i = np.arange(dirs) + 0.5
    phi = np.pi * (1.0 + 5.0**0.5) * i
    ct = 1.0 - 2.0 * i / dirs
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    dvec = np.stack([st * np.cos(phi), ct, st * np.sin(phi)], -1)  # (D, 3)

    MU, HK = np.meshgrid(mu_s, h_km, indexing="ij")
    to_sun = np.stack([np.sqrt(np.maximum(1 - MU**2, 0.0)), MU, np.zeros_like(MU)], -1)
    o = np.zeros((res, res, 3))
    o[..., 1] = GROUND_RADIUS_MM + HK * 1e-3

    l2 = np.zeros((res, res, 3))
    fms = np.zeros((res, res, 3))
    for k in range(dirs):
        d = dvec[k]
        b = np.sum(o * d, -1)
        c_a = np.sum(o * o, -1) - ATMO_RADIUS_MM**2
        t_atmo = -b + np.sqrt(np.maximum(b * b - c_a, 0.0))
        c_g = np.sum(o * o, -1) - GROUND_RADIUS_MM**2
        disc = b * b - c_g
        tg = np.where(
            (disc > 0) & (-b - np.sqrt(np.maximum(disc, 0)) > 0),
            -b - np.sqrt(np.maximum(disc, 0)), np.inf,
        )
        t_max = np.minimum(t_atmo, tg)
        dt = t_max / steps
        trans = np.ones((res, res, 3))
        for s in range(steps):
            t = (s + 0.5) * dt
            p = o + d[None, None, :] * t[..., None]
            hh = (np.sqrt(np.sum(p * p, -1)) - GROUND_RADIUS_MM) * 1e3
            rho_r = np.exp(-hh / 8.0)
            rho_m = np.exp(-hh / 1.2)
            rho_o = np.maximum(0.0, 1.0 - np.abs(hh - 25.0) / 15.0)
            scat = rs * rho_r[..., None] + MIE_SCATTER * rho_m[..., None]
            ext = (
                rs * rho_r[..., None]
                + (MIE_SCATTER + MIE_ABSORB) * rho_m[..., None]
                + oz * rho_o[..., None]
            )
            # Sun transmittance (same Chapman approximation as the march).
            up = p / np.maximum(np.sqrt(np.sum(p * p, -1))[..., None], 1e-9)
            ms = np.sum(up * to_sun, -1)
            air = 1.0 / np.maximum(ms + 0.15 * np.maximum(ms + 0.24, 0.0) ** 0.2, 0.02)
            od = (
                rs * (rho_r * 8e-3 * air)[..., None]
                + (MIE_SCATTER + MIE_ABSORB) * (rho_m * 1.2e-3 * air)[..., None]
                + oz * (rho_o * 15e-3 * air * 0.35)[..., None]
            )
            sun_t = np.exp(-od) * (ms > -0.1)[..., None]
            step_t = np.exp(-ext * dt[..., None])
            integ = (1.0 - step_t) / np.maximum(ext, 1e-6)
            # Second order: isotropic phase 1/4pi; f_ms: scattered-anywhere factor.
            l2 += trans * scat * (1.0 / (4.0 * np.pi)) * sun_t * integ
            fms += trans * scat * integ
            trans = trans * step_t
        # Ground bounce contributes to L_2nd.
        hit = np.isfinite(tg) & (tg < t_atmo)
        pg = o + d[None, None, :] * np.where(hit, tg, 0.0)[..., None]
        upg = pg / np.maximum(np.sqrt(np.sum(pg * pg, -1))[..., None], 1e-9)
        nl = np.clip(np.sum(upg * to_sun, -1), 0.0, 1.0)
        l2 += np.where(
            hit[..., None], trans * (GROUND_ALBEDO / np.pi) * nl[..., None], 0.0
        )
    l2 /= dirs
    fms /= dirs
    psi = l2 / np.maximum(1.0 - fms, 1e-3)
    _MS_CACHE[key] = (psi, mu_s, h_km)
    return _MS_CACHE[key]


def multiscatter_poly(deg: int = 5):
    """Per-channel 2D polynomial fit of sqrt(Psi_ms) over (mu_s, h_norm).
    Returns (deg+1, deg+1, 3) float32 coefficients (numpy)."""
    key = ("poly", deg)
    if key in _MS_CACHE:
        return _MS_CACHE[key]
    psi, mu_s, h_km = multiscatter_lut()
    hn = h_km / h_km[-1]
    MU, HN = np.meshgrid(mu_s, hn, indexing="ij")
    basis = np.stack(
        [MU**i * HN**j for i in range(deg + 1) for j in range(deg + 1)], -1
    ).reshape(-1, (deg + 1) ** 2)
    target = np.sqrt(np.maximum(psi, 0.0)).reshape(-1, 3)
    coeffs, *_ = np.linalg.lstsq(basis, target, rcond=None)
    out = coeffs.reshape(deg + 1, deg + 1, 3).astype(np.float32)
    _MS_CACHE[key] = out
    return out


def psi_ms(mu_s, h_km, coeffs: torch.Tensor) -> torch.Tensor:
    """(..., 3) Psi_ms from the polynomial fit — pure elementwise math."""
    deg = coeffs.shape[0] - 1
    hn = torch.clamp(h_km / ((ATMO_RADIUS_MM - GROUND_RADIUS_MM) * 1e3 - 1.0), 0.0, 1.0)
    mu = torch.clamp(mu_s, -1.0, 1.0)
    acc = torch.zeros((*mu.shape, 3), dtype=torch.float32, device=mu.device)
    mi = torch.ones_like(mu)
    for i in range(deg + 1):
        hj = torch.ones_like(hn)
        for j in range(deg + 1):
            acc = acc + (mi * hj)[..., None] * coeffs[i, j]
            hj = hj * hn
        mi = mi * mu
    return torch.clamp(acc, min=0.0) ** 2


def sky_radiance(
    directions: torch.Tensor,  # (..., 3) world-space unit view rays (y up)
    sun_direction: torch.Tensor,  # (3,) direction the light TRAVELS
    altitude_km: float = 0.2,
    num_steps: int = 12,
) -> torch.Tensor:
    """Sky radiance (..., 3), relative units: single scattering + the Hillaire
    multiple-scattering term, Psi_ms evaluated once per pixel at the first
    march sample (as the JAX frame does)."""
    dev = directions.device

    def const(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    rayleigh = const(RAYLEIGH_SCATTER)
    ozone = const(OZONE_ABSORB)
    to_sun = normalize(-sun_direction.to(torch.float32))
    d = directions
    o = torch.zeros_like(d) + const([0.0, GROUND_RADIUS_MM + altitude_km * 1e-3, 0.0])

    # Ground intersection shortens the ray.
    t_atmo = _ray_sphere_exit(o, d, ATMO_RADIUS_MM)
    b = (o * d).sum(dim=-1)
    c_g = (o * o).sum(dim=-1) - GROUND_RADIUS_MM**2
    disc_g = b * b - c_g
    root = -b - torch.sqrt(torch.clamp(disc_g, min=0.0))
    t_ground = torch.where((disc_g > 0) & (root > 0), root, torch.full_like(root, math.inf))
    t_max = torch.minimum(t_atmo, t_ground)

    cos_sun = (d * to_sun).sum(dim=-1)
    ph_r = _rayleigh_phase(cos_sun)[..., None]
    ph_m = _mie_phase(cos_sun)[..., None]

    dt = t_max / num_steps
    lum = torch.zeros((*d.shape[:-1], 3), dtype=torch.float32, device=dev)
    transmittance = torch.ones((*d.shape[:-1], 3), dtype=torch.float32, device=dev)
    psi0 = None
    for i in range(num_steps):
        t = (i + 0.5) * dt
        p = o + d * t[..., None]
        h_km = (torch.sqrt((p * p).sum(dim=-1)) - GROUND_RADIUS_MM) * 1e3
        rho_r, rho_m, rho_o = _densities(h_km)
        scat_r = rayleigh * rho_r[..., None]
        scat_m = MIE_SCATTER * rho_m[..., None]
        extinction = (
            scat_r
            + (MIE_SCATTER + MIE_ABSORB) * rho_m[..., None]
            + ozone * rho_o[..., None]
        )
        # Sun transmittance: analytic Chapman-ish approximation along the sun ray.
        mu_s = (normalize(p) * to_sun).sum(dim=-1)
        air_mass = 1.0 / torch.clamp(mu_s + 0.15 * (mu_s + 0.24) ** 0.2, min=0.02)
        od_sun = (
            rayleigh * (rho_r * 8e-3 * air_mass)[..., None]
            + (MIE_SCATTER + MIE_ABSORB) * (rho_m * 1.2e-3 * air_mass)[..., None]
            + ozone * (rho_o * 15e-3 * air_mass * 0.35)[..., None]
        )
        sun_t = torch.exp(-od_sun) * (mu_s > -0.1)[..., None]
        in_scatter = (scat_r * ph_r + scat_m * ph_m) * sun_t
        if psi0 is None:
            psi0 = psi_ms(mu_s, h_km, const(multiscatter_poly()))
        in_scatter = in_scatter + (scat_r + scat_m) * psi0
        step_t = torch.exp(-extinction * dt[..., None])
        lum = lum + transmittance * in_scatter * (1.0 - step_t) / torch.clamp(
            extinction, min=1e-6
        )
        transmittance = transmittance * step_t

    # Sun disc (angular radius ~0.53 deg) through remaining transmittance.
    sun_disc = (cos_sun > 0.999957) & (t_ground == math.inf)
    lum = lum + torch.where(
        sun_disc[..., None], transmittance * 1000.0, torch.zeros_like(transmittance)
    )
    return lum


def view_ray_directions(
    inverse_view: torch.Tensor,  # (4, 4)
    p00,
    p11,
    height: int,
    width: int,
) -> torch.Tensor:
    """(H, W, 3) world-space unit rays through pixel centers."""
    dev = inverse_view.device
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width * 2.0 - 1.0
    py = 1.0 - (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height * 2.0
    x = px[None, :] / p00
    y = py[:, None] / p11
    d_view = torch.stack(
        [x.expand(height, width), y.expand(height, width),
         -torch.ones((height, width), dtype=torch.float32, device=dev)],
        dim=-1,
    )
    d_world = d_view @ inverse_view[:3, :3].T
    return normalize(d_world)


def sky_background(
    inverse_view: torch.Tensor,
    p00,
    p11,
    sun_direction: torch.Tensor,
    sun_color: torch.Tensor,
    height: int,
    width: int,
    exposure: float = 0.00031415927,
) -> torch.Tensor:
    """(H, W, 3) HDR sky for the background pass, pre-scaled to lit-scene units."""
    dirs = view_ray_directions(inverse_view, p00, p11, height, width)
    lum = sky_radiance(dirs, sun_direction)
    return lum * sun_color[None, None, :] * exposure * 0.05


# ---------------------------------------------------------------------------
# LUT pipeline (procedural_sky.cpp:75-149).

_TRANSMITTANCE_LUT = {}
T_LUT_MU = 64  # sun zenith cosine axis
T_LUT_H = 64  # altitude axis (0..atmosphere top)
SKY_LUT_H = 128
SKY_LUT_W = 256


def _transmittance_lut_numpy(steps: int = 48) -> np.ndarray:
    """(T_LUT_H, T_LUT_MU, 3) float32: the JAX module's float64 march from
    (0, r0) toward (sin, mu) to the atmosphere's top, every (altitude, mu) cell
    at once (the same float64 operations per cell as its loop)."""
    hs = np.linspace(0.0, (ATMO_RADIUS_MM - GROUND_RADIUS_MM), T_LUT_H)
    mus = np.linspace(-0.2, 1.0, T_LUT_MU)
    rs = np.asarray(RAYLEIGH_SCATTER).astype(np.float64)
    oz = np.asarray(OZONE_ABSORB).astype(np.float64)
    r0 = (GROUND_RADIUS_MM + hs)[:, None] + 0.0 * mus[None, :]
    mu = np.broadcast_to(mus[None, :], r0.shape)
    sn = np.sqrt(np.maximum(1.0 - mu * mu, 0.0))
    b = 0.0 * sn + r0 * mu
    c = (0.0 * 0.0 + r0 * r0) - ATMO_RADIUS_MM**2
    t_exit = -b + np.sqrt(np.maximum(b * b - c, 0.0))
    dt = t_exit / steps
    od = np.zeros(r0.shape + (3,))
    for k in range(steps):
        px = 0.0 + sn * (k + 0.5) * dt
        py = r0 + mu * (k + 0.5) * dt
        hk = (np.sqrt(px * px + py * py) - GROUND_RADIUS_MM) * 1e3  # km
        rho_r = np.exp(-hk / 8.0)
        rho_m = np.exp(-hk / 1.2)
        rho_o = np.maximum(0.0, 1.0 - np.abs(hk - 25.0) / 15.0)
        od = od + (rs * rho_r[..., None] + (MIE_SCATTER + MIE_ABSORB) * rho_m[..., None]
                   + oz * rho_o[..., None]) * dt[..., None]
    return np.exp(-od).astype(np.float32)


def transmittance_lut(device) -> torch.Tensor:
    """(T_LUT_H, T_LUT_MU, 3) transmittance toward the sun from altitude h at
    zenith-cosine mu (256x64 LUT in the reference; static: atmosphere constants
    only), baked in numpy on first use and uploaded once per device."""
    dev = torch.device(device)
    if "host" not in _TRANSMITTANCE_LUT:
        _TRANSMITTANCE_LUT["host"] = _transmittance_lut_numpy()
    if dev not in _TRANSMITTANCE_LUT:
        _TRANSMITTANCE_LUT[dev] = torch.from_numpy(_TRANSMITTANCE_LUT["host"]).to(dev)
    return _TRANSMITTANCE_LUT[dev]


def _sample_transmittance(t_lut: torch.Tensor, h_mm, mu) -> torch.Tensor:
    """Bilinear LUT fetch; h in Mm above ground, mu = cos zenith toward sun."""
    hx = torch.clamp(h_mm / (ATMO_RADIUS_MM - GROUND_RADIUS_MM), 0.0, 1.0) * (T_LUT_H - 1)
    mx = torch.clamp((mu + 0.2) / 1.2, 0.0, 1.0) * (T_LUT_MU - 1)
    h0 = torch.floor(hx).long()
    m0 = torch.floor(mx).long()
    h1 = torch.clamp(h0 + 1, max=T_LUT_H - 1)
    m1 = torch.clamp(m0 + 1, max=T_LUT_MU - 1)
    fh = (hx - h0)[..., None]
    fm = (mx - m0)[..., None]
    a = t_lut[h0, m0] * (1 - fm) + t_lut[h0, m1] * fm
    b = t_lut[h1, m0] * (1 - fm) + t_lut[h1, m1] * fm
    return a * (1 - fh) + b * fh


def _sun_azimuth(sun_direction: torch.Tensor):
    to_sun = normalize(-sun_direction.to(torch.float32))
    return to_sun, torch.atan2(to_sun[2], to_sun[0])


def build_sky_view_lut(sun_direction: torch.Tensor, altitude_km: float = 0.2,
                       num_steps: int = 32) -> torch.Tensor:
    """(SKY_LUT_H, SKY_LUT_W, 3) per-frame sky-view LUT (200x200 in the reference).

    Texel mapping: u = azimuth relative to the sun's azimuth / 2pi; v = non-linear
    elevation warp (Hillaire): elevation = sign(x) * x^2 * pi/2, x = 2v - 1.
    The march's ``num_steps`` samples are evaluated as one batch; the
    transmittance product and the in-scattered sum then run over the steps in
    order (cumprod, cumsum), as the JAX loop accumulates them."""
    dev = sun_direction.device
    t_lut = transmittance_lut(dev)
    to_sun, sun_az = _sun_azimuth(sun_direction)

    u = (torch.arange(SKY_LUT_W, dtype=torch.float32, device=dev) + 0.5) / SKY_LUT_W
    v = (torch.arange(SKY_LUT_H, dtype=torch.float32, device=dev) + 0.5) / SKY_LUT_H
    az = u[None, :] * (2.0 * math.pi) + sun_az
    x = v[:, None] * 2.0 - 1.0
    el = torch.sign(x) * x * x * (math.pi / 2.0)
    ce = torch.cos(el)
    shape = (SKY_LUT_H, SKY_LUT_W)
    d = torch.stack([(ce * torch.cos(az)).expand(shape), torch.sin(el).expand(shape),
                     (ce * torch.sin(az)).expand(shape)], dim=-1)

    # Single-scatter march with LUT-accurate sun transmittance.
    o = torch.tensor([0.0, GROUND_RADIUS_MM + altitude_km * 1e-3, 0.0], dtype=torch.float32,
                     device=dev)
    t_atmo = _ray_sphere_exit(o + 0 * d, d, ATMO_RADIUS_MM)
    b = (o * d).sum(dim=-1)
    c_g = (o * o).sum() - GROUND_RADIUS_MM**2
    disc = b * b - c_g
    root = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    t_ground = torch.where((disc > 0) & (root > 0), root, torch.full_like(root, math.inf))
    t_max = torch.minimum(t_atmo, t_ground)
    cos_sun = (d * to_sun).sum(dim=-1)
    ph_r = _rayleigh_phase(cos_sun)[..., None]
    ph_m = _mie_phase(cos_sun)[..., None]
    dt = t_max / num_steps

    rayleigh = torch.as_tensor(RAYLEIGH_SCATTER, device=dev)
    ozone = torch.as_tensor(OZONE_ABSORB, device=dev)
    i = torch.arange(num_steps, dtype=torch.float32, device=dev)[:, None, None]
    t = (i + 0.5) * dt  # (S, H, W)
    p = o + d * t[..., None]
    r = torch.sqrt((p * p).sum(dim=-1))
    h_km = (r - GROUND_RADIUS_MM) * 1e3
    rho_r, rho_m, rho_o = _densities(h_km)
    scat_r = rayleigh * rho_r[..., None]
    scat_m = MIE_SCATTER * rho_m[..., None]
    ext = (scat_r + (MIE_SCATTER + MIE_ABSORB) * rho_m[..., None]
           + ozone * rho_o[..., None])
    mu_s = (p * to_sun).sum(dim=-1) / torch.clamp(r, min=1e-6)
    sun_t = _sample_transmittance(t_lut, (r - GROUND_RADIUS_MM), mu_s)
    in_scatter = (scat_r * ph_r + scat_m * ph_m) * sun_t
    step_t = torch.exp(-ext * dt[..., None])
    # trans before step k: 1, s0, s0*s1, ... (the loop's running product).
    trans = torch.cat([torch.ones_like(step_t[:1]), torch.cumprod(step_t[:-1], dim=0)])
    terms = trans * in_scatter * (1.0 - step_t) / torch.clamp(ext, min=1e-6)
    return torch.cumsum(terms, dim=0)[-1]


def sample_sky_lut(lut: torch.Tensor, directions: torch.Tensor,
                   sun_direction: torch.Tensor) -> torch.Tensor:
    """(..., 3) radiance from the sky-view LUT for arbitrary unit directions."""
    to_sun, sun_az = _sun_azimuth(sun_direction)
    az = torch.atan2(directions[..., 2], directions[..., 0]) - sun_az
    u = torch.remainder(az / (2.0 * math.pi), 1.0)
    el = torch.asin(torch.clamp(directions[..., 1], -1.0, 1.0))
    x = torch.sign(el) * torch.sqrt(torch.abs(el) / (math.pi / 2.0))
    v = torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)
    fx = u * SKY_LUT_W - 0.5
    fy = v * SKY_LUT_H - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    gx = (fx - x0)[..., None]
    gy = (fy - y0)[..., None]
    x0i = torch.remainder(x0.long(), SKY_LUT_W)
    x1i = torch.remainder(x0i + 1, SKY_LUT_W)
    y0i = torch.clamp(y0.long(), 0, SKY_LUT_H - 1)
    y1i = torch.clamp(y0i + 1, max=SKY_LUT_H - 1)
    a = lut[y0i, x0i] * (1 - gx) + lut[y0i, x1i] * gx
    b = lut[y1i, x0i] * (1 - gx) + lut[y1i, x1i] * gx
    lum = a * (1 - gy) + b * gy
    # Sun disc through transmittance (as the non-LUT path).
    cos_sun = (directions * to_sun).sum(dim=-1)
    t_lut = transmittance_lut(directions.device)
    sun_t = _sample_transmittance(t_lut, torch.zeros_like(cos_sun) + 2e-4, cos_sun)
    disc = (cos_sun > 0.999957) & (directions[..., 1] > -0.05)
    return lum + torch.where(disc[..., None], sun_t * 1000.0, torch.zeros_like(sun_t))


