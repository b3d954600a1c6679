"""Filament-style PBR BRDF — numeric parity with shaders/common/brdf.slangi:22-115.

diffuse = Burley, specular = GGX ``D_GGX`` x height-correlated Smith
``V_SmithGGXCorrelated`` x Schlick Fresnel with f90 = 1;
``f0 = lerp(0.04, base_color, metalness)``;
``diffuse_color = base_color * (1 - 0.04) * (1 - metalness)``.
The port of the JAX package's ops/brdf.py; vectors are (..., 3), scalars (..., 1).
"""

from __future__ import annotations

import torch

PI = 3.1415927
DIELECTRIC_F0 = 0.04


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1, keepdim=True)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v * torch.reciprocal(torch.sqrt(torch.clamp(_dot(v, v), min=eps)))


def d_ggx(noh: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """brdf.slangi:22-25."""
    k = roughness / (1.0 - noh * noh + roughness * roughness)
    return k * k * (1.0 / PI)


def f_schlick(u: torch.Tensor, f0, f90) -> torch.Tensor:
    """brdf.slangi:27."""
    return f0 + (f90 - f0) * torch.clamp(1.0 - u, 0.0, 1.0) ** 5


def v_smith_ggx_correlated(nov: torch.Tensor, nol: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """brdf.slangi:29-35."""
    a2 = a * a
    ggxl = nov * torch.sqrt((-nol * a2 + nol) * nol + a2)
    ggxv = nol * torch.sqrt((-nov * a2 + nov) * nov + a2)
    return 0.5 / torch.clamp(ggxv + ggxl, min=1e-9)


def fd_lambert() -> float:
    """The Lambertian diffuse lobe, 1/pi."""
    return 1.0 / PI


def fd_burley(
    nov: torch.Tensor, nol: torch.Tensor, loh: torch.Tensor, roughness: torch.Tensor
) -> torch.Tensor:
    """brdf.slangi:39-45."""
    f90 = 0.5 + 2.0 * roughness * loh * loh
    light_scatter = f_schlick(nol, torch.ones_like(nol), f90)
    view_scatter = f_schlick(nov, torch.ones_like(nov), f90)
    return light_scatter * view_scatter * (1.0 / PI)


def brdf(
    base_color: torch.Tensor,  # (..., 3)
    normal: torch.Tensor,  # (..., 3) unit
    metalness: torch.Tensor,  # (..., 1)
    roughness: torch.Tensor,  # (..., 1)
    l: torch.Tensor,  # (..., 3) unit, surface -> light
    v: torch.Tensor,  # (..., 3) unit, surface -> view
    diffuse_only: bool = False,
) -> torch.Tensor:
    """brdf() = Fd + Fr (brdf.slangi:60-115). Returns (..., 3).

    ``diffuse_only=True`` gives the Fd-only variant of the RT bounce shading
    (gltf_basic_pbr.slang:438)."""
    f0 = DIELECTRIC_F0 + (base_color - DIELECTRIC_F0) * metalness
    diffuse_color = base_color * (1.0 - DIELECTRIC_F0) * (1.0 - metalness)

    h = normalize(v + l)
    nov = torch.abs(_dot(normal, v) + 1e-5)
    nol_raw = _dot(normal, l)
    nol = torch.clamp(nol_raw, 0.0, 1.0)
    noh = torch.clamp(_dot(normal, h), 0.0, 1.0)
    voh = torch.clamp(_dot(v, h), 0.0, 1.0)
    loh = torch.clamp(_dot(l, h), 0.0, 1.0)

    fd = diffuse_color * fd_burley(nov, nol, loh, roughness)
    if diffuse_only:
        result = fd
    else:
        d = d_ggx(noh, roughness)
        f = f_schlick(voh, f0, 1.0)
        vis = v_smith_ggx_correlated(nov, nol, roughness)
        fr = (d * vis) * f
        result = fd + fr
    # NoL <= 0 contributes nothing (brdf.slangi:83-85).
    return torch.where(nol_raw > 0.0, result, torch.zeros_like(result))
