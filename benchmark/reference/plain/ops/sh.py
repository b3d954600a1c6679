# Frozen copy of androidrenderer_tpu_torch/ops/sh.py at commit dfc74ed377a9,
# part of the benchmark's plain reference: imports renamed only.
"""2-band spherical harmonics — shared math for LPV (common/spherical_harmonics.glsl).
The port of the JAX package's ops/sh.py, on tensors.

Coefficient order: [Y00, Y1-1 (y), Y10 (z), Y11 (x)].
"""

from __future__ import annotations

import torch

SH_C0 = 0.282094791  # Y00
SH_C1 = 0.488602512  # |Y1x|
# Clamped cosine lobe projected to SH (zonal), as used by LPV injection
# (vpl_injection.frag:36-52).
COS_LOBE_C0 = 0.886226925  # sqrt(pi)/2
COS_LOBE_C1 = 1.023326707  # sqrt(pi/3)


def sh_evaluate(direction: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit dir -> (..., 4) SH basis values."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    return torch.stack([torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x], dim=-1)


def sh_cosine_lobe(direction: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit dir -> (..., 4) clamped-cosine-lobe SH coefficients."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    return torch.stack(
        [torch.full_like(x, COS_LOBE_C0), -COS_LOBE_C1 * y, COS_LOBE_C1 * z, -COS_LOBE_C1 * x],
        dim=-1,
    )


def sh_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integrate product of two SH functions: sum over the coefficient axis."""
    return (a * b).sum(dim=-1)
