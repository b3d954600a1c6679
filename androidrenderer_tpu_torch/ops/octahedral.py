"""Octahedral direction <-> texel mapping (shaders/gi/cache/octahedral.slangi).

The port of the JAX package's ops/octahedral.py.
"""

from __future__ import annotations

import torch


def _sign_flip(xy: torch.Tensor) -> torch.Tensor:
    """The octahedron's lower-hemisphere fold of (..., 2) xy."""
    return (1.0 - torch.abs(xy.flip(-1))) * torch.where(xy >= 0.0, 1.0, -1.0)


def dir_to_oct_uv(d: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit dirs -> (..., 2) uv in [0, 1] (octahedral projection)."""
    n = d / torch.abs(d).sum(-1, keepdim=True)
    xy = n[..., :2]
    xy = torch.where(n[..., 2:3] < 0.0, _sign_flip(xy), xy)
    return xy * 0.5 + 0.5


def oct_uv_to_dir(uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) uv in [0, 1] -> (..., 3) unit dirs."""
    xy = uv * 2.0 - 1.0
    z = 1.0 - torch.abs(xy[..., 0]) - torch.abs(xy[..., 1])
    xy = torch.where(z[..., None] < 0.0, _sign_flip(xy), xy)
    d = torch.cat([xy, z[..., None]], dim=-1)
    return d / torch.sqrt((d * d).sum(-1, keepdim=True))


def oct_texel_directions(res: int, device="cpu") -> torch.Tensor:
    """(res, res, 3) unit direction of every octahedral texel center."""
    u = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    uv = torch.stack(torch.meshgrid(u, u, indexing="xy"), dim=-1)
    return oct_uv_to_dir(uv)
