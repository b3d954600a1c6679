"""Temporal state — what one frame hands the next.

The raster-only frame carries the frame counter and the staggered-CSM cache:
the packed 2x2-PCF atlas plus the matrices each cascade was rastered with
(ops/shadow.py::render_shadow_cascades_staggered). The frame counter is a host
integer: it picks the far cascade to re-raster on the host. The TAA, probe,
LPV and RTGI histories of the JAX package's TemporalState join with their
features (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from androidrenderer_tpu_torch import init_device


class TemporalState(NamedTuple):
    frame_index: int
    # Staggered-CSM cache (config.shadow_update_budget > 0); (0, 0, 0, 2) and
    # (0, 4, 4) when staggering is off.
    csm_packed: torch.Tensor  # (C, R, R, 2) i32
    csm_matrices: torch.Tensor  # (C, 4, 4) f32


def initial_temporal_state(
    shadow_cascades: int = 0, shadow_resolution: int = 0, device="cpu"
) -> TemporalState:
    """Zero packed taps decode to depth 0 (reversed-Z farthest) => lit, and the
    zero matrix projects to z = 0 (outside the z > 0 gate) => lit: stale
    cascades degrade to "no shadow" for the first frames, never to garbage."""
    dev = init_device(device)
    return TemporalState(
        frame_index=0,
        csm_packed=torch.zeros(
            (shadow_cascades, shadow_resolution, shadow_resolution, 2),
            dtype=torch.int32, device=dev,
        ),
        csm_matrices=torch.zeros((shadow_cascades, 4, 4), dtype=torch.float32, device=dev),
    )


def temporal_state_for(config, device="cpu") -> TemporalState:
    """Initial TemporalState sized for a RenderConfig."""
    staggered = bool(config.shadow_update_budget)
    return initial_temporal_state(
        shadow_cascades=config.num_shadow_cascades if staggered else 0,
        shadow_resolution=config.shadow_cascade_resolution if staggered else 0,
        device=device,
    )
