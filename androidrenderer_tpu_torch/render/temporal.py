"""Temporal state — what one frame hands the next.

The frame carries the frame counter, the last frame's primitive visibility for
two-phase HiZ occlusion culling (depth_culling_phase.hpp:44-59 analog) and the
staggered-CSM cache: the packed 2x2-PCF atlas plus the matrices each cascade was
rastered with (ops/shadow.py::render_shadow_cascades_staggered). The frame
counter is a host integer: it picks the far cascade to re-raster on the host.
The TAA, probe, LPV and RTGI histories of the JAX package's TemporalState join
with their features (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from androidrenderer_tpu_torch import init_device


class TemporalState(NamedTuple):
    frame_index: int
    # Last-frame primitive visibility: phase 1 of occlusion culling draws these.
    prev_visible_prims: torch.Tensor  # (max_primitives,) bool
    # Staggered-CSM cache (config.shadow_update_budget > 0); (0, 0, 0, 2) and
    # (0, 4, 4) when staggering is off.
    csm_packed: torch.Tensor  # (C, R, R, 2) i32
    csm_matrices: torch.Tensor  # (C, 4, 4) f32


def initial_temporal_state(
    shadow_cascades: int = 0, shadow_resolution: int = 0, max_primitives: int = 65536,
    device="cuda",
) -> TemporalState:
    """Every primitive starts visible, so the first frame's phase 1 draws all.
    Zero packed taps decode to depth 0 (reversed-Z farthest) => lit, and the
    zero matrix projects to z = 0 (outside the z > 0 gate) => lit: stale
    cascades degrade to "no shadow" for the first frames, never to garbage.
    On the card unless the caller asks for the CPU."""
    dev = init_device(device)
    return TemporalState(
        frame_index=0,
        prev_visible_prims=torch.ones((max_primitives,), dtype=torch.bool, device=dev),
        csm_packed=torch.zeros(
            (shadow_cascades, shadow_resolution, shadow_resolution, 2),
            dtype=torch.int32, device=dev,
        ),
        csm_matrices=torch.zeros((shadow_cascades, 4, 4), dtype=torch.float32, device=dev),
    )


def temporal_state_for(config, device="cuda") -> TemporalState:
    """Initial TemporalState sized for a RenderConfig, on the card unless the
    caller asks for the CPU."""
    staggered = bool(config.shadow_update_budget)
    return initial_temporal_state(
        shadow_cascades=config.num_shadow_cascades if staggered else 0,
        shadow_resolution=config.shadow_cascade_resolution if staggered else 0,
        max_primitives=config.max_primitives,
        device=device,
    )


def temporal_from_numpy(leaves: Dict[str, np.ndarray], device) -> TemporalState:
    """TemporalState on ``device`` from host arrays keyed by field name — the
    fields the port carries, as a JAX TemporalState holds them (so a chained
    comparison can start both renderers from identical state)."""
    dev = init_device(device)
    return TemporalState(
        frame_index=int(leaves["frame_index"]),
        **{
            f: torch.from_numpy(np.array(leaves[f], order="C")).to(dev)
            for f in TemporalState._fields if f != "frame_index"
        },
    )
