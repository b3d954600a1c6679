"""Temporal state — what one frame hands the next.

The frame carries the frame counter, the last frame's primitive visibility for
two-phase HiZ occlusion culling (depth_culling_phase.hpp:44-59 analog), the
staggered-CSM cache (the packed 2x2-PCF atlas plus the matrices each cascade
was rastered with; ops/shadow.py::render_shadow_cascades_staggered), the TAA
history at output resolution with its validity flag, the cached LPV cascade
volumes of the staggered GI update (ops/lpv.py::update_lpv_staggered), the RTGI
irradiance accumulation with its validity flag (ops/denoise.py::
temporal_accumulate) and the irradiance probe cascades (ops/probes.py). The
frame counter is a host integer: it picks the far cascade and the LPV cascade
to rebuild on the host.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from androidrenderer_tpu_torch import init_device
from androidrenderer_tpu_torch.ops.lpv import LPVVolumes, make_lpv_state
from androidrenderer_tpu_torch.ops.probes import ProbeCascades, make_probe_state


class TemporalState(NamedTuple):
    frame_index: int
    # Last-frame primitive visibility: phase 1 of occlusion culling draws these.
    prev_visible_prims: torch.Tensor  # (max_primitives,) bool
    # Staggered-CSM cache (config.shadow_update_budget > 0); (0, 0, 0, 2) and
    # (0, 4, 4) when staggering is off.
    csm_packed: torch.Tensor  # (C, R, R, 2) i32
    csm_matrices: torch.Tensor  # (C, 4, 4) f32
    # TAA accumulation at OUTPUT resolution and whether it holds a frame yet.
    taa_history: torch.Tensor  # (OH, OW, 3) f32
    taa_valid: torch.Tensor  # () bool
    # Cached LPV volumes for round-robin updates (config.lpv_update_budget > 0);
    # untouched when staggering is off or GI != LPV.
    lpv: LPVVolumes
    # RTGI pre-albedo irradiance accumulation at RENDER resolution (the
    # vendor-denoiser slot) and whether it holds a frame yet.
    rtgi_history: torch.Tensor  # (H, W, 3) f32
    rtgi_valid: torch.Tensor  # () bool
    # DDGI-style irradiance probe cascades (GI == PROBES).
    probes: ProbeCascades


def initial_temporal_state(
    height: int = 0,
    width: int = 0,
    max_primitives: int = 65536,
    out_height: int | None = None,
    out_width: int | None = None,
    lpv_cascades: int = 4,
    lpv_resolution: int = 32,
    shadow_cascades: int = 0,
    shadow_resolution: int = 0,
    probe_cascades: int = 2,
    probe_grid: Tuple[int, int, int] = (16, 8, 16),
    device="cuda",
) -> TemporalState:
    """``height``/``width`` are the RENDER resolution; with temporal upscaling the
    TAA history accumulates at OUTPUT resolution (``out_height``/``out_width``).
    Every primitive starts visible, so the first frame's phase 1 draws all.
    Zero packed taps decode to depth 0 (reversed-Z farthest) => lit, and the
    zero matrix projects to z = 0 (outside the z > 0 gate) => lit: stale
    cascades degrade to "no shadow" for the first frames, never to garbage.
    LPV cascades start with mins at 1e30, outside every pixel; probe slots
    start invalid (age 10,000, cell 2^20), so the first update refills them.
    On the card unless the caller asks for the CPU."""
    dev = init_device(device)
    oh = out_height or height
    ow = out_width or width
    return TemporalState(
        frame_index=0,
        prev_visible_prims=torch.ones((max_primitives,), dtype=torch.bool, device=dev),
        csm_packed=torch.zeros(
            (shadow_cascades, shadow_resolution, shadow_resolution, 2),
            dtype=torch.int32, device=dev,
        ),
        csm_matrices=torch.zeros((shadow_cascades, 4, 4), dtype=torch.float32, device=dev),
        taa_history=torch.zeros((oh, ow, 3), dtype=torch.float32, device=dev),
        taa_valid=torch.zeros((), dtype=torch.bool, device=dev),
        lpv=make_lpv_state(lpv_cascades, lpv_resolution, dev),
        rtgi_history=torch.zeros((height, width, 3), dtype=torch.float32, device=dev),
        rtgi_valid=torch.zeros((), dtype=torch.bool, device=dev),
        probes=make_probe_state(probe_cascades, probe_grid, dev),
    )


def temporal_state_for(config, device="cuda") -> TemporalState:
    """Initial TemporalState sized for a RenderConfig (the TAA and RTGI
    histories, the LPV volumes, the probe cascades and the staggered-CSM atlas
    must match the config or the frame raises), on the card unless the caller
    asks for the CPU."""
    staggered = bool(config.shadow_update_budget)
    return initial_temporal_state(
        config.render_height, config.render_width,
        max_primitives=config.max_primitives,
        out_height=config.output_height, out_width=config.output_width,
        lpv_cascades=config.lpv_num_cascades,
        lpv_resolution=config.lpv_resolution,
        shadow_cascades=config.num_shadow_cascades if staggered else 0,
        shadow_resolution=config.shadow_cascade_resolution if staggered else 0,
        probe_cascades=config.probe_cascades, probe_grid=config.probe_grid,
        device=device,
    )


def temporal_from_numpy(leaves: Dict[str, np.ndarray], device) -> TemporalState:
    """TemporalState on ``device`` from host arrays keyed by field name (the LPV
    volumes as ``lpv.<field>``, the probe cascades as ``probes.<field>``), as a
    JAX TemporalState holds them, so a chained
    comparison can start both renderers from identical state. A field missing
    from ``leaves`` takes its value from ``initial_temporal_state()``."""
    dev = init_device(device)
    init = initial_temporal_state(device=dev)

    def tensor(key, default):
        if key not in leaves:
            return default
        return torch.from_numpy(np.array(leaves[key], order="C")).to(dev)

    fields = {
        f: tensor(f, getattr(init, f))
        for f in TemporalState._fields if f not in ("frame_index", "lpv", "probes")
    }
    lpv = LPVVolumes(*(tensor(f"lpv.{f}", getattr(init.lpv, f)) for f in LPVVolumes._fields))
    probes = ProbeCascades(*(tensor(f"probes.{f}", getattr(init.probes, f))
                             for f in ProbeCascades._fields))
    return TemporalState(frame_index=int(leaves.get("frame_index", 0)), lpv=lpv, probes=probes,
                         **fields)
