"""CVar registry — the reference's console variable system (console/cvars.hpp:23-129).
The port of the JAX package's app/cvars.py: the same names, kinds, fields, help
text and listeners.

The reference registers ~40 typed cvars (AutoCVar_Float/Int/Enum statics) that
code reads EVERY frame, with an ImGui editor and change listeners. Here a "cvar"
is one of two things:

- a RUNTIME cvar: a float in :class:`RenderParams`, editable per frame (the
  float cvars), stored rounded to float32 as the JAX package stores it;
- a STRUCTURAL cvar: a field of the frozen :class:`RenderConfig`; flipping it
  rebuilds the renderer, as the reference rebuilds pipelines when a mode cvar
  changes (scene_renderer.cpp:134-211).

``set_cvar``/``get_cvar`` address both by the reference's dotted names, and
listeners fire on change like CVarSystem's (cvars.hpp:58). The headless CLI
exposes them as repeatable ``--set name=value`` flags.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np

from androidrenderer_tpu_torch.config import (
    AAMode, AOMode, GIMode, RenderConfig, RenderParams, ShadowMode,
)


class CVarDef(NamedTuple):
    name: str  # reference-style dotted name
    kind: str  # "runtime" (RenderParams) | "structural" (RenderConfig)
    field: str  # attribute name on the owning container
    parse: Callable  # str -> value
    help: str


def _enum_parser(e):
    def parse(v):
        try:
            return e(int(v))
        except ValueError:
            return e[v.upper()]
    return parse


_DEFS: List[CVarDef] = [
    # Structural cvars (mode switches — recompile on change, like the
    # reference's pipeline rebuilds).
    CVarDef("r.GI.Mode", "structural", "gi_mode", _enum_parser(GIMode),
            "0 off / 1 LPV / 2 RT / 3 probes (scene_renderer.cpp:196-211)"),
    CVarDef("r.AO", "structural", "ao_mode", _enum_parser(AOMode),
            "0 off / 1 SSAO (CACAO slot) / 2 RTAO"),
    CVarDef("r.AntiAliasing", "structural", "aa_mode", _enum_parser(AAMode),
            "0 off / 1 TAA / 2 VRSAA"),
    CVarDef("r.Shadow.SunShadowMode", "structural", "shadow_mode",
            _enum_parser(ShadowMode), "0 off / 1 CSM / 2 RT"),
    CVarDef("r.Shadow.NumCascades", "structural", "num_shadow_cascades", int,
            "CSM cascade count (reference default 4)"),
    CVarDef("r.Shadow.CSM.CascadeResolution", "structural",
            "shadow_cascade_resolution", int, "per-cascade shadow map size"),
    CVarDef("r.Shadow.CSM.CascadeSplitLambda", "structural",
            "shadow_cascade_split_lambda", float, "practical split lambda"),
    CVarDef("r.Shadow.Distance", "structural", "shadow_max_distance", float,
            "CSM far distance (m)"),
    CVarDef("r.Shadow.CSM.WinH", "structural", "shadow_win_h", int,
            "bitmask cascade-raster window height (bit-identical output)"),
    CVarDef("r.Shadow.CSM.UpdateBudget", "structural", "shadow_update_budget",
            int,
            "far cascades re-rastered per frame against the cached packed "
            "atlas (0 = all every frame, the reference's refit-and-render-all; "
            "shadow.py::render_shadow_cascades_staggered)"),
    CVarDef("r.GI.LPV.NumCascades", "structural", "lpv_num_cascades", int, ""),
    CVarDef("r.GI.LPV.Resolution", "structural", "lpv_resolution", int, ""),
    CVarDef("r.GI.LPV.CellSize", "structural", "lpv_cell_size", float, ""),
    CVarDef("r.GI.LPV.RsmResolution", "structural", "lpv_rsm_resolution", int, ""),
    CVarDef("r.GI.LPV.NumPropagationSteps", "structural",
            "lpv_num_propagation_steps", int, ""),
    CVarDef("r.GI.LPV.PercentBehindCamera", "structural",
            "lpv_behind_camera_percent", float, ""),
    CVarDef("r.GI.LPV.UpdateBudget", "structural", "lpv_update_budget", int,
            "cascades rebuilt per frame round-robin (0 = all, the reference's "
            "clear-and-rebuild; ops/lpv.py::update_lpv_staggered)"),
    CVarDef("r.GI.Cache.UpdatesPerFrame", "structural", "probe_budget", int, ""),
    CVarDef("r.GI.NumBounces", "structural", "rtgi_num_bounces", int, ""),
    CVarDef("r.AO.RTAO.SamplesPerPixel", "structural", "rtao_num_samples", int, ""),
    CVarDef("r.HalfRateGI", "structural", "half_rate_gi",
            lambda v: v.lower() in ("1", "true", "on"),
            "half-rate GI/AO + bilateral upsample (VRS coarse-rate analog)"),
    CVarDef("r.Raster.Bitmask", "structural", "raster_bitmask",
            lambda v: v.lower() in ("1", "true", "on"),
            "bitmask-driven raster kernel (no scalar Phase A; bit-identical)"),
    CVarDef("r.Raster.PallasInterpret", "structural", "pallas_interpret",
            lambda v: v.lower() in ("1", "true", "on"),
            "interpret-mode Pallas kernels (drives the production kernel "
            "path off-TPU, e.g. the staggered-CSM atlas on a CPU run)"),
    CVarDef("r.Raster.PaUnroll", "structural", "raster_pa_unroll", int,
            "binned-kernel Phase A triangles per loop iteration (pow2)"),
    # Runtime cvars (traced RenderParams — no recompile).
    CVarDef("r.Sun.Exposure", "runtime", "sun_exposure", float,
            "direct-light exposure fudge (directional_light.frag:141-149)"),
    CVarDef("r.GI.RT.Exposure", "runtime", "rtgi_exposure", float,
            "RTGI irradiance fudge (rtgi.rt.slang:104-108)"),
    CVarDef("r.GI.LPV.Exposure", "runtime", "lpv_exposure", float,
            "LPV apply exposure (default pi*10)"),
    CVarDef("r.Bloom.Strength", "runtime", "bloom_strength", float,
            "bloom add factor (scene_upsample.frag:61)"),
    CVarDef("r.Shadow.Bias", "runtime", "shadow_bias", float,
            "slope-scaled CSM bias scale"),
    CVarDef("r.AO.MaxRayDistance", "runtime", "rtao_max_distance", float, ""),
    CVarDef("r.SSAO.Radius", "runtime", "ssao_radius", float, ""),
    CVarDef("r.SSAO.Intensity", "runtime", "ssao_intensity", float, ""),
    CVarDef("r.SSAO.Bias", "runtime", "ssao_bias", float, ""),
    CVarDef("r.GI.Denoise.SigmaZ", "runtime", "atrous_sigma_z", float, ""),
    CVarDef("r.GI.Denoise.SigmaN", "runtime", "atrous_sigma_n", float, ""),
    CVarDef("r.GI.Cache.Hysteresis", "runtime", "probe_hysteresis", float, ""),
]

REGISTRY: Dict[str, CVarDef] = {d.name.lower(): d for d in _DEFS}

_listeners: List[Callable[[str, object], None]] = []


def add_listener(fn: Callable[[str, object], None]) -> None:
    """Register a change listener (cvars.hpp:58 analog)."""
    _listeners.append(fn)


def list_cvars() -> List[CVarDef]:
    return list(_DEFS)


def get_cvar(name: str, config: RenderConfig, params: RenderParams):
    d = REGISTRY[name.lower()]
    src = config if d.kind == "structural" else params
    return getattr(src, d.field)


def set_cvar(
    name: str, value, config: RenderConfig, params: RenderParams,
) -> Tuple[RenderConfig, RenderParams, bool]:
    """Set a cvar by dotted name. Returns (config, params, needs_recompile).

    String values are parsed with the cvar's own parser; typed values pass
    through. Structural changes return a NEW frozen config (the renderer is
    rebuilt); runtime changes return params with the float32-rounded value.
    """
    d = REGISTRY[name.lower()]
    if isinstance(value, str):
        value = d.parse(value)
    for fn in _listeners:
        fn(d.name, value)
    if d.kind == "structural":
        return dataclasses.replace(config, **{d.field: value}), params, True
    params = params._replace(**{d.field: float(np.float32(value))})
    return config, params, False
