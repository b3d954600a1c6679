# Frozen copy of androidrenderer_tpu_torch/render/__init__.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed, the names no frame of the
# benchmark uses left out.
"""Frame assembly: the temporal state and the frame function."""

from benchmark.reference.plain.render.frame import FrameOutputs, make_renderer, render_frame
from benchmark.reference.plain.render.temporal import (
    TemporalState,
    initial_temporal_state,
    temporal_state_for,
)

__all__ = [
    "FrameOutputs", "TemporalState", "initial_temporal_state", "make_renderer",
    "render_frame", "temporal_state_for",
]
