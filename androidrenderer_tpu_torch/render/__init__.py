"""Frame assembly: the temporal state and the frame function."""

from androidrenderer_tpu_torch.render.frame import FrameOutputs, make_renderer, render_frame
from androidrenderer_tpu_torch.render.temporal import (
    TemporalState,
    initial_temporal_state,
    temporal_from_numpy,
    temporal_state_for,
)

__all__ = [
    "FrameOutputs", "TemporalState", "initial_temporal_state", "make_renderer",
    "render_frame", "temporal_from_numpy", "temporal_state_for",
]
