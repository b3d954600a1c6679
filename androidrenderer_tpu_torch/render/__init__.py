"""Frame assembly: the temporal state and the frame function."""

from androidrenderer_tpu_torch.render.frame import FrameOutputs, make_renderer, render_frame
from androidrenderer_tpu_torch.render.temporal import TemporalState, temporal_state_for

__all__ = [
    "FrameOutputs", "TemporalState", "make_renderer", "render_frame", "temporal_state_for",
]
