"""Frame interpolation — the FSR3 frame-generation analog. The port of the JAX
package's ops/interpolation.py.

The reference gets frame generation from the FSR3 vendor SDK (upscaling/fsr3.cpp).
Here the renderer's own reprojection motion vectors are the flow field: the
in-between frame samples both neighbours part way along the flow and blends.
The blend's confidence combines the relative photometric disagreement of the
two warped samples and the flow divergence (the motion at the current-frame tap
against the pixel's own); low confidence falls back smoothly to the temporally
nearer frame, as FSR3's disocclusion mask does.
"""

from __future__ import annotations

import torch

from androidrenderer_tpu_torch.ops.taa import _bilinear_sample, _pixel_uv


def interpolate_frame(
    prev_frame: torch.Tensor,  # (H, W, 3) HDR or display
    curr_frame: torch.Tensor,  # (H, W, 3)
    mv: torch.Tensor,  # (H, W, 2) uv motion (uv_prev = uv_curr - mv)
    t: float = 0.5,  # interpolation phase in (0, 1)
    rel_sigma: float = 0.5,  # photometric confidence falloff (relative diff)
    flow_sigma_px: float = 2.0,  # flow-divergence confidence falloff (pixels)
) -> torch.Tensor:
    """Synthesize the frame at phase t between prev (t=0) and curr (t=1)."""
    h, w, _ = curr_frame.shape
    uv = _pixel_uv(h, w, curr_frame.device)
    # The in-between pixel saw the surface at uv - (1-t)*mv in prev and at
    # uv + t*mv in curr along the flow (mv maps curr -> prev).
    uv_prev = uv - mv * (1.0 - t)
    uv_curr = uv + mv * t
    a = _bilinear_sample(prev_frame, uv_prev)
    b = _bilinear_sample(curr_frame, uv_curr)

    on_a = ((uv_prev >= 0.0).all(dim=-1) & (uv_prev <= 1.0).all(dim=-1))[..., None]
    on_b = ((uv_curr >= 0.0).all(dim=-1) & (uv_curr <= 1.0).all(dim=-1))[..., None]
    one, zero = torch.ones_like(a[..., :1]), torch.zeros_like(a[..., :1])
    blend = torch.where(on_a & on_b, one * t, torch.where(on_b, one, zero))
    mid = a + (b - a) * blend

    # Confidence 1: relative photometric disagreement of the warped taps.
    diff = torch.abs(a - b).mean(dim=-1, keepdim=True)
    mag = 0.5 * (torch.abs(a) + torch.abs(b)).mean(dim=-1, keepdim=True) + 1e-3
    rel = diff / mag
    conf_photo = torch.exp(-((rel / rel_sigma) ** 2))
    # Confidence 2: flow divergence, the motion stored at the current-frame tap
    # against the flow used to get there; pixels of mismatch mean the taps
    # straddle an occlusion boundary.
    mv_b = _bilinear_sample(mv, uv_curr)
    flow_err = torch.stack(
        [(mv_b[..., 0] - mv[..., 0]) * w, (mv_b[..., 1] - mv[..., 1]) * h], dim=-1
    )
    err_px = torch.sqrt((flow_err * flow_err).sum(dim=-1, keepdim=True))
    conf_flow = torch.exp(-((err_px / flow_sigma_px) ** 2))
    conf = conf_photo * conf_flow

    near = b if t >= 0.5 else a
    return conf * mid + (1.0 - conf) * near
