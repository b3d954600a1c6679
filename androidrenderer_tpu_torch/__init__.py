"""androidrenderer_tpu_torch — the PyTorch + CUDA port of androidrenderer_tpu.

The JAX package beside it is the reference. This package renders the raster-only
frame (``config.raster_only_config``): frustum cull, triangle setup, the
hand-written CUDA rasterizer (``csrc/raster.cu``), gbuffer resolve, sky, staggered
cascaded shadow maps, sun BRDF, bloom and tonemap. It imports torch and numpy only.

Entry points, as bench.py drives the JAX frame::

    scene, stats = courtyard_scene(...).build(device="cuda")
    view = Camera(...).view_data()
    temporal = temporal_state_for(cfg, device="cuda")
    out, temporal = make_renderer(cfg)(scene, view, RenderParams.default(), temporal)
"""

__version__ = "0.1.0"

import torch


def init_device(device) -> torch.device:
    """Resolve ``device`` and pin float32 numerics on it.

    TF32 is switched off for cuDNN convolutions and CUDA matmuls: the frame's
    float stages are held to the JAX reference at float32 tolerances, and TF32
    keeps only about three decimal digits."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
