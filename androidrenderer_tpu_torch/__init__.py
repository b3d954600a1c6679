"""androidrenderer_tpu_torch — the PyTorch + CUDA port of androidrenderer_tpu.

The JAX package beside it is the reference. This package renders the raster-only
frame (``config.raster_only_config``) and the headless CLI's default frame
(``config.default_frame_config``): frustum cull, two-phase HiZ occlusion culling,
triangle setup, the hand-written CUDA rasterizer (``csrc/raster.cu``) behind the
entry points of the JAX package's raster family, the exact alpha-test peel, gbuffer
resolve, sky, staggered cascaded shadow maps, sun BRDF, the translucency peel,
bloom and tonemap; the parity frame's SSAO, LPV GI and TAAU; and, over the
bake's BVH through the hand-written CUDA traversal (``csrc/traverse.cu``),
ray-traced sun shadows and AO, RTGI with its denoiser, and the irradiance probe
cache with the sky LUTs; VRSAA at twice the output resolution, frame
interpolation and the debug visualizers; the headless CLI
(``python -m androidrenderer_tpu_torch.app.headless``) with its cvars and
application layer, and the glTF/KTX2 asset layer it loads. It imports torch and
numpy only (Pillow and zstandard lazily, for PNG/JPEG and Zstd KTX2 textures).

Entry points, as bench.py drives the JAX frame; they run on the card unless the
caller passes ``device="cpu"``::

    scene, stats = courtyard_scene(...).build()
    view = Camera(...).view_data()
    temporal = temporal_state_for(cfg)
    out, temporal = make_renderer(cfg)(scene, view, RenderParams.default(), temporal)
"""

__version__ = "0.1.0"

import torch


def init_device(device) -> torch.device:
    """Resolve ``device`` and pin float32 numerics on it.

    A CUDA device without a card raises: nothing falls back to the CPU.
    TF32 is switched off for cuDNN convolutions and CUDA matmuls: the frame's
    float stages are held to the JAX reference at float32 tolerances, and TF32
    keeps only about three decimal digits."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but torch.cuda.is_available() is false; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
