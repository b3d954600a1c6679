"""Multi-rank dry run: the port's counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``.

Two sharded frames of the cornell box over ``n`` ranks (one horizontal band
each; scene and camera replicated, every screen tensor band-sharded, the
temporal state carried sharded into the second frame), with the feature set of
the JAX dry run: LPV GI, SSAO, TAA upscaling 128x(8n) -> 192x(12n), bloom,
two-phase HiZ occlusion culling, 2 CSM cascades of 256^2 and the exact alpha
peel. So the run goes through every collective the parity frame uses (the LPV
surfel gather, the SSAO and upsample halos, the TAA history gather, the
cross-band post, the visibility union) and the divided cascade rasters.

    python -m androidrenderer_tpu_torch.parallel.dryrun --ranks 2 --backend gloo

(two ranks on one card need gloo; NCCL takes one card per rank).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.config import AAMode, AOMode, GIMode, RenderConfig, RenderParams
from androidrenderer_tpu_torch.parallel import collectives as coll
from androidrenderer_tpu_torch.parallel.mesh import make_sharded_renderer, run_ranks, shard_temporal
from androidrenderer_tpu_torch.render.temporal import initial_temporal_state
from androidrenderer_tpu_torch.scene.procedural import cornell_scene

WIDTH, OUT_WIDTH, TILE_H = 128, 192, 8


def dryrun_config(n_devices: int) -> RenderConfig:
    """The JAX dry run's config over ``n_devices`` bands: 8-row tiles, render
    128 x max(8n, 16), output 1.5x per axis."""
    height = max(TILE_H * n_devices, 2 * TILE_H)
    out_h = (height * 3) // 2
    if out_h % n_devices:
        raise ValueError(f"output height {out_h} does not divide into {n_devices} bands")
    return RenderConfig(
        render_width=WIDTH, render_height=height, output_width=OUT_WIDTH, output_height=out_h,
        tile_height=TILE_H, tile_width=128, max_tris_per_tile=256,
        gi_mode=GIMode.LPV, ao_mode=AOMode.SSAO, aa_mode=AAMode.TAA,
        bloom=True, bloom_num_mips=2,
        occlusion_culling=True, hiz_levels=3,
        alpha_masking=True, alpha_bitmap=False, alpha_peel_layers=2, translucency=False,
        lpv_num_cascades=2, lpv_resolution=8, lpv_rsm_resolution=32,
        lpv_num_propagation_steps=4,
        num_shadow_cascades=2, shadow_cascade_resolution=256,
    )


def dryrun_view(config: RenderConfig):
    """The JAX dry run's camera: 2.2 m in front of the box, looking in."""
    cam = Camera(fov_degrees=config.fov_degrees, aspect=config.render_width / config.render_height,
                 z_near=config.z_near, render_resolution=(config.render_width, config.render_height))
    cam.set_position([0.0, 0.0, 2.2])
    cam.yaw = np.pi
    return cam.view_data()


def dryrun_frames(group, device, config: RenderConfig):
    """This rank's two sharded frames, the second from the first's sharded
    temporal state: (the full images gathered from the bands, as host arrays,
    and this rank's last FrameOutputs)."""
    scene, _ = cornell_scene().build(device=device)
    view = dryrun_view(config)
    temporal = shard_temporal(initial_temporal_state(
        config.render_height, config.render_width, out_height=config.output_height,
        out_width=config.output_width, device=device), group)
    renderer = make_sharded_renderer(config, group)
    images = []
    for _ in range(2):
        out, temporal = renderer(scene, view, RenderParams.default(), temporal)
        images.append(coll.gather_rows(out.image, group).cpu().numpy())
    return images, out


def _dryrun_rank(group, device, n_devices):
    config = dryrun_config(n_devices)
    images, _ = dryrun_frames(group, device, config)
    for img in images:
        assert img.shape == (config.output_height, config.output_width, 3), img.shape
    return [img.shape for img in images]


def dryrun_multichip(n_devices: int, device="cuda", *, backend: str, init_file: str | None = None):
    """Two sharded frames over ``n_devices`` ranks on ``device`` with
    ``backend`` (no default: gloo for ranks that share a card, NCCL for one
    card per rank). Returns the gathered images' shapes; raises if a rank fails."""
    if init_file is None:
        init_file = os.path.join(tempfile.mkdtemp(prefix="dryrun_"), "store")
    return run_ranks(n_devices, _dryrun_rank, n_devices, device=device, backend=backend,
                     init_file=init_file)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    shapes = dryrun_multichip(args.ranks, args.device, backend=args.backend)
    print(f"dryrun_multichip({args.ranks}, {args.device}, {args.backend}): frames {shapes}, "
          f"cuda devices {torch.cuda.device_count()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
