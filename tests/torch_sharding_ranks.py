"""The rank side of tests/test_torch_sharding.py: every scenario that needs a
process group, run by each rank in turn inside one launch of
``parallel.mesh.run_ranks`` (4 gloo ranks on the CPU; the 2-rank scenarios run
on a subgroup of ranks 0 and 1). Rank 0 returns every result as host arrays.
This module imports no JAX: the ranks load only the port.
"""

import numpy as np
import torch
import torch.distributed as dist

from androidrenderer_tpu_torch.camera import Camera, taa_jitter
from androidrenderer_tpu_torch.config import AOMode, GIMode, RenderParams, ShadowMode
from androidrenderer_tpu_torch.ops import probes, shadow
from androidrenderer_tpu_torch.parallel import collectives as coll
from androidrenderer_tpu_torch.parallel.dryrun import dryrun_config, dryrun_frames, dryrun_view
from androidrenderer_tpu_torch.parallel.mesh import make_sharded_renderer, shard_temporal
from androidrenderer_tpu_torch.render import temporal_state_for
from androidrenderer_tpu_torch.scene.procedural import cornell_scene

COLL_ROWS, COLL_SHAPE = 16, (5, 2)
HALOS = (2, 5, 9)


def collective_inputs(n: int):
    """(full (16, 5, 2) f32 frame with a -0.0 in it, (n, 37) bool masks)."""
    rng = np.random.default_rng(100 + n)
    full = rng.normal(size=(COLL_ROWS, *COLL_SHAPE)).astype(np.float32)
    full[3, 1, 0] = -0.0
    return full, rng.uniform(size=(n, 37)) > 0.8


def collective_case(group):
    """This rank's row_halo (every halo, wrap and edge), gather_rows and
    any_across results on its band of ``collective_inputs``."""
    rank, n = coll.band_index(group)
    full, masks = collective_inputs(n)
    b = COLL_ROWS // n
    x = torch.from_numpy(full[rank * b:(rank + 1) * b].copy())
    out = {f"halo{h}_{'wrap' if w else 'edge'}": coll.row_halo(x, h, group, w).numpy()
           for h in HALOS for w in (True, False)}
    out["gather"] = coll.gather_rows(x, group).numpy()
    out["any"] = coll.any_across(torch.from_numpy(masks[rank].copy()), group).numpy()
    per_rank = [None] * n
    dist.all_gather_object(per_rank, out, group=group)
    return per_rank


def rt_config(gi_mode=GIMode.OFF):
    """RT shadows and RTAO (and RTGI with ``gi_mode=GIMode.RT``) with TAA at
    render resolution, 128 x 64 in 2 bands of 32 rows."""
    return dryrun_config(2).replace(
        render_height=64, output_width=128, output_height=64, gi_mode=gi_mode,
        ao_mode=AOMode.RT, shadow_mode=ShadowMode.RT, occlusion_culling=False, bloom=False)


def taau_config():
    """TAA upscaling alone, 128 x 32 -> 192 x 48 (tests/test_sharding.py's
    TAAU scenario at the dry run's size)."""
    return dryrun_config(2).replace(
        gi_mode=GIMode.OFF, ao_mode=AOMode.OFF, shadow_mode=ShadowMode.OFF,
        occlusion_culling=False, bloom=False)


def jittered_frames(group, device, config):
    """2 frames with the TAA jitter: gathered (image, hdr, depth, vis) per
    frame; single device when ``group`` is None."""
    from androidrenderer_tpu_torch.render import make_renderer

    scene, _ = cornell_scene().build(device=device)
    cam = Camera(fov_degrees=config.fov_degrees, aspect=config.render_width / config.render_height,
                 z_near=config.z_near, render_resolution=(config.render_width, config.render_height))
    cam.set_position([0.05, 0.03, 2.2])
    cam.yaw = np.pi + 0.02
    temporal = temporal_state_for(config, device=device)
    if group is None:
        render = make_renderer(config)
    else:
        temporal = shard_temporal(temporal, group)
        render = make_sharded_renderer(config, group)
    out = []
    for i in range(2):
        cam.set_jitter(taa_jitter(i))
        o, temporal = render(scene, cam.view_data(), RenderParams.default(), temporal)
        cam.end_frame()
        fields = (o.image, o.hdr, o.depth, o.visibility)
        if group is not None:
            fields = [coll.gather_rows(f.contiguous(), group) for f in fields]
        out.append([f.numpy() for f in fields])
    return out


def probe_case(group, device):
    """(sharded update, single-device update) of 3 probe cascades on 2 ranks."""
    scene, _ = cornell_scene().build(device=device)
    grid = (8, 4, 8)
    state = probes.make_probe_state(3, grid, device)
    args = (torch.tensor([0.0, 0.5, 0.0]), grid, 0.4, 32, 16, 2, 3e-4)
    kw = dict(masked=False, use_textures=False)
    two = probes.update_probes(state, scene.bvh, scene, *args, group=group, **kw)
    one = probes.update_probes(state, scene.bvh, scene, *args, **kw)
    return [tuple(x.numpy() for x in s) for s in (two, one)]


def cascade_case(group, device):
    """(sharded, replicated) cascade maps: 3 cascades of 128^2 with the proxy
    from cascade 1, and the staggered atlas of 4 cascades (budget 1) at
    frame 1."""
    scene, _ = cornell_scene().build(device=device)
    view = dryrun_view(dryrun_config(2))
    inv = torch.from_numpy(np.asarray(view.inverse_view, np.float32))
    p00, p11 = float(view.projection[0, 0]), float(view.projection[1, 1])
    geo = dict(double_sided=scene.tri_double_sided, proxy=scene.proxy, proxy_from_cascade=1,
               corners=scene.tri_corner_pos)
    src = (scene.positions, scene.tri_indices, scene.tri_valid)
    out = {}
    casc = shadow.fit_cascades(inv, p00, p11, scene.sun_direction, 3, 128, 0.05, 32.0, 0.95)
    out["sharded"] = shadow.render_shadow_cascades_sharded(*src, casc, 128, group, **geo).numpy()
    out["replicated"] = shadow.render_shadow_cascades(*src, casc, 128, **geo).numpy()
    casc = shadow.fit_cascades(inv, p00, p11, scene.sun_direction, 4, 128, 0.05, 32.0, 0.95)
    cache = (torch.zeros((4, 128, 128, 2), dtype=torch.int32), torch.zeros((4, 4, 4)))
    for key, g in (("stagger_sharded", group), ("stagger", None)):
        packed, mats = shadow.render_shadow_cascades_staggered(*src, casc, 128, *cache, 1,
                                                               group=g, **geo)
        out[key] = (packed.numpy(), mats.numpy())
    return out


def scenarios(group, device):
    """Every rank scenario in turn; rank 0 returns their results."""
    torch.set_num_threads(1)
    rank = dist.get_rank()
    pair = dist.new_group([0, 1])
    res = {"coll4": collective_case(group)}
    if rank < 2:
        res["coll2"] = collective_case(pair)
        images, _ = dryrun_frames(pair, device, dryrun_config(2))
        res["dryrun"] = images
        res["dryrun_jittered"] = jittered_frames(pair, device, dryrun_config(2))
        res["rt"] = jittered_frames(pair, device, rt_config())
        res["rtgi"] = jittered_frames(pair, device, rt_config(GIMode.RT))
        res["taau"] = jittered_frames(pair, device, taau_config())
        res["probes"] = probe_case(pair, device)
        res["cascades"] = cascade_case(pair, device)
    dist.barrier()
    return res if rank == 0 else None


def failing_rank(group, device):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if dist.get_rank(group) == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier(group)
