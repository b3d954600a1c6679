"""Screen-band sharding: one frame over the ranks of a torch.distributed group.

The port of the JAX package's parallel/mesh.py. The screen splits into
horizontal bands, one per rank (JAX: one per device along the ``screen`` mesh
axis). Scene tensors and the camera are replicated; each rank rasterizes only
its band (triangle setup is replicated, O(triangles)); gbuffer and lighting are
pointwise and stay local. The u8 image and every screen-shaped temporal tensor
stay band-sharded from frame to frame, so the only traffic between ranks is
the frame's collectives (parallel/collectives.py).

``run_ranks`` starts the ranks: n processes (``torch.multiprocessing``,
spawn), each with its process group initialised from a ``file://`` store, so
two launches never share a port. The backend is the caller's choice: NCCL wants
one card per rank; two ranks on one card run with gloo.
"""

from __future__ import annotations

import os
import queue as queue_module
import time
import traceback
from datetime import timedelta
from functools import partial

import torch
import torch.distributed as dist

from androidrenderer_tpu_torch.config import RenderConfig, RenderParams
from androidrenderer_tpu_torch.parallel.collectives import band_index
from androidrenderer_tpu_torch.render.frame import render_frame
from androidrenderer_tpu_torch.render.temporal import TemporalState
from androidrenderer_tpu_torch.scene.scene import SceneArrays

# Seconds a collective, and the whole launch, may take before the ranks are stopped.
TIMEOUT_S = 600.0


def check_split(config: RenderConfig, n: int) -> int:
    """The band height of ``config`` over ``n`` ranks; raises ValueError when
    the frame does not split into whole bands (the JAX package's checks)."""
    if config.render_height % (n * config.tile_height) != 0:
        raise ValueError(
            f"render_height {config.render_height} must divide into {n} bands of "
            f"whole {config.tile_height}-px tiles"
        )
    if config.output_height % n != 0:
        raise ValueError(f"output_height {config.output_height} must divide into {n} bands")
    return config.render_height // n


def render_frame_sharded(
    scene: SceneArrays,
    view,
    params: RenderParams,
    temporal: TemporalState,
    config: RenderConfig,
    group,
):
    """This rank's band of the frame: (FrameOutputs, TemporalState) with every
    screen tensor holding the rank's rows (``temporal`` from ``shard_temporal``)."""
    rank, n = band_index(group)
    band_h = check_split(config, n)
    return render_frame(scene, view, params, temporal, config,
                        band_height=band_h, row_offset=rank * band_h, group=group)


def make_sharded_renderer(config: RenderConfig, group):
    """The frame callable ``(scene, view, params, temporal)`` of this rank's
    band, with ``config`` and ``group`` bound."""
    return partial(render_frame_sharded, config=config, group=group)


def shard_temporal(temporal: TemporalState, group) -> TemporalState:
    """This rank's part of an (unsharded) TemporalState: its rows of the
    screen-shaped histories (TAA, RTGI), every other field replicated, as the
    JAX package's ``_screen_sharded_spec`` lays them out."""
    rank, n = band_index(group)

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not divide into {n} bands")
        b = x.shape[0] // n
        return x[rank * b:(rank + 1) * b].clone()

    return temporal._replace(taa_history=rows(temporal.taa_history),
                             rtgi_history=rows(temporal.rtgi_history))


def _rank_main(rank, n, fn, args, device, backend, init_file, queue):
    """One rank: join the group, pick the device, run ``fn(group, device,
    *args)``, report (rank, error or None, rank 0's result)."""
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=n,
                                rank=rank, timeout=timedelta(seconds=TIMEOUT_S))
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        out = fn(dist.group.WORLD, dev, *args)
        queue.put((rank, None, out if rank == 0 else None))
    except BaseException:  # the parent reports it and stops the other ranks
        queue.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(n: int, fn, *args, device, backend: str, init_file: str):
    """Run ``fn(group, device, *args)`` on ``n`` ranks and return rank 0's
    result (a picklable host object: no CUDA tensors).

    Each rank is a spawned process whose process group is initialised from the
    ``file://`` store at ``init_file`` (removed before and after) with
    ``backend`` ("gloo" or "nccl"), on ``device``: "cpu", or "cuda", which
    gives rank r the card r % device_count. A rank that raises or dies fails
    the call: the other ranks are stopped and RuntimeError carries its
    traceback. ``TIMEOUT_S`` bounds each collective and the wait for a rank."""
    ctx = torch.multiprocessing.get_context("spawn")
    init_file = os.path.abspath(init_file)
    if os.path.exists(init_file):
        os.remove(init_file)
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, fn, args, device, backend, init_file, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    result, errors, reported = None, [], 0
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while reported < n and not errors:
            try:
                rank, err, out = queue.get(timeout=1.0)
            except queue_module.Empty:  # a rank that died without reporting fails now
                dead = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
                if dead:
                    errors.append(f"ranks died without reporting: exit codes {dead}")
                elif time.monotonic() > deadline:
                    errors.append(f"no report within {TIMEOUT_S} s")
                continue
            reported += 1
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            elif rank == 0:
                result = out
        for p in procs:
            p.join(timeout=30 if not errors else 1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(init_file):
            os.remove(init_file)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (0, None)]
    if errors or bad:
        raise RuntimeError(f"run_ranks({n}) failed: {errors or bad}")
    return result
