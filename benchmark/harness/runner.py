"""One run of one cell: set-up, the window, the trace, the check.

Set-up (``setup_s``, from the first statement of run.py to the window's first
dispatch): the frozen generator's record of the scene, handed to the
program's ``RenderScene`` and baked on the device with its BVH (``bake_s``);
the hand kernels loaded from ``build/torch_kernels/``; the configuration's
warm-up frames through the same entry as the window, which run every shape
the window runs and start the RTGI history or the probe cache (``warmup_s``,
loads included).

The window drives ``make_renderer(config)`` once per frame along the walk,
as a viewer would, with at most ``frames_in_flight`` frames in flight: before
it dispatches frame i it waits on the completion event of frame
i - frames_in_flight, and it records an event after each frame. It runs for
the run's seconds (and at least until the frame after the checked one), then
waits for the device. With ``trace`` it runs ``TRACE_FRAMES`` frames under
``torch.profiler``, each in a ``bench/frame`` range, and then times
``UNTRACED_FRAMES`` more frames without it: the profiler's host work slows a
traced frame, so the device's idle share is taken against these.
"""

from __future__ import annotations

import gc
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.harness import check
from benchmark.harness.cell import ROOT, Cell
from benchmark.harness.frames import make_config, make_walk, scene_record
from benchmark.harness.profile import Profile
from benchmark.harness.walk import seed_rng

TRACE_DIR = ROOT / "build" / "bench"
# Frames a traced run profiles and then times without the profiler, and the
# window frames the checked one is drawn from (the reference renders every
# frame up to it).
TRACE_FRAMES = 6
UNTRACED_FRAMES = 24
CHECK_WITHIN_FRAMES = 4


class RunInfo(NamedTuple):
    """What a per-layer reader reads (metrics/<name>.py)."""

    bake_s: float
    warmup_s: float
    profile: Profile | None  # the traced window
    check_frame: int  # the traced frame whose bounds were counted
    bounds: dict | None  # bounds.py's least ms of that frame's raster calls and traces
    window_s: float
    untraced_frame_ms: float | None  # the frames timed without the profiler after it
    check_s: float  # the reference's bake and frames, after the window
    check_frames: int  # the frames the reference rendered


class Run(NamedTuple):
    frames: int
    window_s: float
    frame_ms: float
    frame_ms_p95: float | None
    setup_s: float
    peak_bytes: int
    numbers: dict
    notes: list
    info: RunInfo


class _Clock:
    """Completion marks of frames: CUDA events on the card, host times on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def wait(self, i: int):
        if self.cuda:
            self.marks[i].synchronize()

    def intervals_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [m[i - 1].elapsed_time(m[i]) for i in range(1, len(m))]
        return [(m[i] - m[i - 1]) * 1e3 for i in range(1, len(m))]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(step, seconds, in_flight: int, clock: _Clock, min_frames: int, device):
    """(frames, seconds): call ``step(i)`` for frames i = 0, 1, ... with at most
    ``in_flight`` frames unfinished, marking each frame's completion on
    ``clock``, until ``seconds`` have passed (None: none) and ``min_frames``
    frames were dispatched; then wait for the device. The seconds run from the
    first dispatch to the device's end of the last frame."""
    n = 0
    t0 = time.perf_counter()
    while n < min_frames or (seconds is not None and time.perf_counter() - t0 < seconds):
        if n >= in_flight:
            clock.wait(n - in_flight)
        step(n)
        clock.mark()
        n += 1
    _sync(device)
    return n, time.perf_counter() - t0


def checked_frame(seed: int) -> int:
    """The window frame the check compares, drawn from the seed (in a traced
    run, one of the traced frames)."""
    return int(seed_rng(seed, 2).integers(min(CHECK_WITHIN_FRAMES, TRACE_FRAMES - 1)))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, fault=None, variant: str | None = None) -> Run:
    """Run ``cell`` once. ``fault`` wraps the program's frame callable (tests
    plant faults with it); ``variant`` puts a variant of the reference in the
    comparison (check.VARIANTS)."""
    t_start = time.perf_counter() if t_start is None else t_start
    from androidrenderer_tpu_torch import config as port_config
    from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
    from androidrenderer_tpu_torch.scene import dynamic
    from androidrenderer_tpu_torch.scene.material_storage import Material
    from androidrenderer_tpu_torch.scene.scene import RenderScene

    cfg = cell.config
    record = scene_record(cfg)
    walk = make_walk(cfg, cell.traffic, seed, record)

    t = time.perf_counter()
    rs = record.replay(RenderScene, Material)
    scene, _ = rs.build(device=device)
    _sync(device)
    bake_s = time.perf_counter() - t

    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        from androidrenderer_tpu_torch.ops import gbuffer
        from androidrenderer_tpu_torch.ops.cuda_build import load_all
        from androidrenderer_tpu_torch.ops.raster import raster
        from androidrenderer_tpu_torch.ops.rt import traverse

        load_all(raster.LIBRARY, traverse.LIBRARY, gbuffer.LIBRARY)
    config = make_config(port_config, cfg)
    render = make_renderer(config)
    if fault is not None:
        render = fault(render)
    params = port_config.RenderParams.default()
    temp = temporal_state_for(config, device=device)
    dyn = dynamic.make_dynamic_data(rs, scene) if walk.moved.size else None

    def frame(f, temp):
        sc = scene
        if dyn is not None:
            with record_function("frame/dynamic_update"):
                tr = torch.as_tensor(walk.transforms(f), device=device)
                sc = dynamic.update_primitive_transforms(scene, dyn, tr)
        return render(sc, walk.view(f), params, temp)

    held = {}
    warm = int(cfg["warmup_frames"])
    for f in range(warm):
        out, temp = frame(f, temp)
        if f == 0:
            held["image0"] = out.image
    del out
    _sync(device)
    warmup_s = time.perf_counter() - t

    in_flight = int(cfg["frames_in_flight"])
    held["k"] = k = checked_frame(seed)
    held["f_k"] = warm + k

    def step(n):
        nonlocal temp
        with record_function("bench/frame"):
            out, temp = frame(warm + n, temp)
        if n == k:
            held["image_k"] = out.image
        elif n == k + 1:
            held["image_k1"] = out.image

    clock = _Clock(device)
    setup_s = time.perf_counter() - t_start
    prof, untraced_ms = None, None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        n, window_s = window(step, None, in_flight, clock, TRACE_FRAMES, device)
        prof.__exit__(None, None, None)
        n0, s0 = window(lambda i: step(TRACE_FRAMES + i), None, in_flight, _Clock(device),
                        UNTRACED_FRAMES, device)
        untraced_ms = s0 * 1e3 / n0
    else:
        n, window_s = window(step, seconds, in_flight, clock, k + 2, device)
    profile_data = None
    if prof is not None:
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / f"{cell.name}.json"
        prof.export_chrome_trace(str(path))
        del prof
        profile_data = Profile.load(path, n)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    intervals = clock.intervals_ms()
    p95 = float(np.percentile(intervals, 95)) if intervals else None
    del render, scene, rs, dyn, temp, clock, step
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers, notes, bounds = check.compare(cfg, walk, record, held, device, variant=variant,
                                           count_work=trace)
    info = RunInfo(bake_s, warmup_s, profile_data, k, bounds, window_s, untraced_ms,
                   time.perf_counter() - t, held["f_k"] + 2)
    return Run(n, window_s, window_s * 1e3 / n, p95, setup_s, int(peak), numbers, notes, info)
