"""Cells cut to a size a CPU test run holds (the frames and the check as in a
run; only the sizes are smaller)."""

import copy
import json
from pathlib import Path

import pytest

from benchmark.harness import runner
from benchmark.harness.cell import BENCH_DIR, ROOT, Cell, find_cell, load_manifest


@pytest.fixture
def short_windows(monkeypatch):
    """Check the first window frame, and trace 3 frames."""
    monkeypatch.setattr(runner, "CHECK_WITHIN_FRAMES", 1)
    monkeypatch.setattr(runner, "TRACE_FRAMES", 3)


def small_cell(name: str, root: Path = ROOT) -> Cell:
    """Cell ``name`` of the checkout at ``root`` at a small size. A name
    ``<cell>+<traffic>`` gives that cell with the mix of
    ``traffic/<traffic>.json`` in place of its own (the moving scene of
    ``dynamic16``, whose cell is not in the manifest yet)."""
    name, _, traffic = name.partition("+")
    cell = find_cell(load_manifest(root), name, root)
    if traffic:
        cell = cell._replace(traffic=json.loads(
            (BENCH_DIR / "traffic" / f"{traffic}.json").read_text()))
    return cell._replace(config=small_config(cell.config))


def small_config(cfg: dict) -> dict:
    """Configuration ``cfg`` at a small size: a coarse scene with small
    textures, a 128x64 frame (the parity frame: 128x64 rendered, the least
    its tiles allow, and upscaled to 192x96, its ratio of 1.5), and each GI
    and shadow structure cut to match."""
    cfg = copy.deepcopy(cfg)
    cfg["scene"]["args"].update(detail=2, texture_size=32)
    rc = cfg["render_config"]
    if cfg["frame"] == "parity_frame_config":
        rc.update(width=192, height=96, render_width=128, render_height=64, lpv_resolution=8,
                  lpv_rsm_resolution=32, lpv_num_propagation_steps=4,
                  shadow_cascade_resolution=128)
    else:
        rc.update(width=128, height=64)
    if rc.get("gi_mode") == "PROBES":
        rc.update(probe_grid=[8, 4, 8], probe_budget=32, probe_rays=64,
                  shadow_cascade_resolution=128)
    cfg.update(warmup_frames=2)
    return cfg


def parity_config(limit: int) -> dict:
    """The parity frame (``parity_frame_config`` at its defaults: 1280x736
    rendered, TAAU to 1920x1088, staggered LPV GI, half-rate SSAO, the
    staggered CSM) on the accepted cells' courtyard, held to ``limit``: a
    configuration that no cell of the manifest runs yet."""
    cfg = json.loads((BENCH_DIR / "configs" / "courtyard_rtgi.json").read_text())
    cfg.update(
        name="courtyard_parity",
        source="https://github.com/DethRaid/AndroidRenderer, the mobile frame: r.GI.Mode LPV "
               "(gi/light_propagation_volume.cpp), SSAO, FSR3 Quality upscale with "
               "upscaler.hpp's Halton jitter",
        deployment="parity_frame_config at its defaults on the bench courtyard",
        frame="parity_frame_config",
        render_config={"width": 1920, "height": 1088},
        limits={"image_steps": limit},
    )
    return cfg
