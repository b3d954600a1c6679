"""Cells cut to a size a CPU test run holds (the frames and the check as in a
run; only the sizes are smaller)."""

import copy
import json

import pytest

from benchmark.harness import runner
from benchmark.harness.cell import BENCH_DIR, find_cell, load_manifest


@pytest.fixture
def short_windows(monkeypatch):
    """Check the first window frame, and trace 3 frames."""
    monkeypatch.setattr(runner, "CHECK_WITHIN_FRAMES", 1)
    monkeypatch.setattr(runner, "TRACE_FRAMES", 3)


def small_cell(name: str):
    """Cell ``name`` at a small size. A name ``<cell>+<traffic>`` gives that
    cell with the mix of ``traffic/<traffic>.json`` in place of its own (the
    moving scene of ``dynamic16``, whose cell is not in the manifest yet)."""
    name, _, traffic = name.partition("+")
    cell = find_cell(load_manifest(), name)
    if traffic:
        cell = cell._replace(traffic=json.loads(
            (BENCH_DIR / "traffic" / f"{traffic}.json").read_text()))
    cfg = copy.deepcopy(cell.config)
    cfg["scene"]["args"].update(detail=2, texture_size=32)
    rc = cfg["render_config"]
    rc.update(width=128, height=64)
    if rc.get("gi_mode") == "PROBES":
        rc.update(probe_grid=[8, 4, 8], probe_budget=32, probe_rays=64,
                  shadow_cascade_resolution=128)
    cfg.update(warmup_frames=2)
    return cell._replace(config=cfg)
