"""Cells of ``BENCHMARK.json`` and the files each one names.

A cell names a configuration and a traffic mix; its metrics are the manifest's
entries that list it (or list no cells). Each piece is a file of its own,
found by name: ``configs/<config>.json`` (the manifest's ``file``),
``traffic/<traffic>.json`` and ``metrics/<metric>.py``. A later cell is made
of new files and new manifest entries alone.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, NamedTuple

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: list  # the manifest's end-to-end entries reported in this cell
    per_layer: list  # the manifest's per-layer entries reported in this cell


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reported(entry: dict, cell: str) -> bool:
    return cell in entry.get("workloads", [cell])


def find_cell(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell called ``name``, with its configuration and traffic read."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    bench = root / "benchmark"
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((root / entry["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reported(m, name)],
    )


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``: the metric's value, or None when
    the run holds nothing for it to read."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
