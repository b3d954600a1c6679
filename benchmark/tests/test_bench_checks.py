"""The comparison that decides ``correct`` has teeth.

On the CPU, at a small size: a run whose timed path is sound comes out correct,
and one with a fault planted under it comes out not correct, for each fault a
frame can have: a step that hands on its state unchanged, half of the rays
left out, a displayed image altered where it is produced. There is no
exchange between chips in these one-card cells.

The parity frame, a configuration that no cell runs yet, is held the same way
at a small size, added as new files alone: its faults are the LPV volumes
handed on unchanged, the TAA history dropped each frame and the jitter left
out of the program's views, read against the limit that its readings on the
card propose (``PARITY_LIMIT``).

On the card, at the cells' own size: the control, the reference computed with
TF32 (the precision below the program's float32 with TF32 off) put in the
program's place, comes out not correct on three seeds, and the reference with
its float32 chains reordered in float64 comes out correct; so does the
program itself in the parity frame, whose LPV injection adds in atomic order
on the card.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from benchmark.harness.cell import BENCH_DIR, load_manifest
from benchmark.harness.result import result
from benchmark.harness.runner import run_cell
from benchmark.tests.small import (  # noqa: F401  (short_windows: a fixture)
    parity_config, short_windows, small_cell,
)

# The parity frame's proposed limit on image_steps, set from its readings on
# the card (PERF.md section 7, row 1's readings: the sound runs, ``wide`` and
# ``control``, each with its seeds).
PARITY_LIMIT = 5000

SEED = 2 ** 31 + 7


def _state_unchanged(render):
    def frame(scene, view, params, temporal):
        out, _ = render(scene, view, params, temporal)
        return out, temporal

    return frame


def _image_altered(render):
    def frame(scene, view, params, temporal):
        out, nxt = render(scene, view, params, temporal)
        img = out.image.clone()
        tile = img[:8, :8]
        img[:8, :8] = torch.where(tile > 127, torch.zeros_like(tile), torch.full_like(tile, 255))
        return out._replace(image=img), nxt

    return frame


def _half_the_rays(monkeypatch):
    from androidrenderer_tpu_torch.ops.rt import traverse

    walk = traverse.trace_rays_reference

    def half(bvh, origins, directions, tmin, tmax, any_hit=False, max_steps=1024, active=None,
             alpha_bitmap_test=False, counts=False, masked_any_hit=False):
        keep = torch.arange(origins.shape[0], device=origins.device) % 2 == 0
        active = keep if active is None else active & keep
        return walk(bvh, origins, directions, tmin, tmax, any_hit, max_steps, active,
                    alpha_bitmap_test, counts=counts, masked_any_hit=masked_any_hit)

    monkeypatch.setattr(traverse, "trace_rays_reference", half)


def _correct(cell, fault=None) -> bool:
    run = run_cell(cell, SEED, 0.1, False, device="cpu", fault=fault)
    out, lines = result(cell, run, False, {"platform": "cpu"})
    assert list(out)[-1] == "checks" and lines[-1].startswith("check image_steps")
    return out["correct"]


CELLS = ["courtyard_rtgi.walk", "courtyard_probes.walk", "courtyard_rtgi.walk+dynamic16"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, short_windows):
    assert _correct(small_cell(name))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_rays", "image_altered"])
def test_planted_fault_is_not_correct(name, fault, monkeypatch, short_windows):
    wrap = None
    if fault == "state_unchanged":
        wrap = _state_unchanged
    elif fault == "image_altered":
        wrap = _image_altered
    else:
        _half_the_rays(monkeypatch)
    assert not _correct(small_cell(name), wrap)


PARITY_STAGES = ("lpv", "ssao", "taa")


def _parity_checkout(root):
    """A checkout at ``root`` whose parity cell is new files and new manifest
    entries alone: its configuration, and readers of the frame's existing
    ``frame/lpv``, ``frame/ssao`` and ``frame/taa`` ranges."""
    shutil.copytree(BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "benchmark/configs/courtyard_parity.json").write_text(
        json.dumps(parity_config(PARITY_LIMIT)))
    m = load_manifest()
    m["configs"].append({"name": "courtyard_parity", "source": "x",
                         "file": "benchmark/configs/courtyard_parity.json", "reduced": [],
                         "why": "x"})
    m["workloads"].append({"name": "courtyard_parity.walk", "config": "courtyard_parity",
                           "traffic": "walk", "chips": 1, "why": "x"})
    for stage in PARITY_STAGES:
        (root / f"benchmark/metrics/stage_ms.{stage}.py").write_text(
            "from benchmark.harness.profile import stage_ms\n\n\n"
            f"def read(run):\n    return stage_ms(run.profile, \"frame/{stage}\")\n")
        m["per_layer"].append({"name": f"stage_ms.{stage}", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": stage, "moves": "frame_ms",
                               "workloads": ["courtyard_parity.walk"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def test_parity_cell_from_new_files_only(tmp_path, short_windows):
    """The parity frame added as a cell of new files alone is found by name and
    runs small on the CPU through the harness, correct with no step: on the
    CPU the program's LPV injection adds in the reference's order."""
    cell = small_cell("courtyard_parity.walk", _parity_checkout(tmp_path / "checkout"))
    assert cell.config["frame"] == "parity_frame_config"
    names = [p["name"] for p in cell.per_layer]
    assert names[-3:] == [f"stage_ms.{s}" for s in PARITY_STAGES]
    run = run_cell(cell, SEED, 0.1, False, device="cpu")
    out, _ = result(cell, run, False, {"platform": "cpu"})
    assert out["correct"] and run.numbers["image_steps"] == 0


def _lpv_unchanged(render):
    def frame(scene, view, params, temporal):
        out, nxt = render(scene, view, params, temporal)
        return out, nxt._replace(lpv=temporal.lpv)

    return frame


def _taa_history_dropped(render):
    def frame(scene, view, params, temporal):
        out, nxt = render(scene, view, params, temporal)
        return out, nxt._replace(taa_history=temporal.taa_history, taa_valid=temporal.taa_valid)

    return frame


def _jitter_left_out(render):
    def frame(scene, view, params, temporal):
        p = view.projection.copy()
        p[0, 2] = p[1, 2] = 0.0
        view = view._replace(
            projection=p, view_proj=view.unjittered_view_proj,
            inverse_projection=np.linalg.inv(p.astype(np.float64)).astype(np.float32),
            jitter=np.zeros(2, np.float32))
        return render(scene, view, params, temporal)

    return frame


PARITY_FAULTS = {"lpv_unchanged": _lpv_unchanged, "taa_history_dropped": _taa_history_dropped,
                 "jitter_left_out": _jitter_left_out, "state_unchanged": _state_unchanged,
                 "image_altered": _image_altered}


@pytest.mark.parametrize("fault", sorted(PARITY_FAULTS))
def test_parity_planted_fault_reads_over_the_limit(fault, tmp_path, short_windows):
    cell = small_cell("courtyard_parity.walk", _parity_checkout(tmp_path / "checkout"))
    run = run_cell(cell, SEED, 0.1, False, device="cpu", fault=PARITY_FAULTS[fault])
    out, _ = result(cell, run, False, {"platform": "cpu"})
    assert not out["correct"] and run.numbers["image_steps"] > PARITY_LIMIT


def test_wide_selection_reads_the_cascade_margin():
    """At the CPU size, seed 8 walks past a wall at z = -2.0 on cascade 3's
    margin: the reference with its float32 chains widened reads under the
    limit, and with the LPV apply's cascade selection widened as well, over it
    (the hazard that PERF.md section 7 names as blocker B)."""
    from benchmark.harness import check
    from benchmark.harness.frames import make_walk, scene_record
    from benchmark.harness.runner import checked_frame
    from benchmark.tests.small import small_config

    cfg = small_config(parity_config(PARITY_LIMIT))
    record = scene_record(cfg)
    ref = check.Reference(cfg, record, "cpu")
    walk = make_walk(cfg, json.loads((BENCH_DIR / "traffic/walk.json").read_text()), 8, record)
    k = checked_frame(8)
    frames = check.compared_frames({"k": k, "f_k": int(cfg["warmup_frames"]) + k})
    plain, _ = ref.images(walk, frames)
    read = {v: check.judge(ref.images(walk, frames, v)[0], plain, frames)[0]["image_steps"]
            for v in ("wide", "wide_selection")}
    assert read["wide"] <= PARITY_LIMIT < read["wide_selection"], read


def _cell_under_test(name: str):
    """(configuration, traffic) of a manifest cell, or of the parity frame."""
    from benchmark.harness.cell import find_cell

    if name == "courtyard_parity.walk":
        return parity_config(PARITY_LIMIT), json.loads((BENCH_DIR / "traffic/walk.json").read_text())
    cell = find_cell(load_manifest(), name)
    return cell.config, cell.traffic


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS[:2] + ["courtyard_parity.walk"])
def test_variants_against_the_limit(name, card):
    """At the cell's own size, on three seeds: the control (the TF32
    reference in the program's place) reads over the limit, and the widened
    reference (float64 chains, the same sums in another order) under it; in
    the parity frame a short run of the program through the timed path reads
    under it too."""
    from benchmark.harness import check
    from benchmark.harness.cell import Cell
    from benchmark.harness.frames import make_walk, scene_record
    from benchmark.harness.runner import checked_frame

    cfg, traffic = _cell_under_test(name)
    limit = cfg["limits"]["image_steps"]
    record = scene_record(cfg)
    ref = check.Reference(cfg, record, "cuda")
    for seed in (101, 2 ** 31 + 202, 303):
        walk = make_walk(cfg, traffic, seed, record)
        k = checked_frame(seed)
        frames = check.compared_frames({"k": k, "f_k": int(cfg["warmup_frames"]) + k})
        plain, _ = ref.images(walk, frames)
        read = {v: check.judge(ref.images(walk, frames, v)[0], plain, frames)[0]["image_steps"]
                for v in ("control", "wide")}
        if name == "courtyard_parity.walk":
            cell = Cell(name, 1, cfg, traffic, [], [])
            read["program"] = run_cell(cell, seed, 0.1, False).numbers["image_steps"]
        print(json.dumps({"seed": seed, **read}))
        assert read.pop("control") > limit, seed
        assert max(read.values()) <= limit, seed
