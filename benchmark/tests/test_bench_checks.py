"""The comparison that decides ``correct`` has teeth.

On the CPU, at a small size: a run whose timed path is sound comes out correct,
and one with a fault planted under it comes out not correct, for each fault a
frame can have: a step that hands on its state unchanged, half of the rays
left out, a displayed image altered where it is produced. There is no
exchange between chips in these one-card cells.

On the card, at the cells' own size: the control, the reference computed with
TF32 (the precision below the program's float32 with TF32 off) put in the
program's place, comes out not correct on three seeds, and the reference with
its float32 chains reordered in float64 comes out correct.
"""

import pytest
import torch

from benchmark.harness.result import result
from benchmark.harness.runner import run_cell
from benchmark.tests.small import short_windows, small_cell  # noqa: F401  (a fixture)

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


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS[:2])
def test_variants_against_the_limit(name, card):
    """At the cell's own size, on three seeds: the control (the TF32
    reference in the program's place) reads over the limit, and the widened
    reference (float64 chains, the same sums in another order) under it."""
    import json

    from benchmark.harness import check
    from benchmark.harness.cell import find_cell, load_manifest
    from benchmark.harness.frames import rest_transforms, scene_record
    from benchmark.harness.runner import checked_frame
    from benchmark.harness.walk import Walk

    cell = find_cell(load_manifest(), name)
    cfg, limit = cell.config, cell.config["limits"]["image_steps"]
    record = scene_record(cfg)
    ref = check.Reference(cfg, record, "cuda")
    rc, cam = cfg["render_config"], cfg["camera"]
    for seed in (101, 2 ** 31 + 202, 303):
        walk = Walk(cell.traffic, seed, rc["width"], rc["height"], cam["fov_degrees"],
                    cam["z_near"], record.primitive_meshes(), rest_transforms(record))
        k = checked_frame(seed)
        frames = check.compared_frames({"k": k, "f_k": int(cfg["warmup_frames"]) + k})
        plain, _ = ref.images(walk, frames)
        control = check.judge(ref.images(walk, frames, "control")[0], plain, frames)[0]
        wide = check.judge(ref.images(walk, frames, "wide")[0], plain, frames)[0]
        print(json.dumps({"seed": seed, "control": control, "wide": wide}))
        assert control["image_steps"] > limit, seed
        assert wide["image_steps"] <= limit, seed
