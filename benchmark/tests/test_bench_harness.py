"""CPU tests of the benchmark's harness: the manifest, the traffic, the trace
readers, the window's statistics and the no-JAX rule."""

import ast
import json
import re
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import runner
from benchmark.harness.cell import ROOT, find_cell, load_manifest, metric_reader
from benchmark.harness.frames import make_walk, rest_transforms, scene_record
from benchmark.harness.profile import Profile
from benchmark.harness.walk import Walk
from benchmark.reference.plain.camera import Camera, taa_jitter
from benchmark.tests.small import parity_config

BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_shape():
    m = load_manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["command"] == ["python3", "benchmark/run.py"] and m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in m[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    layers = {}
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert UNIT.match(e["unit"]) and 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for p in m["per_layer"]:
        assert UNIT.match(p["unit"]) and p["moves"] in e2e and p["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{p['name']}.py").is_file()
        layers.setdefault(p["layer"], p["layer"])
    assert len(json.dumps(m)) < 64 * 1024
    for w in m["workloads"]:
        cell = find_cell(m, w["name"])
        assert cell.end_to_end and cell.per_layer


def test_new_cell_from_new_files_only(tmp_path):
    """A cell made only of a new configuration, traffic and metric file and new
    manifest entries is found by name; nothing of the harness changes."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    m = load_manifest()
    cfg = json.loads((ROOT / m["configs"][0]["file"]).read_text())
    cfg["render_config"]["gi_mode"] = "OFF"
    (root / "benchmark/configs/courtyard_nogi.json").write_text(json.dumps(cfg))
    walk = json.loads((BENCH / "traffic/walk.json").read_text())
    walk["path"]["radii_m"] = [1.0, 0.5]
    (root / "benchmark/traffic/small_loop.json").write_text(json.dumps(walk))
    (root / "benchmark/metrics/frames_traced.py").write_text(
        "def read(run):\n    return None if run.profile is None else run.profile.frames\n")
    m["configs"].append({"name": "courtyard_nogi", "source": "x",
                         "file": "benchmark/configs/courtyard_nogi.json", "reduced": [],
                         "why": "x"})
    m["workloads"].append({"name": "courtyard_nogi.small_loop", "config": "courtyard_nogi",
                           "traffic": "small_loop", "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                           "source": "device_trace", "layer": "device", "moves": "frame_ms",
                           "workloads": ["courtyard_nogi.small_loop"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = find_cell(load_manifest(root), "courtyard_nogi.small_loop", root)
    assert cell.config["render_config"]["gi_mode"] == "OFF"
    assert cell.traffic["path"]["radii_m"] == [1.0, 0.5]
    assert "frames_traced" in [p["name"] for p in cell.per_layer]
    info = runner.RunInfo(1.0, 2.0, Profile([], 7), 0, None, 1.0, None, 0.0, 0)
    assert metric_reader("frames_traced", root)(info) == 7
    with pytest.raises(KeyError):
        find_cell(load_manifest(root), "courtyard_nogi.nowhere", root)


def _walk(traffic: str, seed: int) -> Walk:
    config = find_cell(load_manifest(), "courtyard_rtgi.walk").config
    record = scene_record(_small_textures(config))
    return Walk(json.loads((BENCH / "traffic" / f"{traffic}.json").read_text()), seed, 1920,
                1088, 75.0, 0.05, record.primitive_meshes(), rest_transforms(record))


def _view_as_before(walk: Walk, f: int, cfg: dict):
    """Frame ``f``'s view as the walk built it before it read the render size
    and the jitter from the configuration: the camera of the configuration
    file's width and height, no jitter."""
    rc, cam_cfg = cfg["render_config"], cfg["camera"]

    def camera(g):
        cam = Camera(fov_degrees=cam_cfg["fov_degrees"], aspect=rc["width"] / rc["height"],
                     z_near=cam_cfg["z_near"], render_resolution=(rc["width"], rc["height"]))
        cam.position, cam.pitch, cam.yaw = walk._pose(g)
        return cam

    cam = camera(max(f - 1, 0))
    if f > 0:
        cam.end_frame()
        cam.position, cam.pitch, cam.yaw = walk._pose(f)
    return cam.view_data()


@pytest.mark.parametrize("name", ["courtyard_rtgi.walk", "courtyard_probes.walk",
                                  "courtyard_rtgi.walk+dynamic16"])
def test_walk_views_of_the_accepted_cells_are_as_before(name):
    """The accepted cells render at their output size without TAA: the walk
    built from their configuration gives the views it gave before, bit for bit."""
    cell_name, _, traffic = name.partition("+")
    cell = find_cell(load_manifest(), cell_name)
    traffic = (json.loads((BENCH / "traffic" / f"{traffic}.json").read_text()) if traffic
               else cell.traffic)
    record = scene_record(_small_textures(cell.config))
    for seed in (2 ** 31 + 11, 7, 4_000_000_123):
        walk = make_walk(cell.config, traffic, seed, record)
        for f in range(8):
            new, old = walk.view(f), _view_as_before(walk, f, cell.config)
            for a, b in zip(new, old):
                assert a.dtype == b.dtype and np.array_equal(a, b), (seed, f)


def test_parity_walk_takes_the_render_size_and_the_jitter():
    """The parity frame's walk: the output's aspect, the render size's pixels,
    and frame f jittered by taa_jitter(f) after taa_jitter(f - 1)."""
    cfg = parity_config(1000)
    record = scene_record(_small_textures(cfg))
    walk = make_walk(cfg, json.loads((BENCH / "traffic/walk.json").read_text()), 5, record)
    plain = _view_as_before(walk, 3, cfg)
    for f in range(4):
        v = walk.view(f)
        assert np.array_equal(v.render_resolution, np.float32([1280, 736]))
        assert np.array_equal(v.jitter, taa_jitter(f))
        assert np.array_equal(v.previous_jitter,
                              taa_jitter(f - 1) if f else np.zeros(2, np.float32))
        assert v.projection[0, 2] == np.float32(taa_jitter(f)[0] * 2.0 / 1280.0)
        assert v.projection[1, 1] / v.projection[0, 0] == pytest.approx(1920 / 1088, rel=1e-6)
    # The jitter leaves the unjittered matrices and the pose alone.
    assert np.array_equal(walk.view(3).unjittered_view_proj, plain.unjittered_view_proj)
    assert np.array_equal(walk.view(3).last_view_proj, plain.last_view_proj)


def _small_textures(config: dict) -> dict:
    """The configuration with its textures at 16 texels a side (the walk reads
    only the scene's primitives)."""
    config = json.loads(json.dumps(config))
    config["scene"]["args"]["texture_size"] = 16
    return config


@pytest.mark.parametrize("traffic", ["walk", "dynamic16"])
def test_traffic_deterministic_and_distinct(traffic):
    seeds = (2 ** 31 + 11, 2 ** 31 + 11, 12345)
    walks = [_walk(traffic, s) for s in seeds]
    views = [[w.view(f) for f in (0, 1, 57)] for w in walks]
    for a, b in zip(views[0], views[1]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(views[0][2].view, views[2][2].view)
    # Every seed walks the same loop: seed 2's frames are seed 1's, shifted.
    w0, w2 = walks[0], walks[2]
    shift = (w2.start - w0.start) % w0.loop_frames
    assert np.allclose(w0.view(shift + 5).view, w2.view(5).view, atol=1e-5)
    if traffic == "dynamic16":
        t = [w.transforms(9) for w in walks]
        assert np.array_equal(t[0], t[1]) and not np.array_equal(t[0], t[2])
        assert walks[0].moved.size == walks[2].moved.size == 16
        meshes = np.asarray(scene_record(_small_textures(find_cell(
            load_manifest(), "courtyard_rtgi.walk").config)).primitive_meshes())
        assert sorted(meshes[walks[0].moved]) == sorted(meshes[walks[2].moved])
        rest = walks[0].rest
        moved = walks[0].moved
        assert np.abs(t[0][moved, 1, 3] - rest[moved, 1, 3]).max() <= 0.5 + 1e-6
        still = np.setdiff1d(np.arange(rest.shape[0]), moved)
        assert np.array_equal(t[0][still], rest[still])


def test_walk_stays_clear_of_the_columns():
    w = _walk("walk", 5)
    eyes = np.array([w.view(f).position for f in range(w.loop_frames)])
    cols = np.array([(-10.5 + 3 * k, -6.0 + 4 * r) for r in range(4) for k in range(8)])
    d = np.linalg.norm(eyes[:, None, [0, 2]] - cols[None], axis=-1)
    assert d.min() > 0.35 + 0.3
    step = np.linalg.norm(np.diff(eyes, axis=0), axis=1)
    assert np.allclose(step, 0.046667, rtol=0.05) and np.allclose(eyes[:, 1], 1.7)


def _trace_events():
    """A recorded window of 2 frames: host ranges, kernels and their launches."""
    ev = []

    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)

    for i, base in enumerate((0.0, 1000.0)):
        x("user_annotation", "bench/frame", base, 900)
        x("user_annotation", "frame/rtgi", base, 300)
        x("user_annotation", "frame/resolve", base + 350, 100)
        x("kernel", "void at::native::elementwise_kernel<128, 2>(int)", base + 10, 100, 1 + 10 * i)
        x("kernel", "void (anonymous namespace)::traverse_kernel<true>(Params)", base + 150, 160,
          2 + 10 * i)
        x("kernel", "(anonymous namespace)::raster_kernel(float const*)", base + 400, 40,
          3 + 10 * i)
        x("kernel", "(anonymous namespace)::resolve_kernel(int)", base + 450, 50, 4 + 10 * i)
        x("gpu_memcpy", "Memcpy DtoD", base + 600, 110)
        for c, ts in ((1, 5), (2, 100), (3, 360), (4, 440)):
            x("cuda_runtime", "cudaLaunchKernel", base + ts, 2, c + 10 * i)
    return ev


def test_readers_on_a_recorded_profile():
    prof = Profile(_trace_events(), frames=2)
    bounds = {"traverse_ms": 0.016, "raster_ms": 0.009}
    info = runner.RunInfo(3.5, 4.5, prof, 1, bounds, 0.002, 1.0, 0.0, 0)
    read = {p["name"]: metric_reader(p["name"])(info) for p in load_manifest()["per_layer"]}
    assert read["bake_s"] == 3.5 and read["warmup_s"] == 4.5
    assert read["kernels_per_frame"] == 4
    assert read["stage_ms.rtgi"] == pytest.approx(0.26)  # 100 + 160 us a frame
    assert read["stage_ms.resolve"] == pytest.approx(0.09)
    assert read["stage_ms.probes"] is None and read["stage_ms.translucency"] is None
    assert read["traverse_roofline"] == pytest.approx(10.0)  # 16 us bound / 160 us
    assert read["raster_roofline"] == pytest.approx(10.0)  # 9 us / (40 + 50) us
    # Busy: 100 + 160 + 40 + 50 + 110 us a frame, against 1 ms a frame untraced.
    assert read["device_idle_pct"] == pytest.approx(100 * (1 - 0.46 / 1.0))
    gaps = prof.idle_gaps()
    assert gaps[0][1] == pytest.approx(300e-6)  # 710 -> 1010 us
    assert gaps[0][0].startswith("frame/rtgi: before at::native::elementwise_kernel")
    assert gaps[1][0] == "no launch record: before Memcpy DtoD"
    assert [g for g in gaps if g[1] == pytest.approx(40e-6)][0][0].startswith(
        "frame/rtgi: before traverse_kernel")
    assert prof.top_ops()[0][1] == pytest.approx(320e-6)


def test_a_stall_moves_frame_ms_and_its_p95():
    def stats(stall_at):
        clock = runner._Clock("cpu")

        def step(i):
            time.sleep(0.2 if i == stall_at else 0.01)

        n, seconds = runner.window(step, None, 2, clock, 12, "cpu")
        return seconds * 1e3 / n, float(np.percentile(clock.intervals_ms(), 95))

    calm, stalled = stats(None), stats(6)
    assert stalled[0] > calm[0] + 10.0
    assert stalled[1] > calm[1] + 50.0


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_under_benchmark_imports_jax():
    from benchmark.run import FORBIDDEN

    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 40
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark import run

    import androidrenderer_tpu_torch  # noqa: F401  the program: allowed

    assert run.forbidden_modules() == [m for m in ("androidrenderer_tpu", "jax")
                                       if m in sys.modules]
    monkeypatch.setitem(sys.modules, "androidrenderer_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib_extra", object())
    assert "androidrenderer_tpu" in run.forbidden_modules()
    assert "jaxlib_extra" not in run.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        for name in _imports(path):
            assert not name.startswith("androidrenderer_tpu"), f"{path} imports {name}"
        head = path.read_text().splitlines()[:2]
        if path.parent != BENCH / "reference":
            assert (any(f"at commit {c}" in head[0] for c in ("c15a27329e0a", "dfc74ed377a9"))
                    or head[0].startswith("# Written for the benchmark")), path


@pytest.mark.cuda
def test_run_on_the_card_is_correct(card):
    """The command runs a cell on the card and reads it correct."""
    import subprocess

    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "courtyard_rtgi.walk", "--seed", "3", "--seconds", "1", "--trace",
                        "0"], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


def test_run_without_a_card_prints_no_result():
    import subprocess

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "courtyard_rtgi.walk", "--seed", "3", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 2 and p.stdout == "" and "needs 1 CUDA device" in p.stderr
