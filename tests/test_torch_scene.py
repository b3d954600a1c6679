"""The port's scene bake against the JAX package's, leaf for leaf.

Both renderers must read the very same arrays: ``RenderScene.build`` of the port
equals the JAX bake exactly (``np.array_equal`` and equal dtypes; here baked
without a BVH, so both carry the one-node empty BVH — tests/test_torch_rt.py
holds the built BVH), and ``scene_arrays_from_numpy`` carries the JAX
package's own arrays into the port unchanged.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from androidrenderer_tpu.scene import procedural as jax_procedural
from androidrenderer_tpu_torch.ops.rt.traverse import DeviceBVH
from androidrenderer_tpu_torch.scene import procedural as torch_procedural
from androidrenderer_tpu_torch.scene.scene import (
    SceneArrays,
    scene_arrays_from_numpy,
    scene_arrays_to_numpy,
)

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it (a 0.55 s test here took 27 s beside 4 busy workers).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCENES = ["cornell_scene", "alpha_test_scene", "courtyard_scene"]


def jax_leaves(jscene, bvh: bool = False) -> dict:
    """The JAX SceneArrays as the port's flat dict of host arrays (with
    ``bvh``, its BVH's fields as ``bvh.<name>`` too)."""
    out = {
        f: np.asarray(getattr(jscene, f))
        for f in jscene._fields if f not in ("bvh", "proxy")
    }
    out.update({f"proxy.{f}": np.asarray(getattr(jscene.proxy, f))
                for f in jscene.proxy._fields})
    if bvh:
        out.update({f"bvh.{f}": np.asarray(getattr(jscene.bvh, f)) for f in jscene.bvh._fields})
    return out


def jax_temporal_leaves(jt) -> dict:
    """A JAX TemporalState as the port's flat dict of host arrays: every field,
    the LPV volumes as ``lpv.<field>`` and the probe cascades as
    ``probes.<field>`` (temporal_from_numpy's keys)."""
    out = {f: np.asarray(getattr(jt, f)) for f in jt._fields if f not in ("lpv", "probes")}
    out.update({f"lpv.{f}": np.asarray(getattr(jt.lpv, f)) for f in jt.lpv._fields})
    out.update({f"probes.{f}": np.asarray(getattr(jt.probes, f)) for f in jt.probes._fields})
    return out


@pytest.fixture(scope="module", params=SCENES)
def both_bakes(request):
    jscene, jstats = getattr(jax_procedural, request.param)().build(with_bvh=False)
    leaves, stats = getattr(torch_procedural, request.param)().bake(with_bvh=False)
    return jax_leaves(jscene, bvh=True), jstats, leaves, stats


def test_bake_matches_jax_leaf_for_leaf(both_bakes):
    jl, jstats, tl, tstats = both_bakes
    assert set(jl) == set(tl)
    assert jstats == tstats
    for k in sorted(jl):
        a = np.asarray(tl[k])
        if a.dtype == np.float64:  # the JAX bake stores these narrowed
            a = a.astype(np.float32)
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        assert a.dtype == jl[k].dtype, k
        assert np.array_equal(a, jl[k]), k


def test_scene_arrays_from_numpy_round_trips(both_bakes):
    jl = both_bakes[0]
    scene = scene_arrays_from_numpy(jl, "cpu")
    assert isinstance(scene, SceneArrays) and isinstance(scene.bvh, DeviceBVH)
    without = {k: v for k, v in jl.items() if not k.startswith("bvh.")}
    assert scene_arrays_from_numpy(without, "cpu").bvh is None
    back = scene_arrays_to_numpy(scene)
    assert set(back) == set(jl)
    for k in jl:
        assert back[k].dtype == jl[k].dtype, k
        assert np.array_equal(back[k], jl[k]), k


def test_build_gives_device_tensors():
    scene, stats = torch_procedural.cornell_scene().build(device="cpu")
    assert scene.positions.dtype == torch.float32
    assert scene.tri_indices.dtype == torch.int32
    assert scene.textures.dtype == torch.uint8
    assert scene.tri_corner_pos.shape[1:] == (3, 3)
    assert scene.proxy.corners.dtype == torch.float32
    assert stats["num_triangles"] == int(scene.tri_valid.sum())


def _strip_imports(text: str) -> str:
    return re.sub(r"androidrenderer_tpu_torch\b", "androidrenderer_tpu", text)


@pytest.mark.parametrize(
    "rel",
    ["camera.py", "scene/mesh_storage.py", "scene/material_storage.py",
     "scene/procedural.py", "utils/bitstream.py", "scene/uastc.py", "scene/basis_lz.py",
     "scene/ktx2.py", "scene/gltf.py", "utils/image.py"],
)
def test_numpy_modules_are_copies(rel):
    """The numpy modules are carried over with only their imports changed."""
    ours = (REPO / "androidrenderer_tpu_torch" / rel).read_text()
    theirs = (REPO / "androidrenderer_tpu" / rel).read_text()
    assert _strip_imports(ours) == theirs


def _tool_code(text: str) -> list:
    """A tool's non-blank code lines without its module docstring (the usage
    line names the module it runs as) and without the repository tools'
    ``sys.path`` line, which points at one checkout, and its ``import sys``;
    the port's tools run with ``python -m``."""
    text = text[text.index('"""', 3) + 3:]
    return [line for line in text.splitlines()
            if line.strip() and line != "import sys" and not line.startswith("sys.path.insert(")]


@pytest.mark.parametrize("name", ["make_ktx2", "optimize_gltf"])
def test_asset_tools_are_copies(name):
    """The asset tools are the repository's tools/ copies: the same code with
    the port's imports, past the two differences ``_tool_code`` removes."""
    ours = (REPO / "androidrenderer_tpu_torch" / "tools" / f"{name}.py").read_text()
    theirs = (REPO / "tools" / f"{name}.py").read_text()
    assert _tool_code(_strip_imports(ours)) == _tool_code(theirs)


def _png_gltf(tmp_path) -> Path:
    """A one-quad glTF with two PNG textures (20 x 12 and 8 x 8) and its
    buffer in a data URI."""
    import base64
    import json

    from PIL import Image

    rng = np.random.default_rng(21)
    for name, (h, w) in (("base", (12, 20)), ("mr", (8, 8))):
        img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / f"{name}.png")
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    buf = pos.tobytes() + uv.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                "metallicRoughnessTexture": {"index": 1}}}],
        "textures": [{"source": 0}, {"source": 1}],
        "images": [{"uri": "base.png", "mimeType": "image/png"},
                   {"uri": "mr.png", "mimeType": "image/png"}],
        "buffers": [{"byteLength": len(buf), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(buf).decode()}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 48},
                        {"buffer": 0, "byteOffset": 48, "byteLength": 32},
                        {"buffer": 0, "byteOffset": 80, "byteLength": 12}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3",
             "min": [-1, -1, 0], "max": [1, 1, 0]},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
    }
    path = tmp_path / "quad.gltf"
    path.write_text(json.dumps(doc))
    return path


def test_asset_tools_write_the_jax_tools_bytes(tmp_path):
    """optimize_gltf (UASTC, textures resized to 16^2) and make_ktx2 (ETC1S)
    of the port, run with ``python -m``, write the same files byte for byte as
    the repository's tools/ run by path, on a glTF with PNG textures."""
    import os
    import subprocess
    import sys

    src = _png_gltf(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    runs = {
        "jax": [[sys.executable, str(REPO / "tools" / "optimize_gltf.py")],
                [sys.executable, str(REPO / "tools" / "make_ktx2.py")]],
        "port": [[sys.executable, "-m", "androidrenderer_tpu_torch.tools.optimize_gltf"],
                 [sys.executable, "-m", "androidrenderer_tpu_torch.tools.make_ktx2"]],
    }
    for side, (opt, mk) in runs.items():
        out = tmp_path / side
        for cmd in (opt + [str(src), "-o", str(out), "--max-size", "16", "--format", "uastc"],
                    mk + [str(tmp_path / "base.png"), "-o", str(out / "base.ktx2"),
                          "--format", "etc1s"]):
            proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                                  timeout=120)
            assert proc.returncode == 0, proc.stderr[-2000:]
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert {"quad.gltf", "quad.bin", "quad_img0.ktx2", "quad_img1.ktx2", "base.ktx2"} <= set(names)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


_BLOCKED = ("jax", "jaxlib", "androidrenderer_tpu", "tools", "raster_touch", "raster_lanes",
            "raster_subfold", "microbench_pallas_gather", "bench_raster")

_NO_JAX_FRAME = """
import importlib
import pkgutil
import sys
for name in %r:
    sys.modules[name] = None
import numpy as np
import androidrenderer_tpu_torch
for info in pkgutil.walk_packages(androidrenderer_tpu_torch.__path__, "androidrenderer_tpu_torch."):
    importlib.import_module(info.name)
for name in ("ops.gather", "ops.cuda_build", "ops.raster.binning", "ops.raster.raster_xla",
             "ops.raster.interpolate", "tools.microbench_pallas_gather", "tools.bench_raster",
             "tools.experiments.raster_touch", "tools.experiments.raster_lanes",
             "tools.experiments.raster_subfold", "tools.kernel_timing", "tools.raster_cuts",
             "ops.sh", "ops.lpv", "ops.upsample", "ops.taa", "ops.vrsaa", "ops.interpolation",
             "ops.visualize", "app.cvars", "app.application", "app.headless", "utils.image",
             "utils.bitstream", "scene.uastc", "scene.basis_lz", "scene.ktx2", "scene.gltf",
             "scene.dynamic", "parallel.collectives", "parallel.mesh", "parallel.dryrun",
             "tools.make_ktx2", "tools.optimize_gltf"):
    assert "androidrenderer_tpu_torch." + name in sys.modules, name
from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.config import RenderParams, default_frame_config
from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
from androidrenderer_tpu_torch.scene.procedural import cornell_scene

# The default frame with the exact alpha peel runs every stage the port has.
cfg = default_frame_config(128, 128, shadow_cascade_resolution=128, alpha_bitmap=False)
scene, _ = cornell_scene().build(device="cpu")
cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(128, 128))
cam.set_position([0.0, 0.0, 2.2])
cam.yaw = np.pi
temporal = temporal_state_for(cfg, device="cpu")
out, _ = make_renderer(cfg)(scene, cam.view_data(), RenderParams.default(), temporal)
assert tuple(out.image.shape) == (128, 128, 3) and int(out.image.max()) > 0
# The CLI's VRSAA frame, through its own entry point.
import tempfile
from androidrenderer_tpu_torch.app import headless
with tempfile.TemporaryDirectory() as tmp:
    assert headless.main(["--width", "128", "--height", "64", "--platform", "cpu",
                          "--aa", "vrsaa", "--out", tmp + "/f.png"]) == 0
leaked = sorted(m for m, mod in sys.modules.items()
                if mod is not None and m.split(".")[0] in %r)
assert not leaked, leaked
print("rendered without jax")
""" % (_BLOCKED, _BLOCKED)


def test_port_renders_without_jax():
    """Every module of the package imports, the ported tools, design studies,
    app layer and asset layer by name among them, the default frame with the
    exact alpha peel renders a 128^2 cornell frame, and the CLI renders a VRSAA
    frame, with JAX, the JAX package and the repository's tools/ blocked."""
    import os
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_FRAME], cwd=REPO, capture_output=True,
        text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rendered without jax" in proc.stdout


def test_package_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(_BLOCKED), re.M)
    sources = sorted((REPO / "androidrenderer_tpu_torch").rglob("*.py"))
    names = {p.relative_to(REPO / "androidrenderer_tpu_torch").as_posix() for p in sources}
    assert {
        "ops/culling.py", "ops/texture.py", "ops/raster/masked.py",
        "ops/raster/raster_binned.py", "ops/raster/raster_fused.py",
        "ops/raster/raster_pallas.py", "render/frame.py", "render/temporal.py",
        "ops/gather.py", "ops/cuda_build.py", "ops/raster/binning.py", "ops/raster/raster_xla.py",
        "ops/raster/interpolate.py", "tools/microbench_pallas_gather.py", "tools/bench_raster.py",
        "tools/experiments/raster_touch.py", "tools/experiments/raster_lanes.py",
        "tools/experiments/raster_subfold.py", "tools/kernel_timing.py", "tools/raster_cuts.py",
        "ops/sh.py", "ops/lpv.py", "ops/upsample.py", "ops/taa.py", "ops/vrsaa.py",
        "ops/interpolation.py", "ops/visualize.py", "app/cvars.py", "app/application.py",
        "app/headless.py", "utils/image.py", "utils/bitstream.py", "scene/uastc.py",
        "scene/basis_lz.py", "scene/ktx2.py", "scene/gltf.py", "scene/dynamic.py",
        "parallel/__init__.py", "parallel/collectives.py", "parallel/mesh.py",
        "parallel/dryrun.py", "tools/make_ktx2.py", "tools/optimize_gltf.py",
    } <= names
    for path in [*sources, REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_entry_points_default_to_the_card(monkeypatch):
    """The scene build and the temporal state run on the card unless the caller
    asks for the CPU: without a card they raise, and never return CPU tensors."""
    import inspect

    from androidrenderer_tpu_torch.config import raster_only_config
    from androidrenderer_tpu_torch.render import initial_temporal_state, temporal_state_for
    from androidrenderer_tpu_torch.scene.scene import RenderScene

    for fn in (RenderScene.build, initial_temporal_state, temporal_state_for):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        torch_procedural.cornell_scene().build()
    with pytest.raises(RuntimeError, match="is_available"):
        initial_temporal_state()
    with pytest.raises(RuntimeError, match="is_available"):
        temporal_state_for(raster_only_config(128, 128))
    assert temporal_state_for(raster_only_config(128, 128), device="cpu").csm_packed.is_cpu
