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
             "utils.bitstream", "scene.uastc", "scene.basis_lz", "scene.ktx2", "scene.gltf"):
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
        "scene/basis_lz.py", "scene/ktx2.py", "scene/gltf.py",
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
