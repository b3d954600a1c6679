"""The port's renders of tools/make_goldens.py's six cases against the
committed goldens (tests/goldens/*.png, the JAX package's renders), on the CPU
at 128^2: SSIM >= 0.98, the gate of tests/test_goldens.py, with the 38 pixels
the goldens left uncovered on the cornell view taken from the golden
(androidrenderer_tpu_torch/tools/golden_cases.py says why). The cases run
through the port alone and compile no JAX.
"""

import numpy as np
import pytest
import torch

from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.config import RenderConfig
from androidrenderer_tpu_torch.ops.raster import rasterize
from androidrenderer_tpu_torch.render.frame import main_view_setup
from androidrenderer_tpu_torch.scene.procedural import cornell_scene
from androidrenderer_tpu_torch.tools import golden_cases

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(golden_cases.CASES))
def test_golden_ssim(name):
    """Measured (plain SSIM / with the goldens' 38 holes from the golden):
    cornell_direct 0.99143 / 0.99396, cornell_lpv 0.97971 / 0.99185,
    courtyard_csm 0.99913 (no hole), cornell_rtgi 0.98304 / 0.99355,
    cornell_probes 0.99010 / 0.99411, courtyard_vrsaa 0.99746 (no hole)."""
    r = golden_cases.compare(name, "cpu")
    assert r["ssim_holes_from_golden"] >= golden_cases.MIN_SSIM, r
    assert r["holes"] == (38 if name in golden_cases.CORNELL_CASES else 0), r


def test_cornell_view_is_watertight():
    """The golden cases' cornell view from inside the box: the port's raster
    covers every pixel. 92 pixel centres lie exactly on an edge of their
    triangle, whose coverage the last bit of the arithmetic decides, most of
    them on the box's diagonals; the goldens left 38 of them uncovered."""
    n = golden_cases.W
    cfg = RenderConfig(render_width=n, render_height=n, output_width=n, output_height=n,
                       max_tris_per_tile=4096, occlusion_culling=False)
    scene, _ = cornell_scene().build(device="cpu", with_bvh=False)
    cam = Camera(fov_degrees=75.0, aspect=1.0, render_resolution=(n, n))
    cam.set_position([0, 0, 2.2])
    cam.pitch, cam.yaw = 0.0, np.pi
    view = cam.view_data()
    _, setup_opaque, alpha_grid = main_view_setup(scene, view, cfg)
    _, vis = rasterize(setup_opaque, n, n, alpha_grid=alpha_grid)
    assert bool((vis >= 0).all())
    ties = golden_cases.edge_ties(scene, view, cfg, vis).numpy()
    assert ties.sum() == 92
    i = np.arange(n)
    diagonals = ties[i, i].sum() + ties[i, n - 1 - i].sum()
    assert diagonals >= 0.5 * ties.sum()
    assert golden_cases.golden_holes(ties).sum() == 38


def test_load_png_reads_what_pillow_reads(tmp_path):
    """The reader the card's host uses (it has no Pillow): every golden, and an
    image Pillow encodes with its per-row filter choice (Sub and Paeth rows)."""
    from PIL import Image

    for path in sorted(golden_cases.GOLDEN_DIR.glob("*.png")):
        want = np.asarray(Image.open(path).convert("RGB"))
        assert np.array_equal(golden_cases.load_png(path), want), path.name
    rng = np.random.default_rng(0)
    img = (rng.random((20, 17, 3)) * 60).cumsum(axis=1).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "f.png", optimize=True)
    assert np.array_equal(golden_cases.load_png(tmp_path / "f.png"), img)

