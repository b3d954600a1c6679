"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without one.
The file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_kernels.py -m cuda

(``--noconftest``: tests/conftest.py configures JAX, which that machine lacks.)
The rasterizer is held bit-equal to ``rasterize_reference`` in every variant.
"""

import numpy as np
import pytest
import torch

from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.ops.raster import (
    rasterize,
    rasterize_reference,
    transform_to_clip,
    triangle_setup,
)
from androidrenderer_tpu_torch.scene.procedural import alpha_test_scene

W, H = 256, 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run the command in this module's docstring on one)")
    return torch.device("cuda")


def _random_setup(seed, n_tris, device, double_sided=True, ortho=False):
    """Seeded random triangles in front of a camera looking down -z."""
    rng = np.random.default_rng(seed)
    centers = np.stack([
        rng.uniform(-3, 3, n_tris), rng.uniform(-3, 3, n_tris), -rng.uniform(2, 12, n_tris),
    ], axis=1)
    verts = (centers[:, None, :] + rng.normal(0, 0.8, (n_tris, 3, 3))).reshape(-1, 3)
    tris = np.arange(n_tris * 3, dtype=np.int32).reshape(n_tris, 3)
    if ortho:
        m = np.array([[0.25, 0, 0, 0], [0, 0.25, 0, 0], [0, 0, 1 / 16.0, 1.0], [0, 0, 0, 1]],
                     np.float32)
    else:
        cam = Camera(fov_degrees=75.0, aspect=W / H, render_resolution=(W, H))
        cam.yaw = np.pi
        m = cam.view_data().view_proj
    clip = transform_to_clip(
        torch.from_numpy(verts.astype(np.float32)).to(device), torch.from_numpy(m).to(device)
    )
    dbl = torch.full((n_tris,), double_sided, dtype=torch.bool, device=device)
    return triangle_setup(clip, torch.from_numpy(tris).to(device), W, H, double_sided=dbl)


def _assert_bit_equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("double_sided", [True, False])
def test_raster_kernel_depth_and_vis(cuda_device, double_sided):
    setup = _random_setup(0, 400, cuda_device, double_sided)
    launches = rasterize.launches
    got = rasterize(setup, H, W)
    assert rasterize.launches == launches + 1
    assert (got[1] >= 0).any()
    _assert_bit_equal(got, rasterize_reference(setup, H, W))


@pytest.mark.cuda
def test_raster_kernel_depth_only_affine(cuda_device):
    setup = _random_setup(3, 400, cuda_device, ortho=True)
    kw = dict(depth_only=True, affine_z=True)
    _assert_bit_equal(rasterize(setup, H, W, **kw), rasterize_reference(setup, H, W, **kw))


@pytest.mark.cuda
def test_raster_kernel_z_limit_and_sparse(cuda_device):
    setup = _random_setup(4, 400, cuda_device)
    first, _ = rasterize_reference(setup, H, W)
    noise = torch.from_numpy(np.random.default_rng(4).uniform(0.5, 1.0, (H, W))).to(first)
    zlim = torch.where(first > 0, first * noise, torch.full_like(first, float("inf")))
    _assert_bit_equal(
        rasterize(setup, H, W, z_limit=zlim), rasterize_reference(setup, H, W, z_limit=zlim)
    )
    keep = torch.zeros_like(setup.valid)
    keep[[37, 63, 64, 100, 159]] = True
    sparse = setup._replace(valid=setup.valid & keep)
    _assert_bit_equal(rasterize(sparse, H, W), rasterize_reference(sparse, H, W))


@pytest.mark.cuda
def test_raster_kernel_alpha_grid(cuda_device):
    scene, _ = alpha_test_scene().build(device=cuda_device)
    w, h = 128, 96
    cam = Camera(fov_degrees=75.0, aspect=w / h, render_resolution=(w, h))
    cam.set_position([0.0, 1.0, -3.0])
    clip = transform_to_clip(scene.positions, torch.from_numpy(cam.view_data().view_proj).to(cuda_device))
    setup = triangle_setup(
        clip, scene.tri_indices, w, h,
        double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid,
    )
    grid = scene.tri_alpha_grid
    got = rasterize(setup, h, w, alpha_grid=grid)
    assert 0.02 < (got[1] >= 0).float().mean().item() < 0.98
    _assert_bit_equal(got, rasterize_reference(setup, h, w, alpha_grid=grid))


@pytest.mark.cuda
def test_raster_wrapper_rejects_bad_inputs(cuda_device):
    setup = _random_setup(1, 64, cuda_device)
    with pytest.raises(TypeError):
        rasterize(setup, H, W, z_limit=torch.zeros((H, W), dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        rasterize(setup, H, W, alpha_grid=torch.zeros((3, 8), dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        rasterize(setup, H, W, z_limit=torch.zeros((H, W), device="cpu"))
