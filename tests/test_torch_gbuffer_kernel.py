"""The gbuffer resolve kernel (csrc/gbuffer.cu) against its plain PyTorch version.

The tests marked ``cuda`` need an NVIDIA card and skip without one. The file
imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_gbuffer_kernel.py -m cuda

They hold ``resolve_gbuffer`` on CUDA tensors (one kernel launch) bit for bit
equal, in every field, to ``resolve_gbuffer_reference`` run on the same card,
on a small courtyard with every texture slot in use (an emissive texture
added): the full grid, a band (``row_offset``), a strided grid and scattered
(B, 3) samples through ``pixel_coords``, each ``use_*`` flag off in turn, a mip
bias, ``vis`` all -1, the translucent layer's setup, texel rows clamped to
the last row of a pool whose end is not word-aligned, and ids past the last row
of planes. They also check the launch counter, the wrapper's refusals, and that
a prepared call holds the tensors it reads. The two tests without the marker run on
the CPU: the invalid-sample values, which are the kernel's contract, and the
plain path that CPU tensors take.
"""

import numpy as np
import pytest
import torch

from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.config import default_frame_config
from androidrenderer_tpu_torch.ops.gbuffer import (
    GBuffer,
    pack_attribute_planes,
    prepare_resolve,
    resolve_gbuffer,
    resolve_gbuffer_reference,
)
from androidrenderer_tpu_torch.ops.raster import rasterize
from androidrenderer_tpu_torch.render.frame import main_view_setup
from androidrenderer_tpu_torch.scene.procedural import cornell_scene, courtyard_scene, noise_texture

W, H = 256, 128
FLAGS = ("use_base_textures", "use_normal_maps", "use_mr_textures", "use_emission")


def _view(width, height, position, pitch, yaw):
    cam = Camera(fov_degrees=75.0, aspect=width / height, z_near=0.05,
                 render_resolution=(width, height))
    cam.set_position(position)
    cam.pitch, cam.yaw = pitch, yaw
    return cam.view_data()


def _assert_bit_equal(got: GBuffer, want: GBuffer, label=""):
    for name in GBuffer._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and a.dtype == b.dtype, (label, name, a.shape, b.shape)
        if a.dtype == torch.bool:
            same = torch.equal(a, b)
        else:
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        if not same:
            diff = (a.view(torch.int32) != b.view(torch.int32)).reshape(-1)
            pytest.fail(f"{label} {name}: {int(diff.sum())} values differ in their bits")


@pytest.fixture(scope="module")
def courtyard():
    """The courtyard at 256x128 on the card: scene, opaque and translucent
    setups, and the opaque raster."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run the command in this module's docstring on one)")
    rs = courtyard_scene(column_rings=2, detail=2, curtains=True)
    glow = rs.materials.add_texture(noise_texture(32, 9, (250, 200, 90), 60))
    for m in rs.materials.materials[:3]:
        m.emission_texture = glow
        m.emission_factor = np.array([1.5, 0.7, 0.2], np.float32)
    scene, _ = rs.build(device="cuda", with_bvh=False)
    view = _view(W, H, [0.0, 1.7, 6.0], -0.05, np.pi)
    setup, setup_o, grid = main_view_setup(scene, view, default_frame_config(W, H))
    depth, vis = rasterize(setup_o, H, W, alpha_grid=grid)
    assert 0.5 < float((vis >= 0).float().mean()) < 1.0
    setup_t = setup._replace(valid=setup.valid & (scene.tri_alpha_mode == 2))
    return scene, setup, setup_o, setup_t, depth, vis


def _both(scene, setup, vis, depth, **kw):
    n = resolve_gbuffer.launches
    got = resolve_gbuffer(scene, setup, vis, depth, **kw)
    assert resolve_gbuffer.launches == n + 1
    torch.cuda.synchronize()
    want = resolve_gbuffer_reference(scene, setup, vis, depth, **kw)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("off", (None,) + FLAGS)
def test_full_grid(courtyard, off):
    scene, _, setup_o, _, depth, vis = courtyard
    kw = {} if off is None else {off: False}
    _assert_bit_equal(*_both(scene, setup_o, vis, depth, **kw), label=f"{off} off")


@pytest.mark.cuda
def test_mip_bias_and_given_planes(courtyard):
    scene, _, setup_o, _, depth, vis = courtyard
    planes = pack_attribute_planes(scene, setup_o)
    _assert_bit_equal(*_both(scene, setup_o, vis, depth, mip_bias=-0.75, attr_planes=planes))


@pytest.mark.cuda
def test_band(courtyard):
    scene, _, setup_o, _, depth, vis = courtyard
    r0, rows = 40, 48
    band_vis, band_depth = vis[r0:r0 + rows].contiguous(), depth[r0:r0 + rows].contiguous()
    got, want = _both(scene, setup_o, band_vis, band_depth, row_offset=r0)
    _assert_bit_equal(got, want)
    full = resolve_gbuffer(scene, setup_o, vis, depth)
    _assert_bit_equal(got, GBuffer(*(x[r0:r0 + rows] for x in full)))


@pytest.mark.cuda
def test_strided_grid(courtyard):
    """VRSAA's coarse grid: every other pixel, coordinates as broadcast views."""
    scene, setup, _, _, depth, vis = courtyard
    h, w = H // 2, W // 2
    v, d = vis[::2, ::2].contiguous(), depth[::2, ::2].contiguous()
    px = (torch.arange(w, dtype=torch.float32, device="cuda") * 2.0)[None, :].expand(h, w)
    py = (torch.arange(h, dtype=torch.float32, device="cuda") * 2.0)[:, None] + 8
    _assert_bit_equal(*_both(scene, setup, v, d, pixel_coords=(px, py.expand(h, w))))


@pytest.mark.cuda
def test_scattered_samples(courtyard):
    """VRSAA's fine pass: (B, 3) samples at integer coordinates."""
    scene, setup, _, _, depth, vis = courtyard
    g = torch.Generator().manual_seed(3)
    qy = torch.randint(0, H // 2, (777,), generator=g).cuda()
    qx = torch.randint(0, W // 2, (777,), generator=g).cuda()
    pys = torch.stack([qy * 2 + dy for dy in (0, 1, 1)], dim=1)
    pxs = torch.stack([qx * 2 + dx for dx in (1, 0, 1)], dim=1)
    flat = pys * W + pxs
    v, d = vis.reshape(-1)[flat], depth.reshape(-1)[flat]
    assert v.shape == (777, 3)
    _assert_bit_equal(*_both(scene, setup, v, d, pixel_coords=(pxs.float(), pys.float())))


@pytest.mark.cuda
def test_no_samples(courtyard):
    scene, _, setup_o, _, depth, vis = courtyard
    _assert_bit_equal(*_both(scene, setup_o, torch.full_like(vis, -1), depth))


@pytest.mark.cuda
def test_translucent_layer(courtyard):
    scene, _, _, setup_t, _, _ = courtyard
    depth, vis = rasterize(setup_t, H, W)
    share = float((vis >= 0).float().mean())
    assert 0.0 < share < 0.5
    _assert_bit_equal(*_both(scene, setup_t, vis, depth))


@pytest.mark.cuda
def test_rows_past_the_pool_clamp(courtyard):
    """Texture starts past the pool's end clamp to its last row, and a pool of
    R - 1 rows ends mid-word (117 (R - 1) is not a multiple of 4)."""
    scene, _, setup_o, _, depth, vis = courtyard
    pool = scene.textures[:-1].clone()
    assert pool.shape[0] * pool.shape[1] % 4 != 0
    planes = pack_attribute_planes(scene, setup_o).clone()
    far = float((pool.shape[0] // 1024 + 7) * 16 + 3)  # packed start row, log2 size 3
    for k in range(3):  # the packed texture channels of slot 0 and slot 3 in each block
        s = planes[:, 29 * k + 16]
        planes[:, 29 * k + 25] = far * s
        planes[:, 29 * k + 28] = far * s
    sc = scene._replace(textures=pool)
    _assert_bit_equal(*_both(sc, setup_o, vis, depth, attr_planes=planes))


@pytest.mark.cuda
def test_ids_past_the_planes_shade_as_none(courtyard):
    """An id at or past the last row of planes (the plain version raises an
    IndexError) reads nothing outside the table and writes the invalid values."""
    scene, _, setup_o, _, depth, vis = courtyard
    planes = pack_attribute_planes(scene, setup_o)
    bad = vis.clone()
    bad[::5] = planes.shape[0]
    bad[1::7] = torch.iinfo(torch.int32).max
    n = resolve_gbuffer.launches
    got = resolve_gbuffer(scene, setup_o, bad, depth, attr_planes=planes)
    assert resolve_gbuffer.launches == n + 1
    past = bad >= planes.shape[0]
    want = resolve_gbuffer_reference(scene, setup_o, torch.where(past, -1, bad), depth,
                                     attr_planes=planes)
    assert past.any() and (~past & (bad >= 0)).any()
    _assert_bit_equal(got, want)


@pytest.mark.cuda
def test_prepared_call_holds_its_inputs(courtyard):
    """``prepare_resolve``'s launch reads the tensors it was given even after
    the caller has let them go and their blocks were handed out again."""
    scene, setup, _, _, depth, vis = courtyard
    h, w = H // 2, W // 2
    v, d = vis[::2, ::2].contiguous(), depth[::2, ::2].contiguous()
    px = (torch.arange(w, dtype=torch.float32, device="cuda") * 2.0)[None, :].expand(h, w)
    py = (torch.arange(h, dtype=torch.float32, device="cuda") * 2.0)[:, None].expand(h, w)
    planes = pack_attribute_planes(scene, setup)
    call = prepare_resolve(scene, v.clone(), d, planes.clone(), pixel_coords=(px, py))
    torch.cuda.synchronize()
    junk = [torch.full_like(x, 0x7F7F7F7F) for x in (v, v, v, v)]  # the vis copy, px, py
    junk.append(torch.full_like(planes, -3.0e38))
    call.launch()
    want = resolve_gbuffer_reference(scene, setup, v, d, pixel_coords=(px, py))
    _assert_bit_equal(call.out, want)
    del junk


@pytest.mark.cuda
def test_wrapper_refuses(courtyard):
    scene, _, setup_o, _, depth, vis = courtyard
    n = resolve_gbuffer.launches
    with pytest.raises(TypeError):
        resolve_gbuffer(scene, setup_o, vis.long(), depth)
    with pytest.raises(TypeError):
        resolve_gbuffer(scene, setup_o, vis, depth.double())
    with pytest.raises(TypeError):
        resolve_gbuffer(scene, setup_o, vis, depth,
                        attr_planes=pack_attribute_planes(scene, setup_o).double())
    with pytest.raises(ValueError):
        resolve_gbuffer(scene, setup_o, vis.t().contiguous().t(), depth)
    planes = pack_attribute_planes(scene, setup_o)
    with pytest.raises(ValueError):
        resolve_gbuffer(scene, setup_o, vis, depth,
                        attr_planes=torch.cat([planes, planes], 1)[:, :planes.shape[1]])
    with pytest.raises(ValueError):
        resolve_gbuffer(scene, setup_o, vis, depth.cpu())
    assert resolve_gbuffer.launches == n
    # The profiling switch keeps the plain gather on the card.
    resolve_gbuffer(scene, setup_o, vis, depth, debug_gather_only=True)
    assert resolve_gbuffer.launches == n


def _cornell(device="cpu"):
    scene, _ = cornell_scene().build(device=device, with_bvh=False)
    view = _view(128, 64, [0.0, 1.0, 2.5], 0.0, np.pi)
    setup, setup_o, grid = main_view_setup(scene, view, default_frame_config(128, 64))
    depth, vis = rasterize(setup_o, 64, 128, alpha_grid=grid)
    return scene, setup_o, depth, vis


def test_invalid_samples_cpu():
    """A sample with vis < 0 resolves to base, normal, emission and world
    position 0, roughness 1, metalness 0 and valid false: the values the
    kernel writes without gathering."""
    scene, setup, depth, vis = _cornell()
    vis = vis.clone()
    vis[::3] = -1
    gb = resolve_gbuffer(scene, setup, vis, depth)
    none = vis < 0
    assert none.any() and (~none).any()
    for name in ("base_color", "normal", "emission", "world_position"):
        assert torch.equal(getattr(gb, name)[none], torch.zeros_like(getattr(gb, name)[none]))
    assert torch.equal(gb.roughness[none], torch.ones_like(gb.roughness[none]))
    assert torch.equal(gb.metalness[none], torch.zeros_like(gb.metalness[none]))
    assert not gb.valid[none].any() and gb.valid[~none].all()
    assert gb.depth is depth


def test_cpu_tensors_take_the_plain_path():
    scene, setup, depth, vis = _cornell()
    n = resolve_gbuffer.launches
    got = resolve_gbuffer(scene, setup, vis, depth, use_emission=False)
    want = resolve_gbuffer_reference(scene, setup, vis, depth, use_emission=False)
    assert resolve_gbuffer.launches == n
    _assert_bit_equal(got, want)
