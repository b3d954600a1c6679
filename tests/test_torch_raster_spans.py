"""The Hopper rasterizer's work split and row spans, mirrored in plain PyTorch.

csrc/raster.cu walks each live record in work units (its bbox, or 32x128
tiles of it) and evaluates only the pixels of each row's margin-widened span
(front, and back for double-sided records). ``rasterize_spans`` (ops/raster/
raster.py) mirrors that walk with the kernel's float32 arithmetic. A span that
misses a pixel the rounded edge test accepts would change depth or visibility,
so the mirror is held bit for bit to ``rasterize_reference`` (every bbox
pixel): on the cornell, courtyard and alpha-fence fixtures at <= 128^2, and on
hypothesis-driven adversarial records — slivers, near-zero A, huge coordinates,
camera-plane crossers with sid = +1 and -1, one-pixel triangles, many triangles
on one pixel. The card holds the kernel to the same cases
(tests/test_torch_kernels.py). No JAX here.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.ops import shadow as shadow_ops
from androidrenderer_tpu_torch.ops.raster import (
    TriangleSetup,
    pack_fused_records,
    rasterize_reference,
    transform_to_clip,
    triangle_setup,
    triangle_setup_corners,
)
from androidrenderer_tpu_torch.ops.raster.raster import (
    TILE_COLS,
    TILE_ROWS,
    rasterize_spans,
    record_bboxes,
    span_work,
    work_units,
)
from androidrenderer_tpu_torch.scene.procedural import (
    alpha_test_scene,
    cornell_scene,
    courtyard_scene,
)

torch.set_num_threads(1)

# The adversarial target: wider than two tile columns and taller than two tile
# rows, so large records split into tiles both ways.
AW, AH = 300, 70
KINDS = ("sliver", "near_zero_a", "huge", "crosser", "one_pixel", "one_pixel_stack", "planes")


def _from_pixels(sx, sy, zn, w, double_sided, width, height, device):
    """The real triangle setup of (n, 3) corners at pixel (sx, sy), depth zn and
    homogeneous w."""
    x = (2.0 * (sx + 0.5) / width - 1.0) * w
    y = (1.0 - 2.0 * (sy + 0.5) / height) * w
    clip = np.stack([x, y, zn * w, w], axis=-1).reshape(-1, 4).astype(np.float32)
    n = sx.shape[0]
    tris = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    dbl = torch.full((n,), double_sided, dtype=torch.bool, device=device)
    return triangle_setup(torch.from_numpy(clip).to(device), torch.from_numpy(tris).to(device),
                          width, height, double_sided=dbl)


def _planes(rng, n, double_sided, width, height, device, a_values=None, scale=None):
    """Records straight from edge coefficients: each triangle's three half-planes
    all pass through a random pixel of its random bbox (so it covers something),
    with constant depth z = r / q."""
    px = rng.uniform(0, width - 1, n)
    py = rng.uniform(0, height - 1, n)
    a = rng.normal(0, 1, (n, 3)) * 10.0 ** rng.uniform(-3, 3, (n, 3))
    if a_values is not None:
        a = np.where(rng.random((n, 3)) < 0.6, rng.choice(a_values, (n, 3)), a)
    b = rng.normal(0, 1, (n, 3)) * 10.0 ** rng.uniform(-3, 3, (n, 3))
    c = -(a * px[:, None] + b * py[:, None]) - rng.uniform(0, 2, (n, 3)) * np.abs(b)
    edge = np.stack([a, b, c], axis=-1)
    if scale is not None:
        edge = edge * scale(rng, n)[:, :, None]
    x0 = np.floor(rng.uniform(-20, px))
    y0 = np.floor(rng.uniform(-20, py))
    x1 = np.ceil(rng.uniform(px, width + 20))
    y1 = np.ceil(rng.uniform(py, height + 20))
    bbox = np.stack([np.clip(x0, 0, width - 1), np.clip(y0, 0, height - 1),
                     np.clip(x1, 0, width - 1), np.clip(y1, 0, height - 1)], axis=-1)
    z = rng.uniform(0.01, 1.0, n)
    q = np.zeros((n, 3))
    q[:, 2] = 1.0
    r = np.zeros((n, 3))
    r[:, 2] = z

    def t(v, dtype=torch.float32):
        return torch.from_numpy(np.asarray(v)).to(device=device, dtype=dtype)

    return TriangleSetup(
        edge=t(edge), q=t(q), r=t(r), bbox=t(bbox),
        valid=t(rng.random(n) < 0.95, torch.bool),
        double_sided=t(np.full(n, double_sided), torch.bool),
    )


def adversarial_setup(kind: str, seed: int, double_sided: bool, device="cpu",
                      width: int = AW, height: int = AH) -> TriangleSetup:
    """A seeded set of records of one adversarial kind (``KINDS``)."""
    rng = np.random.default_rng(seed)
    n = 48
    if kind == "planes":
        return _planes(rng, n, double_sided, width, height, device)
    if kind == "near_zero_a":
        tiny = np.array([0.0, 1e-13, -1e-13, 9.9999e-13, -9.9999e-13, 1e-12, -1e-12,
                         1.0001e-12, -1.0001e-12, 1e-10, -1e-10, 1e-6, -1e-6])
        return _planes(rng, n, double_sided, width, height, device, a_values=tiny)
    if kind == "huge":
        return _planes(rng, n, double_sided, width, height, device,
                       scale=lambda g, m: 10.0 ** g.uniform(-30, 30, (m, 3)))
    w = np.ones((n, 3))
    zn = rng.uniform(0.02, 1.0, (n, 3))
    sx = rng.uniform(-0.2 * width, 1.2 * width, (n, 1)) + np.zeros((n, 3))
    sy = rng.uniform(-0.2 * height, 1.2 * height, (n, 1)) + np.zeros((n, 3))
    if kind == "sliver":
        # Corners 0 and 1 far apart, corner 2 on their line but for a tiny offset.
        length = rng.uniform(20, 3 * width, (n, 1))
        ang = rng.uniform(0, 2 * np.pi, (n, 1))
        thick = 10.0 ** rng.uniform(-4, 0.5, (n, 1))
        along = np.array([[0.0, 1.0, rng.uniform(0.2, 0.8)]])
        off = np.array([[0.0, 0.0, 1.0]])
        sx = sx + np.cos(ang) * length * along - np.sin(ang) * thick * off
        sy = sy + np.sin(ang) * length * along + np.cos(ang) * thick * off
        w = rng.uniform(0.2, 5.0, (n, 3))
    elif kind == "crosser":
        # One or two corners behind the camera: full-screen boxes, and for
        # double-sided records a back region.
        sx = rng.uniform(-0.5 * width, 1.5 * width, (n, 3))
        sy = rng.uniform(-0.5 * height, 1.5 * height, (n, 3))
        w = rng.uniform(0.05, 4.0, (n, 3)) * np.where(rng.random((n, 3)) < 0.4, -1.0, 1.0)
        w[:, 0] = np.abs(w[:, 0])
    elif kind in ("one_pixel", "one_pixel_stack"):
        if kind == "one_pixel_stack":
            sx = np.full((n, 3), rng.integers(0, width) + 0.0)
            sy = np.full((n, 3), rng.integers(0, height) + 0.0)
        sx = np.floor(sx) + rng.uniform(-0.8, 0.8, (n, 3))
        sy = np.floor(sy) + rng.uniform(-0.8, 0.8, (n, 3))
        # Flat triangles at a few depths: equal depths tie, the higher id wins.
        zn = np.repeat(rng.choice([0.25, 0.5, rng.uniform(0.1, 1.0)], (n, 1)), 3, axis=1)
        w = np.repeat(rng.uniform(0.3, 3.0, (n, 1)), 3, axis=1)
    else:
        raise ValueError(kind)
    return _from_pixels(sx, sy, zn, w, double_sided, width, height, device)


def assert_spans_exact(setup, height, width, **kw):
    got = rasterize_spans(setup, height, width, **kw)
    want = rasterize_reference(setup, height, width, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    return want


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(kind=st.sampled_from(KINDS), seed=st.integers(0, 2**32 - 1), double_sided=st.booleans(),
       affine_z=st.booleans())
def test_spans_exact_on_adversarial_records(kind, seed, double_sided, affine_z):
    setup = adversarial_setup(kind, seed, double_sided)
    assert_spans_exact(setup, AH, AW, affine_z=affine_z)


@pytest.mark.parametrize("kind", KINDS)
def test_adversarial_kinds_cover_pixels(kind):
    """Each kind draws something, so the exactness above is not vacuous."""
    depth, vis = assert_spans_exact(adversarial_setup(kind, 1, True), AH, AW)
    assert (vis >= 0).any()


def _view(width, height, pos, pitch=0.0, yaw=np.pi):
    cam = Camera(fov_degrees=75.0, aspect=width / height, render_resolution=(width, height))
    cam.set_position(pos)
    cam.pitch, cam.yaw = pitch, yaw
    return cam.view_data()


def _scene_setup(scene, vd, width, height):
    return triangle_setup(
        transform_to_clip(scene.positions, torch.from_numpy(vd.view_proj)), scene.tri_indices,
        width, height, double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid,
    )


@pytest.fixture(scope="module")
def courtyard():
    scene, _ = courtyard_scene().build(device="cpu")
    return scene


def test_spans_exact_on_cornell():
    scene, _ = cornell_scene().build(device="cpu")
    w = h = 128
    setup = _scene_setup(scene, _view(w, h, [0.0, 1.0, 2.5]), w, h)
    _, vis = assert_spans_exact(setup, h, w)
    assert (vis >= 0).float().mean() > 0.3


def test_spans_exact_on_courtyard_main_view(courtyard):
    w, h = 128, 96
    setup = _scene_setup(courtyard, _view(w, h, [0.0, 1.7, 6.0], pitch=-0.05), w, h)
    depth, vis = assert_spans_exact(setup, h, w)
    assert (vis >= 0).float().mean() > 0.5
    # A z_limit layer under the first (the peels' gate).
    zl = torch.where(vis >= 0, depth, torch.full_like(depth, float("inf")))
    assert_spans_exact(setup, h, w, z_limit=zl)


def test_spans_exact_on_courtyard_cascade(courtyard):
    """A 128^2 cascade (depth_only + affine_z), derived as the frame derives it."""
    res = 128
    vd = _view(res, res, [0.0, 1.7, 6.0])
    cascades = shadow_ops.fit_cascades(
        torch.from_numpy(vd.inverse_view), float(vd.projection[0, 0]),
        float(vd.projection[1, 1]), courtyard.sun_direction, 4, res, 0.05, 128.0, 0.95,
    )
    setup_c = triangle_setup_corners(
        courtyard.tri_corner_pos, cascades.canonical, res, res,
        double_sided=courtyard.tri_double_sided, tri_valid=courtyard.tri_valid,
    )
    for k in (0, 1):
        ck = shadow_ops.derive_ortho_setup(setup_c, cascades.canonical, cascades.matrices[k], res)
        depth = assert_spans_exact(ck, res, res, depth_only=True, affine_z=True)[0]
        assert (depth > 0).any()


def test_spans_exact_on_alpha_fence():
    scene, _ = alpha_test_scene().build(device="cpu")
    w, h = 128, 96
    setup = _scene_setup(scene, _view(w, h, [0.0, 1.0, -3.0], yaw=0.0), w, h)
    _, vis = assert_spans_exact(setup, h, w, alpha_grid=scene.tri_alpha_grid)
    assert 0.02 < (vis >= 0).float().mean() < 0.98


def test_work_units_tile_each_bbox():
    """The work split covers each live record's clipped bbox once: small records
    are one unit, large ones tiles of at most TILE_ROWS x TILE_COLS."""
    setup = adversarial_setup("crosser", 3, True)
    rec = pack_fused_records(setup)
    (t, x0, y0, x1, y1), counts = work_units(rec, AH, AW)
    bx0, by0, bx1, by1, live = record_bboxes(rec, AH, AW)
    assert ((x1 - x0 + 1 <= TILE_COLS) & (y1 - y0 + 1 <= TILE_ROWS)).all()
    area = (x1 - x0 + 1) * (y1 - y0 + 1)
    per_record = torch.zeros(rec.shape[0], dtype=torch.int64).index_add_(0, t, area)
    bbox_area = torch.where(live, (bx1 - bx0 + 1) * (by1 - by0 + 1), 0)
    assert torch.equal(per_record, bbox_area)
    assert counts["small"] + counts["large"] == int(live.sum())
    assert counts["small"] + counts["large_units"] == t.numel()
    assert counts["large"] > 0 and counts["bbox_pixels"] == int(bbox_area.sum())
    work = span_work(rec, AH, AW)
    assert 0 < work["evaluated"] < work["bbox_pixels"]


def test_empty_and_dead_record_sets():
    setup = adversarial_setup("planes", 5, True)
    dead = setup._replace(valid=torch.zeros_like(setup.valid))
    empty = TriangleSetup(*(x[:0] for x in setup))
    for s in (dead, empty):
        depth, vis = assert_spans_exact(s, AH, AW)
        assert not depth.any() and (vis == -1).all()
        assert span_work(pack_fused_records(s), AH, AW)["units"] == 0
