"""The port's raster-only frame against the JAX package's, end to end.

Both renderers read the same baked arrays (``scene_arrays_from_numpy`` of the
JAX bake) and render the raster-only config at 128^2 with 4 cascades of 128^2
and ``shadow_update_budget=1`` over 3 chained frames. The JAX frame runs its
TPU branch through Pallas interpret mode (``pallas_interpret=True``), as its
own tests do on the CPU; its renderer is built once per module because one
compile takes about half a minute. The port runs on the CPU, where its
rasterizer is the plain PyTorch version.

Held: depth and visibility under the raster contract (widened for the two
programs' setup rounding); the u8 image within one step on >= 99.5% of pixels
with SSIM >= 0.99 once both frames sample the same cascade cache, and end to
end under the measured bound the cascade setup's rounding sets; the staggered
cascades and ``sample_csm``, each fed the JAX frame's own cascade data.
"""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from androidrenderer_tpu import config as jax_config
from androidrenderer_tpu.ops import shadow as jax_shadow
from androidrenderer_tpu.render import make_renderer as jax_make_renderer
from androidrenderer_tpu.render import temporal_state_for as jax_temporal_state_for
from androidrenderer_tpu.scene import procedural as jax_procedural
from androidrenderer_tpu.utils.image import ssim
from androidrenderer_tpu_torch.camera import Camera
from androidrenderer_tpu_torch.config import RenderParams, raster_only_config
from androidrenderer_tpu_torch.ops import shadow
from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

from test_torch_scene import jax_leaves

# pytest's workers share the CPU; torch's own thread pool on top of theirs
# oversubscribes it (a 0.55 s test here took 27 s beside 4 busy workers).
torch.set_num_threads(1)

N = 128
FRAMES = 3


def port_config():
    return raster_only_config(N, N, shadow_cascade_resolution=N)


def to_jax_config(cfg) -> jax_config.RenderConfig:
    """The same config as the JAX package's RenderConfig, run in interpret mode."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(getattr(jax_config, type(v).__name__), v.name)
        kw[f.name] = v
    return jax_config.RenderConfig(**kw, ).replace(pallas_interpret=True)


def camera_for(scene_name: str):
    cam = Camera(fov_degrees=75.0, aspect=1.0, z_near=0.05, render_resolution=(N, N))
    if scene_name == "cornell_scene":
        # Off the box's symmetry axis: centred, its wall-junction edges pass
        # exactly through pixel centres, where either wall wins by an ULP.
        cam.set_position([0.05, 0.03, 2.2])
        cam.yaw = np.pi + 0.02
    else:
        cam.set_position([0.0, 1.7, 6.0])
        cam.pitch, cam.yaw = -0.05, np.pi
    return cam.view_data()


@pytest.fixture(scope="module")
def jax_renderer():
    return jax_make_renderer(to_jax_config(port_config()))


@pytest.fixture(scope="module", params=["cornell_scene", "courtyard_scene"])
def frames(request, jax_renderer):
    jscene, _ = getattr(jax_procedural, request.param)().build(with_bvh=False)
    scene = scene_arrays_from_numpy(jax_leaves(jscene), "cpu")
    view = camera_for(request.param)
    cfg = port_config()
    jparams = jax_config.RenderParams.default()
    jt = jax_temporal_state_for(to_jax_config(cfg))
    renderer = make_renderer(cfg)
    tt = temporal_state_for(cfg)
    jax_out, port_out, jax_temporals = [], [], []
    for _ in range(FRAMES):
        jo, jt = jax_renderer(jscene, view, jparams, jt)
        to, tt = renderer(scene, view, RenderParams.default(), tt)
        jax_out.append(jo)
        port_out.append(to)
        jax_temporals.append(jt)
    return dict(jscene=jscene, scene=scene, view=view, jax=jax_out, port=port_out,
                jax_temporals=jax_temporals, port_temporal=tt)


def _taps(packed: np.ndarray) -> np.ndarray:
    """Self taps of a packed PCF atlas as depth values."""
    return (packed[..., 0] & 0xFFFF).astype(np.float64) / 65535.0


def test_frame_depth_and_visibility(frames):
    """The raster contract, widened for setups computed by two programs: XLA's
    jit contracts the setup's cross products into FMAs, PyTorch rounds each
    product, and the products cancel (sub-pixel triangles at 128^2), so z
    differs by up to ~1e-4 relative (measured max 2.2e-4 courtyard, 4.3e-6
    cornell). An edge shared by two coplanar triangles can flip which of them
    covers a pixel at equal depth (measured 1 of 16384 courtyard pixels)."""
    for jo, to in zip(frames["jax"], frames["port"]):
        depth_ref, vis_ref = np.asarray(jo.depth), np.asarray(jo.visibility)
        depth, vis = to.depth.numpy(), to.visibility.numpy()
        assert (vis_ref >= 0).mean() > 0.5
        np.testing.assert_allclose(depth, depth_ref, rtol=5e-4, atol=1e-9)
        assert ((vis != vis_ref) & (depth == depth_ref)).mean() <= 0.002


def _image_agreement(ref, img):
    off = np.abs(img.astype(int) - ref.astype(int)).max(axis=-1) > 1
    return off.mean(), ssim(img, ref)


def test_frame_image_with_shared_cascades(frames, monkeypatch):
    """Everything but the cascade rasters: the port frame fed the JAX frame's
    own cascade cache each frame agrees within one step on >= 99.5% of pixels
    with SSIM >= 0.99 (measured: no pixel off, SSIM 0.99999)."""
    from androidrenderer_tpu_torch.render import frame as frame_mod

    jax_caches = iter(frames["jax_temporals"])

    def shared(*args, **kwargs):
        jt = next(jax_caches)
        return (torch.from_numpy(np.array(jt.csm_packed)),
                torch.from_numpy(np.array(jt.csm_matrices)))

    monkeypatch.setattr(frame_mod.shadow_ops, "render_shadow_cascades_staggered", shared)
    cfg = port_config()
    renderer, tt = make_renderer(cfg), temporal_state_for(cfg)
    for jo in frames["jax"]:
        to, tt = renderer(frames["scene"], frames["view"], RenderParams.default(), tt)
        img, ref = to.image.numpy(), np.asarray(jo.image)
        assert img.shape == ref.shape == (N, N, 3) and img.dtype == np.uint8
        off, sim = _image_agreement(ref, img)
        assert off <= 0.005, f"{off:.4%} of pixels off by > 1 step"
        assert sim >= 0.99
        assert np.isfinite(to.hdr.numpy()).all()


def test_frame_image(frames):
    """End to end, the cascade rasters included. The JAX reference derives each
    cascade's setup from one canonical union-frame setup; at 128^2 that setup's
    cross products cancel by ~1e5 on small triangles, and XLA's jit rounds them
    differently from its own eager mode (measured: canonical q differs by 3e-3
    relative between JAX jit and JAX eager; the port equals JAX eager). Shadow
    edges then move by a texel: measured 1.8% (cornell) and 0.8% (courtyard)
    of pixels off by > 1 step, SSIM 0.979 / 0.994, and none once the caches are
    shared (test above)."""
    for jo, to in zip(frames["jax"], frames["port"]):
        img, ref = to.image.numpy(), np.asarray(jo.image)
        off, sim = _image_agreement(ref, img)
        assert off <= 0.03, f"{off:.4%} of pixels off by > 1 step"
        assert sim >= 0.97


def _cascades(csm, to=torch.from_numpy):
    return shadow.CascadeData(*(to(np.array(x)) for x in csm))


def test_staggered_cascades_match(frames):
    """render_shadow_cascades_staggered over 3 chained frames from one initial
    state, fed the JAX frame's fitted cascades (its last frame's effective
    matrices: every cascade has been rastered by then, and the static camera
    refits the same matrices each frame). The matrices it caches equal the JAX
    frame's; at steady state the cache equals the rebuild-all maps exactly; the
    maps agree with the JAX frame's up to the canonical-setup rounding above
    (measured: coverage differs on <= 0.32% of texels, median depth delta
    <= 1.4e-3 where both cover)."""
    scene = frames["scene"]
    cascades = _cascades(frames["jax"][-1].csm)
    state = temporal_state_for(port_config())
    packed, mats = state.csm_packed, state.csm_matrices
    kw = dict(double_sided=scene.tri_double_sided, proxy=scene.proxy,
              proxy_from_cascade=2, corners=scene.tri_corner_pos)
    for i, jt in enumerate(frames["jax_temporals"]):
        packed, mats = shadow.render_shadow_cascades_staggered(
            scene.positions, scene.tri_indices, scene.tri_valid, cascades, N,
            packed, mats, i, update_budget=1, **kw,
        )
        assert np.array_equal(mats.numpy(), np.asarray(jt.csm_matrices))
        got, want = _taps(packed.numpy()), _taps(np.asarray(jt.csm_packed))
        assert ((got > 0) != (want > 0)).mean() <= 0.005
        both = (got > 0) & (want > 0)
        assert both[0].any()
        assert np.median(np.abs(got - want)[both]) <= 5e-3
    full = shadow.render_shadow_cascades(
        scene.positions, scene.tri_indices, scene.tri_valid, cascades, N, **kw
    )
    assert torch.equal(shadow.pack_pcf_taps(full), packed)


def test_sample_csm_on_jax_cascades(frames):
    """sample_csm fed the JAX frame's own gbuffer, cascades and packed atlas."""
    jo, jt = frames["jax"][-1], frames["jax_temporals"][-1]
    g = jo.gbuffer
    sun = np.asarray(frames["jscene"].sun_direction)
    l = -sun / np.linalg.norm(sun)
    normal = np.array(g.normal)
    ndotl = np.clip((normal * l).sum(-1, keepdims=True), 0, 1).astype(np.float32)
    depth = np.asarray(jo.depth)
    vdist = np.where(depth > 0, 0.05 / np.maximum(depth, 1e-12), 0).astype(np.float32)
    wp = np.array(g.world_position)
    want = jax_shadow.sample_csm(
        jnp.asarray(wp), jnp.asarray(vdist), jnp.asarray(ndotl), jo.csm, None, 0.0005,
        normal=jnp.asarray(normal), packed_taps=jt.csm_packed,
    )
    got = shadow.sample_csm(
        torch.from_numpy(wp), torch.from_numpy(vdist), torch.from_numpy(ndotl),
        _cascades(jo.csm), None, 0.0005, normal=torch.from_numpy(normal),
        packed_taps=torch.from_numpy(np.array(jt.csm_packed)),
    )
    want = np.asarray(want)
    assert 0.0 < want.mean() < 1.0  # some shadow, some light
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
