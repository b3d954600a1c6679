"""Render configuration: the structural frame switches and the runtime scalars.

``RenderConfig`` carries the same fields, defaults and enums as the JAX package's
``androidrenderer_tpu.config.RenderConfig`` so one config object reads the same in
both renderers; the TPU-only tunables (``raster_backend``, ``pallas_interpret``,
slab/unroll counts, tile sizes, ``gbuffer_barrier``) are kept for that reason
and ignored here; the profiling switches (``debug_*``) act as in the JAX frame.
``RenderParams`` holds the continuous parameters as plain Python floats: PyTorch
runs eagerly, so there is no traced/static split to respect.

The port renders the frame bench.py times (``parity_frame_config``: LPV GI,
half-rate SSAO, TAAU), the bench's raster-only frame (``raster_only_config``)
and the headless CLI's default frame at the bench's size
(``default_frame_config``), with the exact alpha peel when ``alpha_bitmap`` is
off, and every other switch of the CLI on it: the ray-traced ones (RT shadows
and AO, RT and probe GI) and VRSAA (``aa_mode=AAMode.VRSAA``, rendered at twice
the output resolution, without translucency, as the JAX frame requires).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import NamedTuple, Tuple


class GIMode(enum.Enum):
    """r.GI.Mode equivalent (scene_renderer.cpp:196-211)."""

    OFF = 0
    LPV = 1
    RT = 2
    PROBES = 3


class ShadowMode(enum.Enum):
    """r.Shadow.SunShadowMode equivalent (directional_light.cpp:22-44)."""

    OFF = 0
    CSM = 1
    RT = 2


class AOMode(enum.Enum):
    """r.AO equivalent (ambient_occlusion_phase.cpp:191-397)."""

    OFF = 0
    SSAO = 1
    RT = 2


class RasterBackend(enum.Enum):
    """Kept for field parity with the JAX config; the port has one rasterizer."""

    PALLAS = 0
    XLA = 1


class AAMode(enum.Enum):
    """r.AntiAliasing equivalent."""

    OFF = 0
    TAA = 1
    VRSAA = 2


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Structural frame configuration (field-for-field the JAX package's)."""

    render_width: int = 512
    render_height: int = 512
    output_width: int = 512
    output_height: int = 512

    fov_degrees: float = 75.0
    z_near: float = 0.05

    gi_mode: GIMode = GIMode.OFF
    shadow_mode: ShadowMode = ShadowMode.CSM
    ao_mode: AOMode = AOMode.OFF
    aa_mode: AAMode = AAMode.OFF
    bloom: bool = True
    sky: bool = True
    use_base_textures: bool = True
    use_normal_maps: bool = True
    use_mr_textures: bool = True
    use_emission: bool = True
    occlusion_culling: bool = True
    half_rate_gi: bool = True
    hiz_levels: int = 6
    alpha_masking: bool = True
    alpha_peel_layers: int = 3
    # In-kernel alpha test from the baked 16x16 barycentric bitmaps
    # (SceneArrays.tri_alpha_grid), evaluated on a per-triangle lattice; False
    # takes the exact per-pixel peel (ops/raster/masked.py).
    alpha_bitmap: bool = True
    translucency: bool = True
    translucent_layers: int = 2
    raster_backend: RasterBackend = RasterBackend.PALLAS
    pallas_interpret: bool = False
    raster_num_slabs: int = 4
    raster_pa_unroll: int = 1
    raster_bitmask: bool = True

    num_shadow_cascades: int = 4
    shadow_cascade_resolution: int = 1024
    # Cascades >= this index rasterize the vertex-clustered proxy mesh.
    shadow_proxy_from_cascade: int = 2
    shadow_cascade_split_lambda: float = 0.95
    shadow_max_distance: float = 128.0
    # Far cascades re-rastered per frame besides cascade 0 (0 = all cascades
    # every frame); see ops/shadow.py::render_shadow_cascades_staggered.
    shadow_update_budget: int = 0
    shadow_win_h: int = 32

    lpv_num_cascades: int = 4
    lpv_resolution: int = 32
    lpv_cell_size: float = 0.25
    lpv_rsm_resolution: int = 128
    rsm_proxy: bool = True
    lpv_num_propagation_steps: int = 32
    lpv_behind_camera_percent: float = 0.1
    lpv_update_budget: int = 0

    probe_cascades: int = 4
    probe_grid: Tuple[int, int, int] = (32, 8, 32)
    probe_spacing: float = 0.5
    probe_spacing_ladder: Tuple[float, ...] = (1.0, 4.0, 32.0, 500.0)
    probe_budget: int = 256
    probe_rays: int = 400

    taa_pack8: bool = False

    bloom_num_mips: int = 6

    rtao_num_samples: int = 4
    rtao_max_distance: float = 8.0
    rtgi_num_bounces: int = 1

    vrsaa_budget: float = 0.25

    # Profiling-only switches, honoured as in the JAX frame: each replaces one
    # stage with shape-identical synthetic data (render/frame.py's docstring),
    # so whole-frame deltas isolate that stage's in-frame cost. Never set in
    # production: the image is not the scene's.
    debug_stub_raster: bool = False
    debug_stub_resolve: bool = False
    debug_stub_shadow_sample: bool = False
    debug_resolve_gather_only: bool = False
    debug_stub_rsm: bool = False
    debug_stub_lpv_apply: bool = False
    # Kept for field parity, without effect: in the JAX frame it only stops XLA
    # fusing the gbuffer's producers into its consumers, and eager PyTorch
    # materialises the gbuffer anyway.
    gbuffer_barrier: bool = False

    tile_height: int = 32
    tile_width: int = 128
    max_tris_per_tile: int = 2048

    max_primitives: int = 65536
    max_materials: int = 65536

    def __post_init__(self) -> None:
        if self.render_height % self.tile_height != 0:
            raise ValueError(
                f"render_height {self.render_height} must be a multiple of tile_height "
                f"{self.tile_height}"
            )
        if self.render_width % self.tile_width != 0:
            raise ValueError(
                f"render_width {self.render_width} must be a multiple of tile_width "
                f"{self.tile_width}"
            )

    @property
    def render_resolution(self) -> Tuple[int, int]:
        return (self.render_height, self.render_width)

    @property
    def output_resolution(self) -> Tuple[int, int]:
        return (self.output_height, self.output_width)

    def replace(self, **kwargs) -> "RenderConfig":
        return dataclasses.replace(self, **kwargs)


def parity_frame_config(
    width: int = 1920, height: int = 1088, render_width: int = 1280, render_height: int = 736,
    **overrides,
) -> RenderConfig:
    """The frame bench.py times (bench.py:83-129), field for field: rendered at
    1280x736 and temporally upscaled to 1920x1088 (FSR3 Quality's ratio), with
    LPV GI (staggered, ``lpv_update_budget=1``), half-rate SSAO and TAA, the
    staggered CSM (``shadow_update_budget=1``) and alpha bitmaps. The defaults
    of ``RenderConfig`` turn on occlusion culling and translucency; this sets
    them off exactly as bench.py does."""
    cfg = RenderConfig(
        render_width=render_width, render_height=render_height,
        output_width=width, output_height=height,
        tile_height=32, tile_width=128,
        max_tris_per_tile=4096,
        alpha_masking=True,
        translucency=False,
        use_normal_maps=True, use_mr_textures=True, use_emission=False,
        gi_mode=GIMode.LPV, ao_mode=AOMode.SSAO, aa_mode=AAMode.TAA,
        occlusion_culling=False,
        lpv_update_budget=1,
        shadow_update_budget=1,
    )
    return cfg.replace(**overrides)


def raster_only_config(width: int = 1920, height: int = 1088, **overrides) -> RenderConfig:
    """The bench's raster-only frame (bench.py:192-195): the parity config with
    GI, AO and AA off, rendered at native resolution."""
    return parity_frame_config(
        width, height, width, height, gi_mode=GIMode.OFF, ao_mode=AOMode.OFF, aa_mode=AAMode.OFF,
    ).replace(**overrides)


def default_frame_config(width: int = 1920, height: int = 1088, **overrides) -> RenderConfig:
    """The headless CLI's default frame (app/headless.py:115-127) at the bench's
    size: ``raster_only_config`` with the ``RenderConfig`` defaults the CLI keeps
    on, two-phase HiZ occlusion culling (``hiz_levels=6``) and translucency
    (``translucent_layers=2``), and the bench's ``shadow_update_budget=1``.
    ``alpha_bitmap=False`` as an override gives the exact alpha-peel frame."""
    return raster_only_config(
        width, height, occlusion_culling=True, translucency=True
    ).replace(**overrides)


class RenderParams(NamedTuple):
    """Continuous parameters (the "float cvar" half), reference cvar defaults."""

    sun_exposure: float
    rtgi_exposure: float
    lpv_exposure: float
    bloom_strength: float
    shadow_bias: float
    rtao_max_distance: float
    ssao_radius: float
    ssao_intensity: float
    ssao_bias: float
    atrous_sigma_z: float
    atrous_sigma_n: float
    probe_hysteresis: float

    @staticmethod
    def default() -> "RenderParams":
        return RenderParams(
            sun_exposure=0.00031415927,
            rtgi_exposure=0.0031415927,
            lpv_exposure=math.pi * 10.0,
            bloom_strength=0.014159,
            shadow_bias=0.0005,
            rtao_max_distance=8.0,
            ssao_radius=0.5,
            ssao_intensity=1.0,
            ssao_bias=0.02,
            atrous_sigma_z=0.02,
            atrous_sigma_n=16.0,
            probe_hysteresis=0.9,
        )
