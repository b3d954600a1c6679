"""Application — the tick loop + flycam + scene owner (core/application.cpp:17-175).
The port of the JAX package's app/application.py.

The platform layers (GLFW window, Android GameActivity) have no counterpart
here; the surface is headless: ``tick()`` renders one frame and returns the u8
image, and the CLI (headless.py) drives frames to PNG files. Input callbacks map
to direct flycam methods (move/rotate), matching InputManager's dispatch targets
(input/input_manager.hpp:19-60, application.cpp:143-163: move speed 2 m/s).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from androidrenderer_tpu_torch.camera import Camera, taa_jitter
from androidrenderer_tpu_torch.config import AAMode, RenderConfig, RenderParams
from androidrenderer_tpu_torch.render import make_renderer, temporal_state_for
from androidrenderer_tpu_torch.scene.material_storage import FLAT_NORMAL_TEXTURE, WHITE_TEXTURE
from androidrenderer_tpu_torch.scene.scene import RenderScene

MOVE_SPEED = 2.0  # m/s (application.hpp:35-37)


def specialize_config(config: RenderConfig, scene: RenderScene, stats: dict) -> RenderConfig:
    """The static material-feature specialization (the reference's shader-variant
    system): the alpha peel and translucency are skipped when the scene has no
    masked or blend triangles, and sampling paths the scene's materials never
    use are compiled out."""
    if stats.get("num_masked_triangles", 0) == 0 and config.alpha_masking:
        config = config.replace(alpha_masking=False)
    if stats.get("num_blend_triangles", 0) == 0 and config.translucency:
        config = config.replace(translucency=False)
    mats = scene.materials.materials
    if not any(m.normal_texture != FLAT_NORMAL_TEXTURE for m in mats):
        config = config.replace(use_normal_maps=False)
    if not any(m.metal_rough_texture != WHITE_TEXTURE for m in mats):
        config = config.replace(use_mr_textures=False)
    if not any(
        m.emission_texture != WHITE_TEXTURE or np.any(np.asarray(m.emission_factor) > 0)
        for m in mats
    ):
        config = config.replace(use_emission=False)
    if not any(m.base_color_texture != WHITE_TEXTURE for m in mats):
        config = config.replace(use_base_textures=False)
    return config


class Application:
    def __init__(self, config: RenderConfig, scene: RenderScene, device="cuda"):
        self.device = device
        self.scene_host = scene
        self.scene, self.scene_stats = scene.build(device=device)
        self.config = config = specialize_config(config, scene, self.scene_stats)
        self.camera = Camera(
            fov_degrees=config.fov_degrees,
            aspect=config.render_width / config.render_height,
            z_near=config.z_near,
            render_resolution=(config.render_width, config.render_height),
        )
        self._renderer = make_renderer(config)
        self.temporal = temporal_state_for(config, device=device)
        self.params = RenderParams.default()
        self.frame_count = 0
        self.last_frame_seconds: Optional[float] = None

    def reconfigure(self, config) -> None:
        """Swap the frozen render config, as the reference rebuilds pipelines on
        a mode-cvar change (scene_renderer.cpp:134-211). The temporal state is
        rebuilt when its shapes change (resolutions, probe grids, LPV volumes,
        the staggered-CSM atlas); otherwise it carries over."""
        old = self.config
        self.config = config
        self._renderer = make_renderer(config)
        if (
            old.render_resolution != config.render_resolution
            or (old.output_width, old.output_height)
            != (config.output_width, config.output_height)
            or old.probe_cascades != config.probe_cascades
            or old.probe_grid != config.probe_grid
            or old.probe_spacing != config.probe_spacing
            or old.lpv_num_cascades != config.lpv_num_cascades
            or old.lpv_resolution != config.lpv_resolution
            or bool(old.shadow_update_budget) != bool(config.shadow_update_budget)
            or (config.shadow_update_budget and (
                old.num_shadow_cascades != config.num_shadow_cascades
                or old.shadow_cascade_resolution
                != config.shadow_cascade_resolution))
        ):
            self.temporal = temporal_state_for(config, device=self.device)

    # -- input (flycam) ---------------------------------------------------------
    def move(self, local_delta, dt: float = 1.0 / 60.0) -> None:
        self.camera.translate_local(np.asarray(local_delta) * MOVE_SPEED * dt)

    def rotate(self, delta_pitch: float, delta_yaw: float) -> None:
        self.camera.rotate(delta_pitch, delta_yaw)

    # -- frame ---------------------------------------------------------------------
    def tick(self) -> np.ndarray:
        """Render one frame; returns the (H, W, 3) u8 image. The read-back
        blocks, so ``last_frame_seconds`` covers the device's work."""
        if self.config.aa_mode == AAMode.TAA:
            self.camera.set_jitter(taa_jitter(self.frame_count))
        t0 = time.perf_counter()
        out, self.temporal = self._renderer(
            self.scene, self.camera.view_data(), self.params, self.temporal
        )
        img = out.image.cpu().numpy()
        self.last_frame_seconds = time.perf_counter() - t0
        self.camera.end_frame()
        self.frame_count += 1
        self._last_outputs = out
        return img
