# Frozen copy of androidrenderer_tpu_torch/camera.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed; the flycam's moves left out.
"""Camera / SceneView — infinite reversed-Z perspective, jitter, frustum extraction.

Re-creates the reference's ``SceneView`` (render/scene_view.cpp):

- ``inf_depth_reverse_z_perspective`` (scene_view.cpp:13-27): clip.z == z_near for every
  vertex, clip.w == -view.z, so ndc depth = z_near / -view.z — 1.0 at the near plane,
  -> 0 at infinity. Depth buffer clears to 0.0, depth test is GREATER
  (depth_culling_phase.cpp:465-469, pipeline_builder.hpp:44-49).
- ``glm::lookAt`` right-handed view matrix with the flycam forward/right/up basis
  (scene_view.cpp:140-151).
- TAA jitter is injected into projection[0][2] / projection[1][2]
  (scene_view.cpp:163-164).
- Frustum x/z and y/z plane coefficients for GPU culling (scene_view.cpp:168-184).

Pixel convention used throughout this renderer: pixel (0,0) is the TOP-LEFT; the center
of pixel (px, py) maps to ndc = (2*(px+.5)/W - 1,  1 - 2*(py+.5)/H) — world-up renders
at the top of the image.

Host-side math is numpy (tiny, once per frame); the resulting ``ViewData`` NamedTuple is
the device-visible pytree equivalent of the reference's ViewDataGPU UBO
(shared/view_data.hpp:6-41).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np


class ViewData(NamedTuple):
    """Per-frame camera pytree (f32 numpy/jnp arrays) — mirrors ViewDataGPU."""

    view: np.ndarray  # (4,4) world -> view
    inverse_view: np.ndarray  # (4,4)
    projection: np.ndarray  # (4,4) view -> clip (jittered)
    inverse_projection: np.ndarray  # (4,4)
    view_proj: np.ndarray  # (4,4) world -> clip (projection @ view)
    last_view_proj: np.ndarray  # (4,4) previous frame, unjittered (motion vectors)
    unjittered_view_proj: np.ndarray  # (4,4) current frame, unjittered
    position: np.ndarray  # (3,) world-space camera position
    jitter: np.ndarray  # (2,) pixels, current frame
    previous_jitter: np.ndarray  # (2,)
    render_resolution: np.ndarray  # (2,) (width, height) f32
    frustum: np.ndarray  # (4,) [fx.x, fx.z, fy.y, fy.z] as scene_view.cpp:173-178
    z_near: np.ndarray  # () f32


def inf_reverse_z_projection(fov_y_radians: float, aspect: float, z_near: float) -> np.ndarray:
    """Infinite reversed-Z perspective (row-major), per scene_view.cpp:13-27."""
    t = 1.0 / math.tan(fov_y_radians * 0.5)
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = t / aspect
    p[1, 1] = t
    p[2, 3] = z_near  # clip.z = z_near (constant!)
    p[3, 2] = -1.0  # clip.w = -view.z
    return p


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Right-handed lookAt (glm semantics), row-major."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(center, np.float64) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -s @ eye
    m[1, 3] = -u @ eye
    m[2, 3] = f @ eye
    return m.astype(np.float32)


def flycam_basis(pitch: float, yaw: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Forward/right/up from pitch+yaw, per scene_view.cpp:141-144."""
    forward = np.array(
        [math.cos(pitch) * math.sin(yaw), math.sin(pitch), math.cos(pitch) * math.cos(yaw)],
        dtype=np.float32,
    )
    right = np.array(
        [math.sin(yaw - math.pi / 2.0), 0.0, math.cos(yaw - math.pi / 2.0)], dtype=np.float32
    )
    up = np.cross(right, forward).astype(np.float32)
    return forward, right, up


def halton(index: int, base: int) -> float:
    """Halton low-discrepancy sequence (upscaler.hpp:13-32 jitter source)."""
    f = 1.0
    r = 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def taa_jitter(frame_index: int, num_phases: int = 8) -> np.ndarray:
    """Halton(2,3) jitter in [-0.5, 0.5] pixels."""
    i = (frame_index % num_phases) + 1
    return np.array([halton(i, 2) - 0.5, halton(i, 3) - 0.5], dtype=np.float32)


class Camera:
    """Host-side flycam state machine (SceneView + Application flycam,
    application.cpp:143-163: move speed 2 m/s default)."""

    def __init__(
        self,
        fov_degrees: float = 75.0,
        aspect: float = 1.0,
        z_near: float = 0.05,
        render_resolution: Tuple[int, int] = (512, 512),
    ) -> None:
        self.fov_degrees = fov_degrees
        self.aspect = aspect
        self.z_near = z_near
        self.render_resolution = render_resolution  # (width, height)
        self.position = np.zeros(3, dtype=np.float32)
        self.pitch = 0.0
        self.yaw = 0.0
        self.jitter = np.zeros(2, dtype=np.float32)
        self._previous_jitter = np.zeros(2, dtype=np.float32)
        self._last_view_proj: np.ndarray | None = None
        self.frame_count = 0

    # -- state mutation (host only) ------------------------------------------------
    def set_jitter(self, jitter) -> None:
        self._previous_jitter = self.jitter
        self.jitter = np.asarray(jitter, dtype=np.float32)

    # -- matrices -------------------------------------------------------------------
    def view_matrix(self) -> np.ndarray:
        fwd, right, up = flycam_basis(self.pitch, self.yaw)
        return look_at(self.position, self.position + fwd, up)

    def projection_matrix(self, jittered: bool = True) -> np.ndarray:
        p = inf_reverse_z_projection(
            math.radians(self.fov_degrees), self.aspect, self.z_near
        )
        if jittered:
            # scene_view.cpp:163-164 — jitter lands in the view-z column; with
            # w = -view.z this shifts NDC by -jitter*2/res, a sub-pixel offset.
            w, h = self.render_resolution
            p = p.copy()
            p[0, 2] += self.jitter[0] * 2.0 / float(w)
            p[1, 2] += self.jitter[1] * 2.0 / float(h)
        return p

    def view_data(self) -> ViewData:
        view = self.view_matrix()
        proj = self.projection_matrix(jittered=True)
        proj_nj = self.projection_matrix(jittered=False)
        view_proj = (proj.astype(np.float64) @ view.astype(np.float64)).astype(np.float32)
        unjittered_vp = (proj_nj.astype(np.float64) @ view.astype(np.float64)).astype(
            np.float32
        )
        last_vp = self._last_view_proj if self._last_view_proj is not None else unjittered_vp

        # Frustum plane coefficients (scene_view.cpp:168-184): with a symmetric
        # projection, the left/right plane normal in view space is
        # (p00, 0, ±|p...|) — we store normalize(row3 + row0).(x,z) and
        # normalize(row3 + row1).(y,z) like the reference.
        pt = proj.astype(np.float64)
        fx = pt[3] + pt[0]
        fy = pt[3] + pt[1]
        fx = fx / np.linalg.norm(fx[:3])
        fy = fy / np.linalg.norm(fy[:3])
        frustum = np.array([fx[0], fx[2], fy[1], fy[2]], dtype=np.float32)

        w, h = self.render_resolution
        return ViewData(
            view=view,
            inverse_view=np.linalg.inv(view.astype(np.float64)).astype(np.float32),
            projection=proj,
            inverse_projection=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
            view_proj=view_proj,
            last_view_proj=last_vp.astype(np.float32),
            unjittered_view_proj=unjittered_vp,
            position=self.position.copy(),
            jitter=self.jitter.copy(),
            previous_jitter=self._previous_jitter.copy(),
            render_resolution=np.array([float(w), float(h)], dtype=np.float32),
            frustum=frustum,
            z_near=np.float32(self.z_near),
        )

    def end_frame(self) -> None:
        """Latch temporal matrices; call once per rendered frame."""
        proj_nj = self.projection_matrix(jittered=False)
        self._last_view_proj = (
            proj_nj.astype(np.float64) @ self.view_matrix().astype(np.float64)
        ).astype(np.float32)
        self.frame_count += 1
