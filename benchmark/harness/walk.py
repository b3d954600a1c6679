"""The one traffic generator: a viewer walking a closed loop, and moving props.

A traffic file (``traffic/<name>.json``) holds only parameters:

- ``path``: an ellipse on the floor, ``center_m`` (x, z) and ``radii_m`` (x, z);
- ``eye_height_m`` and ``step_m``, the distance walked per frame (1.4 m/s at
  a nominal 30 Hz is 0.0467 m): the loop is cut into the whole number of
  frames nearest to its length over the step;
- ``look``: the view turns from the walking direction by ``yaw_swing_deg``
  and tilts by ``pitch_swing_deg``, as sines with ``yaw_cycles`` and
  ``pitch_cycles`` whole periods per loop, so a view depends only on where on
  the loop it is;
- ``moving`` (or null): ``groups`` of ``{"mesh": id, "count": n}`` pick n of
  the primitives built from mesh ``id``; each turns about its own vertical
  axis by ``turn_rad_per_frame`` and bobs up to ``bob_m`` above and below its
  rest height with a period of ``bob_period_frames``.

The seed picks the frame of the loop the walk starts at, which primitives of
each group move, and their phases. Every seed walks the same loop at the same
speed and moves the same number of primitives of the same meshes, so the work
per frame is the same set in another order. Frame 0 is the first warm-up
frame; the window's frames follow on.

The camera has the output's aspect and counts its pixels at the render size.
With ``jitter`` (a frame with TAA) frame f carries the Halton jitter
``taa_jitter(f)`` and the previous frame's ``taa_jitter(f - 1)`` (none before
frame 0), the sequence the application's tick gives.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference.plain.camera import Camera, taa_jitter


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """Stream ``stream`` of the run's seed (any whole number, however large)."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


class Walk:
    """Views and primitive transforms of each frame of one traffic mix."""

    def __init__(self, traffic: dict, seed: int, width: int, height: int, fov_degrees: float,
                 z_near: float, primitive_meshes=(), rest_transforms=None, render_size=None,
                 jitter: bool = False):
        """``width`` x ``height``: the output; ``render_size``: (width, height)
        rendered, by default the output's."""
        self.traffic = traffic
        self.width, self.height = width, height
        self.render_size = (width, height) if render_size is None else tuple(render_size)
        self.jitter = jitter
        self.fov_degrees, self.z_near = fov_degrees, z_near
        cx, cz = traffic["path"]["center_m"]
        ax, az = traffic["path"]["radii_m"]
        theta = np.linspace(0.0, 2.0 * np.pi, 1 << 16, endpoint=False)
        pts = np.stack([cx + ax * np.cos(theta), cz + az * np.sin(theta)], axis=1)
        seg = np.linalg.norm(np.roll(pts, -1, axis=0) - pts, axis=1)
        self._arc = np.concatenate([[0.0], np.cumsum(seg)])
        self._theta = np.append(theta, 2.0 * np.pi)
        self.perimeter = float(self._arc[-1])
        self.loop_frames = max(1, int(round(self.perimeter / traffic["step_m"])))
        self.start = int(seed_rng(seed, 0).integers(self.loop_frames))
        self._center, self._radii = (cx, cz), (ax, az)
        self.moved = np.zeros(0, np.int64)
        self.rest = None if rest_transforms is None else np.asarray(rest_transforms, np.float32)
        moving = traffic.get("moving")
        if moving:
            rng = seed_rng(seed, 1)
            meshes = np.asarray(primitive_meshes)
            picks = []
            for group in moving["groups"]:
                pool = np.flatnonzero(meshes == group["mesh"])
                picks.append(rng.choice(pool, size=group["count"], replace=False))
            self.moved = np.sort(np.concatenate(picks))
            self._turn0 = rng.uniform(0.0, 2.0 * np.pi, self.moved.size)
            self._bob0 = rng.uniform(0.0, 2.0 * np.pi, self.moved.size)

    def _pose(self, f: int):
        """(eye, pitch, yaw) of frame ``f``."""
        u = ((self.start + f) % self.loop_frames) / self.loop_frames
        th = float(np.interp(u * self.perimeter, self._arc, self._theta))
        (cx, cz), (ax, az) = self._center, self._radii
        eye = np.array([cx + ax * math.cos(th), self.traffic["eye_height_m"],
                        cz + az * math.sin(th)], np.float32)
        dx, dz = -ax * math.sin(th), az * math.cos(th)  # walking direction
        look = self.traffic["look"]
        yaw = math.atan2(dx, dz) + math.radians(look["yaw_swing_deg"]) * math.sin(
            2.0 * math.pi * look["yaw_cycles"] * u)
        pitch = math.radians(look["pitch_swing_deg"]) * math.sin(
            2.0 * math.pi * look["pitch_cycles"] * u)
        return eye, pitch, yaw

    def _camera(self, f: int) -> Camera:
        cam = Camera(fov_degrees=self.fov_degrees, aspect=self.width / self.height,
                     z_near=self.z_near, render_resolution=self.render_size)
        cam.position, cam.pitch, cam.yaw = self._pose(f)
        return cam

    def view(self, f: int):
        """Frame ``f``'s ViewData (numpy), its last frame's matrix and jitter
        latched."""
        cam = self._camera(max(f - 1, 0))
        if f > 0:
            if self.jitter:
                cam.set_jitter(taa_jitter(f - 1))
            cam.end_frame()
            cam.position, cam.pitch, cam.yaw = self._pose(f)
        if self.jitter:
            cam.set_jitter(taa_jitter(f))
        return cam.view_data()

    def transforms(self, f: int) -> np.ndarray:
        """(P, 4, 4) f32 primitive transforms of frame ``f``."""
        tr = self.rest.copy()
        moving = self.traffic["moving"]
        for i, p in enumerate(self.moved):
            a = self._turn0[i] + moving["turn_rad_per_frame"] * f
            ry = np.eye(4, dtype=np.float32)
            ry[0, 0], ry[0, 2], ry[2, 0], ry[2, 2] = (math.cos(a), math.sin(a), -math.sin(a),
                                                      math.cos(a))
            tr[p] = tr[p] @ ry
            tr[p, 1, 3] += moving["bob_m"] * math.sin(
                self._bob0[i] + 2.0 * math.pi * f / moving["bob_period_frames"])
        return tr
