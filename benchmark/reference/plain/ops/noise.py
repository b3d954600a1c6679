# Frozen copy of androidrenderer_tpu_torch/ops/noise.py at commit c15a27329e0a,
# part of the benchmark's plain reference: the STBN asset is read from benchmark/reference/assets/;
# no white noise, no noise generator, no band offset.
"""Noise — per-pixel random numbers for stochastic effects (RT shadows, AO and GI).

The reference ships 64-layer spatio-temporal blue-noise textures frame-indexed by
``pixel %% 128`` (noise_texture.hpp:12-22, scene_renderer.cpp:81-83). Here, as in
the JAX package's ops/noise.py, the spatio-temporal blue-noise stack is loaded
from the benchmark's copy of the baked asset (benchmark/reference/assets/
stbn_128_64.npz); the direction samplers are torch.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

_U32 = 0xFFFFFFFF


def _tangent_frame(n: torch.Tensor):
    """(t, bt) completing the (..., 3) unit vectors ``n`` to an orthonormal
    frame, with the JAX module's expression order."""
    sign = torch.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t = torch.cat([1.0 + sign * n[..., 0:1] ** 2 * a, sign * b, -sign * n[..., 0:1]], dim=-1)
    bt = torch.cat([b, sign + n[..., 1:2] ** 2 * a, -n[..., 1:2]], dim=-1)
    return t, bt


def cosine_hemisphere(normal: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction about (..., 3) normals from two uniforms."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    t, bt = _tangent_frame(normal)
    return t * x[..., None] + bt * y[..., None] + normal * z[..., None]


def disc_jitter(direction: torch.Tensor, tan_radius, u1, u2) -> torch.Tensor:
    """Jitter a (..., 3) direction within a cone of tan(angular radius) — soft sun."""
    t, bt = _tangent_frame(direction)
    r = torch.sqrt(u1) * tan_radius
    phi = 2.0 * math.pi * u2
    d = direction + t * (r * torch.cos(phi))[..., None] + bt * (r * torch.sin(phi))[..., None]
    norm = torch.sqrt((d[..., 0:1] * d[..., 0:1] + d[..., 1:2] * d[..., 1:2])
                      + d[..., 2:3] * d[..., 2:3])
    return d / torch.clamp(norm, min=1e-9)


# --- Blue noise: the void-and-cluster generator (Ulichney 1993) with a toroidal
# gaussian energy kept up to date incrementally (truncated-kernel block updates),
# copied from the JAX module. tools/make_stbn.py bakes the STBN asset with it.

_BLUE_CACHE = {}


# --- STBN stack: (channels, layers, S, S) independent blue-noise slices ---------

STBN_SIZE = 128
STBN_LAYERS = 64
_STBN_ASSET = "stbn_128_64.npz"
_STBN_CACHE = {}


def _stbn_asset_path() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "..", "assets", _STBN_ASSET)


def stbn_stack(channels: int = 2) -> np.ndarray:
    """(channels, 64, 128, 128) f32 spatio-temporal blue noise from the baked
    asset (the JAX package's tools/make_stbn.py), decoded as the JAX module
    decodes it; raises when the asset is missing or holds fewer channels."""
    if channels in _STBN_CACHE:
        return _STBN_CACHE[channels]
    path = _stbn_asset_path()
    if not os.path.exists(path):
        raise FileNotFoundError(f"the blue-noise asset {path} is missing")
    with np.load(path) as z:
        stack = z["stbn"].astype(np.float32) / np.float32(65535.0)
    if stack.shape[0] < channels or stack.shape[1:] != (STBN_LAYERS, STBN_SIZE, STBN_SIZE):
        raise ValueError(f"{path} holds a {stack.shape} stack; need {channels} channels of "
                         f"({STBN_LAYERS}, {STBN_SIZE}, {STBN_SIZE})")
    _STBN_CACHE[channels] = stack[:channels]
    return _STBN_CACHE[channels]


_STBN_DEVICE_CACHE = {}


def _stbn_on(device, channels: int) -> torch.Tensor:
    """The (channels, layers, S, S) stack as a tensor on ``device``, uploaded once."""
    dev = torch.device(device)
    key = (dev, channels)
    if key not in _STBN_DEVICE_CACHE:
        _STBN_DEVICE_CACHE[key] = torch.from_numpy(
            np.ascontiguousarray(stbn_stack(channels=channels))).to(dev)
    return _STBN_DEVICE_CACHE[key]


def stbn_uniforms(height: int, width: int, frame_index: int, num: int, device) -> torch.Tensor:
    """(H, W, num) blue-noise uniforms in [0, 1].

    Layer selection is ``frame % 64`` (scene_renderer.cpp:81-83; shaders index
    ``pixel % 128``), picked on the host from the Python frame index; the
    screen tiles the layer."""
    stack = _stbn_on(device, max(2, num))  # (C, L, S, S)
    s = STBN_SIZE
    li = (int(frame_index) & _U32) % STBN_LAYERS
    reps_y, reps_x = -(-height // s), -(-width // s)
    outs = []
    for k in range(num):
        # Distinct layer per channel (k-offset), same spatial slice.
        lk = (li + k * 17) % STBN_LAYERS
        outs.append(stack[k % stack.shape[0], lk].repeat(reps_y, reps_x)[:height, :width])
    return torch.stack(outs, dim=-1)
