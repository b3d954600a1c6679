"""Noise — per-pixel random numbers for stochastic effects (RT shadows, AO and GI).

The reference ships 64-layer spatio-temporal blue-noise textures frame-indexed by
``pixel %% 128`` (noise_texture.hpp:12-22, scene_renderer.cpp:81-83). Here, as in
the JAX package's ops/noise.py, the spatio-temporal blue-noise stack is loaded
from this package's copy of the baked asset (assets/stbn_128_64.npz); the
direction samplers are torch. The JAX module's white noise (``pixel_uniforms``,
a PCG hash in 32-bit unsigned arithmetic, here int64 masked to 32 bits) and its
void-and-cluster generator (``blue_noise``, numpy, which tools/make_stbn.py bakes
the asset with) are here too. ``stbn_uniforms``' ``row_offset`` keeps a band of
a sharded frame (parallel/mesh.py) equal to those rows of the whole frame's
noise.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

_U32 = 0xFFFFFFFF


def _pcg(v: torch.Tensor) -> torch.Tensor:
    """PCG hash of 32-bit unsigned words, held in int64 (every product stays
    below 2^62) and masked to 32 bits where uint32 arithmetic wraps."""
    state = (v * 747796405 + 2891336453) & _U32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _U32
    return (word >> 22) ^ word


def pixel_uniforms(height: int, width: int, frame_index, num: int, device) -> torch.Tensor:
    """(H, W, num) f32 uniforms in [0, 1), decorrelated per pixel and frame."""
    py = torch.arange(height, dtype=torch.int64, device=device)[:, None]
    px = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    h = (py * 9781 + px * 6271 + (int(frame_index) & _U32) * 26699) & _U32
    outs = []
    for _ in range(num):
        h = _pcg(h)
        outs.append(h.to(torch.float32) * (1.0 / 4294967296.0))
    return torch.stack(outs, dim=-1)


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


def _vac_energy_kernel(size: int, sigma: float):
    """Truncated toroidal gaussian kernel + its offset grids."""
    rad = min(size // 2, int(np.ceil(4.0 * sigma)))
    off = np.arange(-rad, rad + 1)
    d2 = off[None, :] ** 2 + off[:, None] ** 2
    kernel = np.exp(-d2 / (2.0 * sigma * sigma))
    return rad, off, kernel


def blue_noise(size: int = 64, sigma: float = 1.9, seed: int = 0) -> np.ndarray:
    """(size, size) f32 in [0, 1) with a blue (high-frequency) spectrum; cached
    per arguments (the same array is returned again)."""
    key = (size, sigma, seed)
    if key in _BLUE_CACHE:
        return _BLUE_CACHE[key]
    rng = np.random.default_rng(seed)
    n = size * size
    _, off, kernel = _vac_energy_kernel(size, sigma)
    energy = np.zeros((size, size), np.float64)

    def toggle(flat_idx: int, sign: float, mask):
        y, x = divmod(int(flat_idx), size)
        energy[np.ix_((y + off) % size, (x + off) % size)] += sign * kernel
        mask.flat[flat_idx] = sign > 0

    # Initial pattern: ~10% ones, relaxed so no tight clusters remain.
    ones = n // 10
    mask = np.zeros((size, size), bool)
    for i in rng.choice(n, ones, replace=False):
        toggle(i, +1.0, mask)
    for _ in range(4 * ones):
        cluster = int(np.argmax(np.where(mask, energy, -np.inf)))
        toggle(cluster, -1.0, mask)
        void = int(np.argmin(np.where(~mask, energy, np.inf)))
        if void == cluster:
            toggle(cluster, +1.0, mask)
            break
        toggle(void, +1.0, mask)

    rank = np.zeros((size, size), np.int64)
    initial = mask.copy()
    initial_energy = energy.copy()
    # Phase 1: remove the tightest clusters down to empty, ranking them.
    for r in range(ones - 1, -1, -1):
        c = int(np.argmax(np.where(mask, energy, -np.inf)))
        toggle(c, -1.0, mask)
        rank.flat[c] = r
    # Phase 2: fill the largest voids up from the initial pattern.
    mask = initial
    energy[...] = initial_energy
    for r in range(ones, n):
        v = int(np.argmin(np.where(~mask, energy, np.inf)))
        toggle(v, +1.0, mask)
        rank.flat[v] = r

    out = ((rank.astype(np.float64) + 0.5) / n).astype(np.float32)
    _BLUE_CACHE[key] = out
    return out


# --- STBN stack: (channels, layers, S, S) independent blue-noise slices ---------

STBN_SIZE = 128
STBN_LAYERS = 64
_STBN_ASSET = "stbn_128_64.npz"
_STBN_CACHE = {}


def _stbn_asset_path() -> str:
    return os.path.join(os.path.dirname(__file__), "..", "assets", _STBN_ASSET)


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


def stbn_uniforms(height: int, width: int, frame_index: int, num: int, device,
                  row_offset: int = 0) -> torch.Tensor:
    """(H, W, num) blue-noise uniforms in [0, 1], of the frame rows from
    ``row_offset`` on.

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
        layer = torch.roll(stack[k % stack.shape[0], lk], -(row_offset % s), dims=0)
        outs.append(layer.repeat(reps_y, reps_x)[:height, :width])
    return torch.stack(outs, dim=-1)
