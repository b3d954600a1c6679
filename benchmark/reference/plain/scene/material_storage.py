# Frozen copy of androidrenderer_tpu_torch/scene/material_storage.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed, and pack_texture_pool
# rewritten to make the same bytes with whole-array rolls and repeats.
"""MaterialStorage + texture pool.

Mirrors MaterialStorage (material_storage.cpp:6-82): a single pooled material
parameter array (the reference's 65536-slot BasicPbrMaterialGpu buffer) whose texture
slots are integer indices into a bindless pool (texture_descriptor_pool.hpp:16-46).

The TPU-native "bindless array" is ONE flat mip-packed texel pool holding every
texture at its NATIVE resolution (rounded to a power-of-two square, capped at
``max_texture_size``): texture t owns rows [start_t, start_t + 4/3 * b_t^2) of a
(R, 16) u8 array — its full mip chain, each texel row carrying the 2x2 bilinear
footprint (tap-packed: one gather per bilinear fetch). Shading kernels address it
with per-texture (start, log2 base size) metadata, so mixed-resolution pools cost
the same single gather as the old uniform-256^2 array. Index 0 is a default white
texture and index 1 a default flat normal map, like the backend's default
resources (render_backend.cpp default white/normal textures).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

ALPHA_OPAQUE = 0
ALPHA_MASK = 1
ALPHA_BLEND = 2

WHITE_TEXTURE = 0
FLAT_NORMAL_TEXTURE = 1


@dataclasses.dataclass
class Material:
    base_color_factor: np.ndarray  # (4,)
    metalness_factor: float = 0.0
    roughness_factor: float = 1.0
    emission_factor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float32)
    )
    base_color_texture: int = WHITE_TEXTURE
    normal_texture: int = FLAT_NORMAL_TEXTURE
    metal_rough_texture: int = WHITE_TEXTURE
    emission_texture: int = WHITE_TEXTURE
    alpha_mode: int = ALPHA_OPAQUE
    alpha_cutoff: float = 0.5
    double_sided: bool = False


def _resample_to_square(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour resample an (h, w, c) u8 image to (size, size, 4)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ys = (np.arange(size) * h // size).clip(0, h - 1)
    xs = (np.arange(size) * w // size).clip(0, w - 1)
    out = img[ys][:, xs]
    opaque = np.full((size, size, 1), 255, dtype=np.uint8)
    if c == 1:  # grayscale
        out = np.concatenate([np.repeat(out, 3, axis=-1), opaque], axis=-1)
    elif c == 2:  # luminance + alpha: expand L to RGB, keep A as alpha
        out = np.concatenate([np.repeat(out[..., :1], 3, axis=-1), out[..., 1:]], axis=-1)
    elif c == 3:
        out = np.concatenate([out, opaque], axis=-1)
    return out[:, :, :4]


def _native_pow2_size(h: int, w: int, max_size: int) -> int:
    """Power-of-two square size preserving native resolution up to the cap."""
    size = 1
    while size < max(h, w):
        size *= 2
    return max(4, min(size, max_size))


START_ALIGN = 1024  # pool-row alignment: start/1024 survives the f32 plane path


def build_mip_chain(textures: np.ndarray) -> List[np.ndarray]:
    """Box-filtered mip chain for a (T, S, S, 4) u8 array, down to 1x1."""
    mips = [textures]
    cur = textures.astype(np.float32)
    while cur.shape[1] > 1:
        t, s, _, c = cur.shape
        cur = cur.reshape(t, s // 2, 2, s // 2, 2, c).mean(axis=(2, 4))
        mips.append(np.clip(cur + 0.5, 0, 255).astype(np.uint8))
    return mips


class MaterialStorage:
    def __init__(self, max_texture_size: int = 1024, max_materials: int = 65536):
        self.max_texture_size = max_texture_size
        self.max_materials = max_materials
        self.materials: List[Material] = []
        self._images: List[np.ndarray] = []
        # Default resources (tiny — they are constant-colored).
        white = np.full((4, 4, 4), 255, dtype=np.uint8)
        flat_normal = np.zeros((4, 4, 4), dtype=np.uint8)
        flat_normal[..., 0] = 128
        flat_normal[..., 1] = 128
        flat_normal[..., 2] = 255
        flat_normal[..., 3] = 255
        self._images.append(white)
        self._images.append(flat_normal)

    @property
    def num_textures(self) -> int:
        return len(self._images)

    def add_texture(self, image: np.ndarray) -> int:
        """Register an image (h, w, c) u8 or float [0,1]; returns its pool index.

        The image keeps its native resolution (rounded to the enclosing
        power-of-two square, capped at max_texture_size)."""
        img = np.asarray(image)
        h, w = img.shape[:2]
        size = _native_pow2_size(h, w, self.max_texture_size)
        self._images.append(_resample_to_square(img, size))
        return len(self._images) - 1

    def add_material(self, material: Material) -> int:
        if len(self.materials) >= self.max_materials:
            raise RuntimeError("material pool exhausted (65536 slots)")
        self.materials.append(material)
        return len(self.materials) - 1

    # -- packing for device upload ---------------------------------------------------
    def pack_parameters(self, pad_to: int = 256) -> dict:
        """SoA material parameter arrays padded to `pad_to` multiple."""
        n = max(len(self.materials), 1)
        m = -(-n // pad_to) * pad_to

        def arr(shape, dtype=np.float32):
            return np.zeros((m, *shape), dtype=dtype)

        base_color = arr((4,))
        base_color[:, :] = 1.0
        metal_rough = arr((2,))
        emission = arr((3,))
        tex_ids = np.zeros((m, 4), dtype=np.int32)
        tex_ids[:, 1] = FLAT_NORMAL_TEXTURE
        alpha = arr((2,))  # [mode, cutoff]
        double_sided = np.zeros((m,), dtype=bool)
        # Device-side pool-entry slots (material-triple pool; entry 0 = the
        # all-defaults triple, valid for pad rows). ``texture_ids`` stays the
        # raw HOST image indices (alpha-grid bakes index self._images with it).
        _, eids = self._texture_entries()
        entry_ids = np.zeros((m, 4), dtype=np.int32)
        entry_ids[: eids.shape[0]] = eids

        for i, mat in enumerate(self.materials):
            base_color[i] = mat.base_color_factor
            metal_rough[i] = [mat.metalness_factor, mat.roughness_factor]
            emission[i] = mat.emission_factor
            tex_ids[i] = [
                mat.base_color_texture,
                mat.normal_texture,
                mat.metal_rough_texture,
                mat.emission_texture,
            ]
            alpha[i] = [float(mat.alpha_mode), mat.alpha_cutoff]
            double_sided[i] = mat.double_sided

        return {
            "base_color_factor": base_color,
            "metal_rough_factor": metal_rough,
            "emission_factor": emission,
            "texture_ids": tex_ids,
            "entry_ids": entry_ids,
            "alpha": alpha,
            "double_sided": double_sided,
        }

    # Material-packed rows: base 2x2 of level L (16) + base 3x3 of level L+1
    # (36) + normal-map 2x2 RGB (12) + normal 3x3 of L+1 (27) + metal-rough
    # 2x2 [G=rough, B=metal] (8) + MR 3x3 of L+1 (18).  Every map carries BOTH
    # levels, so the whole material samples TRILINEAR from one gather — the
    # reference's default sampler is VK_SAMPLER_MIPMAP_MODE_LINEAR for all
    # four material slots (gltf_model.cpp:497-534); round-3's integer-LOD
    # normal/MR was a measured fidelity amplifier (LOD-boundary flips through
    # GGX).  One pool entry per unique (base, normal, metal_rough) MATERIAL
    # triple; gather WIDTH is ~free (tools/microbench_gather2.py: flat
    # 4 B..348 B rows all cost 13-14 ns/lookup).
    POOL_CHANNELS = 117

    def _texture_entries(self):
        """Unique (primary, normal, metal_rough) image triples + per-material
        pool-entry slots (M, 4) [triple, triple, triple, emission_entry].

        Entry 0 is the all-defaults triple (white / flat normal / white), the
        backend's default-resource analog. Emission textures become entries
        whose PRIMARY slot is the emission image (sampled via the base 0:16
        channels), so every pool consumer shares one addressing scheme."""
        entries: List[tuple] = []
        emap: dict = {}

        def entry(b, n, m):
            key = (b, n, m)
            if key not in emap:
                emap[key] = len(entries)
                entries.append(key)
            return emap[key]

        entry(WHITE_TEXTURE, FLAT_NORMAL_TEXTURE, WHITE_TEXTURE)
        ids = []
        for mat in self.materials:
            t = entry(
                mat.base_color_texture, mat.normal_texture, mat.metal_rough_texture
            )
            e = entry(mat.emission_texture, FLAT_NORMAL_TEXTURE, WHITE_TEXTURE)
            ids.append([t, t, t, e])
        return entries, np.asarray(ids, np.int32).reshape(len(ids), 4)

    def pack_texture_pool(self):
        """(pool (R, 117) u8, start (E,) i32, log2b (E,) i32): the flat
        material-triple pool, as the program's ``pack_texture_pool`` packs it.

        A texel row at (entry t, level l, y, x) lives at flat row
        ``start[t] + (4*b^2 - 4*s^2)/3 + y*s + x`` (b = 1 << log2b[t],
        s = b >> l) and holds, per map, the level's 2x2 wrap footprint at
        (y, x) and the next level's 3x3 wrap neighbourhood centred at
        (y >> 1, x >> 1): channels 0:16 / 16:52 the base (RGBA), 52:64 /
        64:91 the normal map (RGB), 91:99 / 99:117 metal-rough (G, B). The
        last level stands in for its own next level. Maps are resampled to the
        triple's largest size; each entry is padded to ``START_ALIGN`` rows."""
        entries, _ = self._texture_entries()
        triples, sizes = [], []
        for bi, ni, mi in entries:
            imgs = [self._images[bi], self._images[ni], self._images[mi]]
            b = max(im.shape[0] for im in imgs)
            triples.append([im if im.shape[0] == b else _resample_to_square(im, b)
                            for im in imgs])
            sizes.append(b)
        rows = [(4 * b * b - 1) // 3 for b in sizes]  # a full chain of b x b
        starts = np.zeros(len(entries), np.int32)
        acc = 0
        for t, n in enumerate(rows):
            starts[t] = acc
            acc += n + (-n) % START_ALIGN
        pool = np.zeros((acc, self.POOL_CHANNELS), np.uint8)
        log2b = np.asarray([int(b).bit_length() - 1 for b in sizes], np.int32)
        slots = ((0, 16, 52, slice(0, 4)), (52, 64, 91, slice(0, 3)), (91, 99, 117, slice(1, 3)))
        for t, maps in enumerate(triples):
            chains = [[torch.from_numpy(m[0]) for m in build_mip_chain(im[None])]
                      for im in maps]
            row = int(starts[t])
            for li in range(len(chains[0])):
                s_l = chains[0][li].shape[0]
                out = torch.from_numpy(pool[row:row + s_l * s_l]).view(s_l, s_l, -1)
                for mips, (q0, n0, n1, ch) in zip(chains, slots):
                    m = mips[li][..., ch]
                    c = m.shape[-1]
                    x1 = torch.roll(m, -1, dims=1)
                    for j, tap in enumerate((m, x1, torch.roll(m, -1, dims=0),
                                             torch.roll(x1, -1, dims=0))):
                        out[..., q0 + j * c:q0 + (j + 1) * c].copy_(tap)
                    last = li + 1 >= len(mips)
                    nxt = (mips[li] if last else mips[li + 1])[..., ch]
                    nine = torch.cat([torch.roll(nxt, (-dy, -dx), dims=(0, 1))
                                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=-1)
                    if not last:
                        nine = nine.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
                    out[..., n0:n1].copy_(nine)
                row += s_l * s_l
        assert np.all(starts % START_ALIGN == 0)
        return pool, starts, log2b
