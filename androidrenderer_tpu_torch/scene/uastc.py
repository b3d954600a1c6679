"""UASTC LDR 4x4 block codec (KHR_texture_basisu, gltfpack ``-tu``).

The reference's canonical bake is gltfpack's UASTC KTX2 path
(Tools/optimize_gltf.py: "Convert textures to KTX2 textures with UASTC
compression", ``gltfpack -tu``), consumed through libktx's BasisU transcoder
(texture_loader.hpp:23-70). On TPU there is no block-texture hardware, so this
decoder unpacks straight to RGBA8 for the flat texel pool
(scene/material_storage.py).

Faithful-to-spec parts (public ASTC/UASTC design):
- 128-bit blocks, fields packed LSB-first from bit 0;
- a mode-prefixed layout: solid-color blocks plus endpoint+weight modes;
- ASTC LDR interpolation semantics: weights unquantize to 0..64 by bit
  replication to 6 bits (+1 above 32, so the top code hits exactly 64),
  endpoints by bit replication to 8 bits, texel = (e0*(64-w)+e1*w+32)>>6.

Documented reconstruction (same caveat as scene/basis_lz.py): the exact
variable-length mode-code values and per-mode field layouts of the published
UASTC spec are not available in this environment (zero egress, no spec text,
no encoder, no vectors — docs/ROADMAP.md), so blocks here use a fixed 5-bit
mode id and the field layouts below. Files written by tools/make_ktx2.py
round-trip bit-exactly and are SSIM-gated (tests/test_basis.py); foreign
UASTC files decode only if they happen to match, otherwise the per-mode gate
raises naming the unknown mode. All layout constants live in this module.

Implemented modes (subset; the encoder picks per block):
- mode 8  — solid color: RGBA8 at bits [5:37).
- mode 0  — opaque RGB: two RGB888 endpoints [5:53), 16x4-bit weights [53:117).
- mode 10 — RGBA: two RGBA6666 endpoints [5:53), 16x4-bit weights [53:117).
Other mode ids raise NotImplementedError (which real-asset blocks would hit).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MODE_BITS = 5
MODE_SOLID = 8
MODE_RGB = 0
MODE_RGBA = 10
_ENDPOINT_OFF = MODE_BITS
_WEIGHT_OFF = MODE_BITS + 48
BLOCK_BYTES = 16


def _weight_unquant(v: np.ndarray, bits: int) -> np.ndarray:
    """ASTC bit-only weight unquantization to 0..64."""
    w = (v.astype(np.int32) << (6 - bits))
    if 2 * bits > 6:
        w |= v.astype(np.int32) >> (2 * bits - 6)
    return np.where(w > 32, w + 1, w)


def _replicate(v: np.ndarray, bits: int) -> np.ndarray:
    """Bit-replicate a ``bits``-wide value to 8 bits (ASTC endpoint unquant
    for bits-only ranges): concatenate copies of v then keep the top 8."""
    v = v.astype(np.int32)
    out = v
    total = bits
    while total < 8:
        out = (out << bits) | v
        total += bits
    return (out >> (total - 8)) & 0xFF


def _get_bits(lo: np.ndarray, hi: np.ndarray, off: int, n: int) -> np.ndarray:
    """Extract ``n`` (<= 32) bits at ``off`` from (lo, hi) u64 lane pairs."""
    mask = np.uint64((1 << n) - 1)
    if off + n <= 64:
        return ((lo >> np.uint64(off)) & mask).astype(np.uint32)
    if off >= 64:
        return ((hi >> np.uint64(off - 64)) & mask).astype(np.uint32)
    low_part = lo >> np.uint64(off)
    high_part = hi << np.uint64(64 - off)
    return ((low_part | high_part) & mask).astype(np.uint32)


def decode_blocks(blocks: np.ndarray) -> np.ndarray:
    """(N, 16) u8 UASTC blocks -> (N, 16, 4) u8 texels (raster order)."""
    if blocks.ndim != 2 or blocks.shape[1] != BLOCK_BYTES:
        raise ValueError("expected (N, 16) u8 blocks")
    lanes = blocks.reshape(-1).view("<u8").reshape(-1, 2)
    lo, hi = lanes[:, 0], lanes[:, 1]
    mode = _get_bits(lo, hi, 0, MODE_BITS)
    out = np.zeros((blocks.shape[0], 16, 4), np.uint8)
    known = np.zeros(blocks.shape[0], bool)

    m = mode == MODE_SOLID
    if m.any():
        for c in range(4):
            out[m, :, c] = _get_bits(lo[m], hi[m], 5 + 8 * c, 8)[:, None]
        known |= m

    for mid, nch, ebits in ((MODE_RGB, 3, 8), (MODE_RGBA, 4, 6)):
        m = mode == mid
        if not m.any():
            continue
        e = np.zeros((m.sum(), 2, 4), np.int32)
        e[:, :, 3] = 255
        off = _ENDPOINT_OFF
        for pair in range(2):
            for c in range(nch):
                e[:, pair, c] = _replicate(
                    _get_bits(lo[m], hi[m], off, ebits), ebits
                )
                off += ebits
        w = np.zeros((m.sum(), 16), np.int32)
        for t in range(16):
            w[:, t] = _weight_unquant(
                _get_bits(lo[m], hi[m], _WEIGHT_OFF + 4 * t, 4), 4
            )
        texels = (
            e[:, None, 0, :] * (64 - w)[:, :, None]
            + e[:, None, 1, :] * w[:, :, None]
            + 32
        ) >> 6
        out[m] = np.clip(texels, 0, 255).astype(np.uint8)
        known |= m

    if not known.all():
        bad = np.unique(mode[~known])
        raise NotImplementedError(
            f"UASTC mode(s) {bad.tolist()} not implemented (this decoder covers "
            f"modes {MODE_RGB}/{MODE_SOLID}/{MODE_RGBA} — see module docstring; "
            "re-bake with tools/make_ktx2.py)"
        )
    return out


# -- encoder --------------------------------------------------------------------


def _quant(v: np.ndarray, bits: int) -> np.ndarray:
    """Quantize 0..255 floats to the ``bits``-wide code whose replication is
    nearest (inverse of _replicate; exact for the replicated lattice)."""
    maxc = (1 << bits) - 1
    code = np.clip(np.round(v * maxc / 255.0), 0, maxc).astype(np.int32)
    return code


def _pca_dir(px: np.ndarray) -> np.ndarray:
    """Dominant color direction per block via 8 power iterations.

    px: (N, 16, C) f32 centered -> (N, C) unit vectors."""
    cov = np.einsum("npc,npd->ncd", px, px) / 16.0
    v = np.ones((px.shape[0], px.shape[2]), np.float32)
    for _ in range(8):
        v = np.einsum("ncd,nd->nc", cov, v)
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
    return v


def _fit_linear(px: np.ndarray, ebits: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fit two endpoints + 4-bit weights per block. px: (N, 16, C) f32.
    Returns (e0 codes, e1 codes (N, C) i32, weight codes (N, 16) i32)."""
    mean = px.mean(axis=1, keepdims=True)
    d = _pca_dir(px - mean)
    t = np.einsum("npc,nc->np", px - mean, d)  # (N, 16) projections
    t0 = t.min(axis=1, keepdims=True)
    t1 = t.max(axis=1, keepdims=True)
    e0 = mean[:, 0] + d * t0
    e1 = mean[:, 0] + d * t1
    e0 = np.clip(e0, 0, 255)
    e1 = np.clip(e1, 0, 255)
    c0 = _quant(e0, ebits)
    c1 = _quant(e1, ebits)
    # Weights quantize against the DEQUANTIZED endpoints for minimum error.
    r0 = _replicate(c0, ebits).astype(np.float32)
    r1 = _replicate(c1, ebits).astype(np.float32)
    seg = r1 - r0
    denom = np.maximum((seg * seg).sum(axis=1, keepdims=True), 1e-6)
    wf = ((px - r0[:, None, :]) * seg[:, None, :]).sum(-1) / denom
    wq = np.clip(np.round(wf * 15.0), 0, 15).astype(np.int32)
    return c0, c1, wq


def encode_blocks(texels: np.ndarray) -> np.ndarray:
    """(N, 16, 4) u8 -> (N, 16) u8 UASTC blocks (solid / RGB / RGBA per block)."""
    texels = np.asarray(texels, np.uint8)
    n = texels.shape[0]
    solid = (texels == texels[:, :1, :]).all(axis=(1, 2))
    opaque = (texels[..., 3] == 255).all(axis=1)
    lo = np.zeros(n, np.uint64)
    hi = np.zeros(n, np.uint64)

    def put(mask: np.ndarray, off: int, n_bits: int, vals: np.ndarray) -> None:
        v = vals.astype(np.uint64)
        if off + n_bits <= 64:
            lo[mask] |= v << np.uint64(off)
        elif off >= 64:
            hi[mask] |= v << np.uint64(off - 64)
        else:
            lo[mask] |= (v << np.uint64(off)) & np.uint64(0xFFFFFFFFFFFFFFFF)
            hi[mask] |= v >> np.uint64(64 - off)

    m = solid
    if m.any():
        put(m, 0, MODE_BITS, np.full(m.sum(), MODE_SOLID))
        for c in range(4):
            put(m, 5 + 8 * c, 8, texels[m, 0, c])

    for mid, chan_mask, nch, ebits in (
        (MODE_RGB, ~solid & opaque, 3, 8),
        (MODE_RGBA, ~solid & ~opaque, 4, 6),
    ):
        m = chan_mask
        if not m.any():
            continue
        px = texels[m, :, :nch].astype(np.float32)
        c0, c1, wq = _fit_linear(px, ebits)
        put(m, 0, MODE_BITS, np.full(m.sum(), mid))
        off = _ENDPOINT_OFF
        for codes in (c0, c1):
            for c in range(nch):
                put(m, off, ebits, codes[:, c])
                off += ebits
        for t in range(16):
            put(m, _WEIGHT_OFF + 4 * t, 4, wq[:, t])

    return np.stack([lo, hi], axis=1).view("<u1").reshape(n, BLOCK_BYTES)


def decode_image(blocks_bytes: bytes, width: int, height: int) -> np.ndarray:
    """Raw UASTC level payload -> (h, w, 4) u8."""
    bh, bw = -(-height // 4), -(-width // 4)
    n = bh * bw
    blocks = np.frombuffer(blocks_bytes, np.uint8, count=n * BLOCK_BYTES)
    texels = decode_blocks(blocks.reshape(n, BLOCK_BYTES))
    img = (
        texels.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 4)
    )
    return img[:height, :width]


def encode_image(img: np.ndarray) -> bytes:
    """(h, w, 4) u8 -> raw UASTC level payload (edge-replicated to 4x4 grid)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    bh, bw = -(-h // 4), -(-w // 4)
    p = np.pad(img, ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)), mode="edge")
    texels = (
        p.reshape(bh, 4, bw, 4, 4).transpose(0, 2, 1, 3, 4).reshape(bh * bw, 16, 4)
    )
    return encode_blocks(texels).tobytes()
