"""ETC1S codec + KTX2 BasisLZ supercompression (KHR_texture_basisu).

The reference's texture loader is libktx with the BasisU transcoder
(texture_loader.hpp:23-70) and its asset pipeline bakes block-compressed KTX2
(Tools/Optimize-Textures.ps1 ``toktx --encode``, Tools/optimize_gltf.py
``gltfpack -tu``). This module is the TPU framework's from-scratch equivalent
of the ETC1S half: an encoder (vector-quantized codebooks + entropy-coded
slices) and a decoder that unpacks straight to RGBA — on TPU there is no
block-texture hardware, so "transcoding" targets the flat RGBA texel pool
(scene/material_storage.py), not another GPU block format.

What is implemented exactly from public specs:
- ETC1S block semantics: 5:5:5 base color + 3-bit intensity table shared by
  both ETC1 subblocks, 2-bit per-texel selectors; the ETC1 intensity tables
  and 5->8 bit expansion come from the Khronos ETC1 specification.
- The KTX2 BasisLZ container layout (KTX2 spec §supercompressionGlobalData):
  sgd header (endpoint/selector counts + byte lengths), per-image ImageDesc
  (flags, rgb/alpha slice offset+length), endpoint/selector/tables payloads;
  levels carry entropy-coded slices and set uncompressedByteLength = 0.

What is a documented reconstruction (see utils/bitstream.py): the entropy
layer's exact stream layout. With no spec text, encoder, or test vectors
available in this environment (zero egress — docs/ROADMAP.md), foreign-file
bit-compatibility is UNVERIFIED; files written here round-trip bit-exactly
(tests/test_basis.py), decode visually (SSIM-gated), and the layout is:

- endpoints payload: [grayscale:1][inten-delta table][color-delta table]
  [per endpoint: inten delta (mod 8), 3x color5 delta (mod 32), prev starts
  (16,16,16)/0];
- selectors payload: [byte table][4 bytes per selector, texels LSB-first];
- tables payload: the two slice models ([endpoint-index-delta table]
  [selector-index-delta table], alphabets E and S);
- each slice: per block in raster order, endpoint-index delta then
  selector-index delta (mod E / mod S, prev starts 0), byte-aligned.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from androidrenderer_tpu_torch.utils.bitstream import (
    BitReader, BitWriter, HuffmanTable, read_huffman_table, write_huffman_table,
)

# ETC1 intensity modifier tables (Khronos ETC1 spec, table 3.17.2; ETC1S uses
# one table for the whole block). Selector values 0..3 index a row directly.
INTEN_TABLES = np.array(
    [
        [-8, -2, 2, 8],
        [-17, -5, 5, 17],
        [-29, -9, 9, 29],
        [-42, -13, 13, 42],
        [-60, -18, 18, 60],
        [-80, -24, 24, 80],
        [-106, -33, 33, 106],
        [-183, -47, 47, 183],
    ],
    np.int16,
)

_SGD_HEADER = struct.Struct("<HHIIII")
_IMAGE_DESC = struct.Struct("<IIIII")


def _expand5(c5: np.ndarray) -> np.ndarray:
    c5 = c5.astype(np.int16)
    return (c5 << 3) | (c5 >> 2)


# -- block grid ---------------------------------------------------------------


def _to_blocks(img: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """(h, w, c) -> (N, 16, c) 4x4 blocks in raster order (edge-replicated pad)."""
    h, w = img.shape[:2]
    bh, bw = -(-h // 4), -(-w // 4)
    pad = ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0))
    p = np.pad(img, pad, mode="edge")
    blocks = (
        p.reshape(bh, 4, bw, 4, img.shape[2])
        .transpose(0, 2, 1, 3, 4)
        .reshape(bh * bw, 16, img.shape[2])
    )
    return blocks, bh, bw


def _from_blocks(blocks: np.ndarray, bh: int, bw: int, h: int, w: int) -> np.ndarray:
    c = blocks.shape[-1]
    img = (
        blocks.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, c)
    )
    return img[:h, :w]


# -- ETC1S block decode (vectorized) -------------------------------------------


def decode_blocks(
    endpoints: np.ndarray, selectors: np.ndarray,
    e_idx: np.ndarray, s_idx: np.ndarray,
) -> np.ndarray:
    """(E,4) u8 endpoints [r5,g5,b5,inten], (S,16) u8 selectors -> (N,16,3) u8."""
    ep = endpoints[e_idx]  # (N, 4)
    base = _expand5(ep[:, :3])  # (N, 3) i16
    mod = INTEN_TABLES[
        ep[:, 3].astype(np.int32)[:, None], selectors[s_idx].astype(np.int32)
    ]
    rgb = base[:, None, :] + mod[:, :, None]
    return np.clip(rgb, 0, 255).astype(np.uint8)


# -- encoder: per-block fit + codebook VQ --------------------------------------


def _fit_blocks(blocks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Best per-block (endpoint (N,4) u8, selectors (N,16) u8) by exhaustive
    search over the 8 intensity tables at the mean-color base."""
    px = blocks.astype(np.float32)  # (N, 16, 3)
    mean = px.mean(axis=1)  # (N, 3)
    c5 = np.clip(np.round(mean * (31.0 / 255.0)), 0, 31).astype(np.uint8)
    base = _expand5(c5).astype(np.float32)  # (N, 3)
    n = px.shape[0]
    best_err = np.full(n, np.inf, np.float32)
    best_inten = np.zeros(n, np.uint8)
    best_sel = np.zeros((n, 16), np.uint8)
    for t in range(8):
        cand = base[:, None, :] + INTEN_TABLES[t][None, :, None]  # (N, 4, 3)
        cand = np.clip(cand, 0.0, 255.0)
        # (N, 16, 4) squared error of each texel against each level
        d = px[:, :, None, :] - cand[:, None, :, :]
        err = np.einsum("nplc,nplc->npl", d, d)
        sel = err.argmin(axis=2).astype(np.uint8)  # (N, 16)
        tot = np.take_along_axis(err, sel[..., None].astype(np.int64), 2)[..., 0].sum(1)
        better = tot < best_err
        best_err = np.where(better, tot, best_err)
        best_inten = np.where(better, t, best_inten).astype(np.uint8)
        best_sel = np.where(better[:, None], sel, best_sel)
    endpoints = np.concatenate([c5, best_inten[:, None]], axis=1)
    return endpoints, best_sel


def _vq_rows(rows: np.ndarray, counts: np.ndarray, cap: int, feats: np.ndarray,
             iters: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted k-means over unique rows -> (codebook rows, per-unique map)."""
    if rows.shape[0] <= cap:
        return rows, np.arange(rows.shape[0])
    order = np.argsort(-counts)
    centers = feats[order[:cap]].copy()
    assign = np.zeros(rows.shape[0], np.int64)
    for _ in range(iters):
        d = ((feats[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(axis=1)
        for k in range(cap):
            m = assign == k
            if m.any():
                wsum = counts[m].astype(np.float64)
                centers[k] = (feats[m] * wsum[:, None]).sum(0) / wsum.sum()
    # Codebook row for each cluster = the highest-count member (keeps rows on
    # the valid quantized lattice without re-quantizing centroids).
    code = np.zeros((cap, rows.shape[1]), rows.dtype)
    used = np.zeros(cap, bool)
    for k in range(cap):
        m = np.flatnonzero(assign == k)
        if m.size:
            code[k] = rows[m[np.argmax(counts[m])]]
            used[k] = True
    if not used.all():  # drop empty clusters
        remap = np.cumsum(used) - 1
        code = code[used]
        assign = remap[assign]
    return code, assign


def build_codebooks(
    endpoints: np.ndarray, selectors: np.ndarray,
    max_endpoints: int, max_selectors: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """VQ all blocks' fits -> (endpoint codebook, selector codebook,
    per-block endpoint idx, per-block selector idx)."""
    ue, inv_e, cnt_e = np.unique(
        endpoints, axis=0, return_inverse=True, return_counts=True
    )
    feats_e = np.concatenate(
        [
            _expand5(ue[:, :3]).astype(np.float32),
            # Intensity contributes via its table's positive magnitude.
            INTEN_TABLES[ue[:, 3].astype(np.int32), 3][:, None].astype(np.float32),
        ],
        axis=1,
    )
    code_e, map_e = _vq_rows(ue, cnt_e, max_endpoints, feats_e)
    us, inv_s, cnt_s = np.unique(
        selectors, axis=0, return_inverse=True, return_counts=True
    )
    code_s, map_s = _vq_rows(
        us, cnt_s, max_selectors, us.astype(np.float32)
    )
    return code_e, code_s, map_e[inv_e], map_s[inv_s]


# -- sgd + slice serialization --------------------------------------------------


def _write_endpoints(endpoints: np.ndarray) -> bytes:
    bw = BitWriter()
    bw.put_bits(0, 1)  # grayscale flag (we always code 3 channels)
    inten_deltas = np.diff(endpoints[:, 3].astype(np.int32), prepend=0) % 8
    color_deltas = (
        np.diff(endpoints[:, :3].astype(np.int32), axis=0,
                prepend=np.full((1, 3), 16, np.int32)) % 32
    )
    t_inten = HuffmanTable.from_symbols(inten_deltas.tolist(), 8)
    t_color = HuffmanTable.from_symbols(color_deltas.reshape(-1).tolist(), 32)
    write_huffman_table(bw, t_inten)
    write_huffman_table(bw, t_color)
    for i in range(endpoints.shape[0]):
        t_inten.encode(bw, int(inten_deltas[i]))
        for c in range(3):
            t_color.encode(bw, int(color_deltas[i, c]))
    return bw.finish()


def _read_endpoints(data: bytes, count: int) -> np.ndarray:
    br = BitReader(data)
    grayscale = br.get_bits(1)
    t_inten = read_huffman_table(br)
    t_color = read_huffman_table(br)
    out = np.zeros((count, 4), np.uint8)
    prev = np.array([16, 16, 16, 0], np.int32)
    for i in range(count):
        prev[3] = (prev[3] + t_inten.decode(br)) % 8
        for c in range(3):
            prev[c] = (prev[c] + t_color.decode(br)) % 32
        out[i, :3] = prev[:3]
        out[i, 3] = prev[3]
        if grayscale:
            out[i, 1] = out[i, 2] = out[i, 0]
    return out


def _write_selectors(selectors: np.ndarray) -> bytes:
    packed = (
        selectors.reshape(-1, 4, 4)
        * np.array([1, 4, 16, 64], np.uint16)[None, None, :]
    ).sum(-1).astype(np.uint8)  # (S, 4) bytes, texels LSB-first
    bw = BitWriter()
    table = HuffmanTable.from_symbols(packed.reshape(-1).tolist(), 256)
    write_huffman_table(bw, table)
    for b in packed.reshape(-1):
        table.encode(bw, int(b))
    return bw.finish()


def _read_selectors(data: bytes, count: int) -> np.ndarray:
    br = BitReader(data)
    table = read_huffman_table(br)
    packed = np.array(
        [table.decode(br) for _ in range(count * 4)], np.uint8
    ).reshape(count, 4)
    # texel t of row j: bits (2t, 2t+1) of byte j
    out = np.zeros((count, 16), np.uint8)
    for j in range(4):
        for t in range(4):
            out[:, 4 * j + t] = (packed[:, j] >> (2 * t)) & 3
    return out


def _write_slice(e_idx: np.ndarray, s_idx: np.ndarray,
                 t_e: HuffmanTable, t_s: HuffmanTable, e: int, s: int) -> bytes:
    bw = BitWriter()
    prev_e = prev_s = 0
    for i in range(e_idx.shape[0]):
        t_e.encode(bw, int((int(e_idx[i]) - prev_e) % e))
        t_s.encode(bw, int((int(s_idx[i]) - prev_s) % s))
        prev_e, prev_s = int(e_idx[i]), int(s_idx[i])
    return bw.finish()


def _read_slice(data: bytes, n: int, t_e: HuffmanTable, t_s: HuffmanTable,
                e: int, s: int) -> Tuple[np.ndarray, np.ndarray]:
    br = BitReader(data)
    e_idx = np.zeros(n, np.int64)
    s_idx = np.zeros(n, np.int64)
    prev_e = prev_s = 0
    for i in range(n):
        prev_e = (prev_e + t_e.decode(br)) % e
        prev_s = (prev_s + t_s.decode(br)) % s
        e_idx[i] = prev_e
        s_idx[i] = prev_s
    return e_idx, s_idx


class ETC1SEncoded(NamedTuple):
    sgd: bytes  # supercompressionGlobalData (header + descs + payloads)
    level_data: List[bytes]  # per mip level: rgb slice [+ alpha slice]


def encode_etc1s(
    levels: Sequence[np.ndarray],
    max_endpoints: int = 8192,
    max_selectors: int = 8192,
) -> ETC1SEncoded:
    """RGBA8 mip levels (largest-first) -> BasisLZ sgd + per-level slice data.

    Alpha slices are emitted iff any level has a texel with alpha < 255; alpha
    blocks are coded as grayscale ETC1S (KTX2 spec: alpha slice decodes from
    the red/green channel) and share the global codebooks."""
    has_alpha = any(np.asarray(lv)[..., 3].min() < 255 for lv in levels)
    fits_e: List[np.ndarray] = []
    fits_s: List[np.ndarray] = []
    n_rgb_per_level: List[int] = []
    for lv in levels:
        lv = np.asarray(lv, np.uint8)
        rgb_blocks, _, _ = _to_blocks(lv[..., :3])
        e, s = _fit_blocks(rgb_blocks)
        n_rgb_per_level.append(rgb_blocks.shape[0])
        if has_alpha:
            a_blocks, _, _ = _to_blocks(np.repeat(lv[..., 3:4], 3, axis=-1))
            ea, sa = _fit_blocks(a_blocks)
            e = np.concatenate([e, ea])
            s = np.concatenate([s, sa])
        fits_e.append(e)
        fits_s.append(s)
    code_e, code_s, idx_e, idx_s = build_codebooks(
        np.concatenate(fits_e), np.concatenate(fits_s),
        max_endpoints, max_selectors,
    )
    E, S = code_e.shape[0], code_s.shape[0]

    # Global slice models over every slice's delta symbols. Stats run per
    # SLICE segment (rgb and alpha separately, prev reset to 0), exactly as
    # _write_slice emits them — a mismatch would leave boundary symbols
    # codeless.
    off = 0
    spans: List[Tuple[np.ndarray, np.ndarray, int]] = []
    segments: List[Tuple[np.ndarray, np.ndarray]] = []
    for fe, n_rgb in zip(fits_e, n_rgb_per_level):
        n_all = fe.shape[0]
        ei, si = idx_e[off : off + n_all], idx_s[off : off + n_all]
        off += n_all
        spans.append((ei, si, n_rgb))
        segments.append((ei[:n_rgb], si[:n_rgb]))
        if has_alpha:
            segments.append((ei[n_rgb:], si[n_rgb:]))
    sym_e: List[int] = []
    sym_s: List[int] = []
    for ei, si in segments:
        de = np.diff(ei, prepend=0) % E
        ds = np.diff(si, prepend=0) % S
        sym_e.extend(de.tolist())
        sym_s.extend(ds.tolist())
    t_e = HuffmanTable.from_symbols(sym_e, E)
    t_s = HuffmanTable.from_symbols(sym_s, S)
    bw = BitWriter()
    write_huffman_table(bw, t_e)
    write_huffman_table(bw, t_s)
    tables_bytes = bw.finish()

    level_data: List[bytes] = []
    descs: List[bytes] = []
    for (ei, si, n_rgb) in spans:
        rgb_bytes = _write_slice(ei[:n_rgb], si[:n_rgb], t_e, t_s, E, S)
        alpha_bytes = b""
        if has_alpha:
            alpha_bytes = _write_slice(ei[n_rgb:], si[n_rgb:], t_e, t_s, E, S)
        level_data.append(rgb_bytes + alpha_bytes)
        descs.append(
            _IMAGE_DESC.pack(
                0, 0, len(rgb_bytes),
                len(rgb_bytes) if alpha_bytes else 0, len(alpha_bytes),
            )
        )

    endpoints_bytes = _write_endpoints(code_e)
    selectors_bytes = _write_selectors(code_s)
    sgd = b"".join(
        [
            _SGD_HEADER.pack(E, S, len(endpoints_bytes), len(selectors_bytes),
                             len(tables_bytes), 0),
            b"".join(descs),
            endpoints_bytes, selectors_bytes, tables_bytes,
        ]
    )
    return ETC1SEncoded(sgd=sgd, level_data=level_data)


def decode_etc1s(
    sgd: bytes, level_data: Sequence[bytes],
    width: int, height: int,
) -> List[np.ndarray]:
    """BasisLZ sgd + per-level slice bytes -> RGBA8 mip levels largest-first."""
    E, S, len_e, len_s, len_t, len_x = _SGD_HEADER.unpack_from(sgd, 0)
    n_levels = len(level_data)
    off = _SGD_HEADER.size
    descs = [
        _IMAGE_DESC.unpack_from(sgd, off + i * _IMAGE_DESC.size)
        for i in range(n_levels)
    ]
    off += n_levels * _IMAGE_DESC.size
    endpoints = _read_endpoints(sgd[off : off + len_e], E)
    off += len_e
    selectors = _read_selectors(sgd[off : off + len_s], S)
    off += len_s
    br = BitReader(sgd[off : off + len_t])
    t_e = read_huffman_table(br)
    t_s = read_huffman_table(br)

    out: List[np.ndarray] = []
    for lv in range(n_levels):
        w = max(width >> lv, 1)
        h = max(height >> lv, 1)
        bh, bw_ = -(-h // 4), -(-w // 4)
        n = bh * bw_
        _, rgb_off, rgb_len, a_off, a_len = descs[lv]
        data = level_data[lv]
        ei, si = _read_slice(data[rgb_off : rgb_off + rgb_len], n, t_e, t_s, E, S)
        rgb = decode_blocks(endpoints, selectors, ei, si)
        img = np.full((h, w, 4), 255, np.uint8)
        img[..., :3] = _from_blocks(rgb, bh, bw_, h, w)
        if a_len:
            ea, sa = _read_slice(data[a_off : a_off + a_len], n, t_e, t_s, E, S)
            a = decode_blocks(endpoints, selectors, ea, sa)[..., :1]
            img[..., 3:] = _from_blocks(a, bh, bw_, h, w)
        out.append(img)
    return out
