"""KTX2 texture container — TextureLoader parity (texture_loader.hpp:23-70).

The reference's primary texture path is KTX2 via libktx (its glTF optimizer bakes
assets with toktx/gltfpack — Tools/optimize_gltf.py:1-30). This is a dependency-free
reader for the KTX2 container format (Khronos KTX File Format Specification v2):

- header + level index parse, mip levels returned largest-first as (h, w, 4) u8;
- supercompression: None (0), BasisLZ (1 — the ETC1S path, scene/basis_lz.py),
  Zstandard (2) via the zstandard module (read + write — the scheme toktx
  emits by default), ZLIB (3) via stdlib zlib;
- formats: the 8-bit UNORM/SRGB family (R8, RG8, RGB8, RGBA8) plus the
  KHR_texture_basisu block codecs, routed by the DFD color model when
  vkFormat == UNDEFINED: ETC1S (163, scene/basis_lz.py) and UASTC LDR 4x4
  (166, scene/uastc.py — see that module's compatibility caveat).

A matching writer lives here too (used by the asset tool and tests), so every
format path is exercised end-to-end without external binaries
(``tools/make_ktx2.py --format rgba8|etc1s|uastc``).
"""

from __future__ import annotations

import struct
import zlib
from typing import List

import numpy as np

MAGIC = b"\xabKTX 20\xbb\r\n\x1a\n"

# VkFormat values for the supported 8-bit family.
VK_FORMAT_R8_UNORM = 9
VK_FORMAT_R8G8_UNORM = 16
VK_FORMAT_R8G8B8_UNORM = 23
VK_FORMAT_R8G8B8_SRGB = 29
VK_FORMAT_R8G8B8A8_UNORM = 37
VK_FORMAT_R8G8B8A8_SRGB = 43

_CHANNELS = {
    VK_FORMAT_R8_UNORM: 1,
    VK_FORMAT_R8G8_UNORM: 2,
    VK_FORMAT_R8G8B8_UNORM: 3,
    VK_FORMAT_R8G8B8_SRGB: 3,
    VK_FORMAT_R8G8B8A8_UNORM: 4,
    VK_FORMAT_R8G8B8A8_SRGB: 4,
}

SUPERCOMPRESSION_NONE = 0
SUPERCOMPRESSION_BASISLZ = 1
SUPERCOMPRESSION_ZSTD = 2
SUPERCOMPRESSION_ZLIB = 3

VK_FORMAT_UNDEFINED = 0
# Khronos Data Format color models (KDFS 1.3 §basic descriptor block).
KHR_DF_MODEL_RGBSDA = 1
KHR_DF_MODEL_ETC1S = 163
KHR_DF_MODEL_UASTC = 166

_HEADER = struct.Struct("<IIIIIIIII")  # after magic: vkFormat..supercompression
_INDEX = struct.Struct("<IIQQQQ")  # dfd/kvd offsets+lengths (u32 x2? see spec)
_LEVEL = struct.Struct("<QQQ")
_LEVEL_INDEX_OFF = 12 + _HEADER.size + 4 * 4 + 8 * 2


def _make_dfd(color_model: int, srgb: bool, block44: bool, bytes_plane0: int) -> bytes:
    """Basic Khronos data format descriptor: one block, one RGBA sample."""
    block_size = 24 + 16  # header + 1 sample
    sample = struct.pack(
        "<HBBBBBBII",
        0,  # bitOffset
        127 if block44 else 31,  # bitLength - 1
        0x0F if block44 else 0,  # channelType (block codecs: data)
        0, 0, 0, 0,  # samplePosition0..3
        0, 0xFFFFFFFF,  # sampleLower/Upper
    )
    block = struct.pack(
        "<IHHBBBBBBBBBBBBBBBB",
        0,  # vendorId (Khronos) | descriptorType (basic)
        2, block_size,  # versionNumber, descriptorBlockSize
        color_model,
        1,  # colorPrimaries = BT709
        2 if srgb else 1,  # transferFunction
        0,  # flags (straight alpha)
        3 if block44 else 0, 3 if block44 else 0, 0, 0,  # texelBlockDimension
        bytes_plane0, 0, 0, 0, 0, 0, 0, 0,
    )
    body = block + sample
    return struct.pack("<I", 4 + len(body)) + body


def _dfd_color_model(data: bytes, dfd_off: int, dfd_len: int) -> int | None:
    """colorModel byte of the first descriptor block, or None if absent."""
    # dfdTotalSize u32, then block: u32 vendor/type, u16 ver, u16 size, u8 model.
    if dfd_len < 13:
        return None
    return data[dfd_off + 12]


def _decompress(data: bytes, scheme: int, expect: int) -> bytes:
    if scheme == SUPERCOMPRESSION_NONE:
        return data
    if scheme == SUPERCOMPRESSION_ZLIB:
        out = zlib.decompress(data)
    elif scheme == SUPERCOMPRESSION_ZSTD:
        import zstandard

        out = zstandard.ZstdDecompressor().decompress(data, max_output_size=expect)
    elif scheme == SUPERCOMPRESSION_BASISLZ:
        # Valid BasisLZ files are routed to scene/basis_lz.py before per-level
        # decompression; reaching here means vkFormat != UNDEFINED (malformed).
        raise NotImplementedError(
            "KTX2 BasisLZ supercompression with a non-UNDEFINED vkFormat is "
            "malformed (ETC1S decodes via scene/basis_lz.py)"
        )
    else:
        raise ValueError(f"unknown KTX2 supercompression scheme {scheme}")
    if len(out) != expect:
        raise ValueError(f"KTX2 level decompressed to {len(out)} bytes, expected {expect}")
    return out


def load_ktx2(data: bytes) -> List[np.ndarray]:
    """Parse a KTX2 byte string -> mip levels largest-first, each (h, w, 4) u8."""
    if data[:12] != MAGIC:
        raise ValueError("not a KTX2 file (bad magic)")
    (vk_format, type_size, width, height, depth, layers, faces, levels,
     scheme) = _HEADER.unpack_from(data, 12)
    if depth > 1 or layers > 1 or faces > 1:
        raise NotImplementedError("KTX2 3D/array/cubemap textures unsupported")
    levels = max(levels, 1)

    if vk_format == VK_FORMAT_UNDEFINED:
        # Block codecs (KHR_texture_basisu): route by the DFD color model.
        dfd_off, dfd_len = struct.unpack_from("<II", data, 12 + _HEADER.size)
        sgd_off, sgd_len = struct.unpack_from(
            "<QQ", data, 12 + _HEADER.size + 4 * 4
        )
        model = _dfd_color_model(data, dfd_off, dfd_len)
        entries = [
            _LEVEL.unpack_from(data, _LEVEL_INDEX_OFF + lv * _LEVEL.size)
            for lv in range(levels)
        ]
        if scheme == SUPERCOMPRESSION_BASISLZ or model == KHR_DF_MODEL_ETC1S:
            from androidrenderer_tpu_torch.scene.basis_lz import decode_etc1s

            return decode_etc1s(
                data[sgd_off : sgd_off + sgd_len],
                [data[o : o + l] for (o, l, _) in entries],
                width, height,
            )
        if model == KHR_DF_MODEL_UASTC:
            from androidrenderer_tpu_torch.scene.uastc import decode_image

            out = []
            for lv, (o, l, unc) in enumerate(entries):
                raw = _decompress(data[o : o + l], scheme, unc if scheme else l)
                out.append(
                    decode_image(raw, max(width >> lv, 1), max(height >> lv, 1))
                )
            return out
        raise NotImplementedError(
            f"KTX2 vkFormat UNDEFINED with DFD color model {model} unsupported "
            "(ETC1S=163 and UASTC=166 are implemented)"
        )
    if vk_format not in _CHANNELS:
        raise NotImplementedError(
            f"KTX2 vkFormat {vk_format} unsupported (8-bit UNORM/SRGB family, "
            "ETC1S, or UASTC)"
        )
    ch = _CHANNELS[vk_format]

    off = _LEVEL_INDEX_OFF
    out = []
    for lv in range(levels):
        byte_off, byte_len, unc_len = _LEVEL.unpack_from(data, off + lv * _LEVEL.size)
        raw = _decompress(data[byte_off : byte_off + byte_len], scheme,
                          unc_len if scheme else byte_len)
        w = max(width >> lv, 1)
        h = max(height >> lv, 1)
        # KTX2 levels have no row padding for 1-byte-aligned formats at mip sizes
        # used here (texel block align = texel size for these formats).
        img = np.frombuffer(raw, np.uint8, count=h * w * ch).reshape(h, w, ch)
        if ch == 1:
            img = np.concatenate(
                [np.repeat(img, 3, -1), np.full((h, w, 1), 255, np.uint8)], -1
            )
        elif ch == 2:  # luminance + alpha
            img = np.concatenate([np.repeat(img[..., :1], 3, -1), img[..., 1:]], -1)
        elif ch == 3:
            img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
        out.append(img)
    return out


def load_ktx2_file(path: str) -> List[np.ndarray]:
    with open(path, "rb") as f:
        return load_ktx2(f.read())


def write_ktx2(
    levels: List[np.ndarray],
    srgb: bool = True,
    supercompression: int = SUPERCOMPRESSION_ZLIB,
    fmt: str = "rgba8",
) -> bytes:
    """Serialize RGBA8 mip levels (largest-first) to a KTX2 byte string.

    ``fmt``: "rgba8" (vkFormat R8G8B8A8 + optional zlib/zstd supercompression),
    "etc1s" (BasisLZ supercompression, scene/basis_lz.py — ``supercompression``
    is implied), or "uastc" (vkFormat UNDEFINED + DFD UASTC, optionally
    zlib/zstd-supercompressed like gltfpack/toktx emit it)."""
    checked = []
    for lv in levels:
        lv = np.asarray(lv, np.uint8)
        if lv.ndim != 3 or lv.shape[2] != 4:
            raise ValueError("write_ktx2 expects (h, w, 4) u8 levels")
        checked.append(lv)
    levels = checked
    h, w = levels[0].shape[:2]
    n = len(levels)
    sgd = b""

    if fmt == "etc1s":
        from androidrenderer_tpu_torch.scene.basis_lz import encode_etc1s

        enc = encode_etc1s(levels)
        sgd = enc.sgd
        payloads = [(blob, 0) for blob in enc.level_data]  # unc length = 0
        vk_format = VK_FORMAT_UNDEFINED
        scheme = SUPERCOMPRESSION_BASISLZ
        dfd = _make_dfd(KHR_DF_MODEL_ETC1S, srgb, block44=True, bytes_plane0=0)
    else:
        if fmt == "uastc":
            from androidrenderer_tpu_torch.scene.uastc import encode_image

            raws = [encode_image(lv) for lv in levels]
            vk_format = VK_FORMAT_UNDEFINED
            dfd = _make_dfd(
                KHR_DF_MODEL_UASTC, srgb, block44=True,
                bytes_plane0=0 if supercompression else 16,
            )
        elif fmt == "rgba8":
            raws = [lv.tobytes() for lv in levels]
            vk_format = VK_FORMAT_R8G8B8A8_SRGB if srgb else VK_FORMAT_R8G8B8A8_UNORM
            dfd = _make_dfd(
                KHR_DF_MODEL_RGBSDA, srgb, block44=False,
                bytes_plane0=0 if supercompression else 4,
            )
        else:
            raise ValueError(f"unknown KTX2 write format {fmt!r}")
        scheme = supercompression
        if scheme == SUPERCOMPRESSION_BASISLZ:
            raise ValueError("BasisLZ supercompression implies fmt='etc1s'")
        payloads = []
        for raw in raws:
            if scheme == SUPERCOMPRESSION_ZLIB:
                payloads.append((zlib.compress(raw, 6), len(raw)))
            elif scheme == SUPERCOMPRESSION_ZSTD:
                import zstandard

                payloads.append(
                    (zstandard.ZstdCompressor(level=9).compress(raw), len(raw))
                )
            else:
                payloads.append((raw, len(raw)))

    header = _HEADER.pack(vk_format, 1, w, h, 0, 0, 1, n, scheme)
    dfd_off = _LEVEL_INDEX_OFF + n * _LEVEL.size
    sgd_pad = (-(dfd_off + len(dfd))) % 8 if sgd else 0
    sgd_off = dfd_off + len(dfd) + sgd_pad
    payload_off = sgd_off + len(sgd)

    blobs = []
    index = []
    off = payload_off
    for blob, unc_len in payloads:
        pad = (-off) % 8  # mipPadding
        off += pad
        blobs.append(b"\x00" * pad + blob)
        index.append(_LEVEL.pack(off, len(blob), unc_len))
        off += len(blob)

    parts = [
        MAGIC, header,
        struct.pack("<IIII", dfd_off, len(dfd), 0, 0),  # dfd/kvd offsets+lengths
        struct.pack("<QQ", sgd_off if sgd else 0, len(sgd)),
        b"".join(index), dfd, b"\x00" * sgd_pad, sgd, b"".join(blobs),
    ]
    return b"".join(parts)
