"""Bake an image into a KTX2 container (the optimize_gltf.py analog).

The reference's asset pipeline compresses textures to KTX2 with toktx/gltfpack
(Tools/optimize_gltf.py:1-30); this tool bakes PNG/JPEG images to the KTX2
formats androidrenderer_tpu_torch reads natively: RGBA8 (+ zlib/zstd), ETC1S/BasisLZ
(toktx --encode etc1s analog, scene/basis_lz.py) and UASTC (gltfpack -tu
analog, scene/uastc.py), with a full mip chain.

    python -m androidrenderer_tpu_torch.tools.make_ktx2 input.png [-o out.ktx2] [--no-mips]
        [--format rgba8|etc1s|uastc] [--zstd | --no-zlib]

The repository's tools/make_ktx2.py with the port's imports (scene/ktx2.py,
scene/gltf.py). It needs Pillow, imported when it runs.
"""

from __future__ import annotations

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--no-mips", action="store_true")
    ap.add_argument("--no-zlib", action="store_true")
    ap.add_argument("--zstd", action="store_true",
                    help="Zstandard supercompression (toktx's default scheme)")
    ap.add_argument("--format", default="rgba8", choices=("rgba8", "etc1s", "uastc"),
                    help="texel codec (etc1s implies BasisLZ supercompression)")
    args = ap.parse_args()

    from PIL import Image

    from androidrenderer_tpu_torch.scene import ktx2

    img = np.asarray(Image.open(args.input).convert("RGBA"), np.uint8)
    levels = [img]
    if not args.no_mips:
        cur = img.astype(np.float32)
        while min(cur.shape[0], cur.shape[1]) > 1 and cur.shape[0] % 2 == 0 \
                and cur.shape[1] % 2 == 0:
            h, w, c = cur.shape
            cur = cur.reshape(h // 2, 2, w // 2, 2, c).mean(axis=(1, 3))
            levels.append(np.clip(cur + 0.5, 0, 255).astype(np.uint8))

    if args.zstd:
        scheme = ktx2.SUPERCOMPRESSION_ZSTD
    elif args.no_zlib or args.format == "etc1s":
        scheme = ktx2.SUPERCOMPRESSION_NONE
    else:
        scheme = ktx2.SUPERCOMPRESSION_ZLIB
    blob = ktx2.write_ktx2(levels, supercompression=scheme, fmt=args.format)
    out = args.output or (args.input.rsplit(".", 1)[0] + ".ktx2")
    with open(out, "wb") as f:
        f.write(blob)
    print(f"wrote {out} ({len(blob) / 1e3:.1f} kB, {len(levels)} levels)")


if __name__ == "__main__":
    main()
