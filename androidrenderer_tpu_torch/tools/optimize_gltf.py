"""glTF optimizer — the reference Tools/optimize_gltf.py analog.

The reference pipeline compresses glTF assets with gltfpack + toktx into
`.compressed.glb` (Tools/optimize_gltf.py:1-30, KTX2/UASTC). This tool bakes a
.gltf/.glb into the KTX2 subset androidrenderer_tpu_torch reads natively: every image
becomes a mip-mapped RGBA8+ZLIB .ktx2 bound through KHR_texture_basisu, geometry
buffers are exported as one .bin, and the result loads through
scene/gltf.py::load_gltf_scene at native texel rate.

    python -m androidrenderer_tpu_torch.tools.optimize_gltf input.glb -o out_dir/

The repository's tools/optimize_gltf.py with the port's imports (scene/ktx2.py,
scene/gltf.py). It needs Pillow, imported when it runs.
"""

from __future__ import annotations

import argparse
import base64
import copy
import io
import json
from pathlib import Path

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default=None,
                    help="output directory (default: <input>.optimized/)")
    ap.add_argument("--max-size", type=int, default=1024,
                    help="clamp texture resolution (power-of-two)")
    ap.add_argument("--format", default="rgba8", choices=("rgba8", "etc1s", "uastc"),
                    help="KTX2 texel codec (uastc = the gltfpack -tu analog, "
                    "etc1s = toktx --encode etc1s)")
    args = ap.parse_args()

    from PIL import Image

    from androidrenderer_tpu_torch.scene import ktx2
    from androidrenderer_tpu_torch.scene.gltf import GltfFile

    src = Path(args.input)
    out_dir = Path(args.output or (str(src.with_suffix("")) + ".optimized"))
    out_dir.mkdir(parents=True, exist_ok=True)

    g = GltfFile(str(src))
    doc = copy.deepcopy(g.json)

    # One consolidated .bin with every buffer.
    bin_parts = []
    offset = 0
    for bi in range(len(doc.get("buffers", []))):
        data = g.buffer(bi)
        new_off = offset
        bin_parts.append(data)
        bin_parts.append(b"\x00" * ((-len(data)) % 4))
        offset += len(data) + ((-len(data)) % 4)
        for bv in doc.get("bufferViews", []):
            if bv.get("buffer") == bi:
                bv["byteOffset"] = bv.get("byteOffset", 0) + new_off
                bv["buffer"] = 0
    bin_path = out_dir / (src.stem + ".bin")
    bin_path.write_bytes(b"".join(bin_parts))
    doc["buffers"] = [{"uri": bin_path.name, "byteLength": offset}]

    # Bake every image to KTX2 (full mip chain, RGBA8 + ZLIB supercompression).
    image_views = set()
    for img_idx, img in enumerate(doc.get("images", [])):
        pixels = g.image_pixels(img_idx)
        h, w = pixels.shape[:2]
        size = 1
        while size < max(h, w):
            size *= 2
        size = min(size, args.max_size)
        if (h, w) != (size, size):
            pil = Image.fromarray(pixels).resize((size, size), Image.LANCZOS)
            pixels = np.asarray(pil, np.uint8)
        levels = [pixels]
        cur = pixels.astype(np.float32)
        while cur.shape[0] > 1:
            s = cur.shape[0]
            cur = cur.reshape(s // 2, 2, s // 2, 2, 4).mean(axis=(1, 3))
            levels.append(np.clip(cur + 0.5, 0, 255).astype(np.uint8))
        name = f"{src.stem}_img{img_idx}.ktx2"
        (out_dir / name).write_bytes(ktx2.write_ktx2(levels, fmt=args.format))
        if "bufferView" in img:
            image_views.add(img["bufferView"])
            del img["bufferView"]
        img.pop("mimeType", None)
        img["uri"] = name
        img["mimeType"] = "image/ktx2"
        print(f"baked {name} ({size}x{size}, {len(levels)} levels)")

    # Bind through KHR_texture_basisu like toktx-baked assets.
    for tex in doc.get("textures", []):
        if "source" in tex:
            tex.setdefault("extensions", {})["KHR_texture_basisu"] = {
                "source": tex.pop("source")
            }
    used = set(doc.get("extensionsUsed", []))
    used.add("KHR_texture_basisu")
    doc["extensionsUsed"] = sorted(used)

    out_path = out_dir / (src.stem + ".gltf")
    out_path.write_text(json.dumps(doc))
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
