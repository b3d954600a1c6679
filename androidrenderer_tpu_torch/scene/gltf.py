"""glTF 2.0 / GLB importer — the GltfModel equivalent (model_import/gltf_model.cpp).

Pure python + numpy (+ PIL for image decode): parses the GLB container or .gltf JSON,
walks the node hierarchy accumulating world matrices (gltf_model.cpp:96-139), imports
meshes (POSITION / NORMAL / TANGENT / TEXCOORD_0 / COLOR_0 + indices,
gltf_model.cpp:289-329), materials with alpha modes / double-sided / emissive
detection (cpp:173-287), and textures (PNG/JPEG via PIL + KTX2 via scene/ktx2.py,
incl. KHR_texture_basisu bindings — texture_loader.hpp:23-70, cpp:398+). Produces a
RenderScene whose build() bakes the device arrays.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from androidrenderer_tpu_torch.scene.material_storage import (
    ALPHA_BLEND,
    ALPHA_MASK,
    ALPHA_OPAQUE,
    Material,
)
from androidrenderer_tpu_torch.scene.scene import RenderScene

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}
_ALPHA_MODES = {"OPAQUE": ALPHA_OPAQUE, "MASK": ALPHA_MASK, "BLEND": ALPHA_BLEND}


class GltfFile:
    def __init__(self, path: str):
        p = Path(path)
        data = p.read_bytes()
        if data[:4] == b"glTF":
            # GLB container: header + JSON chunk + BIN chunk.
            _, version, _ = struct.unpack_from("<III", data, 0)
            if version != 2:
                raise ValueError(f"unsupported GLB version {version}")
            offset = 12
            self.json: dict = {}
            self.bin = b""
            while offset < len(data):
                clen, ctype = struct.unpack_from("<II", data, offset)
                chunk = data[offset + 8 : offset + 8 + clen]
                if ctype == 0x4E4F534A:  # JSON
                    self.json = json.loads(chunk)
                elif ctype == 0x004E4942:  # BIN
                    self.bin = chunk
                offset += 8 + clen
        else:
            self.json = json.loads(data)
            self.bin = b""
        self.base_dir = p.parent
        self._buffers: Dict[int, bytes] = {}

    def buffer(self, index: int) -> bytes:
        if index not in self._buffers:
            b = self.json["buffers"][index]
            uri = b.get("uri")
            if uri is None:
                self._buffers[index] = self.bin
            elif uri.startswith("data:"):
                self._buffers[index] = base64.b64decode(uri.split(",", 1)[1])
            else:
                from urllib.parse import unquote

                self._buffers[index] = (self.base_dir / unquote(uri)).read_bytes()
        return self._buffers[index]

    def buffer_view_bytes(self, index: int) -> bytes:
        bv = self.json["bufferViews"][index]
        buf = self.buffer(bv["buffer"])
        off = bv.get("byteOffset", 0)
        return buf[off : off + bv["byteLength"]]

    def accessor(self, index: int) -> np.ndarray:
        """Decode an accessor to (count, components) np array (f32/i32)."""
        a = self.json["accessors"][index]
        count = a["count"]
        ncomp = _TYPE_COUNTS[a["type"]]
        dtype = _COMPONENT_DTYPES[a["componentType"]]
        itemsize = np.dtype(dtype).itemsize
        if "bufferView" not in a:
            out = np.zeros((count, ncomp), dtype)
        else:
            bv = self.json["bufferViews"][a["bufferView"]]
            raw = self.buffer(bv["buffer"])
            off = bv.get("byteOffset", 0) + a.get("byteOffset", 0)
            stride = bv.get("byteStride") or itemsize * ncomp
            if stride == itemsize * ncomp:
                out = np.frombuffer(
                    raw, dtype, count * ncomp, off
                ).reshape(count, ncomp)
            else:
                rows = np.frombuffer(raw, np.uint8, stride * count, off).reshape(
                    count, stride
                )
                out = rows[:, : itemsize * ncomp].copy().view(dtype).reshape(
                    count, ncomp
                )
        if a.get("normalized") and dtype != np.float32:
            out = out.astype(np.float32) / np.iinfo(dtype).max
        return np.ascontiguousarray(out)

    def image_pixels(self, image_index: int) -> np.ndarray:
        """(h, w, 4) u8 via PIL."""
        import io

        from PIL import Image

        img = self.json["images"][image_index]
        if "bufferView" in img:
            raw = self.buffer_view_bytes(img["bufferView"])
        else:
            uri = img["uri"]
            if uri.startswith("data:"):
                raw = base64.b64decode(uri.split(",", 1)[1])
            else:
                from urllib.parse import unquote

                raw = (self.base_dir / unquote(uri)).read_bytes()
        # KTX2 (KHR_texture_basisu / toktx-baked assets — texture_loader.hpp:23-70).
        from androidrenderer_tpu_torch.scene.ktx2 import MAGIC as _KTX2_MAGIC, load_ktx2

        if raw[:12] == _KTX2_MAGIC:
            return load_ktx2(raw)[0]
        pil = Image.open(io.BytesIO(raw)).convert("RGBA")
        return np.asarray(pil, dtype=np.uint8)


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T  # column-major
    m = np.eye(4)
    if "translation" in node:
        m[:3, 3] = node["translation"]
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = m[:3, :3] @ r
    if "scale" in node:
        m[:3, :3] = m[:3, :3] * np.asarray(node["scale"])[None, :]
    return m


def load_gltf_scene(
    path: str,
    max_texture_size: int = 1024,
    sun_direction=(0.35, -1.0, 0.25),
    sun_intensity: float = 110_000.0,
) -> RenderScene:
    """Parse a .glb/.gltf into a RenderScene (meshes, materials, textures, nodes).

    Textures keep their native resolution up to ``max_texture_size`` (the pool
    stores per-texture sizes — scene/material_storage.py)."""
    g = GltfFile(path)
    scene = RenderScene()
    scene.materials.max_texture_size = max_texture_size
    scene.set_sun(sun_direction, (1.0, 0.96, 0.88), sun_intensity)

    # Textures: pool index per glTF texture (lazy-dedup on source image).
    tex_pool: Dict[int, int] = {}

    def import_texture(tex_index: Optional[int]) -> Optional[int]:
        if tex_index is None:
            return None
        tex = g.json["textures"][tex_index]
        src = tex.get("source")
        if src is None:
            # KHR_texture_basisu points at the KTX2 image via its extension.
            src = (
                tex.get("extensions", {})
                .get("KHR_texture_basisu", {})
                .get("source")
            )
        if src is None:
            return None
        if src not in tex_pool:
            try:
                tex_pool[src] = scene.materials.add_texture(g.image_pixels(src))
            except Exception:
                return None  # unsupported codec (e.g. KTX2) -> default white
        return tex_pool[src]

    # Materials.
    mat_map: List[int] = []
    for m in g.json.get("materials", [{}]):
        pbr = m.get("pbrMetallicRoughness", {})
        base_tex = import_texture((pbr.get("baseColorTexture") or {}).get("index"))
        mr_tex = import_texture(
            (pbr.get("metallicRoughnessTexture") or {}).get("index")
        )
        nrm_tex = import_texture((m.get("normalTexture") or {}).get("index"))
        em_tex = import_texture((m.get("emissiveTexture") or {}).get("index"))
        emissive = np.asarray(m.get("emissiveFactor", [0, 0, 0]), np.float32)
        strength = (
            m.get("extensions", {})
            .get("KHR_materials_emissive_strength", {})
            .get("emissiveStrength", 1.0)
        )
        mat = Material(
            base_color_factor=np.asarray(
                pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32
            ),
            metalness_factor=pbr.get("metallicFactor", 1.0),
            roughness_factor=pbr.get("roughnessFactor", 1.0),
            emission_factor=emissive * strength,
            base_color_texture=base_tex if base_tex is not None else 0,
            normal_texture=nrm_tex if nrm_tex is not None else 1,
            metal_rough_texture=mr_tex if mr_tex is not None else 0,
            emission_texture=em_tex if em_tex is not None else 0,
            alpha_mode=_ALPHA_MODES.get(m.get("alphaMode", "OPAQUE"), ALPHA_OPAQUE),
            alpha_cutoff=m.get("alphaCutoff", 0.5),
            double_sided=m.get("doubleSided", False),
        )
        mat_map.append(scene.materials.add_material(mat))

    # Spec default material for primitives with no "material" property: white base
    # color, metallic 1, roughness 1, opaque (glTF 2.0 §3.9.6) — NOT the file's
    # material 0, which is an arbitrary authored material. Created lazily so scenes
    # where every primitive is materialed don't grow an unused slot.
    _default_mat: list = []

    def default_mat() -> int:
        if not _default_mat:
            _default_mat.append(scene.materials.add_material(
                Material(np.ones(4, np.float32), metalness_factor=1.0,
                         roughness_factor=1.0)
            ))
        return _default_mat[0]

    # Meshes: one MeshStorage entry per glTF primitive.
    prim_meshes: List[List[tuple]] = []  # per gltf mesh: [(storage_id, material)]
    for mesh in g.json.get("meshes", []):
        prims = []
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:
                continue  # triangles only
            attrs = prim["attributes"]
            pos = g.accessor(attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                idx = g.accessor(prim["indices"]).astype(np.int32).reshape(-1)
            else:
                idx = np.arange(len(pos), dtype=np.int32)
            nrm = (
                g.accessor(attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs else None
            )
            tan = (
                g.accessor(attrs["TANGENT"]).astype(np.float32)
                if "TANGENT" in attrs else None
            )
            uv = (
                g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs else None
            )
            col = None
            if "COLOR_0" in attrs:
                col = g.accessor(attrs["COLOR_0"]).astype(np.float32)
                if col.shape[1] == 3:
                    col = np.concatenate(
                        [col, np.ones((len(col), 1), np.float32)], axis=1
                    )
            sid = scene.meshes.add_mesh(pos, idx, nrm, tan, uv, col)
            mat = mat_map[prim["material"]] if "material" in prim else default_mat()
            prims.append((sid, mat))
        prim_meshes.append(prims)

    # Node hierarchy -> primitives with world transforms (gltf_model.cpp:96-139).
    nodes = g.json.get("nodes", [])
    scene_def = g.json.get("scenes", [{}])[g.json.get("scene", 0)]

    def walk(node_index: int, parent: np.ndarray):
        node = nodes[node_index]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            for sid, mat in prim_meshes[node["mesh"]]:
                scene.add_primitive(sid, mat, world.astype(np.float32))
        for child in node.get("children", []):
            walk(child, world)

    for root in scene_def.get("nodes", []):
        walk(root, np.eye(4))
    return scene
