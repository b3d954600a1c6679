"""RenderScene — the primitive pool + sun owner, and its device-side tensors.

Mirrors the reference's RenderScene (render_scene.hpp:22-124) as the JAX package's
scene/scene.py does: ``build()`` bakes the scene in numpy into ``SceneArrays``, a
NamedTuple of tensors on one device. Primitive transforms are folded into
world-space vertex arrays, triangle-level tables carry material/primitive ids,
and every axis is padded. The bake is the JAX package's, line for line, so both
renderers read identical arrays; ``scene_arrays_from_numpy`` carries an array
set baked elsewhere into this package. ``with_bvh`` builds the ray tracer's
BVH over every triangle (blend curtains included, as opaque) with the native
builder where it can run (``native.py``), and packs its traversal rows; without
it the scene carries the JAX bake's one-node empty BVH.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from androidrenderer_tpu_torch import init_device, native
from androidrenderer_tpu_torch.ops.rt.traverse import (
    BVH_FIELDS, DeviceBVH, empty_device_bvh, pack_node_rows, with_kernel_layout,
)
from androidrenderer_tpu_torch.scene.material_storage import (
    START_ALIGN,
    MaterialStorage,
)
from androidrenderer_tpu_torch.scene.mesh_storage import MAX_POINT_CLOUD_POINTS, MeshStorage
from androidrenderer_tpu_torch.scene.proxy import ProxyMesh, build_proxy_arrays


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if a.shape[0] >= n:
        return a[:n]
    pad = np.full((n - a.shape[0], *a.shape[1:]), fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bake_tri_consts(tri_material, mat_params, tex_start, tex_log2b):
    """(N, 12) per-triangle material constants in pack_attribute_planes'
    channel order: base(3) metal(1) rough(1) emission(3) packed_tex(4)."""
    m = np.asarray(tri_material)
    tex_ids = np.asarray(mat_params["entry_ids"])[m]  # (N, 4)
    packed = (
        np.asarray(tex_start)[tex_ids] // START_ALIGN
    ) * 16 + np.asarray(tex_log2b)[tex_ids]
    return np.concatenate(
        [
            np.asarray(mat_params["base_color_factor"])[m][:, :3],
            np.asarray(mat_params["metal_rough_factor"])[m],
            np.asarray(mat_params["emission_factor"])[m],
            packed.astype(np.float32),
        ],
        axis=1,
    ).astype(np.float32)


class SceneArrays(NamedTuple):
    """Device-resident scene (field-for-field the JAX package's SceneArrays)."""

    positions: torch.Tensor  # (V, 3) f32
    normals: torch.Tensor  # (V, 3) f32
    tangents: torch.Tensor  # (V, 4) f32
    uvs: torch.Tensor  # (V, 2) f32
    colors: torch.Tensor  # (V, 4) f32
    tri_indices: torch.Tensor  # (N, 3) i32
    tri_material: torch.Tensor  # (N,) i32
    tri_primitive: torch.Tensor  # (N,) i32
    tri_double_sided: torch.Tensor  # (N,) bool
    tri_alpha_mode: torch.Tensor  # (N,) i32 (0 opaque / 1 mask / 2 blend)
    # Per-triangle 16x16 barycentric alpha-test bitmap (8 x u32 as i32): bit
    # (v*16+u) = alpha(lam1=(u+.5)/16, lam2=(v+.5)/16) >= cutoff; all-ones for
    # non-masked triangles. The rasterizer tests it in flight.
    tri_alpha_grid: torch.Tensor  # (N, 8) i32
    tri_valid: torch.Tensor  # (N,) bool
    tri_corner_pos: torch.Tensor  # (N, 3, 3) f32 world corners
    # Attribute corners (uv 2, normal 3, tangent 4, color 3, position 3, pad 1)
    # and material constants (base 3, metal 1, rough 1, emission 3, tex 4).
    tri_attr_corners: torch.Tensor  # (N, 3, 16) f32
    tri_consts: torch.Tensor  # (N, 12) f32
    prim_bounds: torch.Tensor  # (P, 4) f32
    prim_tri_range: torch.Tensor  # (P, 2) i32
    prim_valid: torch.Tensor  # (P,) bool
    mat_base_color: torch.Tensor  # (M, 4) f32
    mat_metal_rough: torch.Tensor  # (M, 2) f32
    mat_emission: torch.Tensor  # (M, 3) f32
    mat_texture_ids: torch.Tensor  # (M, 4) i32 pool-entry slots
    mat_alpha: torch.Tensor  # (M, 2) f32 [mode, cutoff]
    mat_double_sided: torch.Tensor  # (M,) bool
    # Material-triple texel pool (R, 117) u8 (material_storage.pack_texture_pool).
    textures: torch.Tensor
    tex_start: torch.Tensor  # (E,) i32
    tex_log2b: torch.Tensor  # (E,) i32
    sun_direction: torch.Tensor  # (3,) f32 — direction the light TRAVELS
    sun_color: torch.Tensor  # (3,) f32
    sun_angular_size: torch.Tensor  # () f32
    emissive_points: torch.Tensor  # (K, 9) f32
    emissive_point_count: torch.Tensor  # () i32
    # The ray tracer's BVH (ops/rt/traverse.py); None when the arrays were
    # carried in without one (no ``bvh.<field>`` leaves).
    bvh: DeviceBVH | None
    proxy: ProxyMesh


@dataclasses.dataclass
class Primitive:
    mesh_id: int
    material_id: int
    transform: np.ndarray  # (4, 4) model -> world


ALPHA_GRID_RES = 16  # barycentric alpha-bitmap lattice (16x16 = 8 u32 words)


def _bake_alpha_grids(alpha_modes, tri_mat, tri_indices, uvs, mat_params, images):
    """(N, 8) i32 alpha-test bitmaps (see SceneArrays.tri_alpha_grid)."""
    n = tri_indices.shape[0]
    grids = np.full((n, 8), -1, np.int64)  # all bits set (opaque)
    masked = np.nonzero(alpha_modes == 1)[0]
    if masked.size == 0:
        return grids.astype(np.int32)
    g = ALPHA_GRID_RES
    l1 = (np.arange(g) + 0.5) / g
    l2 = (np.arange(g) + 0.5) / g
    L1, L2 = np.meshgrid(l1, l2)  # (g, g): rows = lam2 (v), cols = lam1 (u)
    L0 = 1.0 - L1 - L2
    tex_ids = mat_params["texture_ids"][:, 0]
    cutoffs = mat_params["alpha"][:, 1]
    afac = mat_params["base_color_factor"][:, 3]
    word_weights = (np.int64(1) << np.arange(32, dtype=np.int64))[None, None, :]
    masked_tex = tex_ids[tri_mat[masked]]
    for ti in np.unique(masked_tex):
        sel_all = masked[masked_tex == ti]
        img = images[ti]
        size = img.shape[0]
        a = img[..., 3].astype(np.float64) / 255.0
        aflat = np.ascontiguousarray(a.reshape(-1))
        for s0 in range(0, sel_all.size, 2048):  # chunked: keeps taps in cache
            sel = sel_all[s0 : s0 + 2048]
            tri = tri_indices[sel]  # (M, 3)
            uv = (
                L0[None, ..., None] * uvs[tri[:, 0], None, None, :]
                + L1[None, ..., None] * uvs[tri[:, 1], None, None, :]
                + L2[None, ..., None] * uvs[tri[:, 2], None, None, :]
            )  # (M, g, g, 2)
            x = uv[..., 0] * size - 0.5
            y = uv[..., 1] * size - 0.5
            x0 = np.floor(x).astype(np.int64)
            y0 = np.floor(y).astype(np.int64)
            fx = x - x0
            fy = y - y0

            def tap(yy, xx):
                # Textures are power-of-two square: wrap via mask, flat gather.
                return aflat[((yy & (size - 1)) << size.bit_length() - 1)
                             + (xx & (size - 1))]

            al = (
                tap(y0, x0) * (1 - fx) * (1 - fy)
                + tap(y0, x0 + 1) * fx * (1 - fy)
                + tap(y0 + 1, x0) * (1 - fx) * fy
                + tap(y0 + 1, x0 + 1) * fx * fy
            ) * afac[tri_mat[sel], None, None]
            bits = al >= cutoffs[tri_mat[sel], None, None]  # (M, g, g)
            # idx = v*16 + u: flatten (g, g) -> 256 bits -> 8 u32 words.
            words = (
                (bits.reshape(len(sel), 8, 32) * word_weights).sum(axis=2)
            )
            grids[sel] = np.where(words >= 2**31, words - 2**32, words)
    return grids.astype(np.int32)


def _canonical(a) -> np.ndarray:
    """numpy array with 64-bit types narrowed to 32 bits — the dtypes the JAX
    package's arrays have (JAX runs without 64-bit mode)."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(_canonical(a), order="C")).to(device)


class RenderScene:
    """Host-side scene builder."""

    def __init__(
        self,
        meshes: MeshStorage | None = None,
        materials: MaterialStorage | None = None,
        max_primitives: int = 65536,
    ):
        self.meshes = meshes or MeshStorage()
        self.materials = materials or MaterialStorage()
        self.max_primitives = max_primitives
        self.primitives: List[Primitive] = []
        self.sun_direction = np.array([0.1, -1.0, 0.3], dtype=np.float32)
        self.sun_color = np.array([1.0, 1.0, 1.0], dtype=np.float32) * 110_000.0
        self.sun_angular_size = 0.00918  # tan(~0.526 deg), solar disc

    def add_primitive(self, mesh_id: int, material_id: int, transform=None) -> int:
        if len(self.primitives) >= self.max_primitives:
            raise RuntimeError("primitive pool exhausted (65536 slots)")
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        self.primitives.append(
            Primitive(mesh_id, material_id, np.asarray(transform, np.float32))
        )
        return len(self.primitives) - 1

    def set_sun(self, direction, color, intensity: float = 1.0) -> None:
        d = np.asarray(direction, np.float64)
        self.sun_direction = (d / np.linalg.norm(d)).astype(np.float32)
        self.sun_color = (np.asarray(color, np.float32) * intensity).astype(np.float32)

    # ------------------------------------------------------------------ build
    def bake(self, pad: int = 512, with_bvh: bool = True,
             proxy_cell_size: float = 0.25) -> Tuple[Dict, dict]:
        """Bake to numpy: (leaves, stats). ``leaves`` maps each SceneArrays field
        (proxy and BVH fields as ``proxy.<name>`` and ``bvh.<name>``) to its
        array. With ``with_bvh`` the stats name the BVH builder that ran
        (``bvh_builder``) and its seconds (``bvh_s``)."""
        all_pos, all_nrm, all_tan, all_uv, all_col, all_vp = [], [], [], [], [], []
        all_tri, all_mat, all_prim, all_dbl, all_alpha = [], [], [], [], []
        prim_bounds, prim_range = [], []
        vtx_base = 0

        mat_params = self.materials.pack_parameters()
        for pid, prim in enumerate(self.primitives):
            mesh = self.meshes.meshes[prim.mesh_id]
            s, e = mesh.first_vertex, mesh.first_vertex + mesh.num_vertices
            m = prim.transform.astype(np.float64)
            pos = self.meshes.positions[s:e].astype(np.float64)
            wpos = pos @ m[:3, :3].T + m[:3, 3]
            # Normal matrix = inverse transpose of upper 3x3.
            nmat = np.linalg.inv(m[:3, :3]).T
            nrm = self.meshes.normals[s:e].astype(np.float64) @ nmat.T
            nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
            tan = self.meshes.tangents[s:e].astype(np.float64)
            tan_w = tan[:, 3:4]
            tan_xyz = tan[:, :3] @ m[:3, :3].T
            tl = np.linalg.norm(tan_xyz, axis=1, keepdims=True)
            tan_xyz = np.where(tl > 1e-12, tan_xyz / np.maximum(tl, 1e-12), tan_xyz)

            all_pos.append(wpos.astype(np.float32))
            all_nrm.append(nrm.astype(np.float32))
            all_tan.append(np.concatenate([tan_xyz, tan_w], axis=1).astype(np.float32))
            all_uv.append(self.meshes.uvs[s:e])
            all_col.append(self.meshes.colors[s:e])
            all_vp.append(np.full(mesh.num_vertices, pid, np.int32))

            tris = self.meshes.mesh_triangles(prim.mesh_id) - mesh.first_vertex + vtx_base
            ntri = tris.shape[0]
            first_tri = sum(t.shape[0] for t in all_tri)
            all_tri.append(tris)
            all_mat.append(np.full(ntri, prim.material_id, np.int32))
            all_prim.append(np.full(ntri, pid, np.int32))
            mat = self.materials.materials[prim.material_id]
            all_dbl.append(np.full(ntri, mat.double_sided, bool))
            all_alpha.append(np.full(ntri, mat.alpha_mode, np.int32))

            # World bounding sphere (max singular value covers non-uniform scale).
            c = mesh.bounds_sphere[:3].astype(np.float64)
            r = float(mesh.bounds_sphere[3])
            wc = m[:3, :3] @ c + m[:3, 3]
            scale = np.linalg.svd(m[:3, :3], compute_uv=False)[0]
            prim_bounds.append(np.array([*wc, r * scale], np.float32))
            prim_range.append(np.array([first_tri, ntri], np.int32))
            vtx_base += mesh.num_vertices

        if not all_pos:
            raise RuntimeError("empty scene")

        positions = np.concatenate(all_pos)
        tri_indices = np.concatenate(all_tri)
        nv, nt = positions.shape[0], tri_indices.shape[0]
        npr = len(self.primitives)
        pv, pt, pp = _round_up(nv, pad), _round_up(nt, pad), _round_up(npr, 64)

        tex_pool, tex_start, tex_log2b = self.materials.pack_texture_pool()

        # Emissive surface point clouds for GI mesh lights (render_scene.cpp:257-310).
        emissive_samples = []
        rng = np.random.default_rng(7)
        for prim in self.primitives:
            mat = self.materials.materials[prim.material_id]
            if np.any(np.asarray(mat.emission_factor) > 0.0):
                pts = self.meshes.sample_surface_points(prim.mesh_id, rng)
                if pts.shape[0] == 0:
                    continue
                m = prim.transform.astype(np.float64)
                wp = pts[:, :3] @ m[:3, :3].T + m[:3, 3]
                nmat = np.linalg.inv(m[:3, :3]).T
                wn = pts[:, 3:6] @ nmat.T
                wn /= np.maximum(np.linalg.norm(wn, axis=1, keepdims=True), 1e-12)
                rad = np.tile(mat.emission_factor, (pts.shape[0], 1))
                emissive_samples.append(
                    np.concatenate([wp, wn, rad], axis=1).astype(np.float32)
                )
        if emissive_samples:
            epts = np.concatenate(emissive_samples)[:MAX_POINT_CLOUD_POINTS]
            ecount = epts.shape[0]
            epts = _pad_rows(epts, _round_up(max(ecount, 1), 256))
        else:
            epts = np.zeros((1, 9), np.float32)
            ecount = 0

        alpha_grid = _bake_alpha_grids(
            np.concatenate(all_alpha), np.concatenate(all_mat), tri_indices,
            np.concatenate(all_uv), mat_params, self.materials._images,
        )

        proxy, self.proxy_host = build_proxy_arrays(
            positions, np.concatenate(all_nrm), np.concatenate(all_uv),
            np.concatenate(all_col), np.concatenate(all_vp), tri_indices,
            np.concatenate(all_mat), np.concatenate(all_dbl),
            cell_size=proxy_cell_size,
        )
        proxy["consts"] = _bake_tri_consts(
            proxy["tri_material"], mat_params, tex_start, tex_log2b,
        )
        tri_pad = _pad_rows(tri_indices, pt)
        leaves = dict(
            positions=_pad_rows(positions, pv),
            normals=_pad_rows(np.concatenate(all_nrm), pv),
            tangents=_pad_rows(np.concatenate(all_tan), pv),
            uvs=_pad_rows(np.concatenate(all_uv), pv),
            colors=_pad_rows(np.concatenate(all_col), pv, fill=1),
            tri_indices=tri_pad,
            tri_material=_pad_rows(np.concatenate(all_mat), pt),
            tri_primitive=_pad_rows(np.concatenate(all_prim), pt),
            tri_double_sided=_pad_rows(np.concatenate(all_dbl), pt),
            tri_alpha_mode=_pad_rows(np.concatenate(all_alpha), pt),
            tri_alpha_grid=_pad_rows(alpha_grid, pt, fill=-1),
            tri_valid=_pad_rows(np.ones(nt, dtype=bool), pt, fill=False),
            tri_corner_pos=_pad_rows(positions, pv)[tri_pad],
            tri_attr_corners=_pad_rows(
                np.concatenate(
                    [
                        np.concatenate(all_uv),
                        np.concatenate(all_nrm),
                        np.concatenate(all_tan),
                        np.concatenate(all_col)[:, :3],
                        positions,
                        np.zeros((nv, 1), np.float32),
                    ],
                    axis=1,
                ).astype(np.float32),
                pv,
            )[tri_pad],
            tri_consts=_bake_tri_consts(
                _pad_rows(np.concatenate(all_mat), pt),
                mat_params, tex_start, tex_log2b,
            ),
            prim_bounds=_pad_rows(np.stack(prim_bounds), pp),
            prim_tri_range=_pad_rows(np.stack(prim_range), pp),
            prim_valid=_pad_rows(np.ones(npr, dtype=bool), pp, fill=False),
            mat_base_color=mat_params["base_color_factor"],
            mat_metal_rough=mat_params["metal_rough_factor"],
            mat_emission=mat_params["emission_factor"],
            mat_texture_ids=mat_params["entry_ids"],
            mat_alpha=mat_params["alpha"],
            mat_double_sided=mat_params["double_sided"],
            textures=tex_pool,
            tex_start=tex_start,
            tex_log2b=tex_log2b,
            sun_direction=self.sun_direction,
            sun_color=self.sun_color,
            sun_angular_size=np.float32(self.sun_angular_size),
            emissive_points=epts,
            emissive_point_count=np.int32(ecount),
        )
        leaves.update({f"proxy.{k}": v for k, v in proxy.items()})
        if with_bvh:
            t0 = time.perf_counter()
            bvh_np, builder = native.build_bvh(positions, tri_indices)
            bvh_s = time.perf_counter() - t0
            device_bvh = _device_bvh(bvh_np, positions, tri_indices,
                                     np.concatenate(all_alpha), alpha_grid)
        else:
            device_bvh = empty_device_bvh("cpu")
        leaves.update({f"bvh.{f}": getattr(device_bvh, f).numpy() for f in BVH_FIELDS})
        stats = {
            "num_vertices": nv,
            "num_triangles": nt,
            "num_primitives": npr,
            "num_materials": len(self.materials.materials),
            "num_textures": self.materials.num_textures,
            "num_masked_triangles": int((np.concatenate(all_alpha) == 1).sum()),
            "num_blend_triangles": int((np.concatenate(all_alpha) == 2).sum()),
            "num_proxy_triangles": int(self.proxy_host["num_triangles"]),
        }
        if with_bvh:
            stats.update(bvh_builder=builder, bvh_s=bvh_s)
        return leaves, stats

    def build(
        self, device="cuda", pad: int = 512, with_bvh: bool = True,
        proxy_cell_size: float = 0.25,
    ) -> Tuple[SceneArrays, dict]:
        """Bake and upload: (SceneArrays on ``device``, stats). The card unless
        the caller asks for the CPU."""
        dev = init_device(device)  # raises before the bake when there is no card
        leaves, stats = self.bake(pad=pad, with_bvh=with_bvh, proxy_cell_size=proxy_cell_size)
        return scene_arrays_from_numpy(leaves, dev), stats


def _device_bvh(bvh_np, positions, tri_indices, tri_alpha_mode, alpha_grid) -> DeviceBVH:
    """The JAX bake's BVH block, on the CPU: slot-ordered Moller-Trumbore tables
    (dead slots zeroed), per-slot opacity (mask mode != 1) and alpha bitmaps
    (-1 for dead slots), packed into the traversal rows."""
    slots = bvh_np.tri_order
    safe = np.maximum(slots, 0)
    t0 = positions[tri_indices[safe, 0]]
    t1 = positions[tri_indices[safe, 1]]
    t2 = positions[tri_indices[safe, 2]]
    dead = (slots < 0)[:, None]
    slot_v0 = np.where(dead, 0.0, t0).astype(np.float32)
    slot_e1 = np.where(dead, 0.0, t1 - t0).astype(np.float32)
    slot_e2 = np.where(dead, 0.0, t2 - t0).astype(np.float32)
    slot_opaque = np.where(slots >= 0, tri_alpha_mode[safe] != 1, True)
    slot_grid = np.where(slots[:, None] >= 0, alpha_grid[safe], -1).astype(np.int32)
    nodes = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        bvh_np.node_min, bvh_np.node_max, bvh_np.node_miss, bvh_np.node_first,
        bvh_np.node_count)]
    tables = [torch.from_numpy(a) for a in (slot_v0, slot_e1, slot_e2)]
    rows = pack_node_rows(*nodes, *tables, torch.from_numpy(slot_opaque),
                          slot_alpha_grid=torch.from_numpy(slot_grid))
    return DeviceBVH(*nodes, torch.from_numpy(slots.astype(np.int32)), *tables, rows)


def scene_arrays_from_numpy(leaves: Dict[str, np.ndarray], device) -> SceneArrays:
    """SceneArrays on ``device`` from a flat dict of numpy arrays keyed by field
    name (``proxy.<name>`` for the proxy mesh, ``bvh.<name>`` for the BVH; with
    no ``bvh.`` keys ``bvh`` is None; the traversal kernel's layout of the BVH
    is built on ``device``). 64-bit arrays are narrowed to 32 bits, as the JAX
    package stores them."""
    dev = init_device(device)
    proxy = ProxyMesh(
        **{f: _tensor(leaves[f"proxy.{f}"], dev) for f in ProxyMesh._fields}
    )
    bvh = None
    if any(k.startswith("bvh.") for k in leaves):
        bvh = with_kernel_layout(
            DeviceBVH(**{f: _tensor(leaves[f"bvh.{f}"], dev) for f in BVH_FIELDS}))
    fields = {
        f: _tensor(leaves[f], dev)
        for f in SceneArrays._fields if f not in ("bvh", "proxy")
    }
    return SceneArrays(**fields, bvh=bvh, proxy=proxy)


def scene_arrays_to_numpy(scene: SceneArrays) -> Dict[str, np.ndarray]:
    """Inverse of ``scene_arrays_from_numpy``: the flat dict of host arrays."""
    out = {
        f: getattr(scene, f).cpu().numpy()
        for f in SceneArrays._fields if f not in ("bvh", "proxy")
    }
    out.update({f"proxy.{f}": getattr(scene.proxy, f).cpu().numpy()
                for f in ProxyMesh._fields})
    if scene.bvh is not None:
        out.update({f"bvh.{f}": getattr(scene.bvh, f).cpu().numpy() for f in BVH_FIELDS})
    return out
