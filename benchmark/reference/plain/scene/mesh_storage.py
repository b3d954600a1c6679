# Frozen copy of androidrenderer_tpu_torch/scene/mesh_storage.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed only.
"""MeshStorage — pooled vertex/index mega-buffers (host side, numpy).

Mirrors the reference's MeshStorage (mesh_storage.cpp:24-508): one global
position pool split SoA from the other vertex attributes (positions vs
normal/tangent/uv/color — the same split the reference uses for its depth-only passes),
one index pool, bump-allocated; per-mesh draw records; bounding spheres; and
area-weighted surface point-cloud sampling (mesh_storage.cpp:246-319, used for mesh
lights / LPV geometry volume injection).

Capacities default to the reference's desktop budget scale (mesh_storage.cpp:14-20).
Device upload happens once in RenderScene.build() — the arrays here are plain numpy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# Point cloud sampling density: 1 sample per 0.1 m^2 of surface, max 65536 points
# (mesh_storage.cpp:291-319).
POINT_CLOUD_AREA_PER_SAMPLE = 0.1
MAX_POINT_CLOUD_POINTS = 65536


@dataclasses.dataclass
class MeshInfo:
    first_vertex: int
    num_vertices: int
    first_index: int
    num_indices: int
    bounds_sphere: np.ndarray  # (4,) [cx, cy, cz, radius] in object space


class MeshStorage:
    def __init__(self, max_vertices: int = 4_000_000, max_indices: int = 12_000_000):
        self.max_vertices = max_vertices
        self.max_indices = max_indices
        self.positions = np.zeros((0, 3), dtype=np.float32)
        self.normals = np.zeros((0, 3), dtype=np.float32)
        self.tangents = np.zeros((0, 4), dtype=np.float32)
        self.uvs = np.zeros((0, 2), dtype=np.float32)
        self.colors = np.zeros((0, 4), dtype=np.float32)
        self.indices = np.zeros((0,), dtype=np.int32)
        self.meshes: List[MeshInfo] = []

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_indices(self) -> int:
        return self.indices.shape[0]

    def add_mesh(
        self,
        positions: np.ndarray,  # (v, 3)
        indices: np.ndarray,  # (i,) — triangle list, local indices
        normals: Optional[np.ndarray] = None,
        tangents: Optional[np.ndarray] = None,
        uvs: Optional[np.ndarray] = None,
        colors: Optional[np.ndarray] = None,
    ) -> int:
        positions = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
        indices = np.asarray(indices, dtype=np.int32).reshape(-1)
        v = positions.shape[0]
        if indices.size % 3 != 0:
            raise ValueError("index count must be a multiple of 3")
        if self.num_vertices + v > self.max_vertices:
            raise RuntimeError("vertex pool exhausted")
        if self.num_indices + indices.size > self.max_indices:
            raise RuntimeError("index pool exhausted")

        if normals is None:
            normals = _compute_vertex_normals(positions, indices)
        if tangents is None:
            if uvs is not None:
                tangents = _compute_vertex_tangents(
                    positions, np.asarray(normals, np.float32),
                    np.asarray(uvs, np.float32), indices,
                )
            else:
                tangents = np.zeros((v, 4), dtype=np.float32)
                tangents[:, 0] = 1.0
                tangents[:, 3] = 1.0
        if uvs is None:
            uvs = np.zeros((v, 2), dtype=np.float32)
        if colors is None:
            colors = np.ones((v, 4), dtype=np.float32)

        first_vertex = self.num_vertices
        first_index = self.num_indices
        self.positions = np.concatenate([self.positions, positions])
        self.normals = np.concatenate([self.normals, np.asarray(normals, np.float32).reshape(-1, 3)])
        self.tangents = np.concatenate([self.tangents, np.asarray(tangents, np.float32).reshape(-1, 4)])
        self.uvs = np.concatenate([self.uvs, np.asarray(uvs, np.float32).reshape(-1, 2)])
        self.colors = np.concatenate([self.colors, np.asarray(colors, np.float32).reshape(-1, 4)])
        self.indices = np.concatenate([self.indices, indices])

        center = 0.5 * (positions.min(axis=0) + positions.max(axis=0))
        radius = float(np.linalg.norm(positions - center, axis=1).max()) if v else 0.0
        self.meshes.append(
            MeshInfo(
                first_vertex=first_vertex,
                num_vertices=v,
                first_index=first_index,
                num_indices=int(indices.size),
                bounds_sphere=np.array([*center, radius], dtype=np.float32),
            )
        )
        return len(self.meshes) - 1

    def mesh_triangles(self, mesh_id: int) -> np.ndarray:
        """(n, 3) global vertex indices for a mesh."""
        m = self.meshes[mesh_id]
        idx = self.indices[m.first_index : m.first_index + m.num_indices]
        return (idx.reshape(-1, 3) + m.first_vertex).astype(np.int32)

def _compute_vertex_tangents(
    positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray,
    indices: np.ndarray,
) -> np.ndarray:
    """UV-aligned smooth tangents (xyz + handedness w) for meshes authored
    without a TANGENT stream — the standard per-triangle UV-gradient
    accumulation (what gltfpack/MikkTSpace produce up to smoothing details).
    Needed for normal mapping: a constant fallback tangent degenerates on
    faces whose normal is parallel to it."""
    v = positions.shape[0]
    tris = indices.reshape(-1, 3)
    p0, p1, p2 = (positions[tris[:, k]] for k in range(3))
    u0, u1, u2 = (uvs[tris[:, k]] for k in range(3))
    e1, e2 = p1 - p0, p2 - p0
    d1, d2 = u1 - u0, u2 - u0
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    t = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
    b = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r[:, None]
    acc_t = np.zeros((v, 3), np.float64)
    acc_b = np.zeros((v, 3), np.float64)
    for k in range(3):
        np.add.at(acc_t, tris[:, k], t)
        np.add.at(acc_b, tris[:, k], b)
    n = normals.astype(np.float64)
    # Gram-Schmidt against the vertex normal.
    tang = acc_t - n * np.sum(acc_t * n, axis=1, keepdims=True)
    ln = np.linalg.norm(tang, axis=1, keepdims=True)
    bad = ln[:, 0] < 1e-8
    # Degenerate UVs: any stable perpendicular to n.
    alt = np.cross(n, np.array([0.0, 1.0, 0.0]))
    alt2 = np.cross(n, np.array([1.0, 0.0, 0.0]))
    alt = np.where(np.linalg.norm(alt, axis=1, keepdims=True) > 1e-6, alt, alt2)
    tang = np.where(bad[:, None], alt, tang / np.where(ln < 1e-8, 1, ln))
    tang /= np.maximum(np.linalg.norm(tang, axis=1, keepdims=True), 1e-12)
    w = np.where(np.sum(np.cross(n, tang) * acc_b, axis=1) < 0.0, -1.0, 1.0)
    return np.concatenate([tang, w[:, None]], axis=1).astype(np.float32)


