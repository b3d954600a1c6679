# Frozen copy of androidrenderer_tpu_torch/scene/proxy.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed only.
"""Proxy (vertex-clustered) meshes for the far shadow cascades and the LPV's RSMs.

Far cascades cover 32-128 m, where one shadow texel is wider than the proxy's
0.25 m cluster cell, so they rasterize this decimated copy of the scene instead
of full geometry, as do the LPV's 128^2 reflective shadow maps through
``swap_in_proxy`` (the JAX package's scene/proxy.py; the divergence from the
reference renderer is documented in docs/PARITY.md).

Vertex clustering (Rossignac-Borrel): snap vertices to a uniform grid of
``cell_size`` meters (keyed per-primitive), collapse each cell to its mean
vertex, drop degenerate triangles, and dedupe collapsed duplicates. The bake is
numpy, identical to the JAX package's; the result is a ``ProxyMesh`` of tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ProxyMesh(NamedTuple):
    """Decimated geometry on the scene's device (padded static shapes)."""

    positions: torch.Tensor  # (Vp, 3) f32 world
    normals: torch.Tensor  # (Vp, 3) f32 (cluster mean, normalized)
    uvs: torch.Tensor  # (Vp, 2) f32
    colors: torch.Tensor  # (Vp, 4) f32
    vertex_prim: torch.Tensor  # (Vp,) i32 owning primitive
    tri_indices: torch.Tensor  # (Np, 3) i32
    tri_material: torch.Tensor  # (Np,) i32
    tri_double_sided: torch.Tensor  # (Np,) bool
    tri_valid: torch.Tensor  # (Np,) bool
    corners: torch.Tensor  # (Np, 3, 3) f32 baked per-triangle corners
    attr_corners: torch.Tensor  # (Np, 3, 16) f32 (SceneArrays' channel order)
    consts: torch.Tensor  # (Np, 12) f32 material constants


def _pad(a: np.ndarray, rows: int, fill=0):
    out = np.full((rows, *a.shape[1:]), fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def build_proxy_arrays(
    positions: np.ndarray,  # (V, 3) world
    normals: np.ndarray,  # (V, 3)
    uvs: np.ndarray,  # (V, 2)
    colors: np.ndarray,  # (V, 4)
    vertex_prim: np.ndarray,  # (V,) i32
    tri_indices: np.ndarray,  # (N, 3) i32
    tri_material: np.ndarray,  # (N,) i32
    tri_double_sided: np.ndarray,  # (N,) bool
    cell_size: float = 0.25,
    pad: int = 512,
):
    """Vertex-cluster decimation in numpy: (dict of ProxyMesh fields as numpy
    arrays, with ``consts`` left to the scene bake, and the host mapping)."""
    cells = np.floor(positions.astype(np.float64) / cell_size).astype(np.int64)
    key = np.concatenate(
        [vertex_prim.astype(np.int64)[:, None], cells], axis=1
    )  # (V, 4)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    vp = uniq.shape[0]

    def mean_per_cluster(vals):
        acc = np.zeros((vp, vals.shape[1]), np.float64)
        np.add.at(acc, inv, vals.astype(np.float64))
        cnt = np.zeros((vp,), np.float64)
        np.add.at(cnt, inv, 1.0)
        return (acc / np.maximum(cnt[:, None], 1.0)).astype(np.float32)

    p_pos = mean_per_cluster(positions)
    p_nrm = mean_per_cluster(normals)
    nl = np.linalg.norm(p_nrm, axis=1, keepdims=True)
    p_nrm = np.where(nl > 1e-6, p_nrm / np.maximum(nl, 1e-12), [0.0, 1.0, 0.0])
    p_uv = mean_per_cluster(uvs)
    p_col = mean_per_cluster(colors)
    p_prim = uniq[:, 0].astype(np.int32)

    ptri = inv[tri_indices]  # (N, 3) cluster ids
    nondegen = (
        (ptri[:, 0] != ptri[:, 1])
        & (ptri[:, 1] != ptri[:, 2])
        & (ptri[:, 0] != ptri[:, 2])
    )
    ptri = ptri[nondegen]
    pmat = tri_material[nondegen]
    pdbl = tri_double_sided[nondegen]
    # Dedupe exact collapsed duplicates (winding preserved — no vertex sorting).
    tkey = np.concatenate([ptri, pmat[:, None]], axis=1)
    _, first = np.unique(tkey, axis=0, return_index=True)
    first = np.sort(first)
    ptri, pmat, pdbl = ptri[first], pmat[first], pdbl[first]
    np_tris = ptri.shape[0]

    vp_pad = max(-(-vp // pad) * pad, pad)
    nt_pad = max(-(-np_tris // pad) * pad, pad)
    host = {
        "inv": inv,
        "num_clusters": vp,
        "padded_vertices": vp_pad,
        "num_triangles": np_tris,
    }
    ptri_pad = _pad(ptri.astype(np.int32), nt_pad)
    arrays = dict(
        positions=_pad(p_pos, vp_pad),
        normals=_pad(p_nrm, vp_pad),
        uvs=_pad(p_uv, vp_pad),
        colors=_pad(p_col, vp_pad, fill=1),
        vertex_prim=_pad(p_prim, vp_pad),
        tri_indices=ptri_pad,
        tri_material=_pad(pmat.astype(np.int32), nt_pad),
        tri_double_sided=_pad(pdbl, nt_pad, fill=False),
        tri_valid=_pad(np.ones(np_tris, dtype=bool), nt_pad, fill=False),
        corners=_pad(p_pos, vp_pad)[ptri_pad],
        attr_corners=_pad(
            np.concatenate(
                [
                    p_uv,
                    p_nrm,
                    np.zeros((vp, 4), np.float32),
                    p_col[:, :3],
                    p_pos,
                    np.zeros((vp, 1), np.float32),
                ],
                axis=1,
            ).astype(np.float32),
            vp_pad,
        )[ptri_pad],
    )
    return arrays, host


def swap_in_proxy(scene):
    """SceneArrays view whose GEOMETRY fields are the proxy's.

    Raster + resolve paths (the LPV's reflective shadow maps) consume the result
    exactly like a full scene: materials, textures and sun pass through
    untouched. Tangents are zeroed (proxy resolves never normal-map), alpha
    modes are opaque (masked geometry is solid in the proxy) and every alpha
    bitmap is all ones; each new tensor has the scene's dtype and device."""
    p = scene.proxy
    vp = p.positions.shape[0]
    nt = p.tri_indices.shape[0]
    dev = p.positions.device
    return scene._replace(
        positions=p.positions,
        normals=p.normals,
        tangents=torch.zeros((vp, 4), dtype=scene.tangents.dtype, device=dev),
        uvs=p.uvs,
        colors=p.colors,
        tri_indices=p.tri_indices,
        tri_material=p.tri_material,
        tri_primitive=torch.zeros((nt,), dtype=scene.tri_primitive.dtype, device=dev),
        tri_double_sided=p.tri_double_sided,
        tri_alpha_mode=torch.zeros((nt,), dtype=scene.tri_alpha_mode.dtype, device=dev),
        tri_alpha_grid=torch.full((nt, 8), -1, dtype=scene.tri_alpha_grid.dtype, device=dev),
        tri_valid=p.tri_valid,
        tri_corner_pos=p.corners,
        tri_attr_corners=p.attr_corners,
        tri_consts=p.consts,
    )
