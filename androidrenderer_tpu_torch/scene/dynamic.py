"""Dynamic scenes — per-frame primitive transforms with BVH refit.

The port of the JAX package's scene/dynamic.py. The reference updates
primitives per frame through scatter uploads and rebuilds the TLAS when dirty
(render_scene.cpp:90-106, scatter_upload_buffer.hpp:16-33,
raytracing_scene.cpp:50-170). Here the update is a function of tensors on the
scene's device:

    scene2 = update_primitive_transforms(scene, dyn, transforms)

re-derives every transform-dependent tensor from baked OBJECT-space data —
world vertices/normals/tangents (per-vertex multiply-adds against
per-primitive matrices), primitive bounding spheres (conservative Frobenius
scale bound), the proxy mesh, the corner tables, and the RT BVH via a REFIT:
the skip-link BVH's topology (a complete tree over the builder's leaf order) is
static, so only node AABBs and the slot triangle data recompute — bottom-up
level reductions written into the baked preorder slots
(bvh.complete_tree_level_slots).

Refit keeps traversal CORRECT under any motion; tree QUALITY degrades if
primitives travel far from their built positions (boxes inflate). Rebuild from
the host (RenderScene.build) when the scene has deformed beyond recognition.

Nothing here waits on the device: the normal matrices come from
``torch.linalg.inv_ex`` (a singular matrix gives inf/nan, as in JAX, instead
of a host-side check), and every level write is an indexed assignment to
unique slots, deterministic on both devices. Positions, bounds, corner tables
and BVH rows are products, sums and min/max in the JAX order, so they equal
the JAX update run eagerly bit for bit; the normal matrices come from another
LAPACK (or the card's solver) and agree to float32 rounding.

Limitations (as in JAX): emissive GI point clouds stay at their baked
positions, and the leaf order is from build time.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from androidrenderer_tpu_torch.ops.rt.traverse import (
    LOOK0, OPQ0, DeviceBVH, pack_node_rows, with_kernel_layout,
)
from androidrenderer_tpu_torch.scene.bvh import FAR_SENTINEL, LEAF_SIZE, complete_tree_level_slots
from androidrenderer_tpu_torch.scene.scene import SceneArrays


class DynamicSceneData(NamedTuple):
    """Object-space source data for transform updates, on the scene's device."""

    base_positions: torch.Tensor  # (V, 3) object space
    base_normals: torch.Tensor  # (V, 3)
    base_tangents: torch.Tensor  # (V, 4)
    vertex_prim: torch.Tensor  # (V,) i32 primitive owning each vertex
    base_bounds: torch.Tensor  # (P, 4) object-space sphere [center, radius]
    level_slots: List[torch.Tensor]  # preorder slots per BVH level (static topology)
    # Object-space cluster means for the proxy mesh (scene/proxy.py). Clusters
    # never span primitives, so the mean commutes with the per-primitive affine
    # transform: world proxy vertex = M_prim @ object cluster mean, exactly the
    # world-rebuilt cluster mean.
    proxy_base_positions: torch.Tensor  # (Vp, 3)
    proxy_base_normals: torch.Tensor  # (Vp, 3)


def _xform(base: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Each row's 3x3 block times its vector, as broadcast multiply-adds."""
    return rows[:, :, 0] * base[:, 0:1] + rows[:, :, 1] * base[:, 1:2] + rows[:, :, 2] * base[:, 2:3]


def _sum_last(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right (the order of the JAX update run
    eagerly, on either device: no reduction tree)."""
    out = v[..., 0]
    for i in range(1, v.shape[-1]):
        out = out + v[..., i]
    return out


def _length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_sum_last(v * v))[..., None]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(_length(v), min=1e-12)


def _per_vertex(transforms: torch.Tensor, vertex_prim: torch.Tensor) -> torch.Tensor:
    """(V, 4, 4) each vertex's primitive transform (a flat 16-wide row gather)."""
    p = transforms.shape[0]
    return transforms.reshape(p, 16)[vertex_prim.long()].reshape(-1, 4, 4)


def update_primitive_transforms(
    scene: SceneArrays,
    dyn: DynamicSceneData,
    transforms: torch.Tensor,  # (P, 4, 4) model -> world per primitive
) -> SceneArrays:
    """New SceneArrays with every transform-dependent tensor rebuilt."""
    m = _per_vertex(transforms, dyn.vertex_prim)
    positions = _xform(dyn.base_positions, m[:, :3, :3]) + m[:, :3, 3]

    # Normal matrix = inverse-transpose of the upper 3x3, per PRIMITIVE.
    r = transforms[:, :3, :3]
    nmat = torch.linalg.inv_ex(r).inverse.transpose(1, 2)  # (P, 3, 3)
    vp = dyn.vertex_prim.long()
    normals = _unit(_xform(dyn.base_normals, nmat[vp]))
    tan_xyz = _xform(dyn.base_tangents[:, :3], m[:, :3, :3])
    tl = _length(tan_xyz)
    tan_xyz = torch.where(tl > 1e-12, tan_xyz / torch.clamp(tl, min=1e-12), tan_xyz)
    tangents = torch.cat([tan_xyz, dyn.base_tangents[:, 3:4]], dim=-1)

    # Bounding spheres: exact center transform + conservative Frobenius-norm
    # radius scale (sigma_max <= ||R||_F; a bigger sphere is never wrongly culled).
    c = dyn.base_bounds[:, :3]
    wc = (r[:, :, 0] * c[:, 0:1] + r[:, :, 1] * c[:, 1:2] + r[:, :, 2] * c[:, 2:3]
          + transforms[:, :3, 3])
    scale = torch.sqrt(_sum_last((r * r).reshape(-1, 9)))
    bounds = torch.cat([wc, (dyn.base_bounds[:, 3] * scale)[:, None]], dim=-1)
    prim_bounds = scene.prim_bounds.clone()
    n = min(bounds.shape[0], prim_bounds.shape[0])
    prim_bounds[:n] = bounds[:n]

    # Proxy geometry rides the same transforms (cluster means commute with the
    # per-primitive affine — see DynamicSceneData).
    px = scene.proxy
    pvp = px.vertex_prim.long()
    pm = _per_vertex(transforms, px.vertex_prim)
    ppos = _xform(dyn.proxy_base_positions, pm[:, :3, :3]) + pm[:, :3, 3]
    pnrm = _unit(_xform(dyn.proxy_base_normals, nmat[pvp]))
    ptri = px.tri_indices.long()
    zeros = ppos.new_zeros
    proxy = px._replace(
        positions=ppos, normals=pnrm, corners=ppos[ptri],
        # Attribute-corner refresh (uv/color static, tangents zero, constants
        # transform-invariant), as the main scene's below.
        attr_corners=torch.cat(
            [px.uvs, pnrm, zeros((ppos.shape[0], 4)), px.colors[:, :3], ppos,
             zeros((ppos.shape[0], 1))], dim=1,
        )[ptri],
    )

    tri = scene.tri_indices.long()
    bvh = refit_bvh(scene.bvh, positions, scene.tri_indices, dyn.level_slots)
    return scene._replace(
        positions=positions,
        normals=normals,
        tangents=tangents,
        prim_bounds=prim_bounds,
        bvh=bvh,
        proxy=proxy,
        # Corner tables: the per-frame raster setup and attribute planes read
        # these, so the gathers are paid here, only when transforms change.
        tri_corner_pos=positions[tri],
        tri_attr_corners=torch.cat(
            [scene.uvs, normals, tangents, scene.colors[:, :3], positions,
             positions.new_zeros((positions.shape[0], 1))], dim=1,
        )[tri],
    )


def refit_bvh(
    bvh: DeviceBVH,
    positions: torch.Tensor,
    tri_indices: torch.Tensor,
    level_slots: List[torch.Tensor],
) -> DeviceBVH:
    """Recompute node AABBs + slot triangle data for moved vertices (topology,
    miss links and leaf assignments are static — raytracing_scene refit)."""
    slots = bvh.slot_tri
    idx = tri_indices[slots.clamp(min=0).long()].long()
    t0, t1, t2 = positions[idx[:, 0]], positions[idx[:, 1]], positions[idx[:, 2]]
    dead = (slots < 0)[:, None]
    zero = torch.zeros((), dtype=positions.dtype, device=positions.device)
    inf = torch.full((), float("inf"), dtype=positions.dtype, device=positions.device)
    slot_v0 = torch.where(dead, zero, t0)
    slot_e1 = torch.where(dead, zero, t1 - t0)
    slot_e2 = torch.where(dead, zero, t2 - t0)

    tmin = torch.where(dead, inf, torch.minimum(torch.minimum(t0, t1), t2))
    tmax = torch.where(dead, -inf, torch.maximum(torch.maximum(t0, t1), t2))
    p = slots.shape[0] // LEAF_SIZE
    mins = [tmin.reshape(p, LEAF_SIZE, 3).amin(dim=1)]
    maxs = [tmax.reshape(p, LEAF_SIZE, 3).amax(dim=1)]
    while mins[-1].shape[0] > 1:
        lo, hi = mins[-1].reshape(-1, 2, 3), maxs[-1].reshape(-1, 2, 3)
        mins.append(torch.minimum(lo[:, 0], lo[:, 1]))
        maxs.append(torch.maximum(hi[:, 0], hi[:, 1]))

    node_min = bvh.node_min.clone()
    node_max = bvh.node_max.clone()
    for lvl, s in enumerate(level_slots):
        node_min[s.long()] = mins[lvl]
        node_max[s.long()] = maxs[lvl]
    # All-padded subtrees come out of the unions inverted (+inf, -inf), which
    # the slab test always hits: replace them with the finite far sentinel, as
    # the host build does.
    inverted = (node_min[:, 0] > node_max[:, 0])[:, None]
    far = torch.full((), FAR_SENTINEL, dtype=node_min.dtype, device=node_min.device)
    node_min = torch.where(inverted, far, node_min)
    node_max = torch.where(inverted, far, node_max)
    # The packed traversal rows. Opacity and alpha grids [OPQ0:LOOK0] are
    # topology-static (keyed by node_first): reuse them; the lookahead target
    # BOXES [LOOK0:] follow the refit geometry and come from the fresh pack.
    rows = pack_node_rows(node_min, node_max, bvh.node_miss, bvh.node_first, bvh.node_count,
                          slot_v0, slot_e1, slot_e2)
    rows = torch.cat([rows[:, :OPQ0], bvh.node_rows[:, OPQ0:LOOK0], rows[:, LOOK0:]],
                     dim=1).contiguous()
    # The traversal kernel's layout, from the new rows.
    return with_kernel_layout(bvh._replace(node_min=node_min, node_max=node_max, slot_v0=slot_v0,
                                           slot_e1=slot_e1, slot_e2=slot_e2, node_rows=rows))


def make_dynamic_data(render_scene, scene: SceneArrays) -> DynamicSceneData:
    """Bake the object-space source arrays of a built RenderScene, on the
    device of ``scene`` (the RenderScene must be the one that baked it: its
    ``proxy_host`` maps vertices to proxy clusters)."""
    dev = scene.positions.device
    all_pos, all_nrm, all_tan, vp, bounds = [], [], [], [], []
    for pid, prim in enumerate(render_scene.primitives):
        mesh = render_scene.meshes.meshes[prim.mesh_id]
        s, e = mesh.first_vertex, mesh.first_vertex + mesh.num_vertices
        all_pos.append(render_scene.meshes.positions[s:e])
        all_nrm.append(render_scene.meshes.normals[s:e])
        all_tan.append(render_scene.meshes.tangents[s:e])
        vp.append(np.full(mesh.num_vertices, pid, np.int32))
        bounds.append(mesh.bounds_sphere)
    pos = np.concatenate(all_pos)
    nrm = np.concatenate(all_nrm)
    v = scene.positions.shape[0]

    def dev_t(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def pad(a):
        out = np.zeros((v, *a.shape[1:]), a.dtype)
        out[: a.shape[0]] = a
        return dev_t(out)

    # Object-space cluster means for the proxy (the bake's vertex order, so
    # proxy_host["inv"] maps directly).
    inv = render_scene.proxy_host["inv"]
    vp_pad = render_scene.proxy_host["padded_vertices"]

    def cluster_mean(vals):
        acc = np.zeros((vp_pad, vals.shape[1]), np.float64)
        np.add.at(acc, inv, vals.astype(np.float64))
        cnt = np.zeros((vp_pad,), np.float64)
        np.add.at(cnt, inv, 1.0)
        return dev_t((acc / np.maximum(cnt[:, None], 1.0)).astype(np.float32))

    p = int(scene.bvh.slot_tri.shape[0]) // LEAF_SIZE
    return DynamicSceneData(
        base_positions=pad(pos.astype(np.float32)),
        base_normals=pad(nrm.astype(np.float32)),
        base_tangents=pad(np.concatenate(all_tan).astype(np.float32)),
        vertex_prim=pad(np.concatenate(vp)),
        base_bounds=dev_t(np.stack(bounds).astype(np.float32)),
        level_slots=[dev_t(s) for s in complete_tree_level_slots(p)],
        proxy_base_positions=cluster_mean(pos),
        proxy_base_normals=cluster_mean(nrm),
    )


def initial_transforms(render_scene, device="cuda") -> torch.Tensor:
    """(P, 4, 4) the transforms the scene was built with, on ``device`` (the
    card unless the caller asks for the CPU)."""
    return torch.from_numpy(
        np.stack([p.transform for p in render_scene.primitives]).astype(np.float32)
    ).to(device)
