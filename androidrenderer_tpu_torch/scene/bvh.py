"""BVH build — the RaytracingScene / BLAS-TLAS analog (raytracing_scene.cpp:50-170,
blas_build_queue.hpp:14-25).

TPU-native redesign: instead of driver-built acceleration structures, a flat
**preorder skip-link BVH** over all world-space triangles (the instance-expanded
scene is one big BLAS — the reference's TLAS-over-BLAS split exists to support
per-frame instance motion, which the baked scene doesn't need yet):

- Leaves hold up to LEAF_SIZE triangles, ordered by recursive widest-axis
  median splits onto the complete tree's slot capacity (median_split_order —
  the splits a median-SAH builder takes, constrained to the balanced topology
  the refit path needs; replaced the round-3 Morton ordering, ~2x fewer
  node visits per ray on the bench scene).
- Nodes are stored in PREORDER: the "hit" successor of an internal node is simply
  ``index + 1``; each node also stores a "miss" successor (the preorder index after
  its subtree). Traversal state is ONE integer per ray — a branch-free lockstep loop
  that vectorizes over millions of rays (ops/rt/traverse.py).

Built host-side (this numpy builder or the bit-identical C++ one in
native/sah_native.cpp, ~15x faster at Sponza scale; ``native.py`` of this
package builds and binds it).

A copy of the JAX package's scene/bvh.py (numpy only). Its
``complete_tree_level_slots`` feeds the dynamic-scene refit (scene/dynamic.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

LEAF_SIZE = 4


class BVHArrays(NamedTuple):
    node_min: np.ndarray  # (M, 3) f32
    node_max: np.ndarray  # (M, 3) f32
    node_miss: np.ndarray  # (M,) i32 — preorder index after this node's subtree
    node_first: np.ndarray  # (M,) i32 — first slot in tri_order for leaves, -1 internal
    node_count: np.ndarray  # (M,) i32 — triangle count for leaves, 0 internal
    tri_order: np.ndarray  # (L*LEAF_SIZE,) i32 triangle ids, -1 padded


def median_split_order(
    centroid: np.ndarray,
    tri_min: np.ndarray | None = None,
    tri_max: np.ndarray | None = None,
) -> np.ndarray:
    """Recursive SAH-axis median-split ordering of triangle centroids.

    Maps triangles onto the complete tree's leaf slots by recursively
    stable-sorting each capacity segment and splitting at half the slot
    capacity. Round-5 axis rule (the binned-SAH axis decision constrained to
    the balanced topology the refit path needs — raytracing_scene.cpp:50-170
    is the structural spec): with per-triangle AABBs available, each segment
    tries all 3 axes and keeps the one minimizing area(left AABB) +
    area(right AABB) — the SAH cost with the child counts pinned by the
    capacity split (lowest axis index on ties). Without AABBs it falls back
    to the round-4 widest-centroid-extent rule.

    The native builder (native/sah_native.cpp) implements the identical
    recursion with the same stable sort + tie + f32 area rules — outputs are
    bit-identical (tests/test_native.py)."""
    n = centroid.shape[0]
    num_leaves = max(1, -(-n // LEAF_SIZE))
    depth = int(np.ceil(np.log2(num_leaves))) if num_leaves > 1 else 0
    cap0 = (1 << depth) * LEAF_SIZE
    out = np.empty(n, np.int64)
    pos = 0
    use_sah = tri_min is not None and tri_max is not None

    def half_area(mn, mx):
        # f32 surface half-area, same expression order as the C++ builder.
        d = (mx - mn).astype(np.float32)
        return np.float32(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    # Explicit stack, left-first emission (preorder leaf order).
    stack = [(np.arange(n, dtype=np.int64), cap0)]
    while stack:
        idx, cap = stack.pop()
        if len(idx) <= LEAF_SIZE or cap <= LEAF_SIZE:
            out[pos:pos + len(idx)] = idx
            pos += len(idx)
            continue
        c = centroid[idx]
        half = cap // 2
        if use_sah and len(idx) > half:
            best_cost = None
            s = None
            for ax in range(3):
                s_ax = idx[np.argsort(c[:, ax], kind="stable")]
                ls, rs = s_ax[:half], s_ax[half:]
                cost = np.float32(
                    half_area(tri_min[ls].min(axis=0), tri_max[ls].max(axis=0))
                    + half_area(tri_min[rs].min(axis=0), tri_max[rs].max(axis=0))
                )
                if best_cost is None or cost < best_cost:  # strict: lowest ax ties
                    best_cost = cost
                    s = s_ax
        else:
            ext = c.max(axis=0) - c.min(axis=0)
            ax = int(np.argmax(ext))  # argmax takes the LOWEST index on ties
            s = idx[np.argsort(c[:, ax], kind="stable")]
        # push right first so left pops (and emits) first
        stack.append((s[half:], half))
        stack.append((s[:half], half))
    return out


def complete_tree_level_slots(num_leaves_pow2: int):
    """Preorder slot index of every (level, index) node of the complete tree.

    The BVH topology is implicit in the leaf count (complete tree, preorder
    flatten), so a REFIT (raytracing_scene.cpp:50-170 update path) only has to
    recompute AABBs bottom-up and scatter them into the static preorder slots
    this function enumerates. Returns [level 0 (leaves) slots, level 1, ...]."""
    p = num_leaves_pow2
    depth = int(np.log2(p)) if p > 1 else 0
    levels = depth + 1
    slots = [np.zeros(p >> k, np.int64) for k in range(levels)]
    m_total = 2 * p - 1
    stack = [(levels - 1, 0, 0)]
    while stack:
        lvl, idx, slot = stack.pop()
        slots[lvl][idx] = slot
        if lvl > 0:
            left_size = (1 << lvl) - 1
            stack.append((lvl - 1, idx * 2, slot + 1))
            stack.append((lvl - 1, idx * 2 + 1, slot + 1 + left_size))
    return [s.astype(np.int32) for s in slots]


def build_bvh(
    positions: np.ndarray,  # (V, 3)
    tri_indices: np.ndarray,  # (N, 3)
    tri_valid: np.ndarray | None = None,  # (N,) bool
) -> BVHArrays:
    """Median-split implicit-balanced BVH flattened to preorder skip-link arrays."""
    positions = np.asarray(positions, np.float32)
    tri_indices = np.asarray(tri_indices, np.int32)
    n_all = tri_indices.shape[0]
    if tri_valid is None:
        tri_valid = np.ones(n_all, bool)
    ids = np.nonzero(np.asarray(tri_valid))[0].astype(np.int32)
    n = len(ids)
    if n == 0:
        inf = np.full((1, 3), np.inf, np.float32)
        return BVHArrays(inf, -inf, np.array([1], np.int32), np.array([-1], np.int32),
                         np.array([0], np.int32), np.full(LEAF_SIZE, -1, np.int32))

    v0 = positions[tri_indices[ids, 0]]
    v1 = positions[tri_indices[ids, 1]]
    v2 = positions[tri_indices[ids, 2]]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tmin + tmax) * 0.5
    order = median_split_order(centroid, tmin, tmax)
    ids = ids[order]
    tmin, tmax = tmin[order], tmax[order]

    # Pad to a full complete tree of leaves.
    num_leaves = max(1, -(-n // LEAF_SIZE))
    depth = int(np.ceil(np.log2(num_leaves))) if num_leaves > 1 else 0
    p = 1 << depth  # leaves in the complete tree
    tri_order = np.full(p * LEAF_SIZE, -1, np.int32)
    tri_order[:n] = ids

    # Leaf AABBs (padded leaves start inverted; sanitize_padded_boxes below
    # replaces surviving inverted boxes with the far sentinel AFTER the unions).
    leaf_min = np.full((p, 3), np.inf, np.float32)
    leaf_max = np.full((p, 3), -np.inf, np.float32)
    g = np.arange(n) // LEAF_SIZE
    np.minimum.at(leaf_min, g, tmin)
    np.maximum.at(leaf_max, g, tmax)
    leaf_count = np.zeros(p, np.int32)
    np.add.at(leaf_count, g, 1)

    # Internal levels bottom-up: levels[k] has p >> k nodes.
    mins = [leaf_min]
    maxs = [leaf_max]
    while mins[-1].shape[0] > 1:
        m = mins[-1].reshape(-1, 2, 3)
        x = maxs[-1].reshape(-1, 2, 3)
        mins.append(np.minimum(m[:, 0], m[:, 1]))
        maxs.append(np.maximum(x[:, 0], x[:, 1]))
    levels = len(mins)  # = depth + 1

    # Preorder flatten: subtree of a node at level k (leaves = level 0) has
    # 2^(k+1) - 1 nodes. Iterative emission.
    m_total = 2 * p - 1
    node_min = np.zeros((m_total, 3), np.float32)
    node_max = np.zeros((m_total, 3), np.float32)
    node_miss = np.zeros(m_total, np.int32)
    node_first = np.full(m_total, -1, np.int32)
    node_count = np.zeros(m_total, np.int32)

    # Stack of (level, index_within_level, preorder_slot, miss_target).
    stack = [(levels - 1, 0, 0, m_total)]
    while stack:
        lvl, idx, slot, miss = stack.pop()
        node_min[slot] = mins[lvl][idx]
        node_max[slot] = maxs[lvl][idx]
        node_miss[slot] = miss
        if lvl == 0:
            node_first[slot] = idx * LEAF_SIZE
            node_count[slot] = leaf_count[idx]
        else:
            left_size = (1 << lvl) - 1  # nodes in left subtree
            left_slot = slot + 1
            right_slot = slot + 1 + left_size
            stack.append((lvl - 1, idx * 2 + 1, right_slot, miss))
            stack.append((lvl - 1, idx * 2, left_slot, right_slot))

    return BVHArrays(
        node_min=node_min,
        node_max=node_max,
        node_miss=node_miss,
        node_first=node_first,
        node_count=node_count,
        tri_order=tri_order,
    )._replace(**sanitize_padded_boxes(node_min, node_max))


# Finite far-away sentinel for all-padded subtrees. The (+inf, -inf) inverted
# box evaluates as ALWAYS-HIT under the slab test (tn = max(min(t0, t1)) =
# -inf <= tf = +inf) — the round-3 builder's "inverted boxes never intersect"
# assumption was exactly backwards, and the ~53k padded leaves + their
# ancestors made EVERY ray walk the padded forest (~98k of 262k nodes
# box-hit per ray on the bench scene; traversal cost 50x what the geometry
# warrants). A degenerate far point yields tn = tf ~ +-3e37: behind the ray
# (tf < tmin) or beyond any best_t -> never hit, and min/max unions against
# REAL child boxes are unaffected because the sanitize runs AFTER the unions.
FAR_SENTINEL = 3.0e37


def sanitize_padded_boxes(node_min: np.ndarray, node_max: np.ndarray) -> dict:
    """Replace inverted (all-padded-subtree) boxes with the far sentinel."""
    inverted = node_min[:, 0] > node_max[:, 0]
    node_min = np.where(inverted[:, None], FAR_SENTINEL, node_min).astype(
        np.float32
    )
    node_max = np.where(inverted[:, None], FAR_SENTINEL, node_max).astype(
        np.float32
    )
    return {"node_min": node_min, "node_max": node_max}
