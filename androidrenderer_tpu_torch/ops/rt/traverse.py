"""BVH traversal: a CUDA kernel for Hopper and its plain PyTorch version.

Every ray carries ONE integer of traversal state, its node index in the
preorder skip-link BVH (scene/bvh.py): per step it reads the node's packed row,
slab-tests the node's box and either descends or takes the node's miss link;
a leaf Moller-Trumbore-tests its four triangle slots, an inner node slab-tests
its four lookahead targets (its grandchildren, or a leaf child) and jumps to
the first one hit in preorder. Any-hit rays (shadows, AO) park at the first
hit; closest-hit rays walk on with the nearest hit so far as their far bound.

The port of the JAX package's ops/rt/traverse.py. There the walk is a lockstep
``lax.while_loop`` over all rays (``_phase``, not Pallas) with a ray-compaction
schedule between stages that exists only because the TPU runs rays in
lockstep; its result does not depend on that schedule. Here ``trace_rays``
launches ``csrc/traverse.cu`` (persistent warps that refill their idle lanes
with the next rays) for CUDA tensors and runs ``trace_rays_reference`` for CPU
tensors; there is no fallback from one to the other. The kernel reads the
BVH's kernel layout (``kernel_layout``: aligned node headers, lookahead lines
and slot-indexed leaf data, exact copies of ``node_rows``' words), which is
built beside the rows where a BVH reaches its device (the upload,
scene.py::scene_arrays_from_numpy) and where it changes (the refit,
dynamic.py::refit_bvh), by ``with_kernel_layout``; the plain version reads
``node_rows``. Both compute JAX's step op for op, each product, sum and
quotient rounded on its own (no FMA contraction), so the kernel, the plain
version and the JAX walk run op by op agree bit for bit (tests/test_torch_rt.py).

One behaviour of JAX's arrays is made explicit: XLA's CPU backend and the TPU
flush subnormal floats to zero, so a ray component below 2^-126 is zero there
(a direction component then takes the ``1e-30`` branch of ``inv_d``). The port
flushes the rays' subnormal origin and direction components to (signed) zero
as it reads them, in the kernel and the plain version. Subnormal intermediate
results, which JAX would flush too, are kept: scene-scale inputs do not make
them.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_void_p
from typing import NamedTuple

import torch

from androidrenderer_tpu_torch.ops.cuda_build import Library
from androidrenderer_tpu_torch.scene.bvh import FAR_SENTINEL, LEAF_SIZE

# node_rows channel layout (all f32; integer fields are f32-exact, < 2^24):
# 0:3 aabb min | 3:6 aabb max | 6 miss link | 7 first slot (-1 = inner) |
# 8 slot count | SLOT0 : OPQ0 slots x (v0, e1, e2) | OPQ0 : +LEAF_SIZE
# per-slot opaque flags | GRID0 : +LEAF_SIZE*8 per-slot 16x16 barycentric
# alpha bitmaps (8 i32 words bitcast to f32; all-ones for opaque slots) |
# LOOK0 : +4 lookahead target slots (-1 = none) | +4*6 target AABBs.
#
# Lookahead: an inner node's 4 targets are its GRANDCHILDREN (or a leaf child
# directly), in preorder order. A step at an inner node slab-tests the 4
# target boxes of the same row and jumps straight to the first hit target,
# descending two levels (or skipping a whole 2-level subtree) per row read.
SLOT0 = 9
OPQ0 = SLOT0 + LEAF_SIZE * 9
GRID0 = OPQ0 + LEAF_SIZE
LOOK0 = GRID0 + LEAF_SIZE * 8
NODE_ROW_CHANNELS = LOOK0 + 4 + 4 * 6

# Below the smallest normal float32: JAX's flushed arithmetic reads it as zero.
FLT_MIN = 2.0 ** -126

_vp, _ci, _cf = c_void_p, c_int, c_float
LIBRARY = Library("traverse.cu", {
    # header, lookahead, slot block, slot alpha, m, origins, directions, r, tmin (ray,
    # all), tmax (ray, all), active, any_hit, masked_any_hit, bitmap, max_steps,
    # scattered, t, slot, u, v, steps, steps_max, overflow, counter, work, touched, stream
    "traverse_launch": [_vp, _vp, _vp, _vp, _ci, _vp, _vp, _ci, _vp, _cf, _vp, _cf, _vp, _ci,
                        _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                        _vp],
    # any_hit, masked_any_hit, bitmap, counts -> registers per thread, resident
    # blocks per SM, SMs
    "traverse_occupancy": [_ci, _ci, _ci, _ci, _vp, _vp, _vp],
})

# The kernel's layout of a BVH (``kernel_layout``), int32 words; the float fields
# travel as their f32 bits. Per node: a HEADER of 8 words (32 B, one sector):
# min xyz, max xyz, miss link, first slot (-1 = inner); a LOOKAHEAD of 32 words
# (128 B, one line): the 4 target ids (-1 = none), their boxes coordinate-major
# (min x of the 4 targets, then min y, ..., max z), and 4 words of 0.
# Per slot (a leaf owns slots first .. first + 3): a BLOCK of 12 words (48 B):
# v0 xyz, the leaf's slot count | e1 xyz, the opaque flag | e2 xyz, 0; and its 8
# ALPHA words. Slots of no leaf are zero.
HEADER_WORDS, LOOKAHEAD_WORDS, SLOT_WORDS, ALPHA_WORDS = 8, 32, 12, 8
# How the kernel keeps each call site's warps busy, as measured in turns at
# every site (PERF.md, the traversal's findings): True for scattered rays, whose
# warps refill their idle lanes with the next rays once 8 are idle (the
# kernel's kRefillAt), False for coherent rays, whose warps take a new batch
# only when all their lanes are idle. csrc/traverse.cu says why. The result
# does not depend on it.
SCATTERED = {
    "rt_shadow": False,  # sun rays from the camera's pixels
    "primary": False,  # camera rays
    "rtao": True,  # cosine-distributed AO rays
    "rtgi_rays": True,  # cosine-distributed GI rays
    "rtgi_sun": True,  # sun rays from the GI rays' scattered hits
    "probe_rays": True,  # rays every way from each probe
    "probe_sun": False,  # a probe's consecutive rays' sun rays: near, one direction
}

# The kernel's per-ray work counts (scratch ``work``, (R, 6) i32), in order:
# steps, leaf and inner nodes whose box the ray hit, the lookahead targets an
# inner visit examined (up to the first hit) and the slab tests it ran on them
# (targets at -1 take none), and the bitmap lookups (slots that passed
# Moller-Trumbore with the bitmap test on).
WORK_COUNTS = ("steps", "leaf_visits", "inner_visits", "lookahead_targets",
               "lookahead_slabs", "bitmap_lookups")


class DeviceBVH(NamedTuple):
    """Device-side BVH + slot-ordered triangle data (built in scene.bake), and
    the kernel's layout of its rows (``with_kernel_layout``; None where it was
    not built, as in the bake's host copy: the plain version reads
    ``node_rows`` only, the kernel raises)."""

    node_min: torch.Tensor  # (M, 3) f32
    node_max: torch.Tensor  # (M, 3) f32
    node_miss: torch.Tensor  # (M,) i32
    node_first: torch.Tensor  # (M,) i32
    node_count: torch.Tensor  # (M,) i32
    slot_tri: torch.Tensor  # (S,) i32 original triangle id per slot (-1 padded)
    slot_v0: torch.Tensor  # (S, 3) f32 Moller-Trumbore precomputed
    slot_e1: torch.Tensor  # (S, 3)
    slot_e2: torch.Tensor  # (S, 3)
    node_rows: torch.Tensor  # (M, NODE_ROW_CHANNELS) f32 packed traversal rows
    node_header: torch.Tensor | None = None  # (M, HEADER_WORDS) i32
    node_lookahead: torch.Tensor | None = None  # (M, LOOKAHEAD_WORDS) i32
    slot_block: torch.Tensor | None = None  # (S, SLOT_WORDS) i32
    slot_alpha: torch.Tensor | None = None  # (S, ALPHA_WORDS) i32


# The fields of the JAX package's DeviceBVH (the bake's ``bvh.<field>`` leaves),
# and those of the kernel's layout, which are made from them.
BVH_FIELDS = DeviceBVH._fields[:10]
LAYOUT_FIELDS = DeviceBVH._fields[10:]


def kernel_layout(node_rows: torch.Tensor, n_slots: int) -> dict:
    """The kernel's layout of ``node_rows`` (the layout above) for a BVH of
    ``n_slots`` slots, as ``DeviceBVH`` fields: exact copies of the rows' words,
    the integer links converted (f32-exact below 2^24), on the rows' device.
    Only leaf rows (first >= 0) give slot blocks: an inner row's slot columns
    are clamped copies that the walk never reads."""
    m = node_rows.shape[0]
    if n_slots % LEAF_SIZE:
        raise ValueError(f"{n_slots} slots: a leaf owns {LEAF_SIZE} slots, so S is a multiple")
    rows = node_rows.to(torch.float32).contiguous()
    words = rows.view(torch.int32)
    links = rows[:, 6:9].to(torch.int32)  # miss, first, count
    first = links[:, 1]
    header = torch.cat([words[:, 0:6], links[:, 0:2]], dim=1)
    ids = rows[:, LOOK0:LOOK0 + 4].to(torch.int32)
    boxes = words[:, LOOK0 + 4:LOOK0 + 28].reshape(m, 4, 6).transpose(1, 2).reshape(m, 24)
    pad = torch.zeros((m, LOOKAHEAD_WORDS - 28), dtype=torch.int32, device=rows.device)
    lookahead = torch.cat([ids, boxes, pad], dim=1)
    tri = words[:, SLOT0:OPQ0].reshape(m, LEAF_SIZE, 3, 3)
    per_slot = [links[:, 2, None, None].expand(m, LEAF_SIZE, 1),
                words[:, OPQ0:GRID0].reshape(m, LEAF_SIZE, 1),
                torch.zeros((m, LEAF_SIZE, 1), dtype=torch.int32, device=rows.device)]
    block = torch.cat([torch.cat([tri[:, :, j], per_slot[j]], dim=2) for j in range(3)], dim=2)
    alpha = words[:, GRID0:LOOK0].reshape(m, LEAF_SIZE, ALPHA_WORDS)
    # Inner rows land in LEAF_SIZE spare slots past the end, dropped after.
    dest = (torch.where(first >= 0, first, n_slots)[:, None]
            + torch.arange(LEAF_SIZE, device=rows.device)).reshape(-1).long()
    out = {}
    for name, src, width in (("slot_block", block, SLOT_WORDS), ("slot_alpha", alpha, ALPHA_WORDS)):
        table = torch.zeros((n_slots + LEAF_SIZE, width), dtype=torch.int32, device=rows.device)
        table[dest] = src.reshape(-1, width)
        out[name] = table[:n_slots].contiguous()
    return dict(node_header=header.contiguous(), node_lookahead=lookahead.contiguous(), **out)


def with_kernel_layout(bvh: DeviceBVH) -> DeviceBVH:
    """``bvh`` with the kernel's layout built from its ``node_rows``, on their
    device (the upload and the refit call this)."""
    return bvh._replace(**kernel_layout(bvh.node_rows, bvh.slot_tri.shape[0]))


def pack_node_rows(
    node_min, node_max, node_miss, node_first, node_count, slot_v0, slot_e1, slot_e2,
    slot_opaque=None,  # (S,) bool; None = everything opaque
    slot_alpha_grid=None,  # (S, 8) i32 16x16 barycentric bitmaps; None = solid
) -> torch.Tensor:
    """(M, NODE_ROW_CHANNELS) f32 packed rows (see the layout above), bit-equal
    to the JAX package's pack_node_rows (the alpha words travel as their bits)."""
    m = node_min.shape[0]
    s = slot_v0.shape[0]
    # Links (miss/first/count) ride as f32, exact only below 2^24.
    if m >= 2 ** 24 or s >= 2 ** 24:
        raise ValueError(
            f"BVH too large for f32-packed node rows: nodes={m}, slots={s} "
            "(links are exact only below 2**24); split the scene or widen the "
            "row links to a bitcast-i32 channel"
        )
    dev = node_min.device
    f32 = torch.float32
    first = node_first.to(torch.int64)
    base = first.clamp(min=0)
    cols = [
        node_min.to(f32), node_max.to(f32),
        node_miss.to(f32)[:, None], first.to(f32)[:, None], node_count.to(f32)[:, None],
    ]
    opq = torch.ones(s, dtype=f32, device=dev) if slot_opaque is None else slot_opaque.to(f32)
    if slot_alpha_grid is None:
        grid = torch.full((s, 8), -1, dtype=torch.int32, device=dev)
    else:
        grid = slot_alpha_grid.to(torch.int32).contiguous()
    grid_f = grid.view(f32)
    opq_cols, grid_cols = [], []
    for k in range(LEAF_SIZE):
        sl = (base + k).clamp(max=s - 1)
        cols += [slot_v0[sl].to(f32), slot_e1[sl].to(f32), slot_e2[sl].to(f32)]
        opq_cols.append(opq[sl][:, None])
        grid_cols.append(grid_f[sl])

    # Lookahead targets, from the topology: left child of inner X is X+1; the
    # right child is the left subtree's miss link.
    nm, nx = node_min.to(f32), node_max.to(f32)
    miss_i = node_miss.to(torch.int64)
    ids = torch.arange(m, device=dev)
    is_inner = first < 0

    def child_targets(c, c_valid):
        """Two targets for child c: (c itself) when c is a leaf, else c's two
        children: [(slot, valid), (slot, valid)]."""
        c_s = c.clamp(0, m - 1)
        c_leaf = first[c_s] >= 0
        g1 = c_s + 1
        g1_ok = c_valid & ~c_leaf & (g1 < m)
        g1_s = g1.clamp(0, m - 1)
        g2 = miss_i[g1_s]
        g2_ok = g1_ok & (g2 > g1) & (g2 < m)
        t_a = torch.where(c_leaf, c_s, g1_s)
        t_a_ok = c_valid & (c_leaf | g1_ok)
        return [(t_a, t_a_ok), (g2.clamp(0, m - 1), g2_ok)]

    left = ids + 1
    left_ok = is_inner & (left < m)
    left_s = left.clamp(0, m - 1)
    right = miss_i[left_s]
    right_ok = left_ok & (right > left) & (right < m)
    targets = child_targets(left_s, left_ok) + child_targets(right.clamp(0, m - 1), right_ok)
    t_slots, t_boxes = [], []
    for slot_k, ok_k in targets:
        t_slots.append(torch.where(ok_k, slot_k, -1).to(f32)[:, None])
        bmin = torch.where(ok_k[:, None], nm[slot_k], FAR_SENTINEL)
        bmax = torch.where(ok_k[:, None], nx[slot_k], FAR_SENTINEL)
        t_boxes.append(torch.cat([bmin, bmax], dim=1))
    return torch.cat(cols + opq_cols + grid_cols + t_slots + t_boxes, dim=1).contiguous()


def empty_device_bvh(device) -> DeviceBVH:
    """The JAX bake's BVH of a scene baked without one (scene.build(with_bvh=
    False)): one inner node whose box sits at the finite far sentinel (an
    inverted (+inf, -inf) box would hit every ray under the slab test), with
    miss link 1, so every ray parks after one step, and no lookahead target."""
    rows = torch.zeros((1, NODE_ROW_CHANNELS), dtype=torch.float32, device=device)
    rows[0, 0:6] = FAR_SENTINEL
    rows[0, 6] = 1.0  # miss link -> park
    rows[0, 7] = -1.0  # inner (no slots)
    rows[0, LOOK0:LOOK0 + 4] = -1.0
    rows[0, LOOK0 + 4:] = FAR_SENTINEL
    z3 = torch.zeros((4, 3), dtype=torch.float32, device=device)
    return DeviceBVH(
        node_min=torch.full((1, 3), float("inf"), device=device),
        node_max=torch.full((1, 3), float("-inf"), device=device),
        node_miss=torch.ones(1, dtype=torch.int32, device=device),
        node_first=torch.full((1,), -1, dtype=torch.int32, device=device),
        node_count=torch.zeros(1, dtype=torch.int32, device=device),
        slot_tri=torch.full((4,), -1, dtype=torch.int32, device=device),
        slot_v0=z3, slot_e1=z3.clone(), slot_e2=z3.clone(), node_rows=rows,
    )


class Hits(NamedTuple):
    t: torch.Tensor  # (R,) f32 hit distance (tmax where missed)
    slot: torch.Tensor  # (R,) i32 hit slot id, -1 = miss
    u: torch.Tensor  # (R,) f32 barycentric u
    v: torch.Tensor  # (R,) f32 barycentric v
    # () i32 traversal steps of the longest walk / () bool true when the step
    # cap stopped a ray before it parked (a hit may be missing): device
    # tensors, read without a host sync.
    steps: torch.Tensor
    overflow: torch.Tensor
    ray_steps: torch.Tensor  # (R,) i32 steps each ray walked


class TraceCall(NamedTuple):
    """One kernel call with its buffers allocated: ``launch()`` enqueues it on the
    current stream into ``outputs`` (Hits); with work counting, ``work`` (R, 6)
    i32 then holds each ray's ``WORK_COUNTS``, and ``touched`` (M,) u8 is 1 at
    every node whose row some ray read."""

    launch: object
    outputs: Hits
    work: torch.Tensor | None
    touched: torch.Tensor | None


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the rays are on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _bound(x, name, r, device):
    """(scalar as float32-rounded Python float or None, (R,) tensor or None) of a
    ray bound given as a number or an (R,) float32 tensor."""
    if isinstance(x, torch.Tensor):
        _check(x, name, torch.float32, (r,), device)
        return None, x
    if isinstance(x, (int, float)):
        return float(torch.tensor(x, dtype=torch.float32)), None
    raise TypeError(f"{name} must be a number or an (R,) float32 tensor, got {type(x)}")


def trace_rays(
    bvh: DeviceBVH,
    origins: torch.Tensor,  # (R, 3) f32
    directions: torch.Tensor,  # (R, 3) f32, need not be normalized
    tmin,  # number or (R,) f32
    tmax,  # number or (R,) f32
    any_hit: bool = False,
    # Park-step p100 on the bench scene is ~950 in the JAX package's own
    # measurement (tools/microbench_rt.py); the cap bounds the worst case.
    max_steps: int = 1024,
    active: torch.Tensor | None = None,  # (R,) bool: inactive rays report a miss
    alpha_bitmap_test: bool = False,  # in-traversal 16x16 barycentric alpha test
    masked_any_hit: bool = False,  # any-hit parks only on OPAQUE hits (see below)
    scattered: bool = False,  # the kernel's refill policy: SCATTERED[<call site>]
) -> Hits:
    """Closest-hit (or any-hit) trace of R rays.

    ``tmin`` may be per-ray (R,): the exact alpha peel re-traces past an
    ignored hit with its own t as the ray's strict lower bound.
    ``masked_any_hit`` changes any-hit to the reference's masked any-hit
    shader (gltf_basic_pbr.slang:291-317): a ray parks only on a hit whose slot
    is opaque (the per-slot flags in the node rows); a masked slot's hit stays
    the nearest so far and the walk goes on, so the caller can alpha-test the
    committed hit and re-trace (ops/rt/effects.py::occlusion_masked).

    ``alpha_bitmap_test`` resolves alpha-masked geometry inside the traversal
    with the per-triangle 16x16 barycentric bitmaps baked into the node rows
    (the ones the rasterizer tests): a slot whose bit at the hit's (u, v) is 0
    does not hit. A CUDA ray set launches the kernel (counted in
    ``trace_rays.launches``); a CPU one runs ``trace_rays_reference``; any
    other device raises.

    ``scattered`` changes only how the kernel keeps its lanes busy, never the
    result: rays whose neighbours in index order go different ways (AO, GI
    and probe rays, rays from scattered hit points) refill idle lanes; rays
    that walk together (shadow rays from the camera's pixels, primary rays)
    are walked a batch at a time. Each call site passes its entry of
    ``SCATTERED``, where the policies are measured and kept together."""
    if origins.device.type == "cpu":
        return trace_rays_reference(bvh, origins, directions, tmin, tmax, any_hit, max_steps,
                                    active, alpha_bitmap_test, masked_any_hit=masked_any_hit)
    call = prepare_trace(bvh, origins, directions, tmin, tmax, any_hit, max_steps, active,
                         alpha_bitmap_test, masked_any_hit=masked_any_hit,
                         scattered=scattered)
    call.launch()
    trace_rays.launches += 1
    return call.outputs


trace_rays.launches = 0


def prepare_trace(bvh, origins, directions, tmin, tmax, any_hit=False, max_steps=1024,
                  active=None, alpha_bitmap_test=False, counts=False, library=LIBRARY,
                  masked_any_hit=False, scattered=False):
    """Check the inputs of a kernel call and allocate its outputs and scratch
    (the kernel allocates nothing): a TraceCall. Launches and counts nothing;
    ``trace_rays`` launches once and counts it. ``counts`` launches the kernel's
    counting instantiation, with the work-count scratch (measurements only,
    never on the frame path). ``scattered`` is the refill policy, as in
    ``trace_rays``. The kernel reads the BVH's kernel layout: a BVH without
    one raises (``with_kernel_layout`` builds it)."""
    missing = [f for f in LAYOUT_FIELDS if getattr(bvh, f) is None]
    if missing:
        raise ValueError(f"the BVH has no kernel layout ({', '.join(missing)}): build it with "
                         "traverse.with_kernel_layout")
    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"traversal runs on cuda or cpu tensors, got {dev}")
    r = origins.shape[0]
    m, s = bvh.node_rows.shape[0], bvh.slot_block.shape[0]
    if not 1 <= m < 2 ** 24 or s >= 2 ** 24:
        raise ValueError(f"the BVH has {m} nodes and {s} slots; the links need 1 <= M < 2**24 "
                         "and S < 2**24")
    if r >= 2 ** 31 // 3:
        raise ValueError(f"{r} rays exceed the kernel's int32 indexing")
    if not 0 <= int(max_steps) < 2 ** 31:
        raise ValueError(f"max_steps must be in [0, 2**31), got {max_steps}")
    _check(origins, "origins", torch.float32, (r, 3), dev)
    _check(directions, "directions", torch.float32, (r, 3), dev)
    for name, shape in (("node_header", (m, HEADER_WORDS)), ("node_lookahead", (m, LOOKAHEAD_WORDS)),
                        ("slot_block", (s, SLOT_WORDS)), ("slot_alpha", (s, ALPHA_WORDS))):
        _check(getattr(bvh, name), f"bvh.{name}", torch.int32, shape, dev)
    tmin_s, tmin_t = _bound(tmin, "tmin", r, dev)
    tmax_s, tmax_t = _bound(tmax, "tmax", r, dev)
    if active is not None:
        _check(active, "active", torch.bool, (r,), dev)
    lib = library.load()

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    t, u, v = empty(r), empty(r), empty(r)
    slot, ray_steps = empty(r, dtype=torch.int32), empty(r, dtype=torch.int32)
    # The longest walk, and the rays the warps have claimed (scratch), and
    # whether the cap stopped a ray: the launch clears all three, the kernel
    # reduces into them.
    scalars = empty(2, dtype=torch.int32)
    overflow = empty(1, dtype=torch.bool)
    work = empty(r, len(WORK_COUNTS), dtype=torch.int32) if counts else None
    touched = torch.zeros(m, dtype=torch.uint8, device=dev) if counts else None
    hits = Hits(t=t, slot=slot, u=u, v=v, steps=scalars[0], overflow=overflow[0],
                ray_steps=ray_steps)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        with torch.cuda.device(dev):
            err = lib.traverse_launch(
                bvh.node_header.data_ptr(), bvh.node_lookahead.data_ptr(),
                bvh.slot_block.data_ptr(), bvh.slot_alpha.data_ptr(), m,
                origins.data_ptr(), directions.data_ptr(), r,
                ptr(tmin_t), 0.0 if tmin_s is None else tmin_s,
                ptr(tmax_t), 0.0 if tmax_s is None else tmax_s,
                ptr(active), int(any_hit), int(masked_any_hit), int(alpha_bitmap_test),
                int(max_steps), int(scattered),
                t.data_ptr(), slot.data_ptr(), u.data_ptr(), v.data_ptr(), ray_steps.data_ptr(),
                scalars.data_ptr(), overflow.data_ptr(), scalars.data_ptr() + 4,
                ptr(work), ptr(touched), stream,
            )
        if err != 0:
            raise RuntimeError(f"traverse_launch failed with cudaError_t {err}")

    return TraceCall(launch, hits, work, touched)


def occupancy(any_hit=False, masked_any_hit=False, alpha_bitmap_test=False, counts=False,
              library=LIBRARY) -> dict:
    """The kernel instantiation's registers per thread, resident blocks per SM
    and the card's SM count (a launch runs blocks x SMs blocks at most), read
    from the CUDA runtime of the current device."""
    from ctypes import byref

    vals = [c_int(0), c_int(0), c_int(0)]
    err = library.load().traverse_occupancy(int(any_hit), int(masked_any_hit),
                                            int(alpha_bitmap_test), int(counts),
                                            *(byref(x) for x in vals))
    if err != 0:
        raise RuntimeError(f"traverse_occupancy failed with cudaError_t {err}")
    return dict(zip(("registers", "blocks_per_sm", "sms"), (x.value for x in vals)))


def work_counts(call: TraceCall) -> dict:
    """The kernel's work counts of a call made with ``counts=True``, summed over
    the rays (reads the device: for measurements, never on the frame path):
    ``WORK_COUNTS``, and ``rows``, the distinct node rows read."""
    out = dict(zip(WORK_COUNTS, call.work.sum(0, dtype=torch.int64).tolist()))
    out["rows"] = int(call.touched.sum(dtype=torch.int64))
    return out


def _as_ray_bound(x, r, device) -> torch.Tensor:
    """(R,) float32 bound from a number or an (R,) tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).expand(r)
    return torch.full((r,), float(x), dtype=torch.float32, device=device)


def _cross(a, b):
    """JAX's cross, each product and difference rounded on its own."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _dot(a, b):
    """A 3-term dot product summed (x + y) + z, as the kernel sums it."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _slab(lo, hi, o, inv):
    """(tn, tf) of the slab test of boxes [lo, hi] (..., 3), min/max propagating
    NaN as JAX's do."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    mn, mx = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]), mn[..., 2])
    tf = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2])
    return tn, tf


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """``x`` with components below 2^-126 in magnitude replaced by signed zero,
    as JAX's flushed arithmetic reads them."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def trace_rays_reference(bvh, origins, directions, tmin, tmax, any_hit=False, max_steps=1024,
                         active=None, alpha_bitmap_test=False, counts=False,
                         masked_any_hit=False):
    """The plain PyTorch traversal, on any device: Hits (and with ``counts``,
    the kernel's work counts as (Hits, (R, 6) i32 work, (M,) bool touched)).

    Each step advances every ray still walking, with the kernel's arithmetic
    op for op; rays park independently, so the result is the kernel's."""
    dev = origins.device
    rows = bvh.node_rows
    m, r = rows.shape[0], origins.shape[0]
    tmin_r = _as_ray_bound(tmin, r, dev)
    best_t = _as_ray_bound(tmax, r, dev).clone()
    best_slot = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(r, dtype=torch.float32, device=dev)
    best_v = torch.zeros(r, dtype=torch.float32, device=dev)
    best_opq = torch.zeros(r, dtype=torch.bool, device=dev)
    idx = torch.zeros(r, dtype=torch.int64, device=dev)
    if active is not None:
        idx = torch.where(active, idx, m)
    work = torch.zeros((r, len(WORK_COUNTS)), dtype=torch.int32, device=dev)
    touched = torch.zeros(m, dtype=torch.bool, device=dev)
    origins, directions = flush_subnormals(origins), flush_subnormals(directions)
    inv_d = 1.0 / torch.where(directions == 0.0, 1e-30, directions)
    kk = torch.arange(LEAF_SIZE, dtype=torch.float32, device=dev)
    live = torch.nonzero(idx < m).flatten()
    for _ in range(int(max_steps)):
        if live.numel() == 0:
            break
        ni = idx[live]
        row = rows[ni]
        touched[ni] = True
        o, d, inv = origins[live], directions[live], inv_d[live]
        t_lo, bt = tmin_r[live], best_t[live]
        tn, tf = _slab(row[:, 0:3], row[:, 3:6], o, inv)
        box_hit = (tn <= tf) & (tf >= t_lo) & (tn <= bt)
        first_f, count = row[:, 7], row[:, 8]
        miss = row[:, 6].to(torch.int64)
        is_leaf = box_hit & (first_f >= 0.0)
        inner = box_hit & (first_f < 0.0)

        # The leaf's four Moller-Trumbore tests.
        tri = row[:, SLOT0:OPQ0].reshape(-1, LEAF_SIZE, 3, 3)
        v0, e1, e2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
        d_b = d[:, None, :]
        pvec = _cross(d_b, e2)
        det = _dot(e1, pvec)
        inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
        tvec = o[:, None, :] - v0
        u = _dot(tvec, pvec) * inv_det
        qvec = _cross(tvec, e1)
        v = _dot(d_b, qvec) * inv_det
        t = _dot(e2, qvec) * inv_det
        ok = (is_leaf[:, None] & (kk < count[:, None]) & (det.abs() > 1e-12)
              & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t > t_lo[:, None]) & (t < bt[:, None]))
        lookups = torch.zeros_like(count, dtype=torch.int32)
        if alpha_bitmap_test:
            lookups = ok.sum(1, dtype=torch.int32)
            words = row[:, GRID0:GRID0 + LEAF_SIZE * 8].contiguous().view(torch.int32)
            words = words.reshape(-1, LEAF_SIZE, 8)
            ui = torch.clamp(u * 16.0, 0.0, 15.0).to(torch.int32)
            vi = torch.clamp(v * 16.0, 0.0, 15.0).to(torch.int32)
            bit_i = vi * 16 + ui
            wsel = bit_i >> 5
            word = words[:, :, 0]
            for wj in range(1, 8):
                word = torch.where(wsel == wj, words[:, :, wj], word)
            ok = ok & (((word >> (bit_i & 31)) & 1) == 1)
        # The nearest passing slot, the lowest k on ties.
        k_best = torch.full(ok.shape[:1], -1, dtype=torch.int64, device=dev)
        t_near = torch.full(ok.shape[:1], float("inf"), dtype=torch.float32, device=dev)
        for k in range(LEAF_SIZE):
            take = ok[:, k] & (t[:, k] < t_near)
            t_near = torch.where(take, t[:, k], t_near)
            k_best = torch.where(take, k, k_best)
        found = k_best >= 0
        kb = k_best.clamp(min=0)[:, None]
        bt = torch.where(found, t_near, bt)
        slot_l = torch.where(found, first_f.to(torch.int64) + k_best, best_slot[live].to(torch.int64))
        best_t[live] = bt
        best_slot[live] = slot_l.to(torch.int32)
        best_u[live] = torch.where(found, u.gather(1, kb)[:, 0], best_u[live])
        best_v[live] = torch.where(found, v.gather(1, kb)[:, 0], best_v[live])
        opq = torch.where(found, row[:, OPQ0:OPQ0 + LEAF_SIZE].gather(1, kb)[:, 0] != 0.0,
                          best_opq[live])
        best_opq[live] = opq

        # An inner node's lookahead: the first target hit, in preorder.
        t_slot = row[:, LOOK0:LOOK0 + 4]
        t_box = row[:, LOOK0 + 4:LOOK0 + 28].reshape(-1, 4, 2, 3)
        ttn, ttf = _slab(t_box[:, :, 0], t_box[:, :, 1], o[:, None, :], inv[:, None, :])
        t_hit = ((t_slot >= 0.0) & (ttn <= ttf) & (ttf >= t_lo[:, None])
                 & (ttn <= bt[:, None]))
        k1 = torch.full(ok.shape[:1], -1, dtype=torch.int64, device=dev)
        for k in reversed(range(4)):
            k1 = torch.where(t_hit[:, k], k, k1)
        # The kernel examines targets up to the first hit, and slab-tests those >= 0.
        examined = torch.where(k1 >= 0, k1 + 1, 4)
        ran = torch.arange(4, device=dev)[None, :] < examined[:, None]
        targets = torch.where(inner, examined, 0).to(torch.int32)
        slabs = (inner[:, None] & ran & (t_slot >= 0.0)).sum(1, dtype=torch.int32)
        jump = t_slot.gather(1, k1.clamp(min=0)[:, None])[:, 0].to(torch.int64)
        nxt = torch.where(inner & (k1 >= 0), jump, miss)
        if any_hit:
            # Masked any-hit parks only on an opaque nearest hit.
            parked = (slot_l >= 0) & opq if masked_any_hit else slot_l >= 0
            nxt = torch.where(parked, m, nxt)
        idx[live] = nxt
        work[live, 0] += 1
        work[live, 1] += is_leaf.to(torch.int32)
        work[live, 2] += inner.to(torch.int32)
        work[live, 3] += targets
        work[live, 4] += slabs
        work[live, 5] += lookups
        live = live[nxt < m]
    ray_steps = work[:, 0].clone()
    hits = Hits(
        t=best_t, slot=best_slot, u=best_u, v=best_v,
        steps=ray_steps.max() if r else torch.zeros((), dtype=torch.int32, device=dev),
        overflow=(idx < m).any(), ray_steps=ray_steps,
    )
    return (hits, work, touched) if counts else hits


def occlusion(bvh: DeviceBVH, origins, directions, tmin, tmax, max_steps=1024, active=None,
              scattered=False):
    """(R,) bool: True where the segment is occluded (any-hit shadow query).
    Rays outside ``active`` report unoccluded without walking. ``scattered``
    as in ``trace_rays``."""
    hits = trace_rays(bvh, origins, directions, tmin, tmax, any_hit=True,
                      max_steps=max_steps, active=active, scattered=scattered)
    return hits.slot >= 0 if active is None else (hits.slot >= 0) & active
