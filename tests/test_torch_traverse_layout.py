"""The traversal kernel's layout of a BVH (ops/rt/traverse.py::kernel_layout):
every word of ``node_rows`` that the walk reads, held bit for bit, on the port's
uploaded bakes, the empty BVH and a refit BVH; and the wrapper's refusal of a BVH
without it. CPU only, no JAX (the kernel that reads the layout runs on the card:
tests/test_torch_kernels.py)."""

import pytest
import torch

from androidrenderer_tpu_torch.ops.rt import traverse
from androidrenderer_tpu_torch.ops.rt.traverse import GRID0, LOOK0, OPQ0, SLOT0
from androidrenderer_tpu_torch.scene import dynamic
from androidrenderer_tpu_torch.scene import procedural
from androidrenderer_tpu_torch.scene.scene import scene_arrays_from_numpy

torch.set_num_threads(1)


def assert_layout_holds(bvh):
    """Each layout field against the rows' words: the boxes' and slots' f32 bits,
    the links as the integers the rows hold, the alpha words' bits; each valid
    lookahead target's box is its own header's; pads and slots of no leaf are
    zero."""
    rows = bvh.node_rows
    m, s = rows.shape[0], bvh.slot_tri.shape[0]
    w = rows.view(torch.int32)
    h, la, blk, al = bvh.node_header, bvh.node_lookahead, bvh.slot_block, bvh.slot_alpha
    for x, shape in ((h, (m, 8)), (la, (m, 32)), (blk, (s, 12)), (al, (s, 8))):
        assert x.dtype == torch.int32 and tuple(x.shape) == shape and x.is_contiguous()
    assert torch.equal(h[:, :6], w[:, :6])
    assert torch.equal(h[:, 6:8].to(torch.float32).view(torch.int32), w[:, 6:8])

    ids = la[:, :4]
    assert torch.equal(ids.to(torch.float32).view(torch.int32), w[:, LOOK0:LOOK0 + 4])
    boxes = la[:, 4:28].reshape(m, 6, 4).transpose(1, 2)
    assert torch.equal(boxes, w[:, LOOK0 + 4:LOOK0 + 28].reshape(m, 4, 6))
    valid = ids >= 0
    own = h[ids.clamp(min=0).long()]  # (m, 4, 8): each target's header
    assert torch.equal(boxes[valid], own[valid][:, :6])
    assert bool((la[:, 28:] == 0).all())

    first = rows[:, 7].long()
    leaf = first >= 0
    owned = torch.zeros(s, dtype=torch.bool)
    for k in range(4):
        sl = first[leaf] + k
        owned[sl] = True
        b, lw = blk[sl], w[leaf]
        for j in range(3):  # v0, e1, e2
            assert torch.equal(b[:, 4 * j:4 * j + 3], lw[:, SLOT0 + 9 * k + 3 * j:SLOT0 + 9 * k + 3 * j + 3])
        assert torch.equal(b[:, 3].to(torch.float32), rows[leaf, 8])  # the leaf's count
        assert torch.equal(b[:, 7], lw[:, OPQ0 + k])  # the opaque flag's bits
        assert bool((b[:, 11] == 0).all())
        assert torch.equal(al[sl], lw[:, GRID0 + 8 * k:GRID0 + 8 * k + 8])
    assert bool((blk[~owned] == 0).all()) and bool((al[~owned] == 0).all())


@pytest.mark.parametrize("scene_name,with_bvh", [("cornell_scene", True),
                                                 ("alpha_test_scene", True),
                                                 ("cornell_scene", False)])
def test_bake_layout_holds_the_rows(scene_name, with_bvh):
    """The upload's layout, built from the bake's ``bvh.<field>`` leaves, which
    carry none; without a BVH, from the empty BVH's one row."""
    leaves, _ = getattr(procedural, scene_name)().bake(with_bvh=with_bvh)
    assert not any(k.startswith("bvh.") and k[4:] in traverse.LAYOUT_FIELDS for k in leaves)
    bvh = scene_arrays_from_numpy(leaves, "cpu").bvh
    assert_layout_holds(bvh)
    if scene_name == "alpha_test_scene":  # masked slots and their alpha words travel
        assert bool((bvh.slot_block[:, 7] == 0).any())
        assert bool(((bvh.slot_alpha != -1) & (bvh.slot_alpha != 0)).any())
    if not with_bvh:  # the empty BVH: miss link 1, inner, no lookahead target
        assert bvh.node_header.shape[0] == 1
        assert bvh.node_header[0, 6:].tolist() == [1, -1]
        assert bvh.node_lookahead[0, :4].tolist() == [-1] * 4


def test_refit_layout_follows_the_moved_rows():
    """A refit (scene/dynamic.py) of the cornell box with every primitive lifted
    and one scaled: the new layout holds the new rows, and its boxes moved."""
    rs = procedural.cornell_scene()
    leaves, _ = rs.bake()
    scene = scene_arrays_from_numpy(leaves, "cpu")
    dyn = dynamic.make_dynamic_data(rs, scene)
    tr = dynamic.initial_transforms(rs, "cpu")
    tr[:, 1, 3] += 0.5
    tr[1, :3, :3] *= 1.5
    moved = dynamic.update_primitive_transforms(scene, dyn, tr).bvh
    assert_layout_holds(moved)
    assert not torch.equal(moved.node_header[:, :6], scene.bvh.node_header[:, :6])
    assert not torch.equal(moved.slot_block, scene.bvh.slot_block)
    assert torch.equal(moved.slot_alpha, scene.bvh.slot_alpha)


def test_trace_without_the_layout():
    """A BVH without the layout: the kernel's wrapper raises before anything
    else (on a device tensor; ``meta`` stands in for the card here) and does
    not fall back; the plain version on the CPU reads node_rows only."""
    leaves, _ = procedural.cornell_scene().bake()
    bvh = scene_arrays_from_numpy(leaves, "cpu").bvh
    bare = bvh._replace(**{f: None for f in traverse.LAYOUT_FIELDS})
    gen = torch.Generator().manual_seed(0)
    o = torch.rand((64, 3), generator=gen) * 0.5 + 0.25
    d = torch.nn.functional.normalize(torch.randn((64, 3), generator=gen), dim=1)
    meta = [x.to("meta") for x in (o, d)]
    with pytest.raises(ValueError, match="no kernel layout"):
        traverse.prepare_trace(bare, *meta, 0.01, 1e30)
    with pytest.raises(ValueError, match="no kernel layout"):
        traverse.trace_rays(bare, *meta, 0.01, 1e30)
    with pytest.raises(ValueError, match="cuda or cpu"):
        traverse.prepare_trace(bvh, *meta, 0.01, 1e30)
    want = traverse.trace_rays(bvh, o, d, 0.01, 1e30)
    got = traverse.trace_rays(bare, o, d, 0.01, 1e30)
    assert bool((want.slot >= 0).any())
    for f in ("t", "slot", "u", "v", "ray_steps"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
