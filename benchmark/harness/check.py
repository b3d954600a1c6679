"""How ``correct`` is decided: the window's frames against the plain reference.

The reference (benchmark/reference/plain) bakes the scene from the same
recorded inputs, with its own BVH and texture pool, and renders with the
plain walks in the hand kernels' place. It starts from its own initial
temporal state and renders every frame the program rendered, from the first
warm-up frame to the frame after the checked window frame k, carrying its
own state (RTGI history, probe cache) from frame to frame. It compares the
displayed u8 image of three of them with the program's: frame 0 (the start),
window frame k drawn from the seed, and frame k + 1 (a frame that hands on a
wrong state shows there).

The number compared is ``image_steps``: the u8 steps by which the program's
image departs from the reference's, summed over every value of the image,
at the worst of the three frames. In a moving scene the reference applies
each frame's transforms to its own bake. With ``count_work`` the reference's
frame k also counts the plain walks' work for the bounds (bounds.py).

``variant`` puts a variant of the reference in the comparison, for the
readings a limit is set from (benchmark/tests/readings.py): ``control``
computes it with TF32 allowed in CUDA matmuls and convolutions, the precision
below the float32 with TF32 off that the program states (``init_device``);
``wide`` runs the à-trous filter, the bloom's resizes, the probes'
convolutions, the LPV propagation, the LPV apply's fetch and SH evaluation
(not its cascade selection, reference/plain/ops/lpv.py) and the TAAU
resample's contractions in float64 (reference/plain/precision.py), as a
program that reorders those float32 chains without losing precision would.
``wide_selection`` is ``wide`` with the LPV apply's cascade selection in
float64 too: a reading of the cascade margins, not of reordered sums.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import bounds
from benchmark.harness.frames import make_config

VARIANTS = (None, "control", "wide", "wide_selection")


def _diff(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    """(largest step, values that differ, steps summed) of two u8 images."""
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    return int(d.max()), int((d > 0).sum()), int(d.sum(dtype=torch.int64))


class Reference:
    """The plain reference of one configuration: baked once, then walked."""

    def __init__(self, cfg: dict, record, device):
        from benchmark.reference.plain import config as ref_config
        from benchmark.reference.plain.render import make_renderer
        from benchmark.reference.plain.scene.material_storage import Material
        from benchmark.reference.plain.scene.scene import RenderScene

        self.device = device
        self.config = make_config(ref_config, cfg)
        self.rs = record.replay(RenderScene, Material)
        self.scene, _ = self.rs.build(device=device)
        self.render = make_renderer(self.config)
        self.params = ref_config.RenderParams.default()
        self.dyn = None  # made for the first walk that moves primitives

    def images(self, walk, wanted, variant: str | None = None, count_at: int | None = None):
        """({frame: displayed u8 image} of the frames in ``wanted``, the bounds
        of frame ``count_at`` or None): every frame from 0 to the last wanted
        one, from the reference's own initial state, carrying its state."""
        from benchmark.reference.plain import precision
        from benchmark.reference.plain.ops.raster import raster as ref_raster
        from benchmark.reference.plain.ops.rt import traverse as ref_traverse
        from benchmark.reference.plain.render import temporal_state_for
        from benchmark.reference.plain.scene import dynamic as ref_dynamic

        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r} is none of {VARIANTS}")
        if walk.moved.size and self.dyn is None:
            self.dyn = ref_dynamic.make_dynamic_data(self.rs, self.scene)
        state = temporal_state_for(self.config, device=self.device)
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        out_images, work = {}, None
        try:
            if variant == "control":
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            precision.WIDE = variant in ("wide", "wide_selection")
            precision.WIDE_SELECTION = variant == "wide_selection"
            for f in range(max(wanted) + 1):
                scene = self.scene
                if walk.moved.size:
                    scene = ref_dynamic.update_primitive_transforms(
                        scene, self.dyn, torch.as_tensor(walk.transforms(f), device=self.device))
                if f == count_at:
                    ref_raster.RECORD, ref_traverse.RECORD = [], []
                out, state = self.render(scene, walk.view(f), self.params, state)
                if f == count_at:
                    work = dict(
                        raster_ms=sum(bounds.raster_bound_ms(*c) for c in ref_raster.RECORD),
                        traverse_ms=sum(bounds.traverse_bound_ms(*c)
                                        for c in ref_traverse.RECORD),
                        raster_calls=len(ref_raster.RECORD), traces=len(ref_traverse.RECORD),
                    )
                    ref_raster.RECORD = ref_traverse.RECORD = None
                if f in wanted:
                    out_images[f] = out.image
                del out
        finally:
            ref_raster.RECORD = ref_traverse.RECORD = None
            precision.WIDE = precision.WIDE_SELECTION = False
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        return out_images, work


def compared_frames(held: dict) -> dict:
    """{frame: what it is} of the frames compared."""
    k, f_k = held["k"], held["f_k"]
    return {0: "frame 0", f_k: f"window frame {k}", f_k + 1: f"window frame {k + 1}"}


def judge(images: dict, against: dict, frames: dict) -> tuple[dict, list]:
    """(numbers, per-frame notes) of ``images`` held against ``against``."""
    notes = [(what, *_diff(images[f], against[f])) for f, what in frames.items()]
    return {"image_steps": max(n[3] for n in notes)}, notes


def compare(cfg: dict, walk, record, held: dict, device, variant: str | None = None,
            count_work: bool = False):
    """(numbers: {name: value}, per-frame notes, the bounds of frame k or None):
    the program's images in ``held`` against the reference's."""
    frames = compared_frames(held)
    ref = Reference(cfg, record, device)
    images, work = ref.images(walk, frames, variant,
                              count_at=held["f_k"] if count_work else None)
    program = {0: held["image0"], held["f_k"]: held["image_k"],
               held["f_k"] + 1: held["image_k1"]}
    numbers, notes = judge(program, images, frames)
    return numbers, notes, work


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): each number at or under its limit."""
    table = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    return all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values()), table
