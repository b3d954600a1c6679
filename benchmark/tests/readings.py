"""Readings of the compared number over many seeds in one process, on the card.

    python3 benchmark/tests/readings.py --workload <cell> --seeds 11,12,13 \
        --variants control,wide

Bakes the cell's reference once, and for each seed walks the frames a run of
that seed compares: the plain reference, then each variant of it
(harness/check.py) in the program's place, held against the plain one. The
program equals the plain reference where it is sound, so these are the
readings that a run of the program computed that way would give. Prints,
per seed and variant, the number and the frames it was read from. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="control,wide")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import check
    from benchmark.harness.cell import find_cell, load_manifest
    from benchmark.harness.frames import rest_transforms, scene_record
    from benchmark.harness.runner import checked_frame
    from benchmark.harness.walk import Walk

    if not torch.cuda.is_available():
        print("readings are taken on the card; no CUDA device here", file=sys.stderr)
        return 2
    cell = find_cell(load_manifest(ROOT), args.workload, ROOT)
    cfg = cell.config
    record = scene_record(cfg)
    t = time.perf_counter()
    ref = check.Reference(cfg, record, "cuda")
    print(json.dumps({"workload": cell.name, "bake_s": time.perf_counter() - t}), flush=True)
    rc, cam = cfg["render_config"], cfg["camera"]
    for seed in (int(s) for s in args.seeds.split(",")):
        walk = Walk(cell.traffic, seed, rc["width"], rc["height"], cam["fov_degrees"],
                    cam["z_near"], record.primitive_meshes(), rest_transforms(record))
        k = checked_frame(seed)
        frames = check.compared_frames({"k": k, "f_k": int(cfg["warmup_frames"]) + k})
        t = time.perf_counter()
        plain, _ = ref.images(walk, frames)
        plain_s = time.perf_counter() - t
        for variant in args.variants.split(","):
            t = time.perf_counter()
            images, _ = ref.images(walk, frames, variant)
            numbers, notes = check.judge(images, plain, frames)
            print(json.dumps({"workload": cell.name, "seed": seed, "variant": variant,
                              "numbers": numbers, "frames": notes, "plain_s": plain_s,
                              "s": time.perf_counter() - t}), flush=True)
            del images
        del plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
