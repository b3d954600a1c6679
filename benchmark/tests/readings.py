"""Readings of the compared number over many seeds in one process, on the card.

    python3 benchmark/tests/readings.py --workload <cell> --seeds 11,12,13 \
        --variants control,wide
    python3 benchmark/tests/readings.py --config benchmark/configs/<name>.json \
        --traffic walk --seeds 11,12,13 --variants program,control,wide

Bakes the reference of a cell, or of a configuration file under a traffic mix
that no cell pairs yet, once, and for each seed walks the frames a run of that
seed compares: the plain reference, then each variant in the program's place,
held against the plain one. The variants are the reference's (harness/check.py:
``control``, ``wide`` and ``wide_selection``, the default set) and
``program``: a run of that seed through the timed path (runner.run_cell with a
short window), whose number is the one a benchmark run compares (the sound
runs, where the program does not equal the plain reference bit for bit).
Prints, per seed and variant, the number and the frames it was read from. The
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
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--workload", help="a cell of BENCHMARK.json")
    which.add_argument("--config", help="a configuration file, with --traffic")
    ap.add_argument("--traffic", help="the name of a file under benchmark/traffic/")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="control,wide,wide_selection")
    args = ap.parse_args(argv)
    if (args.config is None) != (args.traffic is None):
        ap.error("--config and --traffic go together")

    import torch

    from benchmark.harness import check
    from benchmark.harness.cell import Cell, find_cell, load_manifest
    from benchmark.harness.frames import make_walk, scene_record
    from benchmark.harness.runner import checked_frame, run_cell

    if not torch.cuda.is_available():
        print("readings are taken on the card; no CUDA device here", file=sys.stderr)
        return 2
    if args.workload:
        cell = find_cell(load_manifest(ROOT), args.workload, ROOT)
    else:
        cfg = json.loads(Path(args.config).read_text())
        traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{args.traffic}.json").read_text())
        cell = Cell(f"{Path(args.config).stem}.{args.traffic}", 1, cfg, traffic, [], [])
    name, cfg, traffic = cell.name, cell.config, cell.traffic
    variants = args.variants.split(",")
    record = scene_record(cfg)
    ref = None
    if set(variants) - {"program"}:
        t = time.perf_counter()
        ref = check.Reference(cfg, record, "cuda")
        print(json.dumps({"workload": name, "bake_s": time.perf_counter() - t}), flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        walk = make_walk(cfg, traffic, seed, record)
        k = checked_frame(seed)
        frames = check.compared_frames({"k": k, "f_k": int(cfg["warmup_frames"]) + k})
        t = time.perf_counter()
        plain = ref.images(walk, frames)[0] if ref is not None else None
        plain_s = time.perf_counter() - t
        for variant in variants:
            t = time.perf_counter()
            if variant == "program":
                run = run_cell(cell, seed, 0.1, False)
                numbers, notes = run.numbers, run.notes
            else:
                images, _ = ref.images(walk, frames, variant)
                numbers, notes = check.judge(images, plain, frames)
                del images
            print(json.dumps({"workload": name, "seed": seed, "variant": variant,
                              "numbers": numbers, "frames": notes, "plain_s": plain_s,
                              "s": time.perf_counter() - t}), flush=True)
        del plain
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
