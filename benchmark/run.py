"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, timed over a
window of ``--seconds``; with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of 6 frames (harness/runner.py). Every
run decides ``correct`` against the plain reference (harness/check.py) and
prints each compared number beside its limit, last on standard error and last
in the line. The run exits 2 without a result when the card is missing, and 3
when a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches at fixed paths inside the checkout.
CACHE = ROOT / "build" / "bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path.insert(0, str(ROOT))

# Whole top-level module names that may not be loaded: the JAX stack and the
# JAX package (whose name is a prefix of the program's).
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "androidrenderer_tpu"})


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness.cell import find_cell, load_manifest

    cell = find_cell(load_manifest(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2

    from benchmark.harness.result import result
    from benchmark.harness.runner import run_cell

    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"modules that the run may not load were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": run.peak_bytes}
    out, lines = result(cell, run, bool(args.trace), device)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
