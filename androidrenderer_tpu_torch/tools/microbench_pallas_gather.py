"""The resolve-gather microbench: a hand-written gather-sum kernel against the one
PyTorch call that computes the same function.

The port of tools/microbench_pallas_gather.py. The JAX tool times a Pallas
kernel that pipelines single-row DMAs against XLA's gather; this one times
``pallas_gather`` (here the Hopper kernel csrc/gather.cu, through
``ops/gather.py``) against ``torch.nn.functional.embedding_bag(mode="sum")`` and
against the kernel's plain PyTorch version, on the same shapes: P = 1280 * 736
lookups (the resolve's pixel count) into an (M, C) f32 table, summed per tile of
2048 lookups.

    python -m androidrenderer_tpu_torch.tools.microbench_pallas_gather [--rows 262144] [--width 32]
    python -m androidrenderer_tpu_torch.tools.microbench_pallas_gather --check   # CPU, plain version
    python -m androidrenderer_tpu_torch.tools.microbench_pallas_gather --device cpu --rows 1024

Times are CUDA-event medians on the card and host-clock medians on the CPU;
each line names the device.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from androidrenderer_tpu_torch.ops.gather import TILE, gather_tile_sums, gather_tile_sums_reference

P = 1280 * 736  # lookups (resolve-shaped)


def pallas_gather(table, idx, debug_mode=0, interpret=False):
    """(P,) i32 indices into an (M, C) f32 table -> (P // 2048, 8, C) tile sums.

    The JAX signature: ``interpret`` (Pallas' interpret mode) has no effect, and
    ``debug_mode`` other than 0 raises — those modes were timing stubs that
    skipped the TPU kernel's DMA or its accumulate, and their output meant
    nothing."""
    del interpret
    if debug_mode != 0:
        raise ValueError(f"debug_mode={debug_mode}: the TPU kernel's timing stubs are not ported")
    return gather_tile_sums(table, idx)


def make_inputs(rows: int, width: int, device, lookups: int = P, seed: int = 0):
    """The tool's table (rows, width) f32 uniform in [0, 1) and ``lookups``
    uniform indices, made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.random((rows, width), dtype=np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, rows, lookups).astype(np.int32)).to(device)
    return table, idx


def embedding_bag_sums(table, idx):
    """(P // 2048, C): the one PyTorch call that computes the tile sums."""
    return torch.nn.functional.embedding_bag(idx.view(-1, TILE), table, mode="sum")


def time_ms(fn, device, reps: int = 5) -> float:
    """Median ms of ``reps`` calls of ``fn()`` after one warm-up: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure(table, idx, reps: int = 5) -> dict:
    """ms of ``embedding_bag``, the kernel (``pallas_gather``) and its plain
    version on the same inputs, by name."""
    dev = table.device
    return {
        "embedding_bag": time_ms(lambda: embedding_bag_sums(table, idx), dev, reps),
        "kernel": time_ms(lambda: pallas_gather(table, idx), dev, reps),
        "plain": time_ms(lambda: gather_tile_sums_reference(table, idx), dev, reps),
    }


def check(width: int) -> None:
    """The JAX tool's --check on the CPU: one tile into a 64-row table."""
    table, idx = make_inputs(64, width, "cpu", lookups=TILE)
    got = pallas_gather(table, idx)[0, 0].numpy()
    want = table.numpy()[idx.numpy()].sum(0)
    np.testing.assert_allclose(got, want, rtol=2e-5)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 18)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--check", action="store_true", help="CPU check of the plain version")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.check:
        check(args.width)
        print("check OK")
        return {}
    from androidrenderer_tpu_torch import init_device

    dev = init_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    table, idx = make_inputs(args.rows, args.width, dev)
    times = measure(table, idx)
    for label, ms in times.items():
        print(f"{label:14s} {ms:8.3f} ms  ({ms * 1e6 / P:6.2f} ns/lookup, {name})")
    return times


if __name__ == "__main__":
    main()
