"""The result line a run prints, and the check lines beside it."""

from __future__ import annotations

from benchmark.harness.cell import Cell, metric_reader
from benchmark.harness.check import verdict

GIB = 2 ** 30


def end_to_end(run) -> dict:
    """The end-to-end metrics' values, by name (the manifest picks which to print)."""
    return {
        "frame_ms": run.frame_ms,
        "frame_ms_p95": run.frame_ms_p95,
        "peak_mem_gib": run.peak_bytes / GIB,
        "setup_s": run.setup_s,
    }


def result(cell: Cell, run, trace: bool, device: dict) -> tuple[dict, list]:
    """(the result object, the check lines for standard error)."""
    correct, checks = verdict(run.numbers, cell.config["limits"])
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(run.info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(run)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {"correct": bool(correct), "attempted": run.frames, "failed": 0, "metrics": metrics,
           "device": dict(device)}
    if trace and run.info.profile is not None:
        prof = run.info.profile
        out["device"]["busy_s"] = prof.busy_us() * 1e-6
        out["device"]["window_s"] = run.info.window_s
        out["breakdown"] = {"device_ops": prof.top_ops(), "idle_gaps": prof.idle_gaps()}
    out["checks"] = checks
    lines = [f"compared {what}: {steps} u8 steps in {values} values that differ, largest "
             f"step {step}" for what, step, values, steps in run.notes]
    lines.append(f"reference: its bake and {run.info.check_frames} frames in "
                 f"{run.info.check_s:.1f} s")
    if trace and run.info.profile is not None and run.info.untraced_frame_ms:
        traced_ms = run.info.window_s * 1e3 / run.info.profile.frames
        lines.append(f"frame ms: traced {traced_ms:.3f}, untraced right after "
                     f"{run.info.untraced_frame_ms:.3f}")
    lines += [f"check {name}: {v['value']} (limit {v['limit']})" for name, v in checks.items()]
    return out, lines
