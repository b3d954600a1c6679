"""The traced window, read from ``torch.profiler``'s chrome trace.

The harness wraps each traced frame in a ``bench/frame`` range and the
dynamic update in ``frame/dynamic_update``; the program's frame runs its
stages in ``frame/<stage>`` ranges. A kernel belongs to the range in which the
host launched it: the trace links each kernel to its launch call
(``cuda_runtime`` or ``cuda_driver``, by correlation id), and the launch's time
to the host ranges around it. The hand kernels, launched through ctypes, count
there as the PyTorch ops' kernels do. (A trace of the device's activity alone
holds no ranges, and slows the frame as much: 197.6 against 158.8 ms a probe
frame on an NVIDIA H100.) Times are microseconds as the trace has them; the
readers turn them into the metrics' units.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import NamedTuple

# The hand kernels of csrc/raster.cu and csrc/traverse.cu, by the name the
# compiler gives each kernel (a prefix of the trace's demangled name).
RASTER_KERNELS = ("prep_kernel", "scan_kernel", "raster_kernel", "resolve_kernel")
TRAVERSE_KERNELS = ("traverse_kernel",)


class Op(NamedTuple):
    ts: float  # start, us
    dur: float  # us
    name: str
    correlation: int | None

    @property
    def end(self) -> float:
        return self.ts + self.dur


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    depth, out = 0, []
    for ch in name:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out).split("(")[0].strip()


def is_kernel(op: Op, names) -> bool:
    base = short_name(op.name).split("::")[-1]
    return base in names


class Profile:
    """Device operations and ranges of one traced window of ``frames`` frames."""

    def __init__(self, events: list, frames: int):
        self.frames = frames
        self.kernels, self.device_ops = [], []
        self.ranges: dict[str, list] = {}  # host ranges by name: [(start, end)]
        self.launch_ts: dict[int, float] = {}
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X" or cat is None:
                continue
            op = Op(float(e["ts"]), float(e.get("dur", 0.0)), e.get("name", ""),
                    e.get("args", {}).get("correlation"))
            if cat == "kernel":
                self.kernels.append(op)
                self.device_ops.append(op)
            elif cat in ("gpu_memcpy", "gpu_memset"):
                self.device_ops.append(op)
            elif cat == "user_annotation":
                self.ranges.setdefault(op.name, []).append((op.ts, op.end))
            elif cat in ("cuda_runtime", "cuda_driver") and op.correlation is not None:
                self.launch_ts[op.correlation] = op.ts
        self.kernels.sort()
        self.device_ops.sort()
        for spans in self.ranges.values():
            spans.sort()

    def _at(self, op: Op) -> float | None:
        """When the host issued ``op``'s launch (None: no launch record)."""
        return self.launch_ts.get(op.correlation)

    @staticmethod
    def load(path: Path, frames: int) -> "Profile":
        return Profile(json.loads(Path(path).read_text())["traceEvents"], frames)

    def _launched_in(self, spans: list) -> list:
        starts = [a for a, _ in spans]
        out = []
        for k in self.kernels:
            ts = self._at(k)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                out.append(k)
        return out

    def kernels_in(self, name: str) -> list:
        """The kernels the host launched inside range ``name``."""
        return self._launched_in(self.ranges.get(name, []))

    def frame_kernels(self, index: int) -> list:
        """The kernels of the traced window's frame ``index`` (the
        ``index``-th ``bench/frame`` range)."""
        spans = self.ranges.get("bench/frame", [])
        return self._launched_in(spans[index:index + 1]) if index < len(spans) else []

    def busy_us(self) -> float:
        """Time in which some device operation ran (their intervals' union)."""
        busy, end = 0.0, float("-inf")
        for op in self.device_ops:
            if op.end <= end:
                continue
            busy += op.end - max(op.ts, end)
            end = op.end
        return busy

    def _range_at(self, ts: float) -> str:
        """The innermost range the host was in at ``ts``."""
        inside = [(end - start, name) for name, spans in self.ranges.items()
                  for start, end in spans if start <= ts <= end]
        return min(inside)[1] if inside else "outside any range"

    def idle_gaps(self, limit: int = 10) -> list:
        """[[what the host was doing, seconds]] of the longest gaps between
        device operations: each gap is named by the range in which the host
        launched the operation that ended it, and that operation's short name."""
        gaps, end = [], None
        for op in self.device_ops:
            if end is not None and op.ts > end:
                gaps.append((op.ts - end, op))
            end = op.end if end is None else max(end, op.end)
        gaps.sort(key=lambda g: -g[0])
        out = []
        for dur, op in gaps[:limit]:
            at = self._at(op)
            where = self._range_at(at) if at is not None else "no launch record"
            out.append([f"{where}: before {short_name(op.name)[:80]}", dur * 1e-6])
        return out

    def top_ops(self, limit: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time, summed
        by name over the window."""
        total: dict[str, float] = {}
        for op in self.device_ops:
            total[op.name] = total.get(op.name, 0.0) + op.dur
        top = sorted(total.items(), key=lambda kv: -kv[1])[:limit]
        return [[name[:160], us * 1e-6] for name, us in top]


def stage_ms(prof: Profile | None, span: str) -> float | None:
    """Device ms per traced frame of the kernels launched inside range ``span``,
    or None when no kernel was."""
    kernels = [] if prof is None else prof.kernels_in(span)
    return sum(k.dur for k in kernels) * 1e-3 / prof.frames if kernels else None


def roofline_pct(run, kernels, bound_key: str) -> float | None:
    """100 x the checked frame's bound over its ``kernels``' device time, or None
    when the frame ran none of them or no bound was counted."""
    if run.profile is None or not run.bounds or not run.bounds.get(bound_key):
        return None
    us = sum(k.dur for k in run.profile.frame_kernels(run.check_frame) if is_kernel(k, kernels))
    if us <= 0.0:
        return None
    return 100.0 * run.bounds[bound_key] * 1e3 / us
