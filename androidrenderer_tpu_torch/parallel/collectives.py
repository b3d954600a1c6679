"""Cross-band collectives for sharded rendering — the frame's traffic between ranks.

The port of the JAX package's parallel/collectives.py. Everything here runs on
one rank of a ``torch.distributed`` process group (``group``), on the band that
rank renders. The design goal is the single-device frame's output: halo
exchanges reproduce the exact row neighbourhoods the full-frame operators see
(wrap for roll-based taps, edge for pad-based ones), and full-frame passes (TAA
history fetch, bloom/upscale) gather their inputs and run replicated.

Every collective is one all-reduce SUM over the integer view of a zeroed
full-size buffer into which each rank writes the elements it owns: exactly one
rank contributes each element and the others contribute zero bits, so the sum
is that rank's bits, for any dtype (a float sum would turn -0.0 into +0.0).
One primitive serves every backend and device: gloo accepts CUDA tensors for
all-reduce and broadcast only (not all-gather or send/recv), NCCL takes all of
them. The cost is n times a gather's bytes, which the halos (a few rows) and
the frame-sized gathers (tens of MB at 1080p) afford. Results stay on the
input's device, and no collective reads a value on the host (gloo itself
waits for its copies through host memory; NCCL runs on the stream). Each
all-reduce runs inside a ``frame/collectives`` profiler range, so a profile
of a sharded frame shows what the collectives cost.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.profiler import record_function

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _int_view(x: torch.Tensor) -> torch.Tensor:
    """The same bytes as a signed integer tensor (bools as uint8)."""
    if x.dtype == torch.bool:
        return x.view(torch.uint8)
    if x.dtype.is_floating_point:
        return x.view(_BITS[x.element_size()])
    return x


def assemble(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum of ``x``'s integer view across ``group``: the
    elementwise bits of the one rank that wrote each element (every other rank
    must hold zeros there). Returns a new tensor; ``x`` is unchanged."""
    out = x.contiguous().clone()
    with record_function("frame/collectives"):
        dist.all_reduce(_int_view(out), op=dist.ReduceOp.SUM, group=group)
    return out


def band_index(group) -> tuple[int, int]:
    """(rank, number of ranks) of this process in ``group``, as Python ints."""
    return dist.get_rank(group), dist.get_world_size(group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The full-frame array from every rank's row band (all bands equal height)."""
    d, n = band_index(group)
    h = x.shape[0]
    full = x.new_zeros((n * h, *x.shape[1:]))
    full[d * h:(d + 1) * h] = x
    return assemble(full, group)


def any_across(mask: torch.Tensor, group) -> torch.Tensor:
    """Elementwise OR of a boolean tensor across ``group``."""
    count = mask.to(torch.int32)
    with record_function("frame/collectives"):
        dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
    return count > 0


def row_halo(x: torch.Tensor, halo: int, group, wrap: bool) -> torch.Tensor:
    """Extend a row-sharded (h, w, ...) band with ``halo`` rows from each neighbour.

    ``wrap=True`` reproduces torch.roll semantics across the full frame (rank
    0's top halo comes from the last rank); ``wrap=False`` reproduces edge-pad
    semantics (the outermost ranks replicate their own boundary row)."""
    d, n = band_index(group)
    h = x.shape[0]
    if n == 1:
        if wrap:
            return torch.cat([x[-halo:], x, x[:halo]], dim=0)
        return torch.cat([x[:1].expand(halo, *x.shape[1:]), x,
                          x[-1:].expand(halo, *x.shape[1:])], dim=0)
    if halo > h:
        # The halo spans more than one neighbour band (tiny bands, half-rate
        # grids): take the rows from the gathered frame.
        full = gather_rows(x, group)
        rows = d * h + torch.arange(-halo, h + halo, device=x.device)
        rows = rows % full.shape[0] if wrap else rows.clamp(0, full.shape[0] - 1)
        return full[rows]
    # Every rank's top and bottom ``halo`` rows, assembled in one all-reduce.
    edges = x.new_zeros((n, 2, halo, *x.shape[1:]))
    edges[d, 0] = x[:halo]
    edges[d, 1] = x[-halo:]
    edges = assemble(edges, group)
    top = edges[(d - 1) % n, 1]  # the previous band's bottom rows
    bot = edges[(d + 1) % n, 0]  # the next band's top rows
    if not wrap:
        if d == 0:
            top = x[:1].expand(halo, *x.shape[1:])
        if d == n - 1:
            bot = x[-1:].expand(halo, *x.shape[1:])
    return torch.cat([top, x, bot], dim=0)
