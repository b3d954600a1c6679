# Written for the benchmark's plain reference, beside the frozen copies: no original in
# the program.
"""A switch that runs chosen float32 stages of the reference in float64.

``WIDE`` set, a function under ``@widened`` takes its float32 tensor arguments
as float64 and rounds its float64 results back to float32: the same sums in
another order and at a higher precision, as a program that fuses or reorders
a float32 chain without losing precision would compute them. Off, the
functions run as written.

``WIDE_SELECTION`` set beside it also widens what ``WIDE`` leaves in float32
on purpose: the LPV apply's cascade selection and cell coordinates
(ops/lpv.py::apply_lpv), where a wall on the cells' lattice sits on a
cascade's margin. Its readings show that margin; no limit is set from them.
"""

from __future__ import annotations

import functools

import torch

WIDE = False
WIDE_SELECTION = False


def _cast(x, src, dst):
    if isinstance(x, torch.Tensor):
        return x.to(dst) if x.dtype == src else x
    if isinstance(x, tuple):
        items = [_cast(v, src, dst) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def widened(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not WIDE:
            return fn(*args, **kwargs)
        args = [_cast(a, torch.float32, torch.float64) for a in args]
        kwargs = {k: _cast(v, torch.float32, torch.float64) for k, v in kwargs.items()}
        return _cast(fn(*args, **kwargs), torch.float64, torch.float32)

    return run
