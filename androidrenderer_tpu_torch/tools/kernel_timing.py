"""Kernel-only device time of a launch function, on the card.

``kernel_only_ms(launch)`` times the launch alone, its buffers and inputs
prepared beforehand: ``reps`` launches back to back between one CUDA event
pair, divided by ``reps``. A device-side sleep ahead of the first event lets
the host enqueue every launch before the first one runs, so the host's time
stays out of the window. ``in_turns`` compares two launches on one card, old,
new, new, old. Used by chip_smoke.py and tools/raster_cuts.py.
"""

from __future__ import annotations

import torch

# ~25 ms of the H100's clock: longer than the host takes to enqueue 50 raster
# launches (five CUDA calls each).
_SLEEP_CYCLES = 50_000_000


def kernel_only_ms(launch, reps: int = 50) -> float:
    """Device ms of one ``launch()``, after one warm-up launch."""
    launch()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def in_turns(new, old):
    """(kernel-only ms of ``new``, of ``old`` or None): timed old, new, new, old
    when there is an ``old``, each the mean of its two turns."""
    if old is None:
        return kernel_only_ms(new), None
    t = [kernel_only_ms(f) for f in (old, new, new, old)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
