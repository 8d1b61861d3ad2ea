"""Device timing with CUDA events.

Only ``time_callable`` is ported so far; the config-sweep harness waits
for the autotuner's slice.  A measurement needs the card: there is no CPU
fallback, because a host-clock number is not a device time.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def time_callable(fn: Callable, arg, repeats: int = 20,
                  warmup: int = 3) -> float:
    """Median device time of ``fn(arg)`` in milliseconds.

    Each of ``repeats`` calls (after ``warmup`` untimed ones) sits between
    two CUDA events on the current stream; the events are read after one
    final synchronise.  Raises when no CUDA device is present.
    """
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    if not torch.cuda.is_available():
        raise RuntimeError("time_callable measures device time and needs a "
                           "CUDA device")
    for _ in range(warmup):
        fn(arg)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
