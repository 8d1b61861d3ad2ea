"""Device timing with CUDA events, and the config-sweep harness.

Lives in ``core`` (not ``tune``) so the layering stays one-directional:
``core.pareto.measure_configs`` and the tuner both build on it; the tuner
re-exports :class:`TimingHarness`.

A measurement needs the card: there is no CPU fallback, because a
host-clock number is not a device time.  A caller on the CPU (a test, the
example run with ``--device cpu``) hands the harness its own ``timer``.

The harness keeps no operator: each candidate config's operator holds its
own F_hat copy (2-8 GB at the paper shape), so the harness builds a
callable per measurement and records only (config, variant, time).  PyTorch
runs eagerly, so there is no traced applier to share across configs.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, Optional

import torch

VARIANTS = ("matvec", "rmatvec", "matmat", "rmatmat", "gram")
MODES = ("median", "throughput", "latency")


def time_callable(fn: Callable, arg, repeats: int = 20, warmup: int = 3,
                  mode: str = "median") -> float:
    """Device time of one ``fn(arg)`` in milliseconds, after ``warmup``
    untimed calls.

    ``mode="median"``: an event pair around each of ``repeats`` calls, the
    median.  ``"throughput"`` (the paper's protocol): ``repeats`` calls
    back to back between one event pair, the mean, so launches overlap as
    in a sustained loop.  ``"latency"``: an event pair around each call,
    the minimum.  Raises when no CUDA device is present.
    """
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    if mode not in MODES:
        raise ValueError(f"unknown timing mode {mode!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("time_callable measures device time and needs a "
                           "CUDA device")
    for _ in range(warmup):
        fn(arg)
    torch.cuda.synchronize()
    if mode == "throughput":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn(arg)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / repeats
    pairs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in pairs]
    return min(times) if mode == "latency" else statistics.median(times)


@dataclasses.dataclass
class TimedEntry:
    config: object          # PrecisionConfig
    variant: str
    time_s: float


def _sync(out) -> None:
    if torch.is_tensor(out) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


class TimingHarness:
    """Measures operator applications across precision configs.

    ``repeats``, ``warmup``, ``mode`` go to :func:`time_callable`.
    ``timer`` optionally overrides it: ``timer(cfg, fn, arg) -> seconds``
    (the oracle tests inject a synthetic cost model shared by the
    exhaustive and pruned paths; the example on the CPU a host clock).
    """

    def __init__(self, *, repeats: int = 5, warmup: int = 2,
                 mode: str = "throughput",
                 timer: Optional[Callable] = None):
        if repeats < 1:
            raise ValueError(f"repeats must be >= 1, got {repeats}")
        if mode not in MODES:
            raise ValueError(f"unknown timing mode {mode!r}")
        self.repeats = repeats
        self.warmup = warmup
        self.mode = mode
        self.timer = timer
        self.timed: list[TimedEntry] = []
        self.n_runs = 0             # operator applications issued

    @staticmethod
    def callable_for(op, variant: str = "matvec") -> Callable:
        """The single-argument callable of ``op``'s variant ("gram" is the
        fused parameter-space Gram, CGNR's F*F)."""
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        if variant == "gram":
            return op.gram(space="parameter").apply
        return getattr(op, variant)

    def run_once(self, op, v, variant: str = "matvec"):
        """One application, for its error only (not counted as timed)."""
        out = self.callable_for(op, variant)(v)
        _sync(out)
        self.n_runs += 1
        return out

    def time(self, op, v, variant: str = "matvec"):
        """Measure ``op``'s variant: returns ``(output, seconds)``."""
        fn = self.callable_for(op, variant)
        out = fn(v)
        _sync(out)
        self.n_runs += 1
        if self.timer is not None:
            t = float(self.timer(op.precision, fn, v))
        else:
            t = 1e-3 * time_callable(fn, v, self.repeats, warmup=self.warmup,
                                     mode=self.mode)
            self.n_runs += self.repeats + self.warmup
        self.timed.append(TimedEntry(op.precision, variant, t))
        return out, t

    @property
    def n_timed(self) -> int:
        return len(self.timed)

    def timed_configs(self, variant: str | None = None) -> list:
        return [e.config for e in self.timed
                if variant is None or e.variant == variant]

    def reset_counters(self) -> None:
        """Zero the measurement counters."""
        self.timed.clear()
        self.n_runs = 0
