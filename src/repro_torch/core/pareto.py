"""Pareto-front analysis of mixed-precision configurations (paper §3.2,
Fig. 3).

For every per-phase precision configuration, measure (a) the relative L2
error against the all-highest-precision baseline and (b) the runtime; the
Pareto front is the set of non-dominated (time, error) points, and the
*optimal* configuration for an application is the fastest one whose error
stays below the application's tolerance (set from the sensor noise level,
paper §3.2).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import torch

from .precision import PrecisionConfig, all_configs, max_level
from .timing import TimingHarness


@dataclasses.dataclass
class ConfigRecord:
    config: PrecisionConfig
    rel_error: float
    time_s: float
    speedup: float = float("nan")   # vs the baseline config

    @property
    def prec(self) -> str:
        return self.config.to_string()


def rel_l2(x, ref) -> float:
    """||x - ref||_2 / ||ref||_2 in f64, on the device ``x`` lives on
    (``ref`` is moved there).  A zero reference divides by 1."""
    x64 = torch.as_tensor(x).to(torch.float64)
    r64 = torch.as_tensor(ref).to(device=x64.device, dtype=torch.float64)
    denom = torch.linalg.vector_norm(r64).item()
    num = torch.linalg.vector_norm(x64 - r64).item()
    return num / (denom if denom else 1.0)


def measure_configs(op_builder: Callable[[PrecisionConfig], object], v,
                    configs: Iterable[PrecisionConfig] | None = None, *,
                    adjoint: bool = False, baseline: str | None = None,
                    repeats: int = 5, warmup: int = 2,
                    mode: str = "throughput", variant: str | None = None,
                    harness: TimingHarness | None = None
                    ) -> list[ConfigRecord]:
    """Run every configuration, recording its error against the baseline
    config's output and its time.  ``op_builder(cfg)`` returns a ready
    operator; it is dropped after its measurement, so one candidate's
    F_hat copy is alive at a time.

    ``variant`` selects the operator method ("matvec", "rmatvec",
    "matmat", "rmatmat", "gram"; default follows ``adjoint``).  An explicit
    ``harness`` carries its own repeats/warmup/mode/timer; those arguments
    here apply only to the default-constructed one."""
    configs = list(configs) if configs is not None else list(all_configs())
    if baseline is None:
        baseline = max_level([c.highest() for c in configs])
    base_cfg = PrecisionConfig(*([baseline] * 5))
    if variant is None:
        variant = "rmatvec" if adjoint else "matvec"
    if harness is None:
        harness = TimingHarness(repeats=repeats, warmup=warmup, mode=mode)

    def run(cfg: PrecisionConfig):
        return harness.time(op_builder(cfg), v, variant)

    ref_out, base_t = run(base_cfg)
    records = []
    for cfg in configs:
        if cfg == base_cfg:
            records.append(ConfigRecord(cfg, 0.0, base_t, 1.0))
            continue
        out, t = run(cfg)
        records.append(ConfigRecord(cfg, rel_l2(out, ref_out), t, base_t / t))
        del out
    return records


def pareto_front(records: Sequence[ConfigRecord]) -> list[ConfigRecord]:
    """Non-dominated set: no other record is both faster and more accurate.

    Domination is strict in at least one axis, so exact (time, error)
    duplicates never eliminate each other: a set of identical points is
    returned whole, and a single record is its own front."""
    front = []
    for r in records:
        dominated = any(
            (o.time_s <= r.time_s and o.rel_error <= r.rel_error
             and (o.time_s < r.time_s or o.rel_error < r.rel_error))
            for o in records)
        if not dominated:
            front.append(r)
    return sorted(front, key=lambda r: r.time_s)


def optimal_config(records: Sequence[ConfigRecord],
                   tolerance: float) -> ConfigRecord:
    """Fastest configuration whose relative error stays below ``tolerance``
    (the paper uses 1e-7 for the FP64/FP32 ladder)."""
    ok = [r for r in records if r.rel_error <= tolerance]
    if not ok:
        raise ValueError(f"no configuration meets tolerance {tolerance}")
    return min(ok, key=lambda r: r.time_s)


def format_table(records: Sequence[ConfigRecord], front=None) -> str:
    """One line per record, fastest first; ``*`` marks the front."""
    front_set = {id(r) for r in (front or [])}
    width = max([6] + [len(r.prec) for r in records])
    lines = [f"{'prec':>{width}} {'rel_err':>12} {'time_ms':>10} "
             f"{'speedup':>8} {'front':>6}"]
    for r in sorted(records, key=lambda r: r.time_s):
        lines.append(f"{r.prec:>{width}} {r.rel_error:>12.3e} "
                     f"{r.time_s * 1e3:>10.3f} {r.speedup:>8.2f} "
                     f"{'*' if id(r) in front_set else '':>6}")
    return "\n".join(lines)
