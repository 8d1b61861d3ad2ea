"""Dynamic mixed-precision selection (paper §3.2, Fig. 3) through
``repro_torch.tune``, the twin of ``examples/mixed_precision_pareto.py``.

The paper's Pareto analysis as a run-time service: instead of timing all
32 FP64/FP32 per-phase configurations, the tuner evaluates the eq.-(6)
error model over the whole lattice (calibrated from a handful of probe
runs), prunes configs that cannot meet the tolerance or are
precision-dominated by a cheaper candidate, and times only the surviving
frontier.  The exhaustive sweep runs beside it for comparison: the same
selection from a fraction of the measurements.  A second run repeats it
for the f32/bf16 ladder.

    python -m repro_torch.examples.mixed_precision_pareto              # the card
    python -m repro_torch.examples.mixed_precision_pareto --device cpu

On the card, times are CUDA-event device times.  On the CPU there is no
device clock: the example times with the host clock and says so; those
numbers are CPU times, not device metrics.  The inputs come from a seeded
``torch.Generator``, so they differ from the JAX example's; timing noise
can make the two selections differ where two configs' times are close
(the errors are identical between the tuner and the sweep).
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.core import (FFTMatvec, all_configs, format_table,
                              measure_configs, optimal_config, pareto_front,
                              random_unrepresentable)
from repro_torch.core.toeplitz import default_device
from repro_torch.tune import TimingHarness, autotune

SHAPE = (128, 25, 625)      # N_t, N_d, N_m: the JAX example's shape
RUNS = ((("d", "s"), 1e-7, "paper ladder: FP64 baseline / FP32 low", True),
        (("s", "h"), 1e-2, "f32 baseline / bf16 low", False))


def host_timer(cfg, fn, arg, repeats: int = 3) -> float:
    """Seconds per call on the host clock: the CPU's stand-in for the
    CUDA-event harness (a CPU time, not a device metric)."""
    fn(arg)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(arg)
    return (time.perf_counter() - t0) / repeats


def run(device=None, levels=("d", "s"), tol: float = 1e-7,
        exhaustive: bool = False, seed: int = 0, verbose: bool = True) -> dict:
    """One tuning run at :data:`SHAPE` on ``device`` (None = the card);
    returns the numbers it prints."""
    dev = default_device(device)
    say = print if verbose else (lambda *a, **k: None)
    N_t, N_d, N_m = SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed)
    # paper §4.2.1: inputs must NOT be exactly representable at the lower
    # precision, or copy phases at the low level would show zero error
    F_col = random_unrepresentable(gen, (N_t, N_d, N_m)) / math.sqrt(N_m)
    m = random_unrepresentable(gen, (N_m, N_t))
    op = FFTMatvec.from_block_column(F_col, device=dev)
    timer = host_timer if dev.type == "cpu" else None
    harness = TimingHarness(repeats=3, timer=timer)
    res = autotune(op, tol=tol, v=m, ladder=levels, harness=harness)
    say(format_table(res.records, res.front))
    say(f"--> {res.summary()}")
    out = {"ladder": "".join(levels), "tol": tol, "device": str(dev),
           "clock": "host" if timer else "cuda events",
           "choice": res.config.to_string(), "rel_error": res.record.rel_error,
           "time_ms": res.record.time_s * 1e3, "speedup": res.record.speedup,
           "n_timed": res.n_timed, "n_lattice": res.n_lattice}
    if exhaustive:
        records = measure_configs(
            lambda cfg: FFTMatvec.from_block_column(F_col, precision=cfg,
                                                    device=dev),
            m, list(all_configs(levels)), harness=harness)
        best = optimal_config(records, tol)
        out.update(exhaustive_choice=best.prec,
                   exhaustive_rel_error=best.rel_error,
                   front_size=len(pareto_front(records)),
                   agree=best.config == res.config)
        say(f"    exhaustive sweep: {len(records)} configs timed, front size "
            f"{out['front_size']}, optimal {best.prec} (rel_err "
            f"{best.rel_error:.2e}); tuner vs exhaustive: "
            f"{'AGREE' if out['agree'] else 'DIFFER (timing noise)'}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for levels, tol, title, exhaustive in RUNS:
        print(f"=== {title} (tolerance {tol:g}) ===")
        out = run(args.device, levels, tol, exhaustive, args.seed)
        if out["clock"] == "host":
            print("    (times: host clock on the CPU, not device times)")
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
