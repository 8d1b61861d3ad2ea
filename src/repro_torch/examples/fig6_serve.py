"""Figure 6 (extension): multi-tenant SolveEngine serving throughput; the
twin of ``benchmarks/fig6_serve.py``.

The SBGEMM kernels amortize F_hat reads over S stacked columns; the
:class:`~repro_torch.runtime.SolveEngine` fills that S axis with
independent users.  For each S of the sweep, S compatible solve requests
(same operator, one tolerance decade) are served

  - ``coalesced``  one multi-RHS CGNR per bucket, per-column stopping
                   (the engine's default path);
  - ``naive``      the same requests one at a time (``coalesce=False``),
                   the same tuning path and appliers.

Derived columns: requests/s for both paths and their ratio.  The warm-up
serve runs the cold autotune and builds the served operator outside the
timed region; the JSON records the reuse counters across the timed sweep
(no operator or applier is built there) and the kernel launches of one
more coalesced serve at the widest S.

    python -m repro_torch.examples.fig6_serve [--smoke] [--out PATH]
    python -m repro_torch.examples.fig6_serve --device cpu --smoke

On the card each serve is timed with CUDA events (the median of
``repeats`` after one warm-up).  On the CPU the tuner and the sweep time
with the host clock (the best of ``repeats``, as the reference) and the
JSON says so; those are CPU times, not device times.  The output goes to
``--out`` only (default ``chiprun_out/fig6_serve.json``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Callable, Optional

import torch

from repro_torch.core import FFTMatvec, random_block_column
from repro_torch.core.precision import DOUBLE
from repro_torch.core.timing import TimingHarness, time_callable
from repro_torch.backend import default_device
from repro_torch.examples.mixed_precision_pareto import host_timer
from repro_torch.kernels import _build
from repro_torch.runtime import SolveEngine, SolveRequest

FULL = dict(N_t=64, N_d=8, N_m=256, sweep=(1, 4, 16, 64), max_iters=300,
            repeats=3)
SMOKE = dict(N_t=16, N_d=3, N_m=24, sweep=(1, 4, 16, 64), max_iters=400,
             repeats=2)
# one decade bucket: every request coalesces, none is served looser
TOLS = (1e-6, 3e-6, 9e-6)


def make_requests(op, S: int, max_iters: int, *, damp: float = 0.0,
                  seed: int = 3) -> list[SolveRequest]:
    """S consistent observations (D = F M_true, M_true from a seeded
    generator on the operator's device), one request per user."""
    gen = torch.Generator(device=op.device).manual_seed(seed)
    M_true = torch.randn((op.N_m, op.N_t, S), generator=gen,
                         device=op.device, dtype=torch.float64)
    D = op.matmat(M_true)
    return [SolveRequest(uid=i, d_obs=D[..., i], tol=TOLS[i % len(TOLS)],
                         max_iters=max_iters, damp=damp)
            for i in range(S)]


def host_ms(fn, arg, repeats: int, warmup: int = 1) -> float:
    """Best of ``repeats`` host-clock calls after ``warmup``, in ms (a CPU
    time, not a device metric)."""
    for _ in range(warmup):
        fn(arg)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(arg)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def device_ms(fn, arg, repeats: int, warmup: int = 1) -> float:
    """Median of ``repeats`` CUDA-event timed calls after ``warmup``."""
    return time_callable(fn, arg, repeats=repeats, warmup=warmup,
                         mode="median")


def sweep(eng: SolveEngine, op, sizes, *, max_iters: int, repeats: int,
          time_fn: Callable, damp: float = 0.0,
          naive_repeats: Optional[dict] = None,
          check: Optional[Callable] = None) -> dict:
    """Time coalesced and naive serves of ``S`` requests on ``op`` for
    each S of ``sizes``; ``time_fn(fn, arg, repeats, warmup)`` returns ms.

    A warm-up serve (both paths, 2 requests) tunes the bucket and builds
    the served operator first.  ``naive_repeats`` maps an S to fewer naive
    repeats (one warm-up each).  ``check(S, requests, coalesced, naive)``,
    if given, sees each S's last outcomes of both paths.  Returns the
    per-S times, requests/s and ratio, the ``stats["coalesced"]`` entries
    of each path, the reuse counters across the timed sweep, and the
    launch counts and iterations of one more coalesced serve at
    ``max(sizes)``."""
    warm = make_requests(op, 2, max_iters, damp=damp)
    eng.serve(warm)
    eng.serve(warm, coalesce=False)
    jit_before = eng.jit_stats()
    results = {"sweep": {}}
    for S in sizes:
        reqs = make_requests(op, S, max_iters, damp=damp)
        last = {}

        def serve(coalesce):
            def call(_):
                last[coalesce] = eng.serve(reqs, coalesce=coalesce)
            return call

        n0 = len(eng.stats["coalesced"])
        t_c = time_fn(serve(True), None, repeats, 1) * 1e-3
        n1 = len(eng.stats["coalesced"])
        t_n = time_fn(serve(False), None,
                      (naive_repeats or {}).get(S, repeats), 1) * 1e-3
        rps_c, rps_n = S / t_c, S / t_n
        row = results["sweep"][str(S)] = {
            "t_coalesced_s": t_c, "t_naive_s": t_n,
            "rps_coalesced": rps_c, "rps_naive": rps_n,
            "ratio": rps_c / rps_n,
            "coalesced_batches": sorted(set(eng.stats["coalesced"][n0:n1])),
            "naive_batches": sorted(set(eng.stats["coalesced"][n1:])),
            "iters_max": max(o.n_iters for o in last[True]),
            "config": last[True][0].config}
        print(f"fig6/serve S={S}: coalesced {rps_c:.2f} requests/s, naive "
              f"{rps_n:.2f} ({row['ratio']:.2f}x); config {row['config']}, "
              f"at most {row['iters_max']} iterations", flush=True)
        if check is not None:
            check(S, reqs, last[True], last[False])
        del last, reqs

    jit_after = eng.jit_stats()
    re_serve = make_requests(op, max(sizes), max_iters, damp=damp)
    _build.reset_launch_counts()
    out = eng.serve(re_serve)
    if op.device.type == "cuda":
        torch.cuda.synchronize(op.device)
    launches = dict(_build.launch_counts)
    results["jit"] = {
        "n_appliers": jit_after["n_appliers"],
        "appliers_grown_during_timed":
            jit_after["n_appliers"] - jit_before["n_appliers"],
        "n_traces": jit_after["n_traces"],
        "traces_during_timed":
            jit_after["n_traces"] - jit_before["n_traces"],
        "traces_on_repeat_serve":
            eng.jit_stats()["n_traces"] - jit_after["n_traces"],
        "appliers_on_repeat_serve":
            eng.jit_stats()["n_appliers"] - jit_after["n_appliers"]}
    results["repeat_serve"] = {"S": max(sizes), "launches": launches,
                               "iters_max": max(o.n_iters for o in out)}
    return results


def run(p: dict, device=None, seed: int = 0) -> dict:
    """The sweep of ``p`` (:data:`FULL` or :data:`SMOKE`) on a seeded f64
    operator on ``device`` (None = the card); returns the JSON record."""
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    F_col = random_block_column(gen, p["N_t"], p["N_d"], p["N_m"],
                                dtype=torch.float64)
    op = FFTMatvec.from_block_column(F_col, precision=DOUBLE, device=dev)
    on_card = dev.type == "cuda"
    harness = TimingHarness(timer=None if on_card else host_timer)
    eng = SolveEngine(op, harness=harness, max_batch=max(p["sweep"]))
    results = {"shape": {k: p[k] for k in ("N_t", "N_d", "N_m")},
               "tols": list(TOLS), "device": str(dev),
               "device_name": (torch.cuda.get_device_name(dev) if on_card
                               else "cpu"),
               "clock": "cuda events" if on_card else "host"}
    results.update(sweep(eng, op, p["sweep"], max_iters=p["max_iters"],
                         repeats=p["repeats"],
                         time_fn=device_ms if on_card else host_ms))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes (the reference's CI smoke sizes)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out", default="chiprun_out/fig6_serve.json",
                    help="JSON artifact path")
    args = ap.parse_args(argv)
    results = run(SMOKE if args.smoke else FULL, args.device)
    results["smoke"] = bool(args.smoke)
    if results["clock"] == "host":
        print("(times: host clock on the CPU, not device times)")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, sort_keys=True))
    print(f"# wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
