"""``python -m repro_torch.analysis``: lint the paper plan families.

Sweeps the paper-shape plan matrix (single-device matvec forward and
adjoint, exact and circulant Gram, the hierarchical 2-D-grid matvec, the
ring schedules of F and F*, and the mesh Gram) across the registered
backends and precision configs, entirely by abstract tracing: the sweep
runs in seconds with no device memory at N_m = 5000.  The mesh plans
trace as one rank of the reference's 2 x 4 grid over a fake process
group (``context.PlanContext.grid``).  A CUDA backend's plans trace only
where a card is present (``context.traceable``); without one the sweep
says so and skips them.

Exit status 1 when any error-severity finding fires (``--strict``
promotes warnings).  ``--json`` emits one machine-readable report;
``--rules`` prints the registered rule catalog and exits.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from repro_torch.backend import known_backends
from repro_torch.configs.fftmatvec_paper import PAPER_SINGLE, SMOKE
from repro_torch.core.pipeline import ExecOpts, Plan, gram_plan, matvec_plan
from repro_torch.core.precision import PrecisionConfig

from .context import traceable
from .findings import ERROR, Finding
from .rules import lint_plan, rule_catalog

# the reference's grid for the mesh plans: 2 x 4 (its measured
# BENCH_fig4 leg); the paper and smoke dims both tile it
GRID_ROW, GRID_COL = 2, 4

DEFAULT_CONFIGS = ("ddddd", "dssdd", "sssss")


def plan_matrix(cfg: PrecisionConfig) -> Dict[str, Tuple[Plan, dict]]:
    """name -> (plan, extra lint_plan kwargs) for one precision config."""
    return {
        "matvec": (matvec_plan(cfg), {}),
        "rmatvec": (matvec_plan(cfg, adjoint=True), {}),
        "gram": (gram_plan(cfg), {}),
        "gram-circulant": (gram_plan(cfg, mode="circulant"), {}),
        "matvec-hier": (matvec_plan(
            cfg, psum_axis=("row", "col"), collective="hierarchical",
            psum_groups=(GRID_ROW, GRID_COL)), {}),
        "matvec-ring": (matvec_plan(
            cfg, psum_axis="col", collective="ring",
            psum_groups=(GRID_COL,)), {}),
        "rmatvec-ring": (matvec_plan(
            cfg, adjoint=True, psum_axis="row", collective="ring",
            psum_groups=(GRID_ROW,)), {}),
        "gram-mesh": (gram_plan(
            cfg, mid_psum_axis="col", psum_axis="row",
            mid_psum_groups=(GRID_COL,), psum_groups=(GRID_ROW,),
            collective="hierarchical"), {}),
    }


def run_sweep(backends, configs, dims, plans=None,
              families=None) -> List[dict]:
    rows = []
    for backend in backends:
        opts = ExecOpts(backend=backend)
        for cfg_s in configs:
            cfg = PrecisionConfig.from_string(cfg_s)
            for name, (plan, extra) in plan_matrix(cfg).items():
                if plans is not None and name not in plans:
                    continue
                found = lint_plan(plan, opts, N_t=dims.N_t, N_d=dims.N_d,
                                  N_m=dims.N_m, families=families,
                                  **extra)
                rows.append({"backend": backend, "config": cfg_s,
                             "plan": name,
                             "findings": [f.__dict__ for f in found]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="statically lint the paper-shape plans on the "
                    "registered backends (nothing executes)")
    ap.add_argument("--backend", action="append", default=None,
                    help="backend name (repeatable; default: every "
                         "registered backend this process can trace)")
    ap.add_argument("--config", action="append", default=None,
                    help="precision ladder string (repeatable; default: "
                         f"{', '.join(DEFAULT_CONFIGS)})")
    ap.add_argument("--plan", action="append", default=None,
                    help="plan family to lint (repeatable; default: all)")
    ap.add_argument("--family", action="append", default=None,
                    help="rule family to run (repeatable; default: all)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke dims instead of the paper shape")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on warnings as well as errors")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON report on stdout")
    ap.add_argument("--rules", action="store_true",
                    help="print the registered rule catalog and exit")
    args = ap.parse_args(argv)

    if args.rules:
        for r in rule_catalog():
            print(f"[{r.family}] {r.name}: {r.description}")
        return 0

    dims = SMOKE if args.smoke else PAPER_SINGLE
    if args.backend:
        backends = tuple(args.backend)
        skipped = ()
    else:
        backends = tuple(b for b in known_backends() if traceable(b))
        skipped = tuple(b for b in known_backends() if not traceable(b))
    configs = tuple(args.config or DEFAULT_CONFIGS)
    rows = run_sweep(backends, configs, dims, plans=args.plan,
                     families=args.family)

    n_err = sum(1 for row in rows for f in row["findings"]
                if f["severity"] == ERROR)
    n_warn = sum(len(row["findings"]) for row in rows) - n_err
    if args.as_json:
        print(json.dumps({"dims": dims.name, "rows": rows,
                          "skipped_backends": list(skipped),
                          "errors": n_err, "warnings": n_warn}, indent=2))
    else:
        for b in skipped:
            print(f"skip {b}: its plans trace on card tensors, and this "
                  f"process has no card")
        for row in rows:
            tag = f"{row['plan']:<15} {row['config']} {row['backend']}"
            if not row["findings"]:
                print(f"ok   {tag}")
                continue
            print(f"FAIL {tag}")
            for f in row["findings"]:
                print(f"     {Finding(**f)}")
        print(f"{len(rows)} plan lowerings linted on dims "
              f"{dims.name!r}: {n_err} error(s), {n_warn} warning(s)")
    return 1 if (n_err or (args.strict and n_warn)) else 0


if __name__ == "__main__":
    sys.exit(main())
