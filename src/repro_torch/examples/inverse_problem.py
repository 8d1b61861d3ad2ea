"""End-to-end Bayesian inverse problem (the paper's application, §2.1-2.2),
on the card:

1. build the p2o map of a 1-D periodic heat equation (LTI system), a
   block-lower-triangular Toeplitz matrix;
2. generate noisy observations from a ground-truth source;
3. solve for the MAP point with matrix-free CG on the data-space Hessian
   (every Hessian action is one fused F F* Gram pipeline);
4. compare double precision with the paper's optimal mixed-precision
   config, and report the expected information gain (the
   optimal-sensor-placement objective of Remark 1);
5. re-solve with the Krylov subsystem (LSQR / CGNR) and reconstruct a
   batch of noise realizations at once through the multi-RHS ``matmat``
   path, the outer-loop workload the SBGEMM kernels exist for.

    python -m repro_torch.examples.inverse_problem             # the card
    python -m repro_torch.examples.inverse_problem --device cpu

The noise is drawn from a seeded ``torch.Generator`` on the device, so its
values differ from the JAX example's (``examples/inverse_problem.py``);
the acceptance bands are the same: misfits at the 1e-3 noise level, the
mixed-precision MAP point ~1e-7 from the f64 one, information gain
positive and lower with fewer sensors.
"""

from __future__ import annotations

import argparse
import math

import torch

from repro_torch import solvers
from repro_torch.core import (FFTMatvec, GaussianInverseProblem,
                              PrecisionConfig, heat_equation_p2o, rel_l2)
from repro_torch.core.toeplitz import default_device

SHAPE = (48, 6, 96)          # N_t, N_d, N_m
NOISE_SIGMA = 1e-3


def run(device=None, seed: int = 0, verbose: bool = True) -> dict:
    """Run every step on ``device`` (None = the card); returns the numbers
    the example prints."""
    dev = default_device(device)
    say = print if verbose else (lambda *a, **k: None)
    N_t, N_d, N_m = SHAPE
    out = {"shape": list(SHAPE), "device": str(dev)}

    say("=== building heat-equation p2o map ===")
    F_col = heat_equation_p2o(N_t, N_d, N_m, device=dev)
    op = FFTMatvec.from_block_column(F_col, device=dev)

    # ground-truth source: two localized pulses in space-time
    x = torch.linspace(0, 1, N_m + 1, dtype=torch.float64, device=dev)[:-1]
    t = torch.linspace(0, 1, N_t, dtype=torch.float64, device=dev)
    m_true = (torch.exp(-((x[:, None] - 0.3) ** 2) / 0.002
                        - ((t[None, :] - 0.25) ** 2) / 0.01)
              + 0.7 * torch.exp(-((x[:, None] - 0.7) ** 2) / 0.004
                                - ((t[None, :] - 0.6) ** 2) / 0.02))

    gen = torch.Generator(device=dev).manual_seed(seed)
    d_clean = op.matvec(m_true)
    d_obs = d_clean + NOISE_SIGMA * torch.randn(
        d_clean.shape, generator=gen, device=dev, dtype=d_clean.dtype)
    say(f"observations: {N_d} sensors x {N_t} steps, "
        f"noise sigma={NOISE_SIGMA}")

    prob = GaussianInverseProblem(op, noise_var=NOISE_SIGMA ** 2,
                                  prior_var=1.0)
    say("=== MAP solve (matrix-free CG, double precision) ===")
    m_map = prob.map_point(d_obs, method="cg", maxiter=500, tol=1e-10)
    out["cg_misfit"] = rel_l2(op.matvec(m_map), d_obs)
    out["cg_param_error"] = rel_l2(m_map, m_true)
    say(f"  data misfit      : {out['cg_misfit']:.3e}")
    say(f"  parameter error  : {out['cg_param_error']:.3f} "
        f"(underdetermined: {N_d} sensors for {N_m} params)")

    say("=== MAP solve with the paper's optimal mixed precision ===")
    # sensor noise 1e-3 >> single-precision error 1e-7: fft+gemv in f32
    op_mixed = FFTMatvec.from_block_column(
        F_col, precision=PrecisionConfig.from_string("dssdd"), device=dev)
    prob_mixed = GaussianInverseProblem(op_mixed,
                                        noise_var=NOISE_SIGMA ** 2)
    m_map2 = prob_mixed.map_point(d_obs, method="cg", maxiter=500, tol=1e-10)
    out["mixed_misfit"] = rel_l2(op_mixed.matvec(m_map2), d_obs)
    out["mixed_vs_f64_map"] = rel_l2(m_map2, m_map)
    say(f"  data misfit      : {out['mixed_misfit']:.3e}")
    say(f"  vs f64 MAP point : {out['mixed_vs_f64_map']:.3e} "
        f"(below the noise floor -> mixed precision is free accuracy-wise)")

    say("=== Krylov subsystem: LSQR / CGNR on the factored problem ===")
    m_lsqr, res_lsqr = prob.map_point_krylov(d_obs, method="lsqr",
                                             tol=1e-10, maxiter=500)
    out["lsqr_iters"] = res_lsqr.n_iters
    out["lsqr_relres"] = float(res_lsqr.final_relres.max())
    out["lsqr_vs_cg_map"] = rel_l2(m_lsqr, m_map)
    say(f"  LSQR iters       : {out['lsqr_iters']} "
        f"(relres {out['lsqr_relres']:.2e})")
    say(f"  vs CG MAP point  : {out['lsqr_vs_cg_map']:.3e}")
    m_cgnr, res_cgnr = prob.map_point_krylov(d_obs, method="cgnr",
                                             tol=1e-10, maxiter=500)
    out["cgnr_iters"] = res_cgnr.n_iters
    out["cgnr_relres"] = float(res_cgnr.final_relres.max())
    out["cgnr_vs_cg_map"] = rel_l2(m_cgnr, m_map)
    say(f"  CGNR iters       : {out['cgnr_iters']} "
        f"(relres {out['cgnr_relres']:.2e})")

    say("=== multi-RHS: reconstruct a batch of noise realizations ===")
    S = 8
    noise = NOISE_SIGMA * torch.randn((*d_clean.shape, S), generator=gen,
                                      device=dev, dtype=d_clean.dtype)
    D_obs = d_clean[..., None] + noise               # (N_d, N_t, S) stacked
    M_batch, res_b = prob_mixed.map_point_krylov(
        D_obs, method="lsqr", tol=1e-8, maxiter=500,
        solver_precision=solvers.SolverPrecision.from_string("sss"))
    D_fit = op_mixed.matmat(M_batch)
    misfits = [rel_l2(D_fit[..., s], D_obs[..., s]) for s in range(S)]
    out["batch_iters"] = res_b.n_iters
    out["batch_misfit_max"] = max(misfits)
    out["batch_misfit_min"] = min(misfits)
    out["batch_spread"] = float(M_batch.std(dim=-1).mean())
    say(f"  {S} noise realizations in {res_b.n_iters} shared-matmat "
        f"LSQR iterations (one SBGEMM pipeline per iteration)")
    say(f"  data misfit      : max {out['batch_misfit_max']:.3e} "
        f"(all at the noise level, as expected)")
    say(f"  MAP sampling std : {out['batch_spread']:.3e} per parameter "
        f"(posterior variability across realizations)")

    say("=== fused Gram operator (stage-graph pipeline) ===")
    gram = op.gram(space="data")                     # exact F F*
    composed = op.matvec(op.rmatvec(d_obs))
    out["gram_vs_composed"] = rel_l2(gram.apply(d_obs), composed)
    say(f"  gram.apply vs composed rmatvec/matvec: "
        f"{out['gram_vs_composed']:.2e} (exact fusion)")
    circ = op.gram(space="data", mode="circulant")   # per-bin G_hat
    counts_c, counts_g = circ.stage_counts(), gram.stage_counts()
    out["circulant_transforms"] = counts_c["fft"] + counts_c["ifft"]
    out["exact_transforms"] = counts_g["fft"] + counts_g["ifft"]
    out["circulant_wrap_error"] = rel_l2(circ.apply(d_obs), composed)
    say(f"  circulant pipeline: {out['circulant_transforms']} "
        f"transforms/action vs {out['exact_transforms']} "
        f"(periodic Gram: preconditioning/screening only, "
        f"wrap error {out['circulant_wrap_error']:.1e})")

    say("=== optimal experimental design ingredient (Remark 1) ===")
    # one SBGEMM-backed fused Gram pipeline per 32 Hessian columns
    out["eig"] = float(prob.expected_information_gain())
    say(f"  expected information gain (KL prior->post): {out['eig']:.2f} "
        f"nats")
    few = GaussianInverseProblem(
        FFTMatvec.from_block_column(F_col[:, :2, :], device=dev),
        noise_var=NOISE_SIGMA ** 2)
    out["eig_2_sensors"] = float(few.expected_information_gain())
    say(f"  with only 2 sensors: {out['eig_2_sensors']:.2f} "
        f"nats (fewer sensors -> less information, as expected)")
    return out


def check(out: dict) -> list:
    """The acceptance bands of the reference example; returns the
    failures (empty when every band holds)."""
    bad = []
    noise_band = (1e-4, 1e-2)     # misfits near the 1e-3 noise level
    for key in ("cg_misfit", "mixed_misfit", "batch_misfit_max",
                "batch_misfit_min"):
        if not noise_band[0] <= out[key] <= noise_band[1]:
            bad.append(f"{key} {out[key]:.3e} outside {noise_band}")
    if not out["mixed_vs_f64_map"] <= 1e-5:
        bad.append(f"mixed vs f64 MAP {out['mixed_vs_f64_map']:.3e} > 1e-5")
    if not out["gram_vs_composed"] <= 1e-13:
        bad.append(f"gram vs composed {out['gram_vs_composed']:.3e}")
    if not 0 < out["eig_2_sensors"] < out["eig"]:
        bad.append(f"EIG {out['eig']:.3f} vs 2 sensors "
                   f"{out['eig_2_sensors']:.3f}: not positive and lower")
    if not all(math.isfinite(v) for v in out.values()
               if isinstance(v, float)):
        bad.append("a non-finite result")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    bad = check(run(args.device, args.seed))
    for msg in bad:
        print(f"FAILED: {msg}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
