"""First-order error model of the mixed-precision FFTMatvec (paper §3.2.1),
pure math shared with the JAX package's twin (kept as a copy: the port
imports nothing from it).

Implements the paper's final bound, eq. (6), on one device:

    ||dv5|| / ||v5|| <= kappa(F_hat) * [ c1 e1
                                         + (cF ed + c2 e2 + c4 e4) log2(N_t)
                                         + c3 e3 N_m
                                         + c5 e5 ]

for the F matvec; the F* bound replaces N_m by N_d.  e_i is the unit
roundoff of the precision used in phase i; the O(1) constants c_i are 1;
c1 = 0 when Phase 1 runs at (or above) the precision that represents the
input exactly (double).  The reduce term is 1 rather than the paper's
log2(p_c) = 0: the Phase-5 unpad stores at the reduce precision even on
a single device.  The mesh (p_r, p_c), reduced-precision communication
and per-tile terms of the JAX twin come with the slices that port meshes
and tile maps.
"""

from __future__ import annotations

import math

from .precision import PrecisionConfig, machine_eps

_INPUT_LEVEL = "d"   # the input vector is exactly representable in f64


def phase_factors(N_t: int, N_d: int, N_m: int, *, adjoint: bool = False,
                  variant: str | None = None) -> dict[str, float]:
    """Structural multiplier of each phase's unit roundoff in eq. (6).

    ``variant`` selects the pipeline shape: the matvec/matmat family
    (default; ``adjoint`` flips to the F* factors) or ``"gram"`` — the
    fused Gram pipeline, whose phases each run twice (the fft/ifft terms
    double and the gemv term accumulates both contraction lengths)."""
    log_nt = math.log2(max(N_t, 2))
    if variant in ("gram", "gram_data"):
        return {"pad": 1.0, "fft": 2.0 * log_nt, "gemv": float(N_m + N_d),
                "ifft": 2.0 * log_nt, "reduce": 1.0}
    if variant is not None and variant not in ("matvec", "rmatvec",
                                               "matmat", "rmatmat"):
        raise ValueError(f"unknown variant {variant!r}")
    if variant is not None:
        adjoint = variant in ("rmatvec", "rmatmat")
    return {"pad": 1.0, "fft": log_nt, "gemv": float(N_d if adjoint else N_m),
            "ifft": log_nt, "reduce": 1.0}


def relative_error_bound(cfg: PrecisionConfig, N_t: int, N_d: int, N_m: int,
                         *, adjoint: bool = False,
                         variant: str | None = None) -> float:
    """Evaluate eq. (6) with kappa = 1.  ``variant="gram"`` bounds the
    fused Gram pipeline (doubled structural factors, see
    :func:`phase_factors`)."""
    e = {p: machine_eps(getattr(cfg, p)) for p in
         ("pad", "fft", "gemv", "ifft", "reduce")}
    e_setup = machine_eps(_INPUT_LEVEL)   # setup FFT of F runs at input level
    # c1 = 0 if the pad/broadcast phase is lossless for the input.
    c1 = 0.0 if e["pad"] <= e_setup else 1.0
    f = phase_factors(N_t, N_d, N_m, adjoint=adjoint, variant=variant)
    return (c1 * e["pad"] * f["pad"] + (e_setup + e["fft"]) * f["fft"]
            + e["ifft"] * f["ifft"] + e["gemv"] * f["gemv"]
            + e["reduce"] * f["reduce"])
