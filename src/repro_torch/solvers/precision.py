"""Per-leg precision configuration for the Krylov solvers.

The FFTMatvec pipeline splits one matvec into five phases; a Krylov
iteration has its own three legs, which tolerate very different
precisions (mixed-precision Krylov practice, survey arXiv:2412.19322):

    apply         the operator applications (F / F*; their internal phases
                  follow the operator's own PrecisionConfig): the level
                  vectors are carried at when handed to the operator.
    orthogonalize inner products and norms steering the recurrence
                  coefficients (alpha, beta, rho); the most sensitive leg.
    recurrence    the axpy-style updates of x, r, p, w.

Levels reuse the core ladder: "d" (f64), "s" (f32), "h" (bf16).  A config
is written like the operator's flag, e.g. ``SolverPrecision.from_string
("sds")``; all-double is the default.  Steering dots always accumulate in
f64.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import pipeline as _pipeline
from repro_torch.core import precision as _prec

SOLVER_PHASES = ("apply", "orthogonalize", "recurrence")


@dataclasses.dataclass(frozen=True)
class SolverPrecision:
    """Precision level of each Krylov-iteration leg."""

    apply: str = "d"
    orthogonalize: str = "d"
    recurrence: str = "d"

    def __post_init__(self):
        for p in SOLVER_PHASES:
            lvl = getattr(self, p)
            if lvl not in ("h", "s", "d"):
                raise ValueError(
                    f"bad precision level {lvl!r} for solver phase {p!r}")

    @classmethod
    def from_string(cls, s: str) -> "SolverPrecision":
        if len(s) != 3:
            raise ValueError(f"solver precision string must have 3 chars, "
                             f"got {s!r}")
        return cls(*s)

    def to_string(self) -> str:
        return "".join(getattr(self, p) for p in SOLVER_PHASES)

    def apply_dtype(self) -> torch.dtype:
        return _prec.real_dtype(self.apply)

    def ortho_dtype(self) -> torch.dtype:
        return _prec.real_dtype(self.orthogonalize)

    def recurrence_dtype(self) -> torch.dtype:
        return _prec.real_dtype(self.recurrence)

    def replace(self, **kw) -> "SolverPrecision":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_tolerance(cls, tol: float, *, op=None) -> "SolverPrecision":
        """Per-leg precisions for a target relative residual ``tol``: each
        leg gets the lowest level of h < s < d whose unit roundoff meets
        its sensitivity (orthogonalize ``eps <= tol / 10``, recurrence
        ``eps <= tol``, apply ``eps <= 100 tol``); no qualifying level ->
        "d".  tol=1e-4 -> "hss", tol=1e-10 -> "ddd".  ``op`` (an
        FFTMatvec) floors the target at the operator's own eq.-(6) error
        floor."""
        if tol <= 0.0:
            raise ValueError(f"tolerance must be positive, got {tol}")
        if op is not None:
            from . import error_floor   # deferred: package-level helper
            tol = max(tol, error_floor(op))

        def lowest(target: float) -> str:
            for lvl in ("h", "s", "d"):
                if _prec.machine_eps(lvl) <= target:
                    return lvl
            return "d"

        return cls(apply=lowest(tol * 100.0), orthogonalize=lowest(tol / 10.0),
                   recurrence=lowest(tol))


def resolve_precision(precision, tol: float) -> SolverPrecision:
    """A SolverPrecision passes through, ``"auto"`` derives per-leg levels
    from the solve tolerance, any other string is a 3-char config."""
    if isinstance(precision, SolverPrecision):
        return precision
    if isinstance(precision, str):
        if precision == "auto":
            return SolverPrecision.from_tolerance(tol)
        return SolverPrecision.from_string(precision)
    raise TypeError(f"precision must be SolverPrecision or str, "
                    f"got {type(precision).__name__}")


DOUBLE = SolverPrecision.from_string("ddd")
SINGLE = SolverPrecision.from_string("sss")
# bf16 operator traffic, f32 steering scalars
TPU_MIXED = SolverPrecision.from_string("hss")


def col_dot(a: torch.Tensor, b: torch.Tensor, level: str,
            group=None) -> torch.Tensor:
    """Per-RHS-column inner product <a, b> of (..., S) tensors: both sides
    rounded to ``level``, products summed in f64 over every axis but the
    last.  Returns an (S,) f64 tensor.  A column reduction, not an einsum:
    einsum lowers this to S batched dot products of length N_m*N_t, which
    cuBLAS runs on a handful of blocks.

    ``group`` is the process group that shards the vectors' long axis on
    a grid (``FFTMatvec.dot_group``): this rank's f64 sums are then summed
    over it, so every rank holds the inner product of the global
    vectors."""
    dt = _prec.real_dtype(level)
    af = a.to(dt).to(torch.float64).reshape(-1, a.shape[-1])
    bf = b.to(dt).to(torch.float64).reshape(-1, b.shape[-1])
    out = (af * bf).sum(dim=0)
    return out if group is None else _pipeline.all_reduce(out, group)


def col_norm(a: torch.Tensor, level: str, group=None) -> torch.Tensor:
    """Per-column L2 norm at ``level`` (accumulated in f64; over
    ``group`` as :func:`col_dot`)."""
    return torch.sqrt(col_dot(a, a, level, group))
