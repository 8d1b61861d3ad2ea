"""Mixed-precision Krylov solvers on top of the multi-RHS FFTMatvec.

Both solvers run S stacked right-hand sides as independent chains sharing
every operator application (``matmat`` / ``rmatmat``), and take a
:class:`SolverPrecision` assigning a level to each iteration leg (apply /
orthogonalize / recurrence) on top of the operator's own five-phase
:class:`~repro_torch.core.PrecisionConfig`.

Public API:
    SolverPrecision, DOUBLE, SINGLE, TPU_MIXED   per-leg solver precision
    SolveResult                                  x + residual histories
    pcg                                          preconditioned CG (SPD)
    cg_normal_equations                          CGNR for min ||Fm - d||
    lsqr                                         damped LSQR (Golub-Kahan)
    error_floor                                  eq.-(6) residual floor
"""

from .precision import (SolverPrecision, DOUBLE, SINGLE,  # noqa: F401
                        TPU_MIXED, col_dot, col_norm, resolve_precision)
from .result import SolveResult  # noqa: F401
from .cg import pcg, cg_normal_equations  # noqa: F401
from .lsqr import lsqr  # noqa: F401

from repro_torch.core.error_model import operator_grid
from repro_torch.core.error_model import relative_error_bound as _bound

_SAFETY = 10.0   # headroom over the first-order bound


def error_floor(op, *, p_r: int | None = None,
                p_c: int | None = None) -> float:
    """Achievable relative-residual floor for Krylov iterations driven by
    a mixed-precision FFTMatvec: ``10 * max(bound_F, bound_F*)`` of paper
    eq. (6) (``core.error_model``), since every iteration applies F and
    F*.  Use ``max(tol, error_floor(op))`` as the practical stopping
    target.  The operator's grid and reduction level
    (``FFTMatvec.comm_level``) are priced; explicit ``p_r``/``p_c``, an
    explicit (1, 1) too, override the grid read off the mesh."""
    cfg = op.precision
    p_r, p_c = operator_grid(op, p_r, p_c)
    kw = dict(p_r=p_r, p_c=p_c, comm_level=op.comm_level)
    bf = _bound(cfg, op.N_t, op.N_d, op.N_m, **kw)
    ba = _bound(cfg, op.N_t, op.N_d, op.N_m, adjoint=True, **kw)
    return _SAFETY * max(bf, ba)
