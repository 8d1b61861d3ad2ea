"""Preconditioned conjugate gradients, multi-RHS, mixed precision.

``pcg`` runs S independent CG chains that share every operator
application: vectors carry a minor RHS axis (..., S) and the recurrence
scalars (alpha, beta, rho) are per-column (S,) tensors.  Behind an
:class:`~repro_torch.core.FFTMatvec` this turns the bandwidth-bound SBGEMV
of Phase 3 into the SBGEMM the multi-RHS kernels are built for.

``cg_normal_equations`` is the inverse-problem entry point: CGNR on
(F* F + damp I) m = F* d, Tikhonov-regularized least squares driven by the
fused parameter-space Gram and ``rmatmat``.

The loop is host-driven (per-iteration residual recording and early
exit); each iteration costs one operator application plus O(1)
reductions, whose (S,) results are read back to the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from .precision import (SolverPrecision, col_dot, col_norm,
                        resolve_precision)
from .result import SolveResult


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, torch.ones_like(x), x)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def _budget(col_maxiter, maxiter: int, S: int) -> np.ndarray:
    if col_maxiter is None:
        return np.full((S,), maxiter, dtype=int)
    return np.minimum(np.broadcast_to(np.asarray(col_maxiter, dtype=int),
                                      (S,)), maxiter)


def pcg(A: Callable, b, *, x0=None, tol=1e-10, maxiter: int = 500,
        M: Optional[Callable] = None, multi_rhs: Optional[bool] = None,
        col_maxiter=None,
        precision: Union[SolverPrecision, str] = SolverPrecision()
        ) -> SolveResult:
    """Preconditioned CG for SPD ``A``, S stacked right-hand sides.

    ``b``'s minor axis is the RHS stack when ``multi_rhs`` is true
    (default: inferred, 3-D and higher, the (R, N_t, S) SOTI layout);
    otherwise ``b`` is one vector.  Pass ``multi_rhs=True`` for a flat
    (n, S) system.  ``A`` and the optional preconditioner ``M`` receive
    tensors of ``b``'s exact shape and must act column-wise.

    ``tol`` and ``col_maxiter`` may be per-column (S,) vectors.  A column
    is *frozen* the first time its relative residual drops below its
    tolerance (or its iteration budget runs out): its alpha/beta are
    masked to zero from then on, so low-precision recurrence legs cannot
    drift it back above tol while its batch-mates finish.  The loop stops
    once every column is frozen; ``SolveResult.col_iters[s]`` records the
    iterations column s updated.

    Per ``precision``: operator inputs are carried at the apply level,
    steering dots run at the orthogonalize level (accumulated in f64), and
    x/r/p updates at the recurrence level.  ``precision`` also accepts a
    3-char string ("sds") or ``"auto"`` (derived from the tightest ``tol``).
    """
    precision = resolve_precision(precision, float(np.min(tol)))
    b = torch.as_tensor(b)
    if multi_rhs is None:
        multi_rhs = b.ndim >= 3
    squeeze = not multi_rhs
    if squeeze:
        b = b[..., None]
    S = b.shape[-1]
    tol_col = np.broadcast_to(np.asarray(tol, np.float64), (S,))
    budget = _budget(col_maxiter, maxiter, S)
    rec_dt = precision.recurrence_dtype()
    app_dt = precision.apply_dtype()
    ortho = precision.orthogonalize

    def user_shaped(fn, v):
        if squeeze:
            return torch.as_tensor(fn(v[..., 0]))[..., None]
        return torch.as_tensor(fn(v))

    def apply_A(v):
        return user_shaped(A, v.to(app_dt)).to(rec_dt)

    if x0 is None:
        x = torch.zeros_like(b, dtype=rec_dt)
        r = b.to(rec_dt)
    else:
        x = torch.as_tensor(x0, device=b.device).reshape(b.shape).to(rec_dt)
        r = b.to(rec_dt) - apply_A(x)
    z = user_shaped(M, r).to(rec_dt) if M is not None else r
    p = z
    rz = col_dot(r, z, ortho)
    b_norm = _host(col_norm(b, ortho))
    b_norm = np.where(b_norm == 0, 1.0, b_norm)

    relres = _host(col_norm(r, ortho)) / b_norm
    conv = relres < tol_col              # converged columns (stay frozen)
    frozen = conv | (budget <= 0)        # converged or out of budget
    col_iters = np.zeros((S,), dtype=int)
    history = []
    k = 0
    if frozen.all() or maxiter == 0:
        # no iteration will run: report the initial residual
        history.append(relres)
    for k in range(1, maxiter + 1):
        if frozen.all():
            k -= 1
            break
        active = torch.as_tensor(~frozen, device=b.device)
        Ap = apply_A(p)
        alpha = rz / _safe(col_dot(p, Ap, ortho))
        alpha = torch.where(active, alpha, 0.0).to(rec_dt)
        x = (x + p * alpha).to(rec_dt)
        r = (r - Ap * alpha).to(rec_dt)
        relres_new = _host(col_norm(r, ortho)) / b_norm
        # frozen columns report the residual they froze at
        relres = np.where(frozen, relres, relres_new)
        history.append(relres)
        col_iters[~frozen] = k
        conv |= (~frozen) & (relres < tol_col)
        frozen = frozen | conv | (budget <= k)
        if frozen.all():
            break
        z = user_shaped(M, r).to(rec_dt) if M is not None else r
        rz_new = col_dot(r, z, ortho)
        beta = rz_new / _safe(rz)
        beta = torch.where(torch.as_tensor(~frozen, device=b.device), beta,
                           0.0).to(rec_dt)
        p = (z + p * beta).to(rec_dt)
        rz = rz_new

    x = x[..., 0] if squeeze else x
    return SolveResult(x=x, converged=bool(conv.all()), n_iters=k,
                       residual_history=np.asarray(history),
                       col_iters=col_iters)


def cg_normal_equations(op, d_obs, *, damp: float = 0.0, tol=1e-10,
                        maxiter: int = 500, M: Optional[Callable] = None,
                        col_maxiter=None,
                        precision: Union[SolverPrecision, str] =
                        SolverPrecision()) -> SolveResult:
    """CGNR: min ||F m - d||^2 + damp ||m||^2 via (F* F + damp I) m = F* d,
    with F an :class:`FFTMatvec`-like operator exposing ``matmat`` /
    ``rmatmat`` ((R, N_t, S) stacked SOTI layout, 2-D inputs as S = 1).

    The F*F product runs through the fused parameter-space
    :class:`~repro_torch.core.gram.GramOperator` whenever ``op`` exposes
    ``.gram()``; plain callable-pair operators use the composed
    product.  ``tol`` / ``col_maxiter`` may be per-column vectors as in
    :func:`pcg`."""
    precision = resolve_precision(precision, float(np.min(tol)))
    rec_dt = precision.recurrence_dtype()

    if hasattr(op, "gram"):
        gram = op.gram(space="parameter", mode="exact")

        def normal_op(v):
            return gram.apply(v) + damp * v
    else:
        def normal_op(v):
            return op.rmatmat(op.matmat(v)) + damp * v

    rhs = op.rmatmat(d_obs).to(rec_dt)
    return pcg(normal_op, rhs, tol=tol, maxiter=maxiter, M=M,
               col_maxiter=col_maxiter, precision=precision)
