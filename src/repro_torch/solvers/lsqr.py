"""LSQR (Paige & Saunders) on the factored problem, multi-RHS, mixed
precision.

Solves min ||F m - d||^2 + damp^2 ||m||^2 through the Golub-Kahan
bidiagonalization of F, never squaring the condition number as CGNR does.
S right-hand sides run as independent chains sharing every F / F*
application (``matmat`` / ``rmatmat``), with the rotation scalars carried
per column.  Operator applications run at the apply level, the
bidiagonalization norms at the orthogonalize level (accumulated in f64),
the u/v/w/x updates at the recurrence level.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .cg import _budget, _host, _safe
from .precision import SolverPrecision, col_norm, resolve_precision
from .result import SolveResult


def lsqr(op, d_obs, *, damp: float = 0.0, tol=1e-10, maxiter: int = 500,
         col_maxiter=None,
         precision: Union[SolverPrecision, str] = SolverPrecision()
         ) -> SolveResult:
    """Damped LSQR for ``op`` exposing ``matmat`` / ``rmatmat``.

    ``d_obs``: (N_d, N_t) SOTI or (N_d, N_t, S) stacked; the result has the
    matching layout.  The residual history records LSQR's running
    estimate |phibar| / ||d|| per column, which tracks the residual of the
    damped system and never rises.  ``tol`` and ``col_maxiter`` may be
    per-column (S,) vectors with the freeze contract of
    :func:`~repro_torch.solvers.pcg`: a frozen column has its rotation
    output ``phi`` masked to zero, so its x stops moving and its recorded
    residual is constant, while the shared bidiagonalization keeps serving
    its batch-mates.  ``maxiter=0`` reports the initial residual.
    """
    precision = resolve_precision(precision, float(np.min(tol)))
    d_obs = torch.as_tensor(d_obs)
    squeeze = d_obs.ndim == 2
    b = d_obs[..., None] if squeeze else d_obs
    S = b.shape[-1]
    tol_col = np.broadcast_to(np.asarray(tol, np.float64), (S,))
    budget = _budget(col_maxiter, maxiter, S)
    rec_dt = precision.recurrence_dtype()
    app_dt = precision.apply_dtype()
    ortho = precision.orthogonalize

    def A(v):
        return op.matmat(v.to(app_dt)).to(rec_dt)

    def At(v):
        return op.rmatmat(v.to(app_dt)).to(rec_dt)

    beta = col_norm(b, ortho)                       # (S,) f64
    u = (b / _safe(beta)).to(rec_dt)
    v = At(u)
    alpha = col_norm(v, ortho)
    v = (v / _safe(alpha)).to(rec_dt)
    w = v
    x = torch.zeros_like(v)
    phibar = beta
    rhobar = alpha
    b_norm = _host(beta)
    b_norm = np.where(b_norm == 0, 1.0, b_norm)

    # x0 = 0: the initial residual estimate is |phibar| / ||b||
    relres = np.abs(_host(phibar)) / b_norm
    conv = relres < tol_col
    frozen = conv | (budget <= 0)
    col_iters = np.zeros((S,), dtype=int)
    history = []
    k = 0
    if frozen.all() or maxiter == 0:
        history.append(relres)
    for k in range(1, maxiter + 1):
        if frozen.all():
            k -= 1
            break
        active = torch.as_tensor(~frozen, device=b.device)
        # continue the bidiagonalization (shared across the batch)
        u = A(v) - u * alpha.to(rec_dt)
        beta = col_norm(u, ortho)
        u = (u / _safe(beta)).to(rec_dt)
        v_next = At(u) - v * beta.to(rec_dt)
        alpha = col_norm(v_next, ortho)
        v = (v_next / _safe(alpha)).to(rec_dt)

        # eliminate the damping term (extra rotation)
        rhobar1 = torch.sqrt(rhobar ** 2 + damp ** 2)
        phibar = (rhobar / _safe(rhobar1)) * phibar

        # next orthogonal transformation of the bidiagonal matrix
        rho = torch.sqrt(rhobar1 ** 2 + beta ** 2)
        c = rhobar1 / _safe(rho)
        s = beta / _safe(rho)
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = s * phibar

        # frozen columns: phi = 0, so their x stops moving
        phi = torch.where(active, phi, 0.0)
        x = (x + w * (phi / _safe(rho)).to(rec_dt)).to(rec_dt)
        w = (v - w * (theta / _safe(rho)).to(rec_dt)).to(rec_dt)

        # frozen columns report the residual they froze at
        relres_new = np.abs(_host(phibar)) / b_norm
        relres = np.where(frozen, relres, relres_new)
        history.append(relres)
        col_iters[~frozen] = k
        conv |= (~frozen) & (relres < tol_col)
        frozen = frozen | conv | (budget <= k)
        if frozen.all():
            break

    x = x[..., 0] if squeeze else x
    return SolveResult(x=x, converged=bool(conv.all()), n_iters=k,
                       residual_history=np.asarray(history),
                       col_iters=col_iters)
