"""Solve result carrying per-iteration residual histories (host f64), so
they compare directly with the first-order bound of
:mod:`repro_torch.core.error_model` (see
:func:`repro_torch.solvers.error_floor`)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class SolveResult:
    """Outcome of a Krylov solve.

    ``x`` keeps the RHS layout of the input ``b``: (..., S) for stacked
    multi-RHS solves, no trailing axis for a single vector.
    ``residual_history`` is (n_iters, S): entry [k, s] is column s's
    relative residual after iteration k (estimated for LSQR).
    ``col_iters`` is the number of iterations each column updated before
    it froze.
    """

    x: torch.Tensor
    converged: bool
    n_iters: int
    residual_history: np.ndarray
    col_iters: Optional[np.ndarray] = None

    @property
    def final_relres(self) -> np.ndarray:
        """Per-column relative residual at exit, shape (S,); a single NaN
        for an empty history."""
        if len(self.residual_history) == 0:
            return np.full((1,), np.nan)
        return self.residual_history[-1]
