"""Bayesian inverse problem layer: Hessian actions and MAP solves (paper §2.2).

For a linear p2o map F with Gaussian prior N(m_pr, G_pr) and noise
N(0, G_n),

    m_map = m_pr + G_pr F^T (F G_pr F^T + G_n)^{-1} (d_obs - F m_pr)

(the data-space form of paper eq. (4)).  The dense data-space Hessian
H_d = F G_pr F^T + G_n has dimension (N_d N_t)^2 and is built from
N_d*N_t actions of F and F*: the outer-loop workload of Remark 1.

Every Hessian action runs through the fused data-space
:class:`~repro_torch.core.gram.GramOperator`, one pipeline per action,
and the dense assembly batches S-wide identity blocks through it so each
pipeline is SBGEMM-backed.

On a process grid (exact Gram only) every rank calls each method
together with its shards (``FFTMatvec.local_block``): the actions and
solves take and return this rank's rows, the matrix-free solves sum their
inner products over the group that shards them, and the assembled
Hessian and the EIG come out whole and the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .fftmatvec import FFTMatvec, as_tensor
from .gram import GramOperator


@dataclasses.dataclass
class GaussianInverseProblem:
    op: FFTMatvec                 # the p2o map F
    noise_var: float = 1e-4       # G_n = noise_var * I
    prior_var: float = 1.0        # G_pr = prior_var * I

    @property
    def data_dim(self) -> int:
        return self.op.N_d * self.op.N_t

    @property
    def gram(self) -> GramOperator:
        """The fused data-space Gram F F* behind every Hessian action
        (exact mode: matches the composed pair to roundoff)."""
        g = getattr(self, "_gram", None)
        if g is None or g.op is not self.op:
            g = self.op.gram(space="data", mode="exact")
            self._gram = g
        return g

    # -- dense data-space Hessian (test/demo scale) --------------------------
    def assemble_data_space_hessian(self, *, chunk: int = 8) -> torch.Tensor:
        """H_d = F G_pr F^T + G_n assembled from S-wide identity blocks:
        ceil(N_d*N_t / chunk) SBGEMM-backed fused-Gram pipelines.  The
        default 8 columns is the width at which the SBGEMM kernels take
        the least time a column on an H100 (PERF.md).  On a mesh each
        block goes in as this rank's rows and comes back gathered, so
        every rank holds the whole H_d."""
        op, Nd, Nt = self.op, self.op.N_d, self.op.N_t
        n = Nd * Nt
        chunk = max(1, min(chunk, n))
        eye = torch.eye(n, dtype=op.io_dtype, device=op.device)
        cols = []
        for s0 in range(0, n, chunk):
            E = op.local_block(eye[:, s0:s0 + chunk].reshape(Nd, Nt, -1),
                               "d")
            H = op.gather_block(self.hessian_action_block(E), "d")
            cols.append(H.reshape(n, -1))
        return torch.cat(cols, dim=1)

    # -- matrix-free Hessian action -----------------------------------------
    def hessian_action(self, v_flat) -> torch.Tensor:
        """(F G_pr F^T + G_n) v for a flattened data-space vector (on a
        mesh, this rank's rows of it): one fused Gram pipeline per
        action."""
        op = self.op
        v = as_tensor(v_flat, op.device).reshape(op.local_rows("d"), op.N_t)
        out = self.prior_var * self.gram.apply(v) + self.noise_var * v
        return out.reshape(-1)

    def hessian_action_block(self, V) -> torch.Tensor:
        """(F G_pr F^T + G_n) V on an (N_d, N_t[, S]) observation block:
        one SBGEMM-backed fused Gram pipeline shared by all S columns."""
        V = as_tensor(V, self.op.device)
        return self.prior_var * self.gram.apply(V) + self.noise_var * V

    # -- MAP point ------------------------------------------------------------
    def map_point(self, d_obs, m_prior=None, *, method: str = "cg",
                  tol: float = 1e-10, maxiter: int = 500) -> torch.Tensor:
        """Solve for the MAP point.  d_obs: (N_d, N_t) SOTI.  Returns
        (N_m, N_t) SOTI (on a mesh, this rank's shards of both and of
        ``m_prior``).  method: "cg" (matrix-free, the port's
        :func:`repro_torch.solvers.pcg` on the data-space Hessian) or
        "dense"."""
        from repro_torch import solvers  # deferred: solvers layer on core

        op = self.op
        d_obs = as_tensor(d_obs, op.device)
        m_prior = (torch.zeros((op.local_rows("m"), op.N_t),
                               dtype=op.io_dtype, device=op.device)
                   if m_prior is None else as_tensor(m_prior, op.device))
        resid = d_obs - op.matvec(m_prior)
        if method == "dense":
            H = self.assemble_data_space_hessian()
            w = torch.linalg.solve(H, op.gather_block(resid, "d").reshape(-1))
            w = op.local_block(w.reshape(op.N_d, op.N_t), "d")
        elif method == "cg":
            w = solvers.pcg(self.hessian_action, resid.reshape(-1), tol=tol,
                            maxiter=maxiter, group=op.dot_group("d")).x
            w = w.reshape(resid.shape)
        else:
            raise ValueError(f"unknown MAP method {method!r}")
        return m_prior + self.prior_var * op.rmatvec(w)

    # -- Krylov-subsystem MAP solves (multi-RHS capable) ---------------------
    def map_point_krylov(self, d_obs, m_prior=None, *, method: str = "lsqr",
                         tol: float = 1e-10, maxiter: int = 500,
                         solver_precision=None):
        """MAP solve through :mod:`repro_torch.solvers` (parameter-space
        form).

        For G_n = noise_var I, G_pr = prior_var I the MAP update solves
        Tikhonov least squares  min ||F dm - r||^2 + (noise/prior) ||dm||^2
        with r = d_obs - F m_prior: LSQR on the factored problem
        (``method="lsqr"``) or CGNR on the normal equations
        (``method="cgnr"``, its F*F through the fused parameter-space
        Gram).  ``d_obs`` may be a stacked (N_d, N_t, S) block: all S
        observation sets share each F / F* application.  On a mesh
        ``d_obs``, ``m_prior`` and ``m_map`` are this rank's shards.
        Returns ``(m_map, SolveResult)``.
        """
        from repro_torch import solvers  # deferred: solvers layer on core

        op = self.op
        if solver_precision is None:
            solver_precision = solvers.SolverPrecision()
        d_obs = as_tensor(d_obs, op.device)
        if m_prior is None:
            resid = d_obs
        else:
            m_prior = as_tensor(m_prior, op.device)
            # a shared 2-D prior against a stacked d_obs broadcasts over S
            if d_obs.ndim == 3 and m_prior.ndim == 2:
                m_prior = m_prior[..., None]
            resid = d_obs - op.matmat(m_prior)
        lam = self.noise_var / self.prior_var
        if method == "lsqr":
            res = solvers.lsqr(op, resid, damp=float(lam) ** 0.5, tol=tol,
                               maxiter=maxiter, precision=solver_precision)
        elif method == "cgnr":
            res = solvers.cg_normal_equations(op, resid, damp=lam, tol=tol,
                                              maxiter=maxiter,
                                              precision=solver_precision)
        else:
            raise ValueError(f"unknown Krylov method {method!r}")
        m_map = res.x if m_prior is None else m_prior + res.x
        return m_map, res

    # -- optimal experimental design ingredient ------------------------------
    def expected_information_gain(self, *, chunk: int = 8) -> torch.Tensor:
        """KL(post || prior) for the linear-Gaussian problem (closed form,
        paper Remark 1): 0.5 * logdet(I + G_n^{-1} F G_pr F^T), through
        the chunked SBGEMM-backed Hessian assembly (the same on every
        rank of a mesh)."""
        H = self.assemble_data_space_hessian(chunk=chunk)
        _, logdet = torch.linalg.slogdet(H / self.noise_var)
        return 0.5 * logdet
