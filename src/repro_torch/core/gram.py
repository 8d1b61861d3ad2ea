"""Fused Fourier-domain Gram operators: F*F and F F* in one pipeline.

The paper's motivating outer loop (Remark 1, Bayesian OED) is dominated by
Hessian actions ``F G_pr F* v``.  The composed implementation runs the
whole adjoint pipeline back to the time domain and then the whole forward
pipeline, paying an unpad -> cast -> pad round trip between them.
:class:`GramOperator` compiles the Gram action to one
:mod:`repro_torch.core.pipeline` plan instead.

``mode="exact"`` (default)
    pad -> FFT -> GEMM(F_hat) -> IFFT -> mask -> FFT -> GEMM(F_hat^H) ->
    IFFT -> unpad; the result matches ``rmatvec(matvec(v))`` to roundoff.
    The Hessian and CGNR paths use it.

``mode="circulant"``
    pad -> FFT -> per-bin GEMM with the precomputed Hermitian blocks
    G_hat[k] = F_hat[k]^H F_hat[k] (or the data-space twin
    F_hat[k] F_hat[k]^H, built by the ``sbgemm_gram_complex`` kernel) ->
    IFFT -> unpad: half the FFT/IFFT and reorder stages of the composed
    path.  It computes the *periodic* (circulant) Gram, exact only up to
    the truncation wrap term: a preconditioner or a screening proxy, never
    the composed operator's value.  At the paper shape only the data space
    fits: parameter-space G_hat is (1001, 5000, 5000) per plane.

The operator is single-device, like :class:`FFTMatvec`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from . import pipeline
from . import precision as prec
from .fftmatvec import FFTMatvec, as_tensor
from .precision import PrecisionConfig


@dataclasses.dataclass
class GramOperator:
    """One-pipeline Gram action, built by :meth:`FFTMatvec.gram`.

    ``space="parameter"``: G = F*F on (N_m, N_t[, S]) SOTI blocks (CGNR's
    normal operator).  ``space="data"``: G = F F* on (N_d, N_t[, S]) (the
    data-space Hessian's Gram part).
    """

    op: FFTMatvec
    space: str = "parameter"
    mode: str = "exact"
    G_hat_re: Optional[torch.Tensor] = None   # circulant: (K, R, R) planes
    G_hat_im: Optional[torch.Tensor] = None

    @classmethod
    def from_matvec(cls, op: FFTMatvec, *, space: str = "parameter",
                    mode: str = "exact") -> "GramOperator":
        """The Gram of ``op``; the circulant mode computes G_hat here, at
        the gemv level, through ``ops.sbgemm_gram``."""
        if space not in ("parameter", "data"):
            raise ValueError(f"unknown gram space {space!r}")
        if mode not in ("exact", "circulant"):
            raise ValueError(f"unknown gram mode {mode!r}")
        G_re = G_im = None
        if mode == "circulant":
            r = op.opts.resolve(op.device)
            G_re, G_im = kops.sbgemm_gram(
                op.F_hat_re, op.F_hat_im, space=space,
                out_dtype=prec.real_dtype(op.precision.gemv),
                backend=r.spec, dispatch=r.table)
        return cls(op, space, mode, G_re, G_im)

    # -- delegated operator identity -----------------------------------------
    @property
    def precision(self) -> PrecisionConfig:
        return self.op.precision

    @property
    def opts(self):
        return self.op.opts

    @property
    def N_t(self) -> int:
        return self.op.N_t

    @property
    def N_d(self) -> int:
        return self.op.N_d

    @property
    def N_m(self) -> int:
        return self.op.N_m

    @property
    def device(self) -> torch.device:
        return self.op.device

    @property
    def io_dtype(self) -> torch.dtype:
        return self.op.io_dtype

    @property
    def rows(self) -> int:
        """Row count of the (square) Gram's SOTI domain."""
        return self.N_m if self.space == "parameter" else self.N_d

    def with_precision(self, precision: PrecisionConfig) -> "GramOperator":
        """Gram of the retuned operator (circulant blocks recomputed at the
        new gemv level from the recast Fourier blocks)."""
        return self.from_matvec(self.op.with_precision(precision),
                                space=self.space, mode=self.mode)

    # -- plan inspection -------------------------------------------------------
    def plan(self) -> pipeline.Plan:
        """The stage plan :meth:`apply` runs."""
        return pipeline.gram_plan(self.precision, space=self.space,
                                  mode=self.mode)

    def stage_counts(self):
        """Static stage census of :meth:`plan`."""
        return pipeline.stage_counts(self.plan())

    # -- application -------------------------------------------------------------
    def apply(self, v):
        """G v on an (rows, N_t[, S]) SOTI block; 2-D inputs stay 2-D."""
        operands = {"F": (self.op.F_hat_re, self.op.F_hat_im)}
        if self.mode == "circulant":
            operands["G"] = (self.G_hat_re, self.G_hat_im)
        y = pipeline.run_plan(self.plan(), as_tensor(v, self.device),
                              operands, N_t=self.N_t, opts=self.opts)
        return y.to(self.io_dtype)

    __call__ = apply
