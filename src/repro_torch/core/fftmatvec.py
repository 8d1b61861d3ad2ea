"""FFTMatvec: the paper's 5-phase mixed-precision matvec pipeline (C1+C3).

Phases (paper §2.4), for ``d = F m``:

  1. zero-pad the input block vector + cast       (CUDA kernel pad_cast)
  2. batched FFT  m -> m_hat                      (cuFFT via torch.fft)
  3. block-diagonal matvec in Fourier space       (CUDA kernel sbgemv_*)
  4. batched IFFT d_hat -> d_padded               (cuFFT)
  5. unpad + cast                                 (CUDA kernel unpad_cast)

plus the SOTI<->TOSI reorders between phases 2-3 and 3-4, which are pure
memory ops at the lower of the adjacent phases' precisions (paper
footnote 8).  The adjoint ``m = F* d`` runs the same phases with a
conjugate-transpose SBGEMV.  Blocks of S right-hand sides
(``matmat``/``rmatmat``) run the same plans with an SBGEMM in Phase 3, and
:meth:`FFTMatvec.gram` returns the fused Gram operator
(:mod:`repro_torch.core.gram`).  Every variant compiles to a
:mod:`repro_torch.core.pipeline` plan and runs through its executor.

A config may carry a tile map (``"ddddd;tiles=ds|sh"``): the stored
F_hat stays at the gemv level and Phase 3 rounds each tile through its
cell's level (the tiled kernels).  :meth:`FFTMatvec.autotune` picks the
fastest config within a tolerance (:mod:`repro_torch.tune`).  The
operator is single-device; meshes raise ``NotImplementedError`` naming
the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import dataclasses

import torch

from . import pipeline
from . import precision as prec
from .pipeline import ExecOpts, reorder_planes  # noqa: F401  (public API)
from .precision import PrecisionConfig
from .toeplitz import default_device, fourier_block_column


def as_tensor(x, device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor on ``device`` (no
    copy when it already is one)."""
    return torch.as_tensor(x, device=device).contiguous()


@dataclasses.dataclass
class FFTMatvec:
    """Block-triangular Toeplitz matvec operator on one device.

    Input/output block vectors are SOTI: ``m`` (N_m, N_t), ``d`` (N_d,
    N_t).  The I/O dtype is the highest level the config uses.
    """

    F_hat_re: torch.Tensor       # (K, N_d, N_m) TOSI, stored at gemv level
    F_hat_im: torch.Tensor
    N_t: int
    precision: PrecisionConfig = PrecisionConfig()
    opts: ExecOpts = ExecOpts()

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_block_column(cls, F_col, precision=PrecisionConfig(),
                          opts=ExecOpts(), device=None, backend=None,
                          mesh=None) -> "FFTMatvec":
        """Phase-0 setup in f64 (paper §3.2.1), storing F_hat at the gemv
        level.  ``F_col`` is a numpy array or a tensor (N_t, N_d, N_m);
        ``device=None`` means the card.  ``backend`` is folded into
        ``opts`` (a spec or a registered name such as ``"torch-ref"``)."""
        if mesh is not None:
            raise NotImplementedError(pipeline._LATER["mesh"])
        if backend is not None:
            opts = dataclasses.replace(opts, backend=backend)
        col = as_tensor(F_col, default_device(device))
        F_re, F_im = fourier_block_column(
            col, dtype=prec.real_dtype(precision.gemv))
        return cls(F_re, F_im, col.shape[0], precision, opts)

    def with_precision(self, precision: PrecisionConfig) -> "FFTMatvec":
        """Same operator retuned to another per-phase config: the stored
        Fourier blocks are recast to the new gemv level (an upcast cannot
        restore bits lost when the operator was stored low)."""
        dt = prec.real_dtype(precision.gemv)
        return dataclasses.replace(self, precision=precision,
                                   F_hat_re=self.F_hat_re.to(dt),
                                   F_hat_im=self.F_hat_im.to(dt))

    def with_backend(self, backend, dispatch=None) -> "FFTMatvec":
        """Same operator lowered through another backend and, optionally,
        another dispatch table.  Numerics are unchanged to roundoff."""
        opts = dataclasses.replace(self.opts, backend=backend)
        if dispatch is not None:
            opts = dataclasses.replace(opts, dispatch=dispatch)
        return dataclasses.replace(self, opts=opts)

    def autotune(self, tol: float, *, full_result: bool = False, **kw):
        """Dynamic mixed-precision selection (paper §3.2 at run time): the
        operator retuned to the fastest per-phase config whose measured
        error stays within ``tol``, the lattice pruned by the calibrated
        eq.-(6) model so only a small frontier is timed.
        ``full_result=True`` returns the :class:`repro_torch.tune.
        TuneResult` instead.  Keywords go to :func:`repro_torch.tune.
        autotune` (``ladder``, ``variant``, ``tiles``, ``cache``, ...)."""
        from repro_torch.tune import autotune as _autotune  # tune builds on core
        res = _autotune(self, tol=tol, **kw)
        return res if full_result else res.op

    def gram(self, space: str = "parameter", mode: str = "exact"):
        """The fused Fourier-domain Gram operator
        (:class:`repro_torch.core.gram.GramOperator`): ``space="parameter"``
        is F*F, ``space="data"`` is F F*; ``mode="exact"`` matches the
        composed ``rmatvec(matvec(v))`` to roundoff, ``mode="circulant"``
        applies precomputed per-bin blocks G_hat[k] in one 5-phase pass
        (periodic-Gram semantics)."""
        from .gram import GramOperator  # deferred: gram builds on this class
        return GramOperator.from_matvec(self, space=space, mode=mode)

    # -- shapes --------------------------------------------------------------
    @property
    def N_d(self) -> int:
        return self.F_hat_re.shape[1]

    @property
    def N_m(self) -> int:
        return self.F_hat_re.shape[2]

    @property
    def device(self) -> torch.device:
        return self.F_hat_re.device

    @property
    def io_dtype(self) -> torch.dtype:
        return prec.real_dtype(self.precision.highest())

    # -- plan ------------------------------------------------------------------
    def plan(self, *, adjoint: bool = False) -> pipeline.Plan:
        """The plan :meth:`matvec` / :meth:`rmatvec` run."""
        return pipeline.matvec_plan(self.precision, adjoint=adjoint)

    def _apply(self, x, *, adjoint: bool):
        y = pipeline.run_plan(self.plan(adjoint=adjoint),
                              as_tensor(x, self.device),
                              {"F": (self.F_hat_re, self.F_hat_im)},
                              N_t=self.N_t, opts=self.opts)
        return y.to(self.io_dtype)

    # -- public API ------------------------------------------------------------
    def matvec(self, m):
        """d = F m.   m: (N_m, N_t) SOTI -> d: (N_d, N_t) SOTI."""
        return self._apply(m, adjoint=False)

    def rmatvec(self, d):
        """m = F* d.  d: (N_d, N_t) SOTI -> m: (N_m, N_t) SOTI."""
        return self._apply(d, adjoint=True)

    def matmat(self, M):
        """D = F M over S stacked right-hand sides: M (N_m, N_t, S) ->
        D (N_d, N_t, S), RHS axis minor.  A 2-D input is promoted to S = 1
        and squeezed back, so ``matvec`` is its S = 1 case."""
        if M.ndim == 2:
            return self.matmat(M[..., None])[..., 0]
        return self._apply(M, adjoint=False)

    def rmatmat(self, D):
        """M = F* D over S stacked right-hand sides: D (N_d, N_t, S) ->
        M (N_m, N_t, S)."""
        if D.ndim == 2:
            return self.rmatmat(D[..., None])[..., 0]
        return self._apply(D, adjoint=True)


# ---------------------------------------------------------------------------
# Per-phase callables for the runtime breakdown (paper Fig. 2)
# ---------------------------------------------------------------------------

def phase_callables(op: FFTMatvec, adjoint: bool = False):
    """Per-phase functions keyed by the paper's phase names, each consuming
    the previous phase's output.  The reorders time with the gemv they
    wrap, matching the paper's breakdown."""
    plan = op.plan(adjoint=adjoint)
    operands = {"F": (op.F_hat_re, op.F_hat_im)}
    opts = op.opts.resolve(op.device)
    group_of = {"pad": "pad", "fft": "fft", "reorder": "gemv",
                "gemv": "gemv", "ifft": "ifft", "unpad": "reduce"}
    groups = {name: tuple(s for s in plan if group_of[s.kind] == name)
              for name in ("pad", "fft", "gemv", "ifft", "reduce")}

    def make(stages, final: bool):
        def f(x):
            y = pipeline.run_stages(stages, x, operands, N_t=op.N_t,
                                    opts=opts)
            return y.to(op.io_dtype) if final else y
        return f

    return {name: make(stages, final=(name == "reduce"))
            for name, stages in groups.items()}
