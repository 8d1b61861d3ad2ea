"""Stage-graph pipeline core: typed stages -> plans -> one executor.

The FFTMatvec pipeline (paper §2.4) is a linear graph of memory and
compute stages.  Each variant compiles to a :class:`Plan` (a tuple of
:class:`Stage` descriptors, each carrying its precision level and layout
metadata) and runs through one executor, :func:`run_plan`.

Every stage carries one level of the h < s < d ladder; the reorder memory
stages run at the lower of the adjacent compute phases' levels (paper
footnote 8).

Plans: :func:`matvec_plan` (forward/adjoint) and :func:`gram_plan` (the
fused Fourier-domain Gram operator, exact or circulant), on one device.
Multi-RHS blocks (R, N_t, S) are flattened to stacked rows (S*R, N_t) at
entry and restored at exit, so S = 1 and S > 1 share every stage; Phase 3
dispatches to SBGEMM for S > 1.  The mesh reductions (psum, gemv_psum) and
tile maps raise ``NotImplementedError`` naming the ROADMAP.md item that
brings them.

Instrumentation: :func:`stage_counts` counts a plan's stages statically
and :func:`record_stages` counts stages as the executor runs them.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Iterator, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.backend import (BackendSpec, DispatchTable, default_table,
                                 resolve_backend)
from repro_torch.kernels import ops as kops
from . import precision as prec
from .precision import PrecisionConfig

STAGE_KINDS = ("pad", "fft", "reorder", "gemv", "ifft", "mask", "unpad",
               "psum", "gemv_psum")

_LATER = {
    "mesh": "mesh reductions (psum, gemv_psum) wait for ROADMAP.md queue 1 "
            "item 13 (multi-GPU)",
    "tiles": "tiles= configs wait for ROADMAP.md queue 1 item 11 "
             "(tile-centric precision) and the tiled kernels of queue 2",
}


# ---------------------------------------------------------------------------
# Execution options: which backend lowers the plan.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecOpts:
    """How a plan lowers: a backend + a dispatch table.

    ``backend``   a :class:`repro_torch.backend.BackendSpec`, a registered
                  name ("h100", "cpu-torch", "torch-ref"), or None: the
                  probe for the operator's device (``REPRO_TORCH_BACKEND``
                  override applies).
    ``dispatch``  the gemv's forced path; None = the backend's default.
    """

    backend: Union[BackendSpec, str, None] = None
    dispatch: Optional[DispatchTable] = None

    def resolve(self, device) -> "ResolvedOpts":
        """Bind to the concrete backend for tensors on ``device``."""
        spec = resolve_backend(self.backend, device)
        table = self.dispatch if self.dispatch is not None \
            else default_table(spec)
        return ResolvedOpts(spec=spec, table=table)


@dataclasses.dataclass(frozen=True)
class ResolvedOpts:
    """ExecOpts bound to a concrete spec: what the stage impls consume."""

    spec: BackendSpec
    table: DispatchTable


def _resolved(opts, device) -> ResolvedOpts:
    return opts if isinstance(opts, ResolvedOpts) else opts.resolve(device)


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: what to run, at which precision, on what layout.

    ``kind``     one of :data:`STAGE_KINDS`.
    ``level``    precision level ("h"/"s"/"d") the stage computes/stores at.
    ``adjoint``  gemv: conjugate-transpose flavour (F* pipelines).
    ``to_tosi``  reorder direction (SOTI -> TOSI or back).
    ``operand``  which operator planes feed a gemv stage ("F" for the
                 Fourier block column, "G" for precomputed Gram blocks).
    """

    kind: str
    level: str
    adjoint: bool = False
    to_tosi: bool = True
    operand: str = "F"

    def __post_init__(self):
        if self.kind not in STAGE_KINDS:
            raise ValueError(f"unknown stage kind {self.kind!r}")
        if self.level not in ("h", "s", "d"):
            raise ValueError(f"bad precision level {self.level!r}")


Plan = Tuple[Stage, ...]


# ---------------------------------------------------------------------------
# Stage implementations.  Carrier convention: time-domain data is one real
# tensor of stacked SOTI rows (S*R, T); Fourier-domain data is a split
# (re, im) plane pair, SOTI (S*R, K) around the reorders and TOSI (K, R)
# or, for S > 1, (K, R, S) between them.
# ---------------------------------------------------------------------------

def reorder_planes(re, im, level: str, *, to_tosi: bool, S: int = 1):
    """The SOTI<->TOSI reorder, the paper's "purely memory" intermediate
    phase, at ``level``.  S = 1: the transpose (R, K) <-> (K, R) (both
    directions are the same).  S > 1: stacked SOTI planes (S*R, K) <->
    TOSI panels (K, R, S) with the RHS axis minor.  Materialized: the cast
    and the permutation run as one copy into a contiguous tensor, which is
    what the kernels take."""
    dt = prec.real_dtype(level)

    def f(x):
        if S == 1:
            return x.new_empty((x.shape[1], x.shape[0]), dtype=dt).copy_(x.T)
        if to_tosi:
            K = x.shape[1]
            view = x.reshape(S, -1, K).permute(2, 1, 0)      # (K, R, S)
            return x.new_empty(view.shape, dtype=dt).copy_(view)
        view = x.permute(2, 1, 0)                             # (S, R, K)
        out = x.new_empty(view.shape, dtype=dt).copy_(view)
        return out.reshape(-1, x.shape[0])

    return f(re), f(im)


def _pad(stage, x, operands, N_t, S, opts):
    return kops.pad_cast(x, 2 * N_t, prec.real_dtype(stage.level),
                         backend=opts.spec)


def _fft(stage, x, operands, N_t, S, opts):
    # batched rfft over the minor (time) axis, computed at >= f32; complex
    # lives only inside the stage, which stores split planes at its level
    lvl = stage.level
    v_hat = torch.fft.rfft(x.to(prec.fft_compute_dtype(lvl)), dim=-1)
    dt = prec.real_dtype(lvl)
    return v_hat.real.to(dt), v_hat.imag.to(dt)


def _reorder(stage, x, operands, N_t, S, opts):
    re, im = x
    return reorder_planes(re, im, stage.level, to_tosi=stage.to_tosi, S=S)


def _gemv(stage, x, operands, N_t, S, opts):
    # Fourier-space block-diagonal product: per frequency bin an (m x n)
    # complex GEMV, or GEMM for a stacked block, through the dispatch table
    # (the kernels on the card).  ``operand`` selects F_hat or the
    # precomputed Gram blocks G_hat.
    A_re, A_im = operands[stage.operand]
    dt = prec.real_dtype(stage.level)
    mode = "H" if stage.adjoint else "N"
    x_re, x_im = (p.to(dt) for p in x)
    fn = kops.sbgemv if S == 1 else kops.sbgemm
    return fn(A_re.to(dt), A_im.to(dt), x_re, x_im, mode, out_dtype=dt,
              backend=opts.spec, dispatch=opts.table)


def _ifft(stage, x, operands, N_t, S, opts):
    lvl = stage.level
    part = prec.fft_compute_dtype(lvl)
    v_hat = torch.complex(x[0].to(part), x[1].to(part))
    v = torch.fft.irfft(v_hat, n=2 * N_t, dim=-1)
    return v.to(prec.real_dtype(lvl))


def _mask(stage, x, operands, N_t, S, opts):
    # The inter-pipeline truncation (the P^T P projector of the circulant
    # embedding) as one memory stage at one level: truncate, then
    # zero-extend, through the same pad/unpad kernels as Phases 1 and 5.
    dt = prec.real_dtype(stage.level)
    y = kops.unpad_cast(x, N_t, dt, backend=opts.spec)
    return kops.pad_cast(y, 2 * N_t, dt, backend=opts.spec)


def _unpad(stage, x, operands, N_t, S, opts):
    return kops.unpad_cast(x, N_t, prec.real_dtype(stage.level),
                           backend=opts.spec)


def _later(key):
    def impl(stage, x, operands, N_t, S, opts):
        raise NotImplementedError(f"stage {stage.kind!r}: {_LATER[key]}")
    return impl


_STAGE_IMPLS = {"pad": _pad, "fft": _fft, "reorder": _reorder, "gemv": _gemv,
                "ifft": _ifft, "mask": _mask, "unpad": _unpad,
                "psum": _later("mesh"), "gemv_psum": _later("mesh")}


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

_active_counters: list = []


@contextlib.contextmanager
def record_stages() -> Iterator[collections.Counter]:
    """Count stages as the executor runs them: yields a ``Counter`` mapping
    stage kind -> executions."""
    counter: collections.Counter = collections.Counter()
    _active_counters.append(counter)
    try:
        yield counter
    finally:
        _active_counters.remove(counter)


def stage_counts(plan: Plan) -> collections.Counter:
    """Static stage census of a plan: ``{kind: count}``."""
    return collections.Counter(stage.kind for stage in plan)


def run_stages(stages: Sequence[Stage], x, operands: Mapping, *, N_t: int,
               opts, S: int = 1):
    """Fold ``x`` (stacked rows of ``S`` right-hand sides) through
    ``stages``.  ``opts`` is an :class:`ExecOpts` (resolved here for the
    operands' device) or a :class:`ResolvedOpts`."""
    device = next(iter(operands.values()))[0].device
    opts = _resolved(opts, device)
    for stage in stages:
        for counter in _active_counters:
            counter[stage.kind] += 1
        x = _STAGE_IMPLS[stage.kind](stage, x, operands, N_t, S, opts)
    return x


def run_plan(plan: Plan, x, operands: Mapping, *, N_t: int, opts):
    """Execute a plan on a SOTI block vector: ``x`` is (R, N_t) for one
    right-hand side or (R, N_t, S) for a stacked block (RHS axis minor),
    flattened to (S*R, N_t) stacked rows so phases 1/2/4/5 run once over
    all S columns and Phase 3 dispatches to SBGEMM.  ``operands`` maps
    operand tags ("F", "G") to split (re, im) TOSI planes."""
    if x.ndim == 3:
        R, _, S = x.shape
        flat = x.permute(2, 0, 1).reshape(S * R, N_t)
        y = run_stages(plan, flat, operands, N_t=N_t, opts=opts, S=S)
        return y.reshape(S, -1, N_t).permute(1, 2, 0)
    return run_stages(plan, x, operands, N_t=N_t, opts=opts)


# ---------------------------------------------------------------------------
# Plan builders
# ---------------------------------------------------------------------------

def matvec_plan(cfg: PrecisionConfig, *, adjoint: bool = False,
                operand: str = "F") -> Plan:
    """The 5-phase single-device matvec pipeline as a plan (paper §2.4).

    Forward (``d = F m``) and adjoint (``m = F* d``) differ only in the
    gemv stage's conjugate-transpose flag; ``operand`` selects the planes
    the gemv contracts (the circulant Gram plan is this same pipeline over
    the "G" blocks).
    """
    if cfg.tiles is not None:
        raise NotImplementedError(_LATER["tiles"])
    return (
        Stage("pad", cfg.pad),
        Stage("fft", cfg.fft),
        Stage("reorder", cfg.reorder_level("fft", "gemv"), to_tosi=True),
        Stage("gemv", cfg.gemv, adjoint=adjoint, operand=operand),
        Stage("reorder", cfg.reorder_level("gemv", "ifft"), to_tosi=False),
        Stage("ifft", cfg.ifft),
        Stage("unpad", cfg.reduce),
    )


def gram_plan(cfg: PrecisionConfig, *, space: str = "parameter",
              mode: str = "exact") -> Plan:
    """The fused Fourier-domain Gram pipeline (Hessian actions, Remark 1).

    ``space="parameter"`` builds F*F (CGNR's normal operator),
    ``space="data"`` builds F F* (the data-space Hessian's Gram part).

    ``mode="exact"`` chains both per-bin products through one pipeline:
    pad -> FFT -> GEMM -> IFFT -> *mask* -> FFT -> GEMM^H -> IFFT -> unpad.
    The mask stage is the inter-operator truncation, fused in place of the
    composed path's unpad -> cast -> pad round trip; the result matches
    the composed ``rmatvec(matvec(v))`` to roundoff.

    ``mode="circulant"`` applies the precomputed per-bin Gram blocks
    G_hat[k] (operand "G") in a single 5-phase pass: half the FFT/IFFT and
    reorder stages of the composed path.  It computes the *periodic*
    (circulant) Gram, exact only up to the truncation wrap term: a
    preconditioner or screening proxy, not the composed operator.
    """
    if space not in ("parameter", "data"):
        raise ValueError(f"unknown gram space {space!r}")
    if mode == "circulant":
        return matvec_plan(cfg, operand="G")
    if mode != "exact":
        raise ValueError(f"unknown gram mode {mode!r}")
    if cfg.tiles is not None:
        raise NotImplementedError(_LATER["tiles"])
    # parameter space runs F then F* (first gemv forward), data space F*
    # then F
    first_adjoint = space == "data"
    return (
        Stage("pad", cfg.pad),
        Stage("fft", cfg.fft),
        Stage("reorder", cfg.reorder_level("fft", "gemv"), to_tosi=True),
        Stage("gemv", cfg.gemv, adjoint=first_adjoint),
        Stage("reorder", cfg.reorder_level("gemv", "ifft"), to_tosi=False),
        Stage("ifft", cfg.ifft),
        Stage("mask", prec.min_level(cfg.ifft, cfg.fft)),
        Stage("fft", cfg.fft),
        Stage("reorder", cfg.reorder_level("fft", "gemv"), to_tosi=True),
        Stage("gemv", cfg.gemv, adjoint=not first_adjoint),
        Stage("reorder", cfg.reorder_level("gemv", "ifft"), to_tosi=False),
        Stage("ifft", cfg.ifft),
        Stage("unpad", cfg.reduce),
    )
