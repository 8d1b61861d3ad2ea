"""Stage-graph pipeline core: typed stages -> plans -> one executor.

The FFTMatvec pipeline (paper §2.4) is a linear graph of memory and
compute stages.  Each variant compiles to a :class:`Plan` (a tuple of
:class:`Stage` descriptors, each carrying its precision level and layout
metadata) and runs through one executor, :func:`run_plan`.

Every stage carries one level of the h < s < d ladder; the reorder memory
stages run at the lower of the adjacent compute phases' levels (paper
footnote 8).

This slice ports the single-device, single-right-hand-side matvec plan:
the stages pad, fft, reorder, gemv, ifft and unpad.  The Gram plan, the
mask stage, the mesh reductions and S > 1 blocks raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.

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
    "gram": "the Gram plan and its mask stage wait for ROADMAP.md queue 1 "
            "item 8 (core/gram.py)",
    "mesh": "mesh reductions (psum, gemv_psum) wait for ROADMAP.md queue 1 "
            "item 13 (multi-GPU)",
    "rhs": "S > 1 right-hand sides need the SBGEMM kernels: ROADMAP.md "
           "queue 1 item 6 and queue 2 (sbgemm_n_complex, "
           "sbgemm_th_complex)",
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
    ``operand``  which operator planes feed a gemv stage ("F").
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
# (R, T) tensor of SOTI rows; Fourier-domain data is a split (re, im) plane
# pair, SOTI (R, K) around the reorders and TOSI (K, R) between them.
# ---------------------------------------------------------------------------

def reorder_planes(re, im, level: str, *, to_tosi: bool):
    """The SOTI<->TOSI reorder (R, K) <-> (K, R), the paper's "purely
    memory" intermediate phase, at ``level``.  Materialized: the cast and
    the transpose run as one copy into a contiguous tensor, which is what
    the kernels take.  ``to_tosi`` only names the direction: for one
    right-hand side both directions are the same transpose."""
    dt = prec.real_dtype(level)

    def f(x):
        out = x.new_empty((x.shape[1], x.shape[0]), dtype=dt)
        return out.copy_(x.T)

    return f(re), f(im)


def _pad(stage, x, operands, N_t, opts):
    return kops.pad_cast(x, 2 * N_t, prec.real_dtype(stage.level),
                         backend=opts.spec)


def _fft(stage, x, operands, N_t, opts):
    # batched rfft over the minor (time) axis, computed at >= f32; complex
    # lives only inside the stage, which stores split planes at its level
    lvl = stage.level
    v_hat = torch.fft.rfft(x.to(prec.fft_compute_dtype(lvl)), dim=-1)
    dt = prec.real_dtype(lvl)
    return v_hat.real.to(dt), v_hat.imag.to(dt)


def _reorder(stage, x, operands, N_t, opts):
    re, im = x
    return reorder_planes(re, im, stage.level, to_tosi=stage.to_tosi)


def _gemv(stage, x, operands, N_t, opts):
    # Fourier-space block-diagonal product: per frequency bin an (m x n)
    # complex GEMV, through the dispatch table (the kernels on the card)
    A_re, A_im = operands[stage.operand]
    dt = prec.real_dtype(stage.level)
    mode = "H" if stage.adjoint else "N"
    x_re, x_im = (p.to(dt) for p in x)
    return kops.sbgemv(A_re.to(dt), A_im.to(dt), x_re, x_im, mode,
                       out_dtype=dt, backend=opts.spec, dispatch=opts.table)


def _ifft(stage, x, operands, N_t, opts):
    lvl = stage.level
    part = prec.fft_compute_dtype(lvl)
    v_hat = torch.complex(x[0].to(part), x[1].to(part))
    v = torch.fft.irfft(v_hat, n=2 * N_t, dim=-1)
    return v.to(prec.real_dtype(lvl))


def _unpad(stage, x, operands, N_t, opts):
    return kops.unpad_cast(x, N_t, prec.real_dtype(stage.level),
                           backend=opts.spec)


def _later(key):
    def impl(stage, x, operands, N_t, opts):
        raise NotImplementedError(f"stage {stage.kind!r}: {_LATER[key]}")
    return impl


_STAGE_IMPLS = {"pad": _pad, "fft": _fft, "reorder": _reorder, "gemv": _gemv,
                "ifft": _ifft, "unpad": _unpad, "mask": _later("gram"),
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
               opts):
    """Fold ``x`` through ``stages``.  ``opts`` is an :class:`ExecOpts`
    (resolved here for the operands' device) or a :class:`ResolvedOpts`."""
    device = next(iter(operands.values()))[0].device
    opts = _resolved(opts, device)
    for stage in stages:
        for counter in _active_counters:
            counter[stage.kind] += 1
        x = _STAGE_IMPLS[stage.kind](stage, x, operands, N_t, opts)
    return x


def run_plan(plan: Plan, x, operands: Mapping, *, N_t: int, opts):
    """Execute a plan on a SOTI block vector ``x`` of shape (R, N_t), or
    (R, N_t, 1) for a one-column block.  ``operands`` maps operand tags to
    split (re, im) TOSI planes."""
    if x.ndim == 3:
        if x.shape[2] != 1:
            raise NotImplementedError(_LATER["rhs"])
        return run_plan(plan, x[..., 0], operands, N_t=N_t, opts=opts)[..., None]
    return run_stages(plan, x, operands, N_t=N_t, opts=opts)


# ---------------------------------------------------------------------------
# Plan builders
# ---------------------------------------------------------------------------

def matvec_plan(cfg: PrecisionConfig, *, adjoint: bool = False,
                operand: str = "F") -> Plan:
    """The 5-phase single-device matvec pipeline as a plan (paper §2.4).

    Forward (``d = F m``) and adjoint (``m = F* d``) differ only in the
    gemv stage's conjugate-transpose flag.
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


def gram_plan(cfg: PrecisionConfig, **kw) -> Plan:
    """The fused Fourier-domain Gram pipeline: not ported yet."""
    raise NotImplementedError(_LATER["gram"])
