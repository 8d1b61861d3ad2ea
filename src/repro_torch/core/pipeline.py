"""Stage-graph pipeline core: typed stages -> plans -> one executor.

The FFTMatvec pipeline (paper §2.4) is a linear graph of memory and
compute stages.  Each variant compiles to a :class:`Plan` (a tuple of
:class:`Stage` descriptors, each carrying its precision level and layout
metadata) and runs through one executor, :func:`run_plan`.

Every stage carries one level of the h < s < d ladder; the reorder memory
stages run at the lower of the adjacent compute phases' levels (paper
footnote 8).

Plans: :func:`matvec_plan` (forward/adjoint) and :func:`gram_plan` (the
fused Fourier-domain Gram operator, exact or circulant).  Multi-RHS blocks
(R, N_t, S) are flattened to stacked rows (S*R, N_t) at entry and restored
at exit, so S = 1 and S > 1 share every stage; Phase 3 dispatches to
SBGEMM for S > 1.  A config's tile map rides on the gemv stages that
contract F_hat (tile-centric precision).

On a 2-D process grid (``torch.distributed``, SPMD: every rank runs the
same plan on its own shard) the plans end their partial contractions in
``psum`` stages, reductions over a mesh axis lowered one of
:data:`COLLECTIVE_KINDS` ways, or fuse the gemv with its reduction in one
``gemv_psum`` super-stage that chunks the contraction along its output
rows so one chunk's reduction is in flight while the next computes.  The
process group of each axis comes with the resolved options
(``ResolvedOpts.groups``, from the operator's ``DeviceMesh``).

Instrumentation: :func:`stage_counts` counts a plan's stages statically
and :func:`record_stages` counts stages as the executor runs them, with
the collectives each reduction launched under ``collective:*`` keys.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Iterator, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.backend import (BackendSpec, DispatchTable, default_table,
                                 resolve_backend)
from repro_torch.kernels import ops as kops
from . import precision as prec
from .precision import PrecisionConfig

STAGE_KINDS = ("pad", "fft", "reorder", "gemv", "ifft", "mask", "unpad",
               "psum", "gemv_psum")

# How a psum stage lowers (paper §4.2.2, as in the JAX package):
#   "psum"            one flat all-reduce over the whole axis group
#   "hierarchical"    one all-reduce a mesh axis, the minor (fast) tier
#                     first, then outward: the executed form of the
#                     paper's comm-aware blocking
#   "reduce_scatter"  reduce-scatter + all-gather over the minor axis (an
#                     all-reduce over the outer axes between them); the
#                     flat all-reduce, counted as
#                     ``collective:reduce_scatter:fallback``, when the
#                     carrier's leading dim does not divide the group
#   "ring"            g-1 send/receive hops over the minor axis that
#                     circulate the ORIGINAL partials, summed on every
#                     rank in canonical origin-rank order 0..g-1, so each
#                     row's sum is independent of how the rows were
#                     chunked (the pipelined schedule is bit for bit the
#                     serial one); ``collective:ring:fallback`` (the flat
#                     all-reduce) when the stage records no group sizes
COLLECTIVE_KINDS = ("psum", "hierarchical", "reduce_scatter", "ring")


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
    ``overlap``   chunk count of the pipelined ``gemv_psum`` super-stage:
                  ``"auto"`` lets the dispatch table decide
                  (:meth:`DispatchTable.overlap_chunks`, which may decline:
                  K = 1 is the serial schedule), an int pins K, None never
                  pipelines.  Plans without a collective are unchanged by
                  it, and it changes a plan's timing, never its math.
    """

    backend: Union[BackendSpec, str, None] = None
    dispatch: Optional[DispatchTable] = None
    overlap: Union[str, int, None] = "auto"

    def __post_init__(self):
        ov = self.overlap
        if not (ov is None or ov == "auto"
                or (isinstance(ov, int) and not isinstance(ov, bool)
                    and ov >= 1)):
            raise ValueError(f"overlap must be 'auto', a chunk count >= 1 "
                             f"or None, got {ov!r}")

    def resolve(self, device) -> "ResolvedOpts":
        """Bind to the concrete backend for tensors on ``device``."""
        spec = resolve_backend(self.backend, device)
        table = self.dispatch if self.dispatch is not None \
            else default_table(spec)
        return ResolvedOpts(spec=spec, table=table, overlap=self.overlap)


@dataclasses.dataclass(frozen=True)
class ResolvedOpts:
    """ExecOpts bound to a concrete spec: what the stage impls consume.
    ``groups`` maps each psum axis spec of the plans (a mesh dim name or a
    tuple of them) to this rank's ``ProcessGroup`` over it; None off a
    mesh."""

    spec: BackendSpec
    table: DispatchTable
    overlap: Union[str, int, None] = "auto"
    groups: Optional[Mapping] = dataclasses.field(default=None,
                                                  compare=False)


def _resolved(opts, operands: Mapping) -> ResolvedOpts:
    """``opts`` bound for the operands' device (as it is when resolved)."""
    if isinstance(opts, ResolvedOpts):
        return opts
    return opts.resolve(next(iter(operands.values()))[0].device)


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: what to run, at which precision, on what layout.

    ``kind``     one of :data:`STAGE_KINDS`.
    ``level``    precision level ("h"/"s"/"d") the stage computes/stores at.
    ``adjoint``  gemv: conjugate-transpose flavour (F* pipelines).
    ``to_tosi``  reorder direction (SOTI -> TOSI or back).
    ``operand``  which operator planes feed a gemv stage ("F" for the
                 Fourier block column, "G" for precomputed Gram blocks).
    ``tile_map`` gemv: per-tile *effective* storage levels (the config's
                 map min'd against the stage level) that the product
                 rounds the operand through, cell by cell.  On a mesh the
                 map's grid partitions the local operand shard.
    ``axis``     psum: the mesh dim name, or a tuple of names ordered slow
                 (outer tier) to fast (minor tier), to reduce over.  For a
                 psum stage ``level`` is the *communication* level: the
                 reduction runs at it and the carrier's dtype is restored
                 after it.
    ``collective`` psum: the lowering (:data:`COLLECTIVE_KINDS`).
    ``groups``   psum: the device count of each axis in ``axis``.
    ``comm``     gemv_psum: the fused reduction's level (its own ``level``
                 is the gemv's).
    ``body``     gemv_psum: the stages between the gemv and its reduction
                 (reorder/ifft/unpad of the matvec tail; none for the
                 Gram's mid reduction), run per chunk.
    """

    kind: str
    level: str
    adjoint: bool = False
    to_tosi: bool = True
    operand: str = "F"
    tile_map: Optional[prec.TileMap] = None
    axis: Union[str, Tuple[str, ...], None] = None
    collective: str = "psum"
    groups: Optional[Tuple[int, ...]] = None
    comm: Optional[str] = None
    body: Tuple["Stage", ...] = ()

    def __post_init__(self):
        if self.kind not in STAGE_KINDS:
            raise ValueError(f"unknown stage kind {self.kind!r}")
        if self.level not in ("h", "s", "d"):
            raise ValueError(f"bad precision level {self.level!r}")
        if self.collective not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {self.collective!r}")
        if self.groups is not None and len(self.groups) != len(self.axes):
            raise ValueError("groups must match the psum axis tuple")
        if self.kind == "gemv_psum" and self.axis is None:
            raise ValueError("gemv_psum needs a psum axis: use a plain gemv "
                             "stage when there is no collective")

    @property
    def axes(self) -> Tuple[str, ...]:
        """The psum axis group as a tuple (slow -> fast order)."""
        if self.axis is None:
            return ()
        return (self.axis,) if isinstance(self.axis, str) else self.axis

    def gemv_stage(self) -> "Stage":
        """The compute half of a gemv_psum super-stage."""
        return Stage("gemv", self.level, adjoint=self.adjoint,
                     operand=self.operand, tile_map=self.tile_map)

    def psum_stage(self) -> "Stage":
        """The reduction half of a gemv_psum super-stage."""
        return Stage("psum", self.comm or self.level, axis=self.axis,
                     collective=self.collective, groups=self.groups)


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
              backend=opts.spec, dispatch=opts.table, tile_map=stage.tile_map)


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


# ---------------------------------------------------------------------------
# Collectives: the psum stage's lowerings over torch.distributed.
# ---------------------------------------------------------------------------

def _count(key: str, n: int = 1) -> None:
    for counter in _active_counters:
        counter[key] += n


def _group(opts, axes: Tuple[str, ...]):
    """This rank's process group over the mesh axes ``axes``."""
    if opts.groups is None:
        raise RuntimeError("a psum stage runs only on a mesh: its operator "
                           "hands the executor the axes' process groups")
    return opts.groups[axes[0] if len(axes) == 1 else tuple(axes)]


def _host_staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on ``t`` goes through host memory: a card
    tensor on a gloo group (the backend that lets several ranks share one
    card), whose CUDA support differs from op to op.  Decided by the
    group's backend alone, and counted as ``collective:host_staged``."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _start_collective(kind: str, out: torch.Tensor, inp: torch.Tensor,
                      group):
    """Start one collective from ``inp`` into ``out`` (``all_reduce``:
    in place, ``out is inp``; ``reduce_scatter``, ``all_gather``: the
    tensor forms) with ``async_op``; returns a function that waits for it
    and returns ``out``.  Under NCCL the wait only orders the current
    stream after it, so the host runs on: this is what lets a chunk's
    reduction overlap the next chunk's gemv."""
    staged = _host_staged(inp, group)
    if staged:
        _count("collective:host_staged")
        src = inp.cpu()
        dst = src if kind == "all_reduce" else out.new_empty(out.shape,
                                                             device="cpu")
    else:
        src, dst = inp, out
    if kind == "all_reduce":
        work = dist.all_reduce(dst, group=group, async_op=True)
    elif kind == "reduce_scatter":
        work = dist.reduce_scatter_tensor(dst, src, group=group,
                                          async_op=True)
    else:
        work = dist.all_gather_into_tensor(dst, src, group=group,
                                           async_op=True)

    def done():
        work.wait()
        if staged:
            out.copy_(dst)
        return out
    return done


def _ring_hop(t: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
    """Send ``t`` to group rank ``dst`` and return what group rank ``src``
    sent this rank (one hop of the ring)."""
    staged = _host_staged(t, group)
    if staged:
        _count("collective:host_staged")
    send = t.cpu() if staged else t
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst),
                      group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src),
                      group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(t.device) if staged else recv


def _ring_all_reduce(q: torch.Tensor, group, g: int) -> torch.Tensor:
    """All-reduce over ``group`` (g ranks) as g-1 ring hops that
    circulate the original partials, then a local sum in canonical
    origin-rank order 0..g-1: every rank and every chunking sums each row
    over the same g parts in the same order (a segmented reduce-scatter
    ring would start each segment at another rank).  The price is
    bandwidth, (g-1) whole payloads a hop against 2(g-1)/g, the right
    trade for the paper's latency-bound 0.8 MB collectives."""
    if g <= 1:
        return q
    me = dist.get_rank(group)
    nxt, prv = (me + 1) % g, (me - 1) % g
    parts, cur = [q], q
    for _ in range(g - 1):
        cur = _ring_hop(cur, group, nxt, prv)
        parts.append(cur)
    # after s hops this rank holds the partial of origin (me - s) mod g
    acc = parts[me % g]
    for origin in range(1, g):
        acc = acc + parts[(me - origin) % g]
    return acc


def _collective_count(stage) -> int:
    """How many collectives one carrier plane of this psum stage launches:
    what :func:`record_stages` reports under ``collective:*``."""
    if stage.collective == "hierarchical":
        return len(stage.axes)
    if stage.collective == "reduce_scatter":
        return 2 + (1 if len(stage.axes) > 1 else 0)
    if stage.collective == "ring":
        g = stage.groups[-1] if stage.groups else 1
        return max(1, (g - 1) + (1 if len(stage.axes) > 1 else 0))
    return 1


def _psum_start(stage, x, opts):
    """Start the reduction of carrier ``x`` (a tensor or a (re, im) plane
    pair) at the stage's communication level; returns a function that
    completes it and returns the reduced carrier in its own dtype (a low
    communication level is one rounding per reduction, never a downgrade
    of the stages after it).  Only the last collective of a lowering is
    left in flight; the ring runs to its end."""
    axes = stage.axes
    comm_dt = prec.real_dtype(stage.level)
    minor_group = stage.groups[-1] if stage.groups else None
    lead = (x[0] if isinstance(x, tuple) else x).shape[0]
    rs_ok = (stage.collective == "reduce_scatter"
             and minor_group is not None and lead % minor_group == 0)
    ring_ok = stage.collective == "ring" and minor_group is not None
    # a decomposition the carrier or the plan cannot take runs the flat
    # all-reduce, and says so
    fallback = ((stage.collective == "reduce_scatter" and not rs_ok)
                or (stage.collective == "ring" and not ring_ok))
    key = (f"collective:{stage.collective}:fallback" if fallback
           else f"collective:{stage.collective}")
    _count(key, 1 if fallback else _collective_count(stage))

    def reduce_one(p):
        q = p.to(comm_dt).contiguous()
        if stage.collective == "hierarchical":
            done = None
            for ax in reversed(axes):        # the minor tier first
                if done is not None:
                    q = done()
                done = _start_collective("all_reduce", q, q,
                                         _group(opts, (ax,)))
            return done
        if rs_ok:
            minor = _group(opts, axes[-1:])
            part = q.new_empty((lead // minor_group,) + q.shape[1:])
            part = _start_collective("reduce_scatter", part, q, minor)()
            if len(axes) > 1:
                part = _start_collective("all_reduce", part, part,
                              _group(opts, axes[:-1]))()
            return _start_collective("all_gather", q, part, minor)
        if ring_ok:
            q = _ring_all_reduce(q, _group(opts, axes[-1:]), minor_group)
            if len(axes) > 1:
                return _start_collective("all_reduce", q, q,
                                         _group(opts, axes[:-1]))
            return lambda: q
        return _start_collective("all_reduce", q, q, _group(opts, axes))

    planes = x if isinstance(x, tuple) else (x,)
    pending = [(reduce_one(p), p.dtype) for p in planes]

    def done():
        out = tuple(wait().to(dt) for wait, dt in pending)
        return out if isinstance(x, tuple) else out[0]
    return done


def _psum(stage, x, operands, N_t, S, opts):
    # mesh reduction at the stage's communication level, completed here
    return _psum_start(stage, x, opts)()


def _overlap_chunks(stage, rows: int, opts) -> int:
    """The chunk count of a pipelined super-stage: ``ExecOpts.overlap``
    against the dispatch table, the local output rows and the reduction
    group's size.  A gemv with a tile map never chunks: the map's grid
    partitions the whole local operand, and a grid per chunk would round
    other cells."""
    if stage.tile_map is not None:
        return 1
    group = None
    if stage.groups is not None:
        group = 1
        for g in stage.groups:
            group *= g
    return opts.table.overlap_chunks(rows, group, opts.spec,
                                     prefer=opts.overlap)


def _chunk_bounds(rows: int, K: int):
    """K near-equal (start, size) row chunks (empty chunks dropped)."""
    base, rem = divmod(rows, K)
    bounds, start = [], 0
    for i in range(K):
        size = base + (1 if i < rem else 0)
        if size:
            bounds.append((start, size))
        start += size
    return bounds


def _assemble_chunks(pieces, rows: int, S: int):
    """The per-chunk outputs in the serial row order, one ``cat`` per
    carrier plane."""
    if len(pieces) == 1:
        return pieces[0]
    if isinstance(pieces[0], tuple):
        # plane-pair carrier: rows on axis 1 (TOSI)
        return tuple(torch.cat([piece[p] for piece in pieces], dim=1)
                     for p in range(len(pieces[0])))
    # time-domain carrier (S*rows_chunk, T), S-major: join through an
    # (S, rows, T) view
    T = pieces[0].shape[-1]
    parts = [piece.reshape(S, piece.shape[0] // S, T) for piece in pieces]
    return torch.cat(parts, dim=1).reshape(S * rows, T)


def _gemv_psum(stage, x, operands, N_t, S, opts):
    # The pipelined gemv -> psum super-stage: the Phase-3 contraction
    # splits along its OUTPUT rows into K chunks, each a view of F_hat
    # (the kernels take A's strides: no copy), so chunk k's reduction is
    # in flight while chunk k+1 computes.  Rows are independent in the
    # contraction and in the reduction, so every row is computed as in the
    # serial plan.
    A_re, A_im = operands[stage.operand]
    axis = 2 if stage.adjoint else 1         # the gemv's output-rows axis
    rows = A_re.shape[axis]
    K = min(_overlap_chunks(stage, rows, opts), rows)
    sub = (stage.gemv_stage(),) + stage.body + (stage.psum_stage(),)
    if K <= 1:
        # serial: the constituent stages, counted as the unpipelined plan
        return run_stages(sub, x, operands, N_t=N_t, opts=opts, S=S)
    ring = stage.collective == "ring"
    _count(f"collective:{'ring' if ring else 'pipelined'}:{K}")
    compute, reduction = sub[:-1], sub[-1]
    pieces, pending = [], []
    for start, size in _chunk_bounds(rows, K):
        chunk_ops = dict(operands)
        chunk_ops[stage.operand] = (A_re.narrow(axis, start, size),
                                    A_im.narrow(axis, start, size))
        produced = run_stages(compute, x, chunk_ops, N_t=N_t, opts=opts, S=S)
        if ring:
            # software pipeline: this chunk's compute, then the previous
            # chunk's ring reduction; one unreduced carrier waits at a time
            if pending:
                pieces.append(run_stages((reduction,), pending.pop(),
                                         operands, N_t=N_t, opts=opts, S=S))
            pending.append(produced)
        else:
            # each chunk's collective left in flight, waited at assembly
            _count("psum")
            pending.append(_psum_start(reduction, produced, opts))
    if ring:
        pieces.append(run_stages((reduction,), pending.pop(), operands,
                                 N_t=N_t, opts=opts, S=S))
    else:
        pieces = [wait() for wait in pending]
    return _assemble_chunks(pieces, rows, S)


_STAGE_IMPLS = {"pad": _pad, "fft": _fft, "reorder": _reorder, "gemv": _gemv,
                "ifft": _ifft, "mask": _mask, "unpad": _unpad, "psum": _psum,
                "gemv_psum": _gemv_psum}


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

_active_counters: list = []


@contextlib.contextmanager
def record_stages() -> Iterator[collections.Counter]:
    """Count stages as the executor runs them: yields a ``Counter`` mapping
    stage kind -> executions.  A psum stage also counts the collectives it
    launched for each carrier plane, under ``"collective:<kind>"`` (a
    two-axis hierarchical reduction counts 2), ``":fallback"`` when a
    requested decomposition could not run, and each host-staged one under
    ``"collective:host_staged"``; a chunked super-stage counts
    ``"collective:pipelined:<K>"`` or ``"collective:ring:<K>"`` once."""
    counter: collections.Counter = collections.Counter()
    _active_counters.append(counter)
    try:
        yield counter
    finally:
        _active_counters.remove(counter)


def stage_counts(plan: Plan) -> collections.Counter:
    """Static stage census of a plan: ``{kind: count}``.  A ``gemv_psum``
    super-stage counts under its own kind and under each constituent
    (``gemv``, its body, ``psum``), so pipelined and serial plans agree on
    the constituent totals."""
    counter: collections.Counter = collections.Counter()
    for stage in plan:
        counter[stage.kind] += 1
        if stage.kind == "gemv_psum":
            counter["gemv"] += 1
            for b in stage.body:
                counter[b.kind] += 1
            counter["psum"] += 1
    return counter


def run_stages(stages: Sequence[Stage], x, operands: Mapping, *, N_t: int,
               opts, S: int = 1):
    """Fold ``x`` (stacked rows of ``S`` right-hand sides) through
    ``stages``.  ``opts`` is an :class:`ExecOpts` (resolved here for the
    operands' device) or a :class:`ResolvedOpts`."""
    opts = _resolved(opts, operands)
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

def _gemv_tiles(cfg: PrecisionConfig, operand: str = "F"):
    """The gemv stage's tile map: the config's, min'd against the gemv
    level.  Only the F operand carries one: the map is derived from
    F_hat's block norms and says nothing about precomputed G blocks."""
    if cfg.tiles is None or operand != "F":
        return None
    return prec.TileMap(cfg.tiles.effective(cfg.gemv))


def matvec_plan(cfg: PrecisionConfig, *, adjoint: bool = False,
                operand: str = "F", psum_axis=None,
                collective: str = "psum",
                psum_groups: Optional[Tuple[int, ...]] = None,
                comm_level: Optional[str] = None) -> Plan:
    """The 5-phase matvec pipeline as a plan (paper §2.4).

    Forward (``d = F m``) and adjoint (``m = F* d``) differ only in the
    gemv stage's conjugate-transpose flag; ``operand`` selects the planes
    the gemv contracts (the circulant Gram plan is this same pipeline over
    the "G" blocks).  On a mesh, ``psum_axis`` (a mesh dim name or a
    slow-to-fast tuple) is the axis the local contraction was partial in:
    the plan then ends in its reduction, lowered per ``collective`` at
    ``comm_level`` (None: the reduce level), ``psum_groups`` the device
    count of each axis.  The gemv and its reduction are then one
    ``gemv_psum`` super-stage carrying the tail between them, chunked or
    not per ``ExecOpts.overlap`` (None runs its constituent stages in
    order, the serial schedule).
    """
    head = (
        Stage("pad", cfg.pad),
        Stage("fft", cfg.fft),
        Stage("reorder", cfg.reorder_level("fft", "gemv"), to_tosi=True),
    )
    gemv = Stage("gemv", cfg.gemv, adjoint=adjoint, operand=operand,
                 tile_map=_gemv_tiles(cfg, operand))
    tail = (
        Stage("reorder", cfg.reorder_level("gemv", "ifft"), to_tosi=False),
        Stage("ifft", cfg.ifft),
        Stage("unpad", cfg.reduce),
    )
    if psum_axis is None:
        return head + (gemv,) + tail
    return head + (Stage("gemv_psum", cfg.gemv, adjoint=adjoint,
                         operand=operand, tile_map=_gemv_tiles(cfg, operand),
                         axis=psum_axis, collective=collective,
                         groups=psum_groups, comm=comm_level or cfg.reduce,
                         body=tail),)


def gram_plan(cfg: PrecisionConfig, *, space: str = "parameter",
              mode: str = "exact", mid_psum_axis=None, psum_axis=None,
              collective: str = "psum",
              mid_psum_groups: Optional[Tuple[int, ...]] = None,
              psum_groups: Optional[Tuple[int, ...]] = None,
              comm_level: Optional[str] = None) -> Plan:
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

    On a mesh ``mid_psum_axis`` completes the first contraction and
    ``psum_axis`` the second, as in :func:`matvec_plan` (the mid reduction
    defaults to the reorder level between the gemv it completes and the
    ifft); each gemv is fused with the reduction it feeds into a
    ``gemv_psum`` super-stage (the mid one with an empty body).
    """
    if space not in ("parameter", "data"):
        raise ValueError(f"unknown gram space {space!r}")
    if mode == "circulant":
        return matvec_plan(cfg, operand="G", psum_axis=psum_axis,
                           collective=collective, psum_groups=psum_groups,
                           comm_level=comm_level)
    if mode != "exact":
        raise ValueError(f"unknown gram mode {mode!r}")
    # parameter space runs F then F* (first gemv forward), data space F*
    # then F
    first_adjoint = space == "data"
    mid_level = cfg.reorder_level("gemv", "ifft")
    stages = [
        Stage("pad", cfg.pad),
        Stage("fft", cfg.fft),
        Stage("reorder", cfg.reorder_level("fft", "gemv"), to_tosi=True),
    ]
    if mid_psum_axis is not None:
        stages.append(Stage("gemv_psum", cfg.gemv, adjoint=first_adjoint,
                            tile_map=_gemv_tiles(cfg), axis=mid_psum_axis,
                            collective=collective, groups=mid_psum_groups,
                            comm=comm_level or mid_level))
    else:
        stages.append(Stage("gemv", cfg.gemv, adjoint=first_adjoint,
                            tile_map=_gemv_tiles(cfg)))
    stages += [
        Stage("reorder", mid_level, to_tosi=False),
        Stage("ifft", cfg.ifft),
        Stage("mask", prec.min_level(cfg.ifft, cfg.fft)),
        Stage("fft", cfg.fft),
        Stage("reorder", cfg.reorder_level("fft", "gemv"), to_tosi=True),
    ]
    gemv2 = Stage("gemv", cfg.gemv, adjoint=not first_adjoint,
                  tile_map=_gemv_tiles(cfg))
    tail = (
        Stage("reorder", cfg.reorder_level("gemv", "ifft"), to_tosi=False),
        Stage("ifft", cfg.ifft),
        Stage("unpad", cfg.reduce),
    )
    if psum_axis is None:
        return tuple(stages) + (gemv2,) + tail
    return tuple(stages) + (Stage(
        "gemv_psum", cfg.gemv, adjoint=not first_adjoint,
        tile_map=_gemv_tiles(cfg), axis=psum_axis, collective=collective,
        groups=psum_groups, comm=comm_level or cfg.reduce, body=tail),)
