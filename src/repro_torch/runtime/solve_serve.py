"""Multi-tenant solve serving: continuous batching for FFTMatvec/Krylov.

Twin of ``src/repro/runtime/solve_serve.py``, the solver-side analogue of
:class:`repro_torch.runtime.serve.ServeEngine`: a request queue of
independent inverse-problem solves, each carrying its own ``(d_obs,
tolerance, max_iters)``, served by coalescing compatible requests into ONE
multi-RHS CGNR call, so independent users fill the S axis of the SBGEMM
kernels.

Pipeline per admitted request:

  admission   d_obs shape routes to a registered operator; bad shapes,
              non-positive tolerances and negative budgets are rejected
              up front.
  bucketing   the tolerance is rounded DOWN to its decade bucket (the
              served config is never looser than what the user asked
              for), and requests group by (operator fingerprint,
              tolerance bucket, damp).
  tuning      tolerance -> operator PrecisionConfig through the engine's
              memo, then the TuningCache (warm), then one
              ``autotune(variant="gram")`` (cold, CGNR's per-iteration
              cost), which also fills the cache.
  coalescing  up to ``max_batch`` bucket-mates stack their observation
              blocks along the RHS axis, on the operator's device, and
              share one Gram-apply-per-iteration ``pcg`` with per-column
              tolerances and budgets (its column freeze keeps a converged
              user's solution from drifting while batch-mates finish).
  demux       each request gets back its own column: the solution (a view
              on the operator's device, no host copy), converged flag,
              iteration count and residual history.

On a process grid the engine is SPMD: every rank builds it over its
meshed operator and calls ``serve`` with the same requests.  Requests
carry the global ``d_obs`` and route by the operator's global data
shape; each rank cuts its rows (``FFTMatvec.local_block``), the solve's
inner products sum over the grid, and each outcome's ``x`` is the
gathered global block, as the single-device engine returns it.  The
fingerprint covers the whole operator, so buckets, cache keys and cold
or warm tunes agree on every rank.

Reuse counters.  PyTorch runs eagerly, so there is no trace to reuse; the
engine counts what a trace costs the reference here.  ``n_appliers`` is
the number of distinct ``(family, variant)`` callables the engine has
taken from its :class:`~repro_torch.core.timing.TimingHarness` (family
"mat" for ``rmatmat``, "gram" for the Gram, as the reference's shared
appliers).
``n_traces`` is the number of served operators built: one
``op.with_precision(cfg)`` (a cast of F_hat to the config's gemv level)
per distinct config an operator is served under, the eager counterpart of
a retrace.  Re-serving a bucket, or serving a new bucket under a config
already built, builds neither.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.timing import TimingHarness
from ..solvers import pcg

# F_hat bins hashed per host copy by operator_fingerprint
_HASH_BINS = 64


class AdmissionError(ValueError):
    """A request the engine cannot serve: unroutable observation shape,
    non-positive tolerance, or negative iteration budget."""


@dataclasses.dataclass
class SolveRequest:
    """One user's inverse-problem solve.

    ``d_obs`` is the (N_d, N_t) SOTI observation block, a tensor or a
    numpy array; its shape routes the request to a registered operator.
    ``tol`` is the user's relative residual target (it drives both the
    operator precision config and this column's stopping test),
    ``max_iters`` the per-request iteration budget, ``damp`` the Tikhonov
    damping of the CGNR normal operator."""
    uid: int
    d_obs: object
    tol: float = 1e-6
    max_iters: int = 200
    damp: float = 0.0


@dataclasses.dataclass
class SolveOutcome:
    """Demuxed per-request result of a (possibly coalesced) solve."""
    uid: int
    x: torch.Tensor                 # (N_m, N_t) MAP point, operator's device
                                    # (the whole block on every rank of a grid)
    converged: bool
    n_iters: int                    # iterations this column actually updated
    relres: float                   # final relative residual of this column
    residual_history: np.ndarray    # this column's history, trimmed
    config: str                     # operator PrecisionConfig served under
    coalesced: int                  # S of the batch this request rode in


def tol_bucket(tol: float, base: float = 10.0) -> float:
    """Round ``tol`` DOWN to its bucket boundary (decades by default).

    Bucketing must never select a config looser than the request: the
    bucket tolerance is always <= ``tol``, so a config feasible at the
    bucket is feasible for every request in it."""
    if tol <= 0.0:
        raise AdmissionError(f"tolerance must be positive, got {tol}")
    return float(base ** math.floor(math.log(tol, base)))


def _digest(h, plane: torch.Tensor) -> None:
    """Feed ``plane``'s bytes (C order) to ``h``, a few bins a host copy."""
    for k in range(0, plane.shape[0], _HASH_BINS):
        chunk = plane[k:k + _HASH_BINS].contiguous().view(torch.uint8)
        h.update(chunk.cpu().numpy())


def _grid_digest(op, digest: bytes) -> bytes:
    """Every rank's ``digest`` of its shard, gathered over the rows and
    then the cols (one fixed rank order) and hashed: the same bytes on
    every rank of the grid.  Off a mesh, ``digest``."""
    if op.mesh is None:
        return digest
    t = torch.frombuffer(bytearray(digest), dtype=torch.uint8).to(op.device)
    for space in ("d", "m"):
        t = op.gather_block(t, space)
    return hashlib.sha1(t.cpu().numpy().tobytes()).digest()


def operator_fingerprint(op) -> str:
    """Coalescing identity of an operator: problem shape, a SHA-1 of the
    stored Fourier blocks, the backend fingerprint and the dispatch
    table's fields, the process grid and the reduction precision.  Two
    requests share a batch only when their solves run the same pipeline on
    the same operator data.  On a mesh the SHA-1 covers every rank's shard
    (each rank's digest gathered in rank order, a collective), so every
    rank has the same fingerprint."""
    r = op.opts.resolve(op.device)
    h = hashlib.sha1()
    _digest(h, op.F_hat_re)
    _digest(h, op.F_hat_im)
    digest = _grid_digest(op, h.digest())
    disp = ";".join(f"{f.name}={getattr(r.table, f.name)}"
                    for f in dataclasses.fields(r.table))
    return (f"{op.N_t}x{op.N_d}x{op.N_m}/F={digest.hex()[:12]}"
            f"/{r.spec.fingerprint()}/disp={disp}/grid={op.grid_shape()}"
            f"/comm={op.comm_level}")


class SolveEngine:
    """Continuous-batching engine over inverse-problem solve requests.

    Parameters
    ----------
    operators:
        one FFTMatvec or a sequence, each registered under its
        fingerprint; requests route by ``d_obs`` shape (ambiguous shapes
        are a construction error).  Meshed operators take every rank
        of their grid building the engine together.  Operators should
        be the highest-precision build (``autotune`` recasts down per
        bucket).
    cache, cache_path:
        optional :class:`~repro_torch.tune.TuningCache` (or a path) backing
        the warm tuning path, shared across engines and processes.
        Without it, configs are memoized per engine only.
    harness:
        the :class:`TimingHarness` the tuner times with and the appliers
        come from; defaults to a fresh one (CUDA-event timing: on the CPU
        pass one with a ``timer``).
    max_batch:
        S cap per coalesced solve (larger buckets are split).
    solver_precision:
        per-leg Krylov precision forwarded to :func:`repro_torch.solvers.
        pcg` (default ``"auto"``: derived from the tightest tolerance in
        the batch).
    tune_kw:
        extra keywords for the cold-path :func:`repro_torch.tune.autotune`
        call (``ladder``, ``slack``, ...; the harness carries the timer).
    """

    def __init__(self, operators, *, cache=None, cache_path=None,
                 harness: Optional[TimingHarness] = None,
                 max_batch: int = 64, solver_precision="auto",
                 tune_kw: Optional[dict] = None):
        ops = [operators] if not isinstance(operators, (list, tuple)) \
            else list(operators)
        if not ops:
            raise ValueError("SolveEngine needs at least one operator")
        if cache is None and cache_path is not None:
            from repro_torch.tune import TuningCache
            cache = TuningCache(cache_path)
        self.cache = cache
        self.harness = harness if harness is not None else TimingHarness()
        self.max_batch = int(max_batch)
        self.solver_precision = solver_precision
        self.tune_kw = dict(tune_kw or {})
        self._ops: dict[str, object] = {}
        self._by_shape: dict[tuple, str] = {}
        for op in ops:
            fp = operator_fingerprint(op)
            self._ops[fp] = op
            shape = (op.N_d, op.N_t)
            if shape in self._by_shape and self._by_shape[shape] != fp:
                raise ValueError(
                    f"two operators accept d_obs shape {shape}; requests "
                    f"cannot be routed unambiguously")
            self._by_shape[shape] = fp
        self._tuned: dict[tuple, tuple] = {}   # (fp, bucket) -> (cfg, op_t)
        self._built: dict[tuple, object] = {}  # (fp, config) -> op_t
        self._appliers: set[tuple[str, str]] = set()
        self.n_traces = 0
        self._queue: list[SolveRequest] = []
        self.stats = {"requests": 0, "batches": 0, "coalesced": [],
                      "cold_tunes": 0, "warm_hits": 0}

    # -- admission ----------------------------------------------------------
    def _route(self, req: SolveRequest) -> str:
        shape = tuple(np.shape(req.d_obs))
        fp = self._by_shape.get(shape)
        if fp is None:
            raise AdmissionError(
                f"no registered operator accepts d_obs shape {shape} "
                f"(known: {sorted(self._by_shape)})")
        if req.max_iters < 0:
            raise AdmissionError(
                f"max_iters must be >= 0, got {req.max_iters}")
        tol_bucket(req.tol)     # validates tol > 0
        return fp

    def submit(self, req: SolveRequest) -> None:
        """Admit one request into the queue (raises AdmissionError)."""
        self._route(req)
        self._queue.append(req)

    # -- tolerance -> config ------------------------------------------------
    def _config_for(self, fp: str, bucket: float):
        """The operator precision config for one (operator, tolerance
        bucket) pair: engine memo -> TuningCache (warm) -> autotune (cold,
        fills the cache).  The served operator is built once per config."""
        memo = self._tuned.get((fp, bucket))
        if memo is not None:
            return memo
        from repro_torch.tune import autotune
        res = autotune(self._ops[fp], tol=bucket, variant="gram",
                       harness=self.harness, cache=self.cache,
                       **self.tune_kw)
        self.stats["warm_hits" if res.from_cache else "cold_tunes"] += 1
        key = (fp, res.config.to_string())
        op_t = self._built.get(key)
        if op_t is None:
            op_t = self._built[key] = res.op     # autotune's one build of it
            self.n_traces += 1
        memo = self._tuned[(fp, bucket)] = (res.config, op_t)
        return memo

    def _applier(self, op_t, variant: str):
        """``variant``'s callable of ``op_t`` ("rmatmat" or "gram"), counted
        under its family ("mat" or "gram")."""
        self._appliers.add(("gram" if variant == "gram" else "mat", variant))
        return self.harness.callable_for(op_t, variant)

    # -- the coalesced solve ------------------------------------------------
    def _run_batch(self, fp: str, bucket: float,
                   requests: Sequence[SolveRequest]) -> list[SolveOutcome]:
        cfg, op_t = self._config_for(fp, bucket)
        gram_fn = self._applier(op_t, "gram")
        rmatmat = self._applier(op_t, "rmatmat")
        D = torch.stack([op_t.local_block(r.d_obs, "d") for r in requests],
                        dim=-1).to(op_t.io_dtype)
        rhs = rmatmat(D)
        damp = requests[0].damp         # batches group on damp
        normal = (lambda v: gram_fn(v) + damp * v) if damp else gram_fn
        tol_col = np.array([r.tol for r in requests], np.float64)
        budget = np.array([r.max_iters for r in requests], int)
        res = pcg(normal, rhs, tol=tol_col, maxiter=int(budget.max()),
                  col_maxiter=budget, multi_rhs=True,
                  precision=self.solver_precision,
                  group=op_t.dot_group("m"))
        X = op_t.gather_block(res.x, "m")
        self.stats["batches"] += 1
        self.stats["coalesced"].append(len(requests))

        hist = res.residual_history     # (rows, S); rows >= 1 always
        outcomes = []
        for s, r in enumerate(requests):
            iters = int(res.col_iters[s])
            h = hist[:max(iters, 1), s]
            relres = float(h[-1])
            outcomes.append(SolveOutcome(
                uid=r.uid, x=X[..., s],
                converged=bool(relres < r.tol), n_iters=iters,
                relres=relres, residual_history=h,
                config=cfg.to_string(), coalesced=len(requests)))
        return outcomes

    # -- serving ------------------------------------------------------------
    def serve(self, requests: Optional[Sequence[SolveRequest]] = None, *,
              coalesce: bool = True) -> list[SolveOutcome]:
        """Serve the queue plus ``requests``: admit, bucket, coalesce,
        solve, demux.  ``coalesce=False`` is the naive one-at-a-time
        baseline (same tuning path, S = 1 solves) the throughput
        benchmark compares against.  Results come back in uid order."""
        reqs = self._queue + list(requests or [])
        self._queue = []
        batches: dict[tuple, list[SolveRequest]] = {}
        for r in reqs:
            fp = self._route(r)
            batches.setdefault((fp, tol_bucket(r.tol), float(r.damp)),
                               []).append(r)
        self.stats["requests"] += len(reqs)
        out: list[SolveOutcome] = []
        for (fp, bucket, _damp), group in batches.items():
            chunk = 1 if not coalesce else self.max_batch
            for i in range(0, len(group), chunk):
                out.extend(self._run_batch(fp, bucket, group[i:i + chunk]))
        return sorted(out, key=lambda o: o.uid)

    # -- instrumentation ----------------------------------------------------
    def jit_stats(self) -> dict:
        """Reuse accounting under the reference's key names: distinct
        appliers taken and served operators built across every bucket
        served so far (see the module docstring)."""
        return {"n_appliers": len(self._appliers),
                "n_traces": self.n_traces}
