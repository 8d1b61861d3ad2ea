"""Dynamic mixed-precision selection (paper §3.2 as a runtime service).

``autotune`` answers the paper's central question, which per-phase
precision config is fastest at a given error tolerance, without timing
the whole lattice:

  0. cache lookup: (shape, ladder, variant, backend, card) seen before ->
     done.
  1. baseline run: the all-highest config is timed and its output becomes
     the error reference (it is also the guaranteed-feasible fallback).
  2. calibration probes: one error-only run per (phase, sub-baseline
     level) fits the eq.-(6) constants (``pruner.calibrate_constants``).
  3. model prune: the calibrated bound over the full lattice discards
     configs whose bound exceeds ``slack * tol``.
  4. frontier search: surviving candidates are visited cheapest-first; a
     candidate precision-dominated by an already *measured*-feasible
     config is skipped (it cannot be faster), otherwise one error-only run
     decides feasibility.  With ``tiles=``, each frontier config also gets
     a block-norm tile map, and the mapped config joins if its measured
     error meets the tolerance.
  5. timing: only baseline + frontier are timed; the fastest
     measured-feasible config wins, exactly as the exhaustive
     ``optimal_config`` would pick, at a fraction of the measurements.
  6. cache store (opt-in via ``cache``/``cache_path``).

Each candidate operator (one F_hat copy) lives only while it is measured.

On a process grid every rank runs ``autotune`` together: each feeds its
shard of the global probe input, measures errors on the gathered global
outputs and takes the slowest rank's time, so all ranks choose the same
configs; eq. (6) prices the grid (``p_r``, ``p_c``) and the reduction
level (``comm_level``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.error_model import operator_grid, relative_error_bound
from repro_torch.core.pareto import (ConfigRecord, optimal_config,
                                     pareto_front, rel_l2)
from repro_torch.core.precision import (PrecisionConfig, all_configs,
                                        config_le, max_level)
from repro_torch.core.toeplitz import random_unrepresentable

from .cache import CacheKey, TuningCache
from .harness import TimingHarness
from .pruner import calibrate_constants, probe_configs, prune_lattice
from .tile_map import tile_map_for_operator

_ADJOINT_VARIANTS = ("rmatvec", "rmatmat")


@dataclasses.dataclass
class TuneResult:
    """Outcome of one autotune run."""
    config: PrecisionConfig              # selected configuration
    op: object                           # operator retuned to ``config``
    record: ConfigRecord                 # its (error, time) record
    records: list[ConfigRecord]          # everything that was *timed*
    front: list[ConfigRecord]            # Pareto front of the timed set
    bounds: dict[str, float]             # calibrated model bound per config
    errors: dict[str, float]             # every measured error (incl. probes)
    constants: dict[str, float]          # calibrated eq.-(6) constants
    n_timed: int
    n_lattice: int
    from_cache: bool = False
    cache_key: Optional[CacheKey] = None

    def summary(self) -> str:
        src = "cache" if self.from_cache else \
            f"timed {self.n_timed}/{self.n_lattice}"
        return (f"autotune -> {self.config.to_string()} "
                f"(rel_err {self.record.rel_error:.2e}, "
                f"{self.record.time_s * 1e3:.3f} ms, "
                f"speedup {self.record.speedup:.2f}x; {src})")


def default_input(op, variant: str = "matvec", *, n_rhs: int = 4,
                  seed: int = 0) -> torch.Tensor:
    """Probe input for tuning, on the operator's device: values whose
    mantissas are unrepresentable below f64 (paper §4.2.1), so phases that
    only copy at a low level still show their true error."""
    rows = op.N_d if variant in _ADJOINT_VARIANTS else op.N_m
    shape = (rows, op.N_t) if variant in ("matvec", "rmatvec", "gram") \
        else (rows, op.N_t, n_rhs)
    gen = torch.Generator(device=op.device).manual_seed(seed)
    return random_unrepresentable(gen, shape).to(op.io_dtype)


_SPACES = {"matvec": ("m", "d"), "matmat": ("m", "d"),
           "rmatvec": ("d", "m"), "rmatmat": ("d", "m"), "gram": ("m", "m")}


class _GridHarness:
    """A timing harness on a meshed operator: each rank feeds its shard of
    the global input and reads the gathered global output, and a time is
    the slowest rank's, so every rank's choices agree."""

    def __init__(self, inner: TimingHarness, variant: str):
        self.inner, self.variant = inner, variant
        self.mode, self.timer = inner.mode, inner.timer

    def _io(self, op, v):
        space_in, space_out = _SPACES[self.variant]
        return op.local_block(v, space_in), space_out

    def run_once(self, op, v, variant):
        x, space = self._io(op, v)
        return op.gather_block(self.inner.run_once(op, x, variant), space)

    def time(self, op, v, variant):
        x, space = self._io(op, v)
        out, t = self.inner.time(op, x, variant)
        slowest = torch.tensor([t], dtype=torch.float64, device=op.device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        return op.gather_block(out, space), float(slowest)


def _input_tag(v) -> str:
    data = v.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
    return "v" + hashlib.sha1(data).hexdigest()[:12]


def _assert_op_clean(op) -> None:
    """``lint=True`` pre-flight: statically lint the plans a candidate
    operator would run and raise before any timing budget is spent on a
    contract-violating config."""
    from repro_torch import analysis  # deferred: tune imports without it
    bad = analysis.errors(analysis.lint_operator(op))
    if bad:
        raise analysis.PlanLintError(
            f"candidate config {op.precision.to_string()!r} failed "
            f"static analysis:\n" + analysis.format_findings(bad), bad)


def autotune(op, *, tol: float, v=None, ladder: Sequence[str] | None = None,
             variant: str = "matvec", harness: TimingHarness | None = None,
             repeats: int = 5, warmup: int = 2, mode: str = "throughput",
             timer=None, cache: TuningCache | None = None, cache_path=None,
             slack: float = 8.0, kappa: float = 1.0,
             constants: dict | None = None, n_rhs: int = 4, seed: int = 0,
             tiles: bool | tuple[int, int] | None = None,
             lint: bool = False, p_r: int | None = None,
             p_c: int | None = None,
             comm_level: str | None = None) -> TuneResult:
    """Pick the fastest precision config of ``op`` meeting ``tol``.

    ``op`` should be the *highest-precision* operator (its stored Fourier
    blocks are recast down per candidate; upcasting cannot restore lost
    bits).  ``ladder`` defaults to ("d", "s") when the operator is
    double-based, ("s", "h") otherwise.  ``variant`` may also be
    ``"gram"``: the fused parameter-space Gram pipeline, pruned with its
    own eq.-(6) factors.  ``slack`` widens the model-prune cutoff to absorb
    calibration error; every kept candidate is still rechecked against its
    *measured* error, so slack trades pruning aggressiveness, never the
    correctness of the final config.  ``constants`` skips the probe
    calibration and prunes with the given eq.-(6) constants.

    ``tiles`` enables tile-centric refinement: after the uniform frontier
    search, each frontier config gets a per-tile precision map derived
    from F_hat's block norms (``True`` = a 2x2 grid, or an explicit
    ``(R_tiles, C_tiles)``), and mapped configs whose *measured* error
    meets ``tol`` join the timed set.  On a backend whose spec lacks
    ``tile_precision`` refinement is skipped.  Tile-enabled tunes cache
    under a ``;tiles=RxC`` key.

    Persistence is opt-in: pass ``cache`` (a :class:`TuningCache`) or
    ``cache_path``; hits answer any tolerance from stored measurements.

    ``lint=True`` pre-flights every config that is about to be *timed*
    (the baseline and each frontier candidate) through the static plan
    linter (:func:`repro_torch.analysis.lint_operator`: abstract tracing,
    nothing executes) and raises :class:`repro_torch.analysis.
    PlanLintError` on an error finding before any timing is spent on it.

    The bound prices a process grid: ``p_r``/``p_c`` default to the
    operator's ``grid_shape()`` (explicit values, an explicit (1, 1) too,
    override it) and ``comm_level`` to the operator's reduction level; the
    cache keys on both.  On a mesh every rank calls this together (see the
    module head); tile refinement there waits for ROADMAP.md item 13b.
    """
    p_r, p_c = operator_grid(op, p_r, p_c)
    if comm_level is None:
        comm_level = op.comm_level
    if op.mesh is not None and tiles:
        raise NotImplementedError("tile refinement on a meshed operator "
                                  "waits for ROADMAP.md item 13b")
    if ladder is None:
        ladder = ("d", "s") if op.precision.highest() == "d" else ("s", "h")
    ladder = tuple(ladder)
    adjoint = variant in _ADJOINT_VARIANTS
    model_variant = variant if variant == "gram" else None
    lattice = list(all_configs(ladder))
    top = max_level(ladder)
    base_cfg = PrecisionConfig(*([top] * 5))
    tile_shape = (2, 2) if tiles is True else (tuple(tiles) if tiles else None)
    grid_kw = dict(p_r=p_r, p_c=p_c, comm_level=comm_level)
    if tile_shape is not None and \
            not op.opts.resolve(op.device).spec.tile_precision:
        tile_shape = None          # the backend gates tile precision off
    if v is None:
        v = default_input(op, variant, n_rhs=n_rhs, seed=seed)
        input_tag = f"seed{seed}"
    else:
        v = torch.as_tensor(v, device=op.device)
        input_tag = _input_tag(v)

    if cache is None and cache_path is not None:
        cache = TuningCache(cache_path)
    key = None
    if cache is not None:
        # an explicit harness carries its own mode and timer: the key says
        # what is actually measured
        key = CacheKey.for_operator(
            op, ladder, variant,
            mode=harness.mode if harness is not None else mode,
            n_rhs=v.shape[-1] if variant in ("matmat", "rmatmat") else None,
            input_tag=input_tag,
            synthetic_timer=(harness.timer if harness is not None
                             else timer) is not None,
            tiles=tile_shape, comm_level=comm_level)
        cached = cache.lookup_config(key, tol)
        if cached is not None:
            recs = cache.records(key)
            rec = next(r for r in recs if r.config == cached)
            return TuneResult(config=cached, op=op.with_precision(cached),
                              record=rec, records=recs,
                              front=pareto_front(recs), bounds={},
                              errors=dict(cache.get(key).get("errors", {})),
                              constants={}, n_timed=0,
                              n_lattice=len(lattice), from_cache=True,
                              cache_key=key)

    if harness is None:
        harness = TimingHarness(repeats=repeats, warmup=warmup, mode=mode,
                                timer=timer)
    if op.mesh is not None:
        harness = _GridHarness(harness, variant)

    # 1. baseline: timing reference + error reference + fallback selection.
    base_op = op.with_precision(base_cfg)
    if lint:
        _assert_op_clean(base_op)
    ref_out, base_t = harness.time(base_op, v, variant)
    errors: dict[str, float] = {base_cfg.to_string(): 0.0}

    def error_of(cfg: PrecisionConfig) -> float:
        s = cfg.to_string()
        if s not in errors:
            out = harness.run_once(op.with_precision(cfg), v, variant)
            errors[s] = rel_l2(out, ref_out)
        return errors[s]

    # 2. calibrate the eq.-(6) constants from single-phase probes.
    if constants is None:
        probe_errs: dict[str, dict[str, float]] = {}
        for phase, lvl, cfg in probe_configs(ladder):
            probe_errs.setdefault(phase, {})[lvl] = error_of(cfg)
        constants = calibrate_constants(probe_errs, op.N_t, op.N_d, op.N_m,
                                        p_r=p_r, p_c=p_c, adjoint=adjoint,
                                        variant=model_variant)

    # 3. model prune over the full lattice.
    bound_kw = dict(adjoint=adjoint, variant=model_variant, kappa=kappa,
                    input_level=top, constants=constants, **grid_kw)
    report = prune_lattice(lattice, tol, op.N_t, op.N_d, op.N_m,
                           slack=slack, **bound_kw)

    # 4. frontier search: cheapest-first, dominated-by-measured-feasible
    #    skipped, measured error decides the rest.
    candidates = sorted((c for c in report.model_feasible if c != base_cfg),
                        key=lambda c: (c.cost_rank(),
                                       report.bounds[c.to_string()],
                                       c.to_string()))
    frontier: list[PrecisionConfig] = []
    for cfg in candidates:
        if any(config_le(f, cfg) for f in frontier):
            continue
        if error_of(cfg) <= tol:
            frontier.append(cfg)

    # 4b. tile refinement: a block-norm tile map per frontier config (the
    #     tile-aware eq.-(6) budget, calibrated constants); the mapped
    #     config joins only if its *measured* error meets tol.
    if tile_shape is not None:
        tiled: list[PrecisionConfig] = []
        for cfg in frontier:
            tm, t_w = tile_map_for_operator(op, cfg, tol, shape=tile_shape,
                                            **bound_kw)
            if tm is None:
                continue
            tcfg = cfg.replace(tiles=tm)
            report.bounds[tcfg.to_string()] = relative_error_bound(
                tcfg, op.N_t, op.N_d, op.N_m, tile_weights=t_w, **bound_kw)
            if error_of(tcfg) <= tol:
                tiled.append(tcfg)
        frontier += tiled

    # 5. time baseline + frontier only; select exactly as optimal_config
    #    would over the exhaustive sweep.
    records = [ConfigRecord(base_cfg, 0.0, base_t, 1.0)]
    for cfg in frontier:
        cand = op.with_precision(cfg)
        if lint:
            _assert_op_clean(cand)
        _, t = harness.time(cand, v, variant)
        records.append(ConfigRecord(cfg, errors[cfg.to_string()], t,
                                    base_t / t))
    best = optimal_config(records, tol)
    front = pareto_front(records)
    result = TuneResult(config=best.config, op=op.with_precision(best.config),
                        record=best, records=records, front=front,
                        bounds=report.bounds, errors=dict(errors),
                        constants=dict(constants), n_timed=len(records),
                        n_lattice=len(lattice), cache_key=key)

    # 6. persist.
    if cache is not None:
        cache.put(key, records=records, front=front, chosen=best.config,
                  tol=tol, baseline=base_cfg, n_lattice=len(lattice),
                  errors=errors)
        cache.save()
    return result
