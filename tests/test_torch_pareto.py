"""The port's error model, lattice pruner, Pareto analysis and timing
harness against the JAX package.

Eq. (6) is pure arithmetic on the same constants, so the port's
``phase_factors``, ``relative_error_bound`` (with and without a tile map
and tile weights), ``lattice_bounds``, ``dominant_phase``,
``calibrate_constants`` and ``prune_lattice`` are held to the JAX twins at
1e-15 relative over every config of the 32- and 243-config lattices (the
two sides may associate a sum differently, nothing more).  The Pareto
helpers are held to JAX on the same records; ``measure_configs`` runs the
port's operators on the CPU with an injected timer (CUDA-event timing
needs the card, which ``chip_smoke.py`` drives).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import error_model as jem
from repro.core import pareto as jpareto
from repro.core import precision as jprec
from repro.core import FFTMatvec as JaxFFTMatvec
from repro.tune import pruner as jpruner
from repro_torch.core import (FFTMatvec, PrecisionConfig, TimingHarness,
                              all_configs, error_model, format_table,
                              measure_configs, optimal_config, pareto_front,
                              time_callable)
from repro_torch.core.pareto import ConfigRecord
from repro_torch.tune import pruner

SHAPES = [(1000, 100, 5000), (128, 25, 625), (16, 3, 24)]
LADDERS = [("d", "s"), ("d", "s", "h"), ("s", "h")]
WEIGHTS = ((0.5, 0.25), (0.2, 0.05))
CONSTANTS = {"c1": 2.0, "c2": 0.3, "c3": 0.02, "c4": 0.7, "c5": 1.5,
             "cF": 0.9}


def _close(a, b, tol=1e-15):
    assert abs(a - b) <= tol * max(abs(a), abs(b), 1e-300), (a, b)


def _pair(s):
    return PrecisionConfig.from_string(s), jprec.PrecisionConfig.from_string(s)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("variant", [None, "matvec", "rmatmat", "gram"])
def test_phase_factors_match_jax(shape, variant):
    for adjoint in (False, True):
        for tiles in (None, (2, 2), (3, 1)):
            w = None if tiles != (2, 2) else WEIGHTS
            got = error_model.phase_factors(*shape, adjoint=adjoint,
                                            variant=variant, tile_shape=tiles,
                                            tile_weights=w)
            want = jem.phase_factors(*shape, adjoint=adjoint, variant=variant,
                                     tile_shape=tiles, tile_weights=w)
            assert want.pop("comm") == 0.0      # one device: no comm tree
            assert got.keys() == want.keys()
            for k in got:
                if k == "gemv_tiles":
                    for a, b in zip(got[k], want[k]):
                        _close(a, b)
                else:
                    _close(got[k], want[k])


@pytest.mark.parametrize("ladder", LADDERS[:2])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_relative_error_bound_matches_jax_over_the_lattice(ladder, shape):
    kws = [{}, {"adjoint": True}, {"variant": "gram", "kappa": 3.0},
           {"constants": CONSTANTS, "input_level": "s", "kappa": 2.0}]
    for cfg in all_configs(ladder):
        s = cfg.to_string()
        for tiles in (None, "hs|sd", "hhs|dsd"):
            cs = s if tiles is None else f"{s};tiles={tiles}"
            tc, jc = _pair(cs)
            for kw in kws:
                for w in (None, WEIGHTS if tiles == "hs|sd" else None):
                    _close(error_model.relative_error_bound(
                        tc, *shape, tile_weights=w, **kw),
                        jem.relative_error_bound(jc, *shape, tile_weights=w,
                                                 **kw))
        tc, jc = _pair(s)
        assert error_model.dominant_phase(tc, *shape) == \
            jem.dominant_phase(jc, *shape)
    tb = error_model.lattice_bounds(all_configs(ladder), *shape)
    jb = jem.lattice_bounds(jprec.all_configs(ladder), *shape)
    assert tb.keys() == jb.keys()


def test_uniform_tile_map_reduces_to_the_phase_term():
    for lvl in "hsd":
        cfg = PrecisionConfig.from_string(f"dssdd;tiles={lvl}{lvl}|{lvl}{lvl}")
        base = cfg.replace(tiles=None, gemv=min(lvl, "s", key="hsd".index))
        _close(error_model.relative_error_bound(cfg, 1000, 100, 5000,
                                                tile_weights=WEIGHTS),
               error_model.relative_error_bound(base, 1000, 100, 5000), 1e-14)
    with pytest.raises(ValueError, match="does not match"):
        error_model.relative_error_bound(
            PrecisionConfig.from_string("ddddd;tiles=hs"), 16, 3, 24,
            tile_weights=WEIGHTS)


def test_probe_configs_and_calibration_match_jax():
    for ladder in LADDERS:
        got = [(p, l, c.to_string()) for p, l, c in
               pruner.probe_configs(ladder)]
        want = [(p, l, c.to_string()) for p, l, c in
                jpruner.probe_configs(ladder)]
        assert got == want
    rng = np.random.default_rng(0)
    errs = {p: {lvl: float(rng.uniform(1e-9, 1e-3)) for lvl in "sh"}
            for p in ("pad", "fft", "gemv", "ifft")}
    for kw in ({}, {"adjoint": True}, {"variant": "gram"},
               {"defaults": {"cF": 3.0}}):
        got = pruner.calibrate_constants(errs, 128, 25, 625, **kw)
        want = jpruner.calibrate_constants(errs, 128, 25, 625, **kw)
        assert got.keys() == want.keys()
        for k in got:
            _close(got[k], want[k])


@pytest.mark.parametrize("ladder", LADDERS[:2])
@pytest.mark.parametrize("tol", [1e-7, 1e-5, 1e-3])
def test_prune_lattice_matches_jax(ladder, tol):
    for kw in ({}, {"constants": CONSTANTS, "slack": 8.0},
               {"adjoint": True, "kappa": 2.0}, {"variant": "gram"}):
        got = pruner.prune_lattice(all_configs(ladder), tol, 1000, 100, 5000,
                                   **kw)
        want = jpruner.prune_lattice(jprec.all_configs(ladder), tol, 1000,
                                     100, 5000, **kw)
        assert got.bounds.keys() == want.bounds.keys()
        for k in got.bounds:
            _close(got.bounds[k], want.bounds[k])
        for part in ("model_feasible", "infeasible", "frontier", "dominated"):
            assert [c.to_string() for c in getattr(got, part)] == \
                [c.to_string() for c in getattr(want, part)], part
        assert got.n_lattice == len(list(all_configs(ladder)))
        assert [c.to_string() for c in pruner.minimal_elements(
            got.model_feasible)] == [c.to_string() for c in got.frontier]
    with pytest.raises(ValueError):
        pruner.prune_lattice(all_configs(ladder), 0.0, 16, 3, 24)


def test_pareto_helpers_match_jax():
    rng = np.random.default_rng(1)
    cfgs = list(all_configs(("d", "s")))
    times = rng.uniform(1e-3, 3e-3, len(cfgs))
    times[3] = times[5]                       # a duplicate time
    errs = rng.uniform(0, 1e-5, len(cfgs))
    errs[0] = 0.0
    tr = [ConfigRecord(c, float(e), float(t)) for c, e, t in
          zip(cfgs, errs, times)]
    jr = [jpareto.ConfigRecord(jprec.PrecisionConfig.from_string(r.prec),
                               r.rel_error, r.time_s) for r in tr]
    assert [r.prec for r in pareto_front(tr)] == \
        [r.prec for r in jpareto.pareto_front(jr)]
    for tol in (1e-9, 1e-6, 1e-5):
        assert optimal_config(tr, tol).prec == \
            jpareto.optimal_config(jr, tol).prec
    with pytest.raises(ValueError):
        optimal_config(tr[1:], -1.0)
    table = format_table(tr, pareto_front(tr)).splitlines()
    assert len(table) == len(tr) + 1 and sum("*" in ln for ln in table) == \
        len(pareto_front(tr))


def _rank_timer(cfg, fn, arg):
    h = int(hashlib.sha1(cfg.to_string().encode()).hexdigest()[:6], 16)
    return 1e-3 * cfg.cost_rank() + 1e-8 * (h / 0xFFFFFF)


def test_measure_configs_against_jax_errors():
    rng = np.random.default_rng(2)
    F = rng.standard_normal((16, 3, 24)) / np.sqrt(24)
    m = rng.standard_normal((24, 16))
    cfgs = [PrecisionConfig.from_string(s) for s in
            ("ddddd", "dssdd", "sdddd", "ddsdd;tiles=hs|sd")]
    harness = TimingHarness(timer=_rank_timer)
    recs = measure_configs(
        lambda c: FFTMatvec.from_block_column(F, precision=c, device="cpu"),
        torch.as_tensor(m), cfgs, harness=harness)
    jrecs = jpareto.measure_configs(
        lambda c: JaxFFTMatvec.from_block_column(jnp.asarray(F), precision=c,
                                                 backend="xla-ref"),
        jnp.asarray(m), [jprec.PrecisionConfig.from_string(c.to_string())
                         for c in cfgs], repeats=1, warmup=0)
    # a lowered config's error is its own rounding noise, which the two
    # frameworks' summation orders change: the same magnitude, not bits
    tol = {"d": 1e-12, "s": 1e-5, "h": 2e-2}
    for r, j in zip(recs, jrecs):
        assert r.prec == j.prec
        lowest = min(list(r.config.levels()) + [
            lvl for row in (r.config.gemv_tile_levels() or ()) for lvl in row],
            key="hsd".index)
        assert r.rel_error <= tol[lowest] and j.rel_error <= tol[lowest]
        if j.rel_error:
            assert 0.25 <= r.rel_error / j.rel_error <= 4.0
        assert r.time_s == _rank_timer(r.config, None, None)
    assert recs[0].rel_error == 0.0 and recs[0].speedup == 1.0
    # one baseline run plus one per non-baseline config, each timed once
    assert harness.n_timed == 4 and harness.n_runs == 4
    assert [c.to_string() for c in harness.timed_configs("matvec")] == \
        ["ddddd"] + [c.to_string() for c in cfgs[1:]]
    harness.reset_counters()
    assert harness.n_timed == 0 and harness.n_runs == 0


def test_time_callable_and_harness_guards():
    with pytest.raises(ValueError, match="repeats"):
        time_callable(lambda x: x, 0, repeats=0)
    with pytest.raises(ValueError, match="mode"):
        time_callable(lambda x: x, 0, mode="fastest")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            time_callable(lambda x: x, 0)
    with pytest.raises(ValueError):
        TimingHarness(repeats=0)
    with pytest.raises(ValueError):
        TimingHarness(mode="fastest")
    with pytest.raises(ValueError, match="variant"):
        TimingHarness.callable_for(None, "solve")


@pytest.mark.parametrize("mode", ["median", "throughput", "latency",
                                  "queued"])
def test_time_callable_modes_need_the_card(mode):
    """Every timing mode, the queued one too, measures device time: on a
    host without a card it raises before calling the function."""
    calls = []
    if torch.cuda.is_available():
        assert time_callable(calls.append, 0, repeats=2, mode=mode) >= 0.0
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        time_callable(calls.append, 0, repeats=2, mode=mode)
    assert calls == []
