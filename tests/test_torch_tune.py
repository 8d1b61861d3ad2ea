"""The port's autotuner (``repro_torch.tune``) against the JAX package's.

Timing is made deterministic by injecting a synthetic cost model
(``_rank_timer``, the one ``tests/test_tile_precision.py`` uses: strictly
monotone in ``cost_rank``, mixed-tile configs strictly cheaper than their
uniform base) into both tuners, so the selections are compared exactly;
the measured errors are real.  Inputs are the same numpy arrays on both
sides.  The tuner on the card, with CUDA-event timing at the paper shape,
is driven by ``chip_smoke.py``.
"""

import dataclasses
import hashlib
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FFTMatvec as JaxFFTMatvec
from repro.core import precision as jprec
from repro.tune import autotune as jax_autotune
from repro.tune import block_norms as jax_block_norms
from repro.tune import derive_tile_map as jax_derive
from repro.tune import tile_weights as jax_tile_weights
from repro_torch.backend import CPU_TORCH
from repro_torch.core import (FFTMatvec, PrecisionConfig, all_configs,
                              measure_configs, optimal_config)
from repro_torch.core.error_model import relative_error_bound
from repro_torch.examples import mixed_precision_pareto as example
from repro_torch.tune import (CacheKey, TimingHarness, TuningCache, autotune,
                              block_norms, default_input, derive_tile_map,
                              tile_map, tile_weights)

GATED = dataclasses.replace(CPU_TORCH, name="cpu-torch-nogate",
                            tile_precision=False)


def _rank_timer(cfg, fn, arg):
    h = int(hashlib.sha1(cfg.to_string().encode()).hexdigest()[:6], 16)
    return 1e-3 * cfg.cost_rank() + 1e-8 * (h / 0xFFFFFF)


def _unrepresentable(rng, shape):
    """numpy twin of ``random_unrepresentable``: the 29 mantissa bits an
    f32 cast drops set to 0101..."""
    bits = (rng.random(shape) * 0.5 + 0.5).view(np.int64)
    bits = (bits & ~np.int64((1 << 29) - 1)) | np.int64(0x0AAAAAAA)
    return bits.view(np.float64)


def _skewed(seed, Nt, Nd, Nm, cold=1e-6):
    """Block column whose model-axis tail carries ~no energy (the Fig.-3
    column of ``tests/test_tile_precision.py``), and an input."""
    rng = np.random.default_rng(seed)
    F = _unrepresentable(rng, (Nt, Nd, Nm)) / np.sqrt(Nm)
    F = F * np.where(np.arange(Nm) < (Nm + 1) // 2, 1.0, cold)[None, None, :]
    return F, _unrepresentable(rng, (Nm, Nt))


def _ops(F, **kw):
    return (FFTMatvec.from_block_column(F, device="cpu", **kw),
            JaxFFTMatvec.from_block_column(jnp.asarray(F), backend="cpu-xla"))


def test_block_norms_weights_and_maps_match_jax(monkeypatch):
    F, _ = _skewed(11, 16, 3, 24)
    top, jop = _ops(F)
    monkeypatch.setattr(tile_map, "_CHUNK", 3)       # several chunks
    for shape in ((2, 2), (3, 2), (1, 3)):
        got = block_norms(top.F_hat_re, top.F_hat_im, shape)
        want = jax_block_norms(jop.F_hat_re, jop.F_hat_im, shape)
        np.testing.assert_allclose(got, want, rtol=1e-12)
        w, jw = tile_weights(got), jax_tile_weights(want)
        np.testing.assert_allclose(np.array(w), np.array(jw), rtol=1e-12,
                                   atol=1e-300)
        for base in ("ddsdd", "dssdd", "sssss"):
            for tol in (1e-30, 1e-6, 1e-4):
                cfg = PrecisionConfig.from_string(base)
                got_map = derive_tile_map(cfg, tol, 16, 3, 24, shape=shape,
                                          weights=w)
                want_map = jax_derive(jprec.PrecisionConfig.from_string(base),
                                      tol, 16, 3, 24, shape=shape, weights=jw)
                assert (got_map and got_map.to_string()) == \
                    (want_map and want_map.to_string())
    assert tile_weights(np.zeros((2, 2))) == ((0.25, 0.25), (0.25, 0.25))


def test_autotune_selects_the_jax_tiled_config_fig3_shape():
    """The acceptance oracle of the JAX package at the Fig.-3 shape (128,
    25, 625) with a cold model-axis tail: tiles=(2, 2) refinement selects
    a mixed-tile config, the same one on both sides."""
    Nt, Nd, Nm = 128, 25, 625
    F, m = _skewed(13, Nt, Nd, Nm)
    top, jop = _ops(F)
    tol = 1e-5
    kw = dict(tol=tol, ladder=("d", "s"), timer=_rank_timer)
    res = autotune(top, v=torch.as_tensor(m), tiles=(2, 2), **kw)
    jres = jax_autotune(jop, v=jnp.asarray(m), tiles=(2, 2), **kw)
    assert res.config.to_string() == jres.config.to_string()
    assert res.config.tiles is not None and res.config.tiles.shape == (2, 2)
    assert res.record.rel_error <= tol
    w = tile_weights(block_norms(top.F_hat_re, top.F_hat_im, (2, 2)))
    assert res.record.rel_error <= relative_error_bound(res.config, Nt, Nd,
                                                        Nm, tile_weights=w)
    assert res.config.to_string() in res.bounds
    uniform = autotune(top, v=torch.as_tensor(m), **kw)
    assert res.config.replace(tiles=None) == uniform.config
    assert res.record.time_s < uniform.record.time_s
    assert res.n_timed < res.n_lattice == 32
    # the tuned operator runs the selected config
    assert res.op.precision == res.config


def test_autotune_matches_the_exhaustive_sweep():
    Nt, Nd, Nm = 128, 25, 625
    F, m = _skewed(0, Nt, Nd, Nm, cold=1.0)
    op = FFTMatvec.from_block_column(F, device="cpu")
    v = torch.as_tensor(m)
    for ladder, tol in ((("d", "s"), 1e-7), (("d", "s"), 1e-5),
                        (("s", "h"), 1e-2)):
        res = autotune(op, tol=tol, v=v, ladder=ladder, timer=_rank_timer)
        recs = measure_configs(
            lambda c: FFTMatvec.from_block_column(F, precision=c,
                                                  device="cpu"),
            v, list(all_configs(ladder)),
            harness=TimingHarness(timer=_rank_timer))
        assert res.config == optimal_config(recs, tol).config
        assert res.n_timed <= res.n_lattice // 2


def test_tiles_is_a_no_op_on_a_gating_spec():
    F, m = _skewed(15, 16, 3, 24)
    op = FFTMatvec.from_block_column(F, device="cpu", backend=GATED)
    res = autotune(op, tol=1e-5, v=torch.as_tensor(m), ladder=("d", "s"),
                   timer=_rank_timer, tiles=(2, 2))
    assert res.config.tiles is None
    assert all(";tiles=" not in s for s in res.errors)


def test_cache_roundtrip_tiles_keys_and_corruption(tmp_path):
    F, m = _skewed(16, 16, 3, 24)
    op = FFTMatvec.from_block_column(F, device="cpu")
    path = tmp_path / "tune.json"
    kw = dict(tol=2e-4, v=torch.as_tensor(m), ladder=("d", "s"),
              timer=_rank_timer, tiles=(2, 2))
    res = autotune(op, cache_path=path, **kw)
    assert ";tiles=2x2" in res.cache_key.detail
    assert res.cache_key.backend.startswith("cpu-torch@")
    entry = json.loads(path.read_text())[res.cache_key.to_string()]
    assert entry["version"] == 4 and entry["baseline"] == "ddddd"
    res2 = autotune(op, cache_path=path, **kw)
    assert res2.from_cache and res2.n_timed == 0
    assert res2.config == res.config
    assert {r.prec for r in res2.records} == {r.prec for r in res.records}
    # a new tolerance is answered from the stored records
    looser = autotune(op, cache_path=path, **{**kw, "tol": 1e-3})
    assert looser.from_cache
    # a tile-less tune of the same shape keys separately
    res3 = autotune(op, cache_path=path, tol=2e-4, v=torch.as_tensor(m),
                    ladder=("d", "s"), timer=_rank_timer)
    assert not res3.from_cache and ";tiles=" not in res3.cache_key.detail
    # a corrupt file is a miss (with a warning), then rewritten
    path.write_text("{not json")
    with pytest.warns(UserWarning, match="unreadable"):
        res4 = autotune(op, cache_path=path, **kw)
    assert not res4.from_cache
    assert res.cache_key.to_string() in json.loads(path.read_text())
    # a stale schema version is a miss and is dropped at the next save
    data = json.loads(path.read_text())
    data[res.cache_key.to_string()]["version"] = 3
    path.write_text(json.dumps(data))
    assert TuningCache(path).get(res.cache_key) is None
    assert not autotune(op, cache_path=path, **kw).from_cache


def test_cache_key_and_save_merge(tmp_path):
    F, _ = _skewed(17, 16, 3, 24)
    op = FFTMatvec.from_block_column(F, device="cpu")
    k1 = CacheKey.for_operator(op, ("d", "s"), "matmat", n_rhs=4)
    k2 = CacheKey.for_operator(op, ("d", "s"), "matmat", n_rhs=8)
    k3 = CacheKey.for_operator(op.with_backend("torch-ref"), ("d", "s"),
                               "matmat", n_rhs=4)
    assert len({k1.to_string(), k2.to_string(), k3.to_string()}) == 3
    assert k1.device_kind == "cpu"
    path = tmp_path / "c.json"
    res = autotune(op, tol=1e-5, ladder=("d", "s"), timer=_rank_timer)
    a, b = TuningCache(path), TuningCache(path)
    for cache, key in ((a, k1), (b, k2)):
        cache.put(key, records=res.records, front=res.front,
                  chosen=res.config, tol=1e-5, baseline=res.records[0].config,
                  n_lattice=32)
    a.save()
    b.save()                       # merges a's entry instead of dropping it
    assert TuningCache(path).get(k1) is not None
    assert TuningCache(path).get(k2) is not None


def test_operator_autotune_and_unported_knobs(monkeypatch):
    F, m = _skewed(18, 16, 3, 24)
    op = FFTMatvec.from_block_column(F, device="cpu")
    tuned = op.autotune(1e-5, timer=_rank_timer)
    assert isinstance(tuned, FFTMatvec)
    res = op.autotune(1e-5, timer=_rank_timer, full_result=True)
    assert tuned.precision == res.config
    # lint=True (the twin of tests/test_analysis.py::
    # test_autotune_lint_preflight): a clean pre-flight chooses as before;
    # a contract-violating lowering fails it before anything is timed
    linted = autotune(op, tol=1e-5, timer=_rank_timer, lint=True)
    assert linted.config == res.config and linted.n_timed == res.n_timed
    from repro_torch import analysis
    from repro_torch.core import pipeline
    orig = pipeline._STAGE_IMPLS["unpad"]

    def degraded(stage, x, operands, N_t, S, opts):
        return orig(stage, x, operands, N_t, S, opts).to(torch.float32)

    monkeypatch.setitem(pipeline._STAGE_IMPLS, "unpad", degraded)
    timed = []
    with pytest.raises(analysis.PlanLintError,
                       match="silent-output-downgrade"):
        autotune(op, tol=1e-5, lint=True,
                 timer=lambda cfg, fn, arg: timed.append(cfg) or 1.0)
    assert timed == []
    monkeypatch.undo()
    for kw in ({"p_r": 2}, {"p_c": 1}, {"comm_level": "s"}):
        with pytest.raises(NotImplementedError, match="item 13"):
            autotune(op, tol=1e-5, **kw)
    for variant, shape in (("matvec", (24, 16)), ("rmatvec", (3, 16)),
                           ("rmatmat", (3, 16, 4)), ("gram", (24, 16))):
        v = default_input(op, variant)
        assert tuple(v.shape) == shape and v.dtype == torch.float64
        # lossy at every sub-f64 level
        assert not torch.equal(v.to(torch.float32).to(torch.float64), v)
    res = autotune(op, tol=1e-5, variant="gram", timer=_rank_timer)
    assert res.errors["ddddd"] == 0.0


def test_example_runs_on_the_cpu(capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = example.run("cpu", ("s", "h"), 1e-2, verbose=False)
    assert out["clock"] == "host" and out["n_timed"] < out["n_lattice"]
    assert out["rel_error"] <= 1e-2
    assert example.main(["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "exhaustive sweep: 32 configs timed" in text
    assert "host clock" in text
