"""The port's multi-tenant SolveEngine (``repro_torch.runtime.solve_serve``):
twins of ``tests/test_solve_serve.py`` at its shapes, then the port held
against the JAX engine on the same numpy inputs.

On the CPU the tuner cannot take CUDA-event times, so every engine here
gets a :class:`TimingHarness` with the synthetic ``_rank_timer`` of
``tests/test_torch_tune.py`` (strictly monotone in ``cost_rank``).  The
JAX engine always hands autotune its own harness, which then ignores a
``timer`` in ``tune_kw``; so both engines of a parity test get the timer
through their harness, and their selections compare exactly.  The
reference's ``n_traces`` counts jit traces; the port's counts served
operator builds (one ``op.with_precision(cfg)`` per config), its eager
counterpart.
"""

import dataclasses
import hashlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FFTMatvec as JaxFFTMatvec
from repro.core.timing import TimingHarness as JaxTimingHarness
from repro.runtime import SolveEngine as JaxSolveEngine
from repro.runtime import SolveRequest as JaxSolveRequest
from repro_torch.backend import DispatchTable
from repro_torch.core import FFTMatvec, rel_l2
from repro_torch.core.timing import TimingHarness
from repro_torch.examples import fig6_serve
from repro_torch.runtime import (AdmissionError, SolveEngine, SolveRequest,
                                 operator_fingerprint, tol_bucket)
from repro_torch.tune import TuningCache

# rel_l2 of the port's x against the JAX engine's, by the served config's
# lowest level: f64 sums in another order (~1e-13 seen), f32 planes and
# f32 io (~2e-6 seen)
X_TOL = {"d": 1e-10, "s": 1e-5}


def _rank_timer(cfg, fn, arg):
    h = int(hashlib.sha1(cfg.to_string().encode()).hexdigest()[:6], 16)
    return 1e-3 * cfg.cost_rank() + 1e-8 * (h / 0xFFFFFF)


def _unrepresentable(rng, shape):
    """numpy twin of ``random_unrepresentable``: the 29 mantissa bits an
    f32 cast drops set to 0101..."""
    bits = (rng.random(shape) * 0.5 + 0.5).view(np.int64)
    bits = (bits & ~np.int64((1 << 29) - 1)) | np.int64(0x0AAAAAAA)
    return bits.view(np.float64)


def _op(Nt=16, Nd=3, Nm=24, seed=0, **kw):
    F_col = _unrepresentable(np.random.default_rng(seed),
                             (Nt, Nd, Nm)) / np.sqrt(Nm)
    return FFTMatvec.from_block_column(F_col, device="cpu", **kw)


def _engine(ops, **kw):
    return SolveEngine(ops, harness=TimingHarness(timer=_rank_timer), **kw)


def _requests(op, S, tols, seed=1, max_iters=400):
    """S consistent observations (D = F M_true) as one request each."""
    M_true = np.random.default_rng(seed).standard_normal((op.N_m, op.N_t, S))
    D = op.matmat(torch.as_tensor(M_true))
    reqs = [SolveRequest(uid=i, d_obs=D[..., i], tol=tols[i % len(tols)],
                         max_iters=max_iters)
            for i in range(S)]
    return M_true, reqs


# ---------------------------------------------------------------------------
# admission / bucketing policy
# ---------------------------------------------------------------------------

def test_tol_bucket_rounds_down_never_looser():
    for t in (1e-6, 3e-6, 9.99e-6, 1e-8, 5.5e-3, 2.0):
        b = tol_bucket(t)
        assert b <= t                       # config never looser than asked
        assert b > t / 10.0                 # and never absurdly tighter
    assert tol_bucket(1e-6) == pytest.approx(1e-6)   # boundary maps to itself
    assert tol_bucket(3e-6) == pytest.approx(1e-6)
    with pytest.raises(AdmissionError):
        tol_bucket(0.0)
    with pytest.raises(AdmissionError):
        tol_bucket(-1e-6)


def test_admission_rejects_unroutable_and_invalid():
    eng = _engine(_op())
    bad_shape = SolveRequest(uid=0, d_obs=np.zeros((7, 7)))
    with pytest.raises(AdmissionError, match="shape"):
        eng.submit(bad_shape)
    with pytest.raises(AdmissionError, match="shape"):
        eng.serve([bad_shape])
    op = _op()
    with pytest.raises(AdmissionError):
        eng.submit(SolveRequest(uid=1, d_obs=torch.zeros((op.N_d, op.N_t)),
                                tol=0.0))
    with pytest.raises(AdmissionError):
        eng.submit(SolveRequest(uid=2, d_obs=np.zeros((op.N_d, op.N_t)),
                                max_iters=-1))


def test_ambiguous_operator_shapes_rejected_at_construction():
    with pytest.raises(ValueError, match="unambiguous"):
        _engine([_op(seed=0), _op(seed=1)])   # same (N_d, N_t) twice


def test_multi_operator_routing_by_shape():
    op_a, op_b = _op(Nt=16, Nd=3, Nm=24), _op(Nt=8, Nd=4, Nm=12, seed=3)
    assert operator_fingerprint(op_a) != operator_fingerprint(op_b)
    eng = _engine([op_a, op_b])
    _, reqs_a = _requests(op_a, 2, [1e-5])
    _, reqs_b = _requests(op_b, 2, [1e-5], seed=4)
    for r in reqs_b:
        r.uid += 10
    out = eng.serve(reqs_a + reqs_b)
    assert [o.uid for o in out] == [0, 1, 10, 11]
    assert eng.stats["batches"] == 2          # one per operator fingerprint
    shapes = {o.uid: tuple(o.x.shape) for o in out}
    assert shapes[0] == (op_a.N_m, op_a.N_t)
    assert shapes[10] == (op_b.N_m, op_b.N_t)


def test_fingerprint_tracks_data_backend_and_dispatch():
    op = _op()
    fp = operator_fingerprint(op)
    assert operator_fingerprint(_op()) == fp           # same data, same id
    assert fp.startswith("16x3x24/F=") and fp.endswith("/grid=(1, 1)/comm=None")
    moved = dataclasses.replace(op, F_hat_im=op.F_hat_im.clone())
    moved.F_hat_im[5, 1, 7] += 1e-12                    # one value
    assert operator_fingerprint(moved) != fp
    forced = op.with_backend(op.opts.backend,
                             dispatch=DispatchTable(force="torch"))
    assert "disp=force=torch" in operator_fingerprint(forced)
    assert operator_fingerprint(op.with_backend("torch-ref")) != fp


# ---------------------------------------------------------------------------
# coalescing correctness: demux per uid, parity with the naive path
# ---------------------------------------------------------------------------

def test_coalesced_demux_matches_naive_per_uid(tmp_path):
    op = _op()
    _, reqs = _requests(op, 4, [1e-6, 3e-6])     # one decade bucket
    cache = TuningCache(tmp_path / "tune.json")  # shared: same config both
    eng = _engine(op, cache=cache)
    out = eng.serve(list(reversed(reqs)))        # arrival order scrambled
    assert [o.uid for o in out] == [0, 1, 2, 3]  # uid order restored
    assert all(o.coalesced == 4 for o in out)
    assert eng.stats["coalesced"] == [4]

    naive = _engine(op, cache=cache).serve(reqs, coalesce=False)
    assert all(o.coalesced == 1 for o in naive)
    for o_c, o_n, r in zip(out, naive, reqs):
        assert o_c.uid == o_n.uid == r.uid
        assert o_c.config == o_n.config          # same bucket -> same config
        assert o_c.converged and o_n.converged
        assert o_c.relres < r.tol and o_n.relres < r.tol
        # same Krylov from the same start: demuxed column == solo solve
        # (loose bound: the system is underdetermined, so x agreement is
        # weaker than the normal-equation residual both paths satisfy)
        assert rel_l2(o_c.x, o_n.x) < 1e-3
        assert o_c.residual_history.shape == (o_c.n_iters,)


def test_outcomes_stay_on_the_operator_device():
    """Requests stack on the operator's device whether they arrive as
    tensors or numpy arrays; x comes back as a tensor there."""
    op = _op()
    _, reqs = _requests(op, 2, [1e-6])
    as_numpy = [dataclasses.replace(r, d_obs=r.d_obs.numpy()) for r in reqs]
    out = _engine(op).serve(reqs)
    out_np = _engine(op).serve(as_numpy)
    for a, b in zip(out, out_np):
        assert torch.is_tensor(a.x) and a.x.device == op.device
        assert tuple(a.x.shape) == (op.N_m, op.N_t)
        assert torch.equal(a.x, b.x)


def test_mixed_decades_split_into_buckets():
    op = _op()
    _, reqs = _requests(op, 4, [1e-5, 1e-8])
    eng = _engine(op)
    out = eng.serve(reqs)
    assert eng.stats["batches"] == 2
    assert sorted(eng.stats["coalesced"]) == [2, 2]
    # bucket-mates serve under one config; a 1e-5 request is never served
    # under a config selected for a looser tolerance than its own
    cfg_by_tol = {r.tol: out[r.uid].config for r in reqs}
    assert len(cfg_by_tol) == 2
    for o, r in zip(out, reqs):
        assert o.converged and o.relres < r.tol


def test_damp_splits_batches():
    """Batches group on damp: two dampings in one bucket are two solves,
    under one config."""
    op = _op()
    _, reqs = _requests(op, 4, [1e-6])
    for r in reqs[2:]:
        r.damp = 0.1
    eng = _engine(op)
    out = eng.serve(reqs)
    assert eng.stats["coalesced"] == [2, 2]
    assert len({o.config for o in out}) == 1
    assert eng.jit_stats()["n_traces"] == 1
    assert all(o.converged for o in out)


def test_same_bucket_shares_config_with_tighter_member():
    """A 3e-6 request rides the 1e-6 bucket: identical config to an
    explicit 1e-6 request (rounding DOWN, never up)."""
    op = _op()
    _, reqs = _requests(op, 2, [3e-6, 1e-6])
    out = _engine(op).serve(reqs)
    assert out[0].config == out[1].config
    assert out[0].coalesced == 2


def test_max_batch_chunks_large_buckets():
    op = _op()
    _, reqs = _requests(op, 5, [1e-5])
    eng = _engine(op, max_batch=2)
    out = eng.serve(reqs)
    assert [o.uid for o in out] == [0, 1, 2, 3, 4]
    assert eng.stats["coalesced"] == [2, 2, 1]
    assert all(o.converged for o in out)


def test_zero_budget_request_reports_initial_residual():
    op = _op()
    _, reqs = _requests(op, 2, [1e-6])
    reqs[1].max_iters = 0          # out of budget before the first step
    out = _engine(op).serve(reqs)
    assert out[0].converged and out[0].n_iters > 0
    assert not out[1].converged
    assert out[1].n_iters == 0
    assert np.isfinite(out[1].relres) and out[1].relres >= 1e-6


# ---------------------------------------------------------------------------
# tolerance -> config resolution: cold tune populates, warm path hits
# ---------------------------------------------------------------------------

def test_cold_tune_populates_cache_warm_path_hits(tmp_path):
    path = tmp_path / "tune.json"
    op = _op()
    _, reqs = _requests(op, 3, [1e-6])

    eng1 = _engine(op, cache_path=path)
    out1 = eng1.serve(reqs)
    assert eng1.stats["cold_tunes"] == 1 and eng1.stats["warm_hits"] == 0
    assert path.exists()

    # fresh engine + fresh cache object (new-process stand-in): warm path
    eng2 = _engine(op, cache=TuningCache(path))
    out2 = eng2.serve(reqs)
    assert eng2.stats["cold_tunes"] == 0 and eng2.stats["warm_hits"] == 1
    assert [o.config for o in out2] == [o.config for o in out1]
    for a, b in zip(out1, out2):
        assert rel_l2(a.x, b.x) < 1e-10      # identical served solution


def test_engine_memo_avoids_repeat_tuning():
    op = _op()
    eng = _engine(op)
    _, reqs = _requests(op, 2, [1e-6])
    eng.serve(reqs)
    tunes = eng.stats["cold_tunes"] + eng.stats["warm_hits"]
    eng.serve(reqs)
    # second round of the same bucket resolves from the engine memo
    assert eng.stats["cold_tunes"] + eng.stats["warm_hits"] == tunes


# ---------------------------------------------------------------------------
# reuse: one applier per family, re-serving builds nothing
# ---------------------------------------------------------------------------

def test_jit_applier_reuse_across_buckets_and_rounds():
    op = _op()
    eng = _engine(op)
    _, reqs_a = _requests(op, 3, [1e-5])
    eng.serve(reqs_a)
    stats1 = eng.jit_stats()
    # serving coalesced CGNR needs exactly the "mat" (rmatmat) and "gram"
    # family appliers
    assert stats1["n_appliers"] <= 2
    assert stats1["n_traces"] >= 1

    # same bucket again: no operator build, no new applier
    _, reqs_a2 = _requests(op, 3, [1e-5], seed=9)
    eng.serve(reqs_a2)
    stats2 = eng.jit_stats()
    assert stats2["n_traces"] == stats1["n_traces"]
    assert stats2["n_appliers"] == stats1["n_appliers"]

    # a NEW bucket (another config) builds its operator through the SAME
    # appliers: the applier count must not grow
    _, reqs_b = _requests(op, 3, [1e-9], seed=10)
    eng.serve(reqs_b)
    stats3 = eng.jit_stats()
    assert stats3["n_appliers"] == stats1["n_appliers"]

    # ... and re-serving that bucket again builds nothing
    _, reqs_b2 = _requests(op, 3, [1e-9], seed=11)
    eng.serve(reqs_b2)
    assert eng.jit_stats()["n_traces"] == stats3["n_traces"]


def test_buckets_sharing_a_config_share_its_operator():
    """n_traces counts operators built, not buckets: two decades served
    under one config build it once; a decade under another config builds
    one more."""
    op = _op()
    eng = _engine(op)
    out = []
    for tols, seed in (([1e-5], 1), ([1e-4], 2), ([1e-9], 3)):
        out.append(eng.serve(_requests(op, 2, tols, seed=seed)[1]))
    configs = [o[0].config for o in out]
    assert configs[0] == configs[1] != configs[2]
    assert eng.stats["cold_tunes"] == 3
    assert eng.jit_stats() == {"n_appliers": 2, "n_traces": 2}


def test_submit_queue_drains_on_serve():
    op = _op()
    eng = _engine(op)
    _, reqs = _requests(op, 2, [1e-5])
    for r in reqs:
        eng.submit(r)
    out = eng.serve()
    assert [o.uid for o in out] == [0, 1]
    assert eng.serve() == []                 # queue drained


# ---------------------------------------------------------------------------
# the port against the JAX engine on the same numpy inputs
# ---------------------------------------------------------------------------

def _p2o_column(seed, Nt, Nd, Nm):
    """numpy twin of ``random_block_column``'s law (a geometrically
    decaying impulse response): a well-conditioned damped normal operator,
    so the two frameworks' Krylov iterates stay within roundoff."""
    rng = np.random.default_rng(seed)
    decay = 0.5 ** np.arange(Nt)[:, None, None]
    return rng.standard_normal((Nt, Nd, Nm)) * decay / np.sqrt(Nm)


@pytest.mark.parametrize("decade", [1e-5, 1e-8])
def test_engine_matches_jax_engine(decade):
    Nt, Nd, Nm, S, damp = 16, 3, 24, 4, 0.01
    F = _p2o_column(0, Nt, Nd, Nm)
    op = FFTMatvec.from_block_column(F, device="cpu")
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(F), backend="cpu-xla")
    M_true = np.random.default_rng(1).standard_normal((Nm, Nt, S))
    D = op.matmat(torch.as_tensor(M_true)).numpy()
    tols = (decade, 3 * decade)
    kw = [dict(uid=i, d_obs=D[..., i], tol=tols[i % 2], max_iters=400,
               damp=damp) for i in range(S)]
    out = SolveEngine(op, harness=TimingHarness(timer=_rank_timer)).serve(
        [SolveRequest(**k) for k in reversed(kw)])
    jout = JaxSolveEngine(jop, harness=JaxTimingHarness(timer=_rank_timer)
                          ).serve([JaxSolveRequest(**k) for k in kw])
    assert [o.uid for o in out] == [o.uid for o in jout] == list(range(S))
    for o, j in zip(out, jout):
        assert o.config == j.config
        assert o.n_iters == j.n_iters and o.n_iters > 0
        assert o.converged == j.converged is True
        assert o.coalesced == j.coalesced == S
        lvl = min(o.config, key="hsd".index)
        assert rel_l2(o.x, np.array(j.x)) < X_TOL[lvl], (o.config, lvl)
        np.testing.assert_allclose(o.residual_history, j.residual_history,
                                   rtol=1e-3 if lvl == "s" else 1e-6)


# ---------------------------------------------------------------------------
# the fig6 twin at its smoke size
# ---------------------------------------------------------------------------

def test_fig6_smoke_writes_only_its_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "sub" / "serve.json"
    assert fig6_serve.main(["--device", "cpu", "--smoke", "--out",
                            str(out)]) == 0
    assert sorted(p.relative_to(tmp_path).as_posix()
                  for p in tmp_path.rglob("*")) == ["sub", "sub/serve.json"]
    res = json.loads(out.read_text())
    assert res["clock"] == "host" and res["smoke"] is True
    assert sorted(map(int, res["sweep"])) == [1, 4, 16, 64]
    for S, row in res["sweep"].items():
        assert row["coalesced_batches"] == [int(S)]
        assert row["naive_batches"] == [1]
        assert row["rps_coalesced"] > 0 and row["rps_naive"] > 0
    jit = res["jit"]
    assert jit["n_appliers"] == 2 and jit["n_traces"] == 1
    assert jit["traces_during_timed"] == jit["appliers_grown_during_timed"] \
        == jit["traces_on_repeat_serve"] == 0
    assert res["repeat_serve"]["iters_max"] > 0
