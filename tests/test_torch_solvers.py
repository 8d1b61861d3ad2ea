"""The port's Krylov solvers, solver precision and error model against the
JAX package on the CPU.

Both packages solve the same f64 systems (numpy inputs): dense SPD
matrices for ``pcg`` and the same Toeplitz block column for CGNR and
LSQR.  At f64 they take the same number of iterations per column and
their iterates agree to 1e-9 relative: two frameworks' summation orders
perturb each iteration at ~1e-16, and the systems' condition numbers
(<= 1e6) amplify that to well under 1e-9.  The freeze and budget
contracts of ``tests/test_solvers.py`` are checked on the port as the
reference checks them.  The JAX solvers drive a jitted view of the JAX
operator (``jitted_block()`` and a jitted parameter-space Gram), which
computes what its eager calls do, in less time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solvers as jsolvers
from repro.core import FFTMatvec as JaxFFTMatvec
from repro.core import PrecisionConfig as JaxConfig
from repro.core import error_model as jerr
from repro_torch import solvers
from repro_torch.core import (FFTMatvec, NAMED_CONFIGS, PrecisionConfig,
                              all_configs, rel_l2)
from repro_torch.core import error_model as terr

X_TOL = 1e-9


def _spd(n, seed):
    B = np.random.default_rng(seed).standard_normal((n, n))
    return B @ B.T + n * np.eye(n)


def _np(a):
    if torch.is_tensor(a):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float64))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


class _Jitted:
    """The JAX operator's matmat / rmatmat / exact parameter-space Gram,
    each through ``jax.jit``: what the JAX solvers call."""

    def __init__(self, jop):
        self.matmat, self.rmatmat = jop.jitted_block()
        self._gram = jop.gram(space="parameter", mode="exact")
        self._gram.apply = jax.jit(self._gram.apply)

    def gram(self, space="parameter", mode="exact"):
        assert (space, mode) == ("parameter", "exact")
        return self._gram


@pytest.fixture(scope="module")
def toeplitz():
    """The same f64 operator in both packages, and two stacked blocks."""
    rng = np.random.default_rng(2)
    Nt, Nd, Nm = 24, 4, 12
    F = rng.standard_normal((Nt, Nd, Nm)) * \
        (0.5 ** np.arange(Nt))[:, None, None] / np.sqrt(Nm)
    op = FFTMatvec.from_block_column(F, device="cpu")
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(F))
    M_true = rng.standard_normal((Nm, Nt, 2))
    return {"op": op, "jop": jop, "jit": _Jitted(jop),
            "D": _np(op.matmat(M_true)),
            "D_noise": rng.standard_normal((Nd, Nt, 2))}


def _same_solve(res, jres):
    assert res.n_iters == jres.n_iters
    np.testing.assert_array_equal(res.col_iters, jres.col_iters)
    assert res.converged == jres.converged
    assert res.residual_history.shape == jres.residual_history.shape
    assert _rel(res.x, jres.x) <= X_TOL


# ---------------------------------------------------------------------------
# pcg against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,S,tol", [(40, None, 1e-12), (32, 5, 1e-12),
                                     (24, 2, [1e-2, 1e-10])])
def test_pcg_matches_jax(n, S, tol):
    A = _spd(n, n)
    rng = np.random.default_rng(n + 1)
    b = A @ rng.standard_normal((n,) if S is None else (n, S))
    multi = S is not None
    res = solvers.pcg(lambda v: torch.as_tensor(A) @ v, torch.as_tensor(b),
                      tol=tol, maxiter=200, multi_rhs=multi)
    jA = jnp.asarray(A)
    jres = jsolvers.pcg(lambda v: jA @ v, jnp.asarray(b), tol=tol,
                        maxiter=200, multi_rhs=multi)
    _same_solve(res, jres)
    assert res.converged and res.x.shape == b.shape
    x_true = np.linalg.solve(A, b)
    np.testing.assert_allclose(
        np.linalg.norm(_np(res.x) - x_true, axis=0)
        / np.linalg.norm(x_true, axis=0), 0.0, atol=100 * np.max(tol))


def test_pcg_preconditioned_matches_jax_and_helps():
    d = np.logspace(0, 6, 50)
    A = np.diag(d) + 0.1 * _spd(50, 5) / 50
    b = np.ones(50)
    At = torch.as_tensor(A)
    plain = solvers.pcg(lambda v: At @ v, torch.as_tensor(b), tol=1e-10,
                        maxiter=400)
    jac = solvers.pcg(lambda v: At @ v, torch.as_tensor(b), tol=1e-10,
                      maxiter=400,
                      M=lambda r: r / torch.as_tensor(np.diag(A).copy()))
    jA = jnp.asarray(A)
    jjac = jsolvers.pcg(lambda v: jA @ v, jnp.asarray(b), tol=1e-10,
                        maxiter=400, M=lambda r: r / jnp.diag(jA))
    assert jac.converged and jac.n_iters < plain.n_iters
    _same_solve(jac, jjac)


def test_pcg_freezes_converged_columns():
    d = np.linspace(1.0, 9.0, 30)
    A = torch.as_tensor(np.diag(d))
    b0 = np.zeros(30)
    b0[4] = 2.0
    b1 = np.random.default_rng(0).standard_normal(30)
    B = np.stack([b0, b1], axis=-1)
    res = solvers.pcg(lambda v: A @ v, torch.as_tensor(B), tol=1e-12,
                      maxiter=200, multi_rhs=True)
    jres = jsolvers.pcg(lambda v: jnp.asarray(A.numpy()) @ v, jnp.asarray(B),
                        tol=1e-12, maxiter=200, multi_rhs=True)
    _same_solve(res, jres)
    k0, k1 = int(res.col_iters[0]), int(res.col_iters[1])
    assert k0 < k1 == res.n_iters
    h = res.residual_history
    np.testing.assert_array_equal(h[k0 - 1:, 0],
                                  np.full(res.n_iters - k0 + 1, h[k0 - 1, 0]))
    assert rel_l2(res.x[:, 0], torch.as_tensor(b0 / d)) < 1e-10
    assert rel_l2(res.x[:, 1], torch.as_tensor(b1 / d)) < 1e-10


def test_pcg_col_maxiter_budget_freezes_column():
    A = _spd(40, 13)
    B = A @ np.random.default_rng(14).standard_normal((40, 2))
    At = torch.as_tensor(A)
    res = solvers.pcg(lambda v: At @ v, torch.as_tensor(B), tol=1e-13,
                      maxiter=300, col_maxiter=[3, 300], multi_rhs=True)
    jres = jsolvers.pcg(lambda v: jnp.asarray(A) @ v, jnp.asarray(B),
                        tol=1e-13, maxiter=300, col_maxiter=[3, 300],
                        multi_rhs=True)
    _same_solve(res, jres)
    assert int(res.col_iters[0]) == 3 and not res.converged
    h = res.residual_history
    np.testing.assert_array_equal(h[3:, 0], np.full(len(h) - 3, h[2, 0]))
    assert h[-1, 1] < 1e-13


def test_pcg_maxiter0_reports_initial_residual():
    A = _spd(10, 15)
    x_true = np.random.default_rng(16).standard_normal(10)
    At, b = torch.as_tensor(A), torch.as_tensor(A @ x_true)
    res = solvers.pcg(lambda v: At @ v, b, tol=1e-10, maxiter=0)
    assert res.n_iters == 0 and not res.converged
    assert res.residual_history.shape == (1, 1)
    assert res.final_relres[0] == pytest.approx(1.0)
    assert not res.x.any()
    res2 = solvers.pcg(lambda v: At @ v, b, x0=torch.as_tensor(x_true),
                       tol=1e-10, maxiter=0)
    assert res2.converged and res2.n_iters == 0
    assert res2.final_relres[0] < 1e-10


# ---------------------------------------------------------------------------
# CGNR and LSQR on the Toeplitz operator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("damp", [0.0, 1e-3])
def test_cgnr_matches_jax(toeplitz, damp):
    t = toeplitz
    res = solvers.cg_normal_equations(t["op"], t["D"], damp=damp, tol=1e-10,
                                      maxiter=500)
    jres = jsolvers.cg_normal_equations(t["jit"], jnp.asarray(t["D"]),
                                        damp=damp, tol=1e-10, maxiter=500)
    _same_solve(res, jres)
    assert res.converged and res.x.shape == (12, 24, 2)


@pytest.mark.parametrize("damp", [0.0, 0.1])
@pytest.mark.parametrize("key", ["D", "D_noise"])
def test_lsqr_matches_jax(toeplitz, damp, key):
    t = toeplitz
    res = solvers.lsqr(t["op"], t[key], damp=damp, tol=1e-10, maxiter=500)
    jres = jsolvers.lsqr(t["jit"], jnp.asarray(t[key]), damp=damp,
                         tol=1e-10, maxiter=500)
    _same_solve(res, jres)
    np.testing.assert_allclose(res.residual_history[:10],
                               jres.residual_history[:10], rtol=1e-9)
    # the LSQR residual estimate never rises
    h = res.residual_history
    assert (np.diff(h, axis=0) <= 1e-15).all()


def test_lsqr_single_rhs_keeps_its_layout(toeplitz):
    t = toeplitz
    res = solvers.lsqr(t["op"], t["D"][..., 0], tol=1e-10, maxiter=500)
    jres = jsolvers.lsqr(t["jit"], jnp.asarray(t["D"][..., 0]), tol=1e-10,
                         maxiter=500)
    assert res.x.shape == (12, 24)
    _same_solve(res, jres)


def test_cgnr_per_column_tol_and_budget(toeplitz):
    t = toeplitz
    res = solvers.cg_normal_equations(t["op"], t["D"], tol=[1e-4, 1e-10],
                                      maxiter=500, col_maxiter=[500, 500])
    jres = jsolvers.cg_normal_equations(t["jit"], jnp.asarray(t["D"]),
                                        tol=[1e-4, 1e-10], maxiter=500,
                                        col_maxiter=[500, 500])
    _same_solve(res, jres)
    assert res.converged
    assert int(res.col_iters[0]) <= int(res.col_iters[1])
    final = res.residual_history[-1]
    assert final[0] < 1e-4 and final[1] < 1e-10


def test_cgnr_col_maxiter_budget_freezes_column(toeplitz):
    t = toeplitz
    res = solvers.cg_normal_equations(t["op"], t["D"], tol=1e-12,
                                      maxiter=500, col_maxiter=[2, 500])
    assert int(res.col_iters[0]) == 2 and not res.converged
    h = res.residual_history
    np.testing.assert_array_equal(h[2:, 0], np.full(len(h) - 2, h[1, 0]))
    assert h[-1, 1] < 1e-12


@pytest.mark.parametrize("solver", ["cgnr", "lsqr"])
def test_maxiter0_reports_initial_residual(toeplitz, solver):
    t = toeplitz
    fn = solvers.lsqr if solver == "lsqr" else solvers.cg_normal_equations
    res = fn(t["op"], t["D_noise"], tol=1e-10, maxiter=0)
    assert res.n_iters == 0 and not res.converged
    assert res.residual_history.shape == (1, 2)
    np.testing.assert_allclose(res.final_relres, 1.0)
    assert (res.col_iters == 0).all()


def test_lsqr_per_column_tolerances(toeplitz):
    t = toeplitz
    res = solvers.lsqr(t["op"], t["D"], tol=[1e-3, 1e-12], maxiter=500)
    jres = jsolvers.lsqr(t["jit"], jnp.asarray(t["D"]), tol=[1e-3, 1e-12],
                         maxiter=500)
    _same_solve(res, jres)
    assert int(res.col_iters[0]) < int(res.col_iters[1])
    k0 = int(res.col_iters[0])
    h = res.residual_history
    np.testing.assert_array_equal(h[k0 - 1:, 0],
                                  np.full(len(h) - k0 + 1, h[k0 - 1, 0]))


def test_lsqr_col_maxiter_budget_freezes_column(toeplitz):
    t = toeplitz
    res = solvers.lsqr(t["op"], t["D"], tol=1e-13, maxiter=300,
                       col_maxiter=[3, 300])
    assert int(res.col_iters[0]) == 3 and not res.converged
    h = res.residual_history
    np.testing.assert_array_equal(h[3:, 0], np.full(len(h) - 3, h[2, 0]))
    res3 = solvers.lsqr(t["op"], t["D"], tol=1e-13, maxiter=3)
    assert torch.equal(res.x[..., 0], res3.x[..., 0])


@pytest.mark.parametrize("prec", ["sss", "sds", "hss"])
def test_mixed_precision_solves_reach_their_level(toeplitz, prec):
    t = toeplitz
    res = solvers.lsqr(t["op"], t["D"], tol=1e-4, maxiter=200,
                       precision=prec)
    assert res.x.dtype == solvers.SolverPrecision.from_string(
        prec).recurrence_dtype()
    assert res.converged and res.final_relres.max() < 1e-4


# ---------------------------------------------------------------------------
# Solver precision and the error model (pure math, both packages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tol", [1e-1, 1e-3, 1e-4, 1e-6, 1e-8, 1e-10, 1e-14])
def test_from_tolerance_matches_jax(tol):
    got = solvers.SolverPrecision.from_tolerance(tol)
    want = jsolvers.SolverPrecision.from_tolerance(tol)
    assert got.to_string() == want.to_string()
    assert solvers.resolve_precision("auto", tol) == got


@pytest.mark.parametrize("cfg", [c.to_string() for c in NAMED_CONFIGS])
def test_error_floor_and_op_floor_match_jax(toeplitz, cfg):
    op = toeplitz["op"].with_precision(PrecisionConfig.from_string(cfg))
    jop = toeplitz["jop"].with_precision(JaxConfig.from_string(cfg))
    assert solvers.error_floor(op) == pytest.approx(
        jsolvers.error_floor(jop), rel=1e-15)
    got = solvers.SolverPrecision.from_tolerance(1e-9, op=op)
    want = jsolvers.SolverPrecision.from_tolerance(1e-9, op=jop)
    assert got.to_string() == want.to_string()


@pytest.mark.parametrize("kw", [{}, {"adjoint": True}, {"variant": "gram"},
                                {"variant": "rmatmat"}])
def test_error_model_matches_jax_over_the_lattice(kw):
    for cfg in all_configs(("h", "s", "d")):
        jcfg = JaxConfig.from_string(cfg.to_string())
        for shape in [(1000, 100, 5000), (16, 4, 40)]:
            assert terr.relative_error_bound(cfg, *shape, **kw) == \
                pytest.approx(jerr.relative_error_bound(jcfg, *shape, **kw),
                              rel=1e-15)
            got = terr.phase_factors(*shape, **kw)
            want = jerr.phase_factors(*shape, **kw)
            assert want["comm"] == 0.0 and got == want


def test_col_dot_accumulates_in_f64():
    a = torch.full((1000, 2), 1.0 + 2.0 ** -20, dtype=torch.float32)
    got = solvers.col_dot(a, a, "s")
    assert got.dtype == torch.float64
    want = 1000 * (1.0 + 2.0 ** -20) ** 2
    assert float(got[0]) == pytest.approx(want, rel=1e-15)
    with pytest.raises(ValueError):
        solvers.SolverPrecision.from_string("dd")
    with pytest.raises(TypeError):
        solvers.resolve_precision(3, 1e-3)
