"""The port's Bayesian inverse-problem layer against the JAX package on the
CPU, at the sizes of ``tests/test_inverse_problem.py``.

Both packages build the heat-equation p2o map at (N_t, N_d, N_m) =
(12, 3, 16) and get the same numpy vectors; the JAX problems apply their
Gram through ``jax.jit`` (what ``GramOperator.jitted()`` does), for time.
Tolerances: the Hessian and
its actions to 1e-12 relative (f64, two FFT libraries); the MAP points
of both packages to 1e-6 after CG at tol 1e-12 (the reference's own
cg-vs-dense tolerance), and dense to dense to 1e-9; the information gain
to 1e-10 relative.  The example twin runs end to end on the CPU inside the
reference example's acceptance bands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FFTMatvec as JaxFFTMatvec
from repro.core import GaussianInverseProblem as JaxProblem
from repro.core import PrecisionConfig as JaxConfig
from repro.core import heat_equation_p2o as jax_heat
from repro_torch.core import (FFTMatvec, GaussianInverseProblem,
                              PrecisionConfig, heat_equation_p2o, rel_l2)
from repro_torch.examples import inverse_problem as example
from repro_torch.kernels import _build

SHAPE = (12, 3, 16)


def _np(a):
    if torch.is_tensor(a):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float64))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jitted(jprob):
    """A JAX problem whose cached Gram applies through ``jax.jit``."""
    g = jprob.gram
    g.apply = jax.jit(g.apply)
    return jprob


class _JittedOp:
    """A JAX operator whose block products and exact parameter-space Gram
    run through ``jax.jit``: what the JAX Krylov solvers call."""

    def __init__(self, jop):
        self.matmat, self.rmatmat = jop.jitted_block()
        self._gram = jop.gram(space="parameter", mode="exact")
        self._gram.apply = jax.jit(self._gram.apply)

    def gram(self, space="parameter", mode="exact"):
        return self._gram


@pytest.fixture(scope="module")
def problems():
    F = heat_equation_p2o(*SHAPE, device="cpu")
    assert _rel(F, jax_heat(*SHAPE)) <= 1e-15
    op = FFTMatvec.from_block_column(F, device="cpu")
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(_np(F)))
    rng = np.random.default_rng(0)
    return {"port": GaussianInverseProblem(op, noise_var=1e-10),
            "jax": _jitted(JaxProblem(jop, noise_var=1e-10)),
            "m": rng.standard_normal((SHAPE[2], SHAPE[0])),
            "v": rng.standard_normal(SHAPE[1] * SHAPE[0]),
            "V": rng.standard_normal((SHAPE[1], SHAPE[0], 4))}


@pytest.fixture(scope="module")
def hessians(problems):
    return (problems["port"].assemble_data_space_hessian(),
            problems["jax"].assemble_data_space_hessian())


def test_hessian_assembly_matches_jax_and_is_spd(hessians):
    H, jH = hessians
    assert H.shape == (SHAPE[1] * SHAPE[0],) * 2
    assert _rel(H, jH) <= 1e-12
    np.testing.assert_allclose(_np(H), _np(H).T, rtol=1e-10, atol=1e-12)
    assert np.linalg.eigvalsh(_np(H)).min() > 0


@pytest.mark.parametrize("chunk", [1, 7, 32])
def test_hessian_assembly_chunks_agree(problems, hessians, chunk):
    H, _ = hessians
    got = problems["port"].assemble_data_space_hessian(chunk=chunk)
    assert rel_l2(got, H) <= 1e-14


def test_hessian_actions_match_jax_and_dense(problems, hessians):
    p, j = problems["port"], problems["jax"]
    H, _ = hessians
    got = p.hessian_action(problems["v"])
    assert _rel(got, j.hessian_action(jnp.asarray(problems["v"]))) <= 1e-12
    np.testing.assert_allclose(_np(got), _np(H) @ problems["v"], rtol=1e-9,
                               atol=1e-11)
    V = problems["V"]
    block = p.hessian_action_block(V)
    assert block.shape == V.shape
    assert _rel(block, j.hessian_action_block(jnp.asarray(V))) <= 1e-12
    for s in range(V.shape[-1]):
        assert rel_l2(block[..., s], p.hessian_action(V[..., s].ravel())
                      .reshape(V.shape[:2])) <= 1e-13


def test_map_point_cg_and_dense_match_jax(problems):
    p, j = problems["port"], problems["jax"]
    d_obs = _np(p.op.matvec(problems["m"]))
    m_cg = p.map_point(d_obs, method="cg", maxiter=3000, tol=1e-13)
    m_dn = p.map_point(d_obs, method="dense")
    assert m_cg.shape == (SHAPE[2], SHAPE[0])
    assert rel_l2(m_cg, m_dn) < 1e-6
    assert rel_l2(p.op.matvec(m_cg), torch.as_tensor(d_obs)) < 1e-3
    jd = jnp.asarray(d_obs)
    assert _rel(m_dn, j.map_point(jd, method="dense")) <= 1e-9
    assert _rel(m_cg, j.map_point(jd, method="cg", maxiter=3000,
                                  tol=1e-13)) <= 1e-6


def test_map_point_with_prior_mean(problems):
    p, j = problems["port"], problems["jax"]
    d_obs = _np(p.op.matvec(problems["m"]))
    prior = 0.1 * problems["m"]
    got = p.map_point(d_obs, prior, method="dense")
    want = j.map_point(jnp.asarray(d_obs), jnp.asarray(prior),
                       method="dense")
    assert _rel(got, want) <= 1e-9
    with pytest.raises(ValueError, match="method"):
        p.map_point(d_obs, method="bogus")


@pytest.mark.parametrize("method", ["lsqr", "cgnr"])
def test_map_point_krylov_matches_jax(method):
    F = heat_equation_p2o(*SHAPE, device="cpu")
    op = FFTMatvec.from_block_column(F, device="cpu")
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(_np(F)))
    p = GaussianInverseProblem(op, noise_var=1e-6)
    j = JaxProblem(_JittedOp(jop), noise_var=1e-6)
    rng = np.random.default_rng(3)
    D = _np(op.matmat(rng.standard_normal((SHAPE[2], SHAPE[0], 3)))) \
        + 1e-3 * rng.standard_normal((SHAPE[1], SHAPE[0], 3))
    prior = rng.standard_normal((SHAPE[2], SHAPE[0])) * 0.01
    m, res = p.map_point_krylov(D, prior, method=method, tol=1e-10,
                                maxiter=500)
    jm, jres = j.map_point_krylov(jnp.asarray(D), jnp.asarray(prior),
                                  method=method, tol=1e-10, maxiter=500)
    assert m.shape == (SHAPE[2], SHAPE[0], 3) and res.converged
    # the heat-equation map is ill-conditioned: roundoff of two frameworks
    # may move a column's crossing of tol by one iteration
    assert abs(res.n_iters - jres.n_iters) <= 1
    assert np.abs(res.col_iters - jres.col_iters).max() <= 1
    assert _rel(m, jm) <= 1e-6
    with pytest.raises(ValueError, match="Krylov"):
        p.map_point_krylov(D, method="bogus")


def test_information_gain_matches_jax_and_orders(problems):
    p, j = problems["port"], problems["jax"]
    ig = float(p.expected_information_gain())
    assert ig > 0
    assert ig == pytest.approx(float(j.expected_information_gain()),
                               rel=1e-10)
    noisier = GaussianInverseProblem(p.op, noise_var=1e-4)
    assert float(noisier.expected_information_gain()) < ig


def test_mixed_precision_problem_matches_jax(problems):
    pc = PrecisionConfig.from_string("dssdd")
    op = problems["port"].op.with_precision(pc)
    jop = problems["jax"].op.with_precision(JaxConfig.from_string("dssdd"))
    p = GaussianInverseProblem(op, noise_var=1e-6)
    j = _jitted(JaxProblem(jop, noise_var=1e-6))
    got = p.hessian_action_block(problems["V"])
    want = j.hessian_action_block(jnp.asarray(problems["V"]))
    assert got.dtype == torch.float64
    assert _rel(got, want) <= 1e-5


def test_gram_is_cached_per_operator(problems):
    p = problems["port"]
    assert p.gram is p.gram and p.gram.space == "data"
    _build.reset_launch_counts()
    p.hessian_action(problems["v"])
    assert sum(_build.launch_counts.values()) == 0      # CPU: plain paths


def test_example_twin_runs_inside_the_reference_bands():
    out = example.run("cpu", verbose=False)
    assert example.check(out) == []
    assert out["circulant_transforms"] * 2 == out["exact_transforms"]
    assert out["gram_vs_composed"] <= 1e-13
    # the reference example prints these same values, which do not depend
    # on the noise draw
    assert out["eig"] == pytest.approx(883.62, abs=0.01)
    assert out["eig_2_sensors"] == pytest.approx(295.72, abs=0.01)
