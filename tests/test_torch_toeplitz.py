"""Parity of the port's Toeplitz helpers with the JAX package (CPU).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the f64 Fourier setup agrees to rel 1e-14 (two FFT libraries,
same transform); the dense oracles and the heat-equation column are the
same arithmetic in another order, rel 1e-13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import toeplitz as jtz
from repro_torch.core import pareto as tpareto
from repro_torch.core import toeplitz as ttz


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("Nt,Nd,Nm", [(4, 3, 5), (16, 2, 8), (13, 5, 7),
                                      (32, 4, 40)])
def test_fourier_block_column_matches_jax_f64(Nt, Nd, Nm):
    F = np.random.default_rng(Nt).standard_normal((Nt, Nd, Nm))
    jre, jim = jtz.fourier_block_column(jnp.asarray(F))
    tre, tim = ttz.fourier_block_column(torch.as_tensor(F))
    assert tre.shape == (Nt + 1, Nd, Nm) and tre.dtype == torch.float64
    assert tre.is_contiguous() and tim.is_contiguous()
    assert _rel(tre, jre) <= 1e-14
    assert _rel(tim, jim) <= 1e-14


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fourier_block_column_stores_at_dtype(dtype):
    F = np.random.default_rng(1).standard_normal((6, 2, 3))
    re64, _ = ttz.fourier_block_column(torch.as_tensor(F))
    re, im = ttz.fourier_block_column(torch.as_tensor(F), dtype=dtype)
    assert re.dtype == im.dtype == dtype
    assert torch.equal(re, re64.to(dtype))


@pytest.mark.parametrize("Nt,Nd,Nm", [(6, 2, 3), (9, 3, 4)])
def test_dense_oracles_match_jax(Nt, Nd, Nm):
    rng = np.random.default_rng(2)
    F = rng.standard_normal((Nt, Nd, Nm))
    m = rng.standard_normal((Nm, Nt))
    d = rng.standard_normal((Nd, Nt))
    Ft = torch.as_tensor(F)
    assert _rel(ttz.dense_matvec(Ft, torch.as_tensor(m)),
                jtz.dense_matvec(jnp.asarray(F), jnp.asarray(m))) <= 1e-13
    assert _rel(ttz.dense_rmatvec(Ft, torch.as_tensor(d)),
                jtz.dense_rmatvec(jnp.asarray(F), jnp.asarray(d))) <= 1e-13
    np.testing.assert_array_equal(
        ttz.dense_from_block_column(Ft).numpy(),
        np.asarray(jtz.dense_from_block_column(jnp.asarray(F))))


def test_dense_matrix_consistent_with_dense_matvec():
    rng = np.random.default_rng(3)
    Nt, Nd, Nm = 6, 2, 3
    F = torch.as_tensor(rng.standard_normal((Nt, Nd, Nm)))
    m = torch.as_tensor(rng.standard_normal((Nm, Nt)))
    d = (ttz.dense_from_block_column(F) @ m.T.reshape(-1)).reshape(Nt, Nd).T
    assert tpareto.rel_l2(ttz.dense_matvec(F, m), d) < 1e-13


@pytest.mark.parametrize("Nt,Nd,Nm", [(5, 3, 16), (8, 4, 10)])
def test_heat_equation_p2o_matches_jax(Nt, Nd, Nm):
    got = ttz.heat_equation_p2o(Nt, Nd, Nm, device="cpu")
    want = jtz.heat_equation_p2o(Nt, Nd, Nm)
    assert got.shape == (Nt, Nd, Nm) and got.dtype == torch.float64
    assert _rel(got, want) <= 1e-13


def test_heat_equation_p2o_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttz.heat_equation_p2o(4, 2, 8)


def test_random_unrepresentable_loses_bits_on_f32_cast():
    g = torch.Generator().manual_seed(0)
    x = ttz.random_unrepresentable(g, (64, 32))
    assert x.dtype == torch.float64
    assert bool(((x >= 0.5) & (x < 1.0)).all())
    # the 29 low mantissa bits hold the 0101... pattern
    low = x.view(torch.int64) & ((1 << 29) - 1)
    assert bool((low == 0x0AAAAAAA).all())
    rt = x.to(torch.float32).to(torch.float64)
    err = ((rt - x).abs() / x).min().item()
    assert err > 2.0 ** -26          # every element loses a real fraction
    # the JAX package's construction gives the same bit pattern
    jx = np.asarray(jtz.random_unrepresentable(jax.random.PRNGKey(0), (8,)))
    assert np.all((jx.view(np.int64) & ((1 << 29) - 1)) == 0x0AAAAAAA)


def test_random_block_column_law():
    g = torch.Generator().manual_seed(1)
    F = ttz.random_block_column(g, 6, 8, 400, decay=0.5)
    assert F.shape == (6, 8, 400) and F.dtype == torch.float32
    # block k has standard deviation decay^k / sqrt(N_m)
    for k in range(4):
        assert F[k].std().item() * 20 == pytest.approx(0.5 ** k, rel=0.1)
    g2 = torch.Generator().manual_seed(1)
    assert torch.equal(F, ttz.random_block_column(g2, 6, 8, 400, decay=0.5))


def test_rel_l2_matches_reference_metric():
    from repro.core.pareto import rel_l2 as jrel
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal(50), rng.standard_normal(50)
    assert tpareto.rel_l2(torch.as_tensor(a), torch.as_tensor(b)) == \
        pytest.approx(jrel(a, b), rel=1e-14)
    assert tpareto.rel_l2(torch.ones(3), torch.zeros(3)) == \
        pytest.approx(jrel(np.ones(3), np.zeros(3)))
