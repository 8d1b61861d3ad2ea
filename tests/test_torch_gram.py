"""Multi-RHS blocks and the fused Gram operators of the port, against the
JAX package on the CPU.

Both packages get the same numpy block column and blocks; the JAX side
runs jitted (``jitted_block()``, ``GramOperator.jitted()``), which
computes what its eager calls do in a quarter of the time.  Tolerances go
by the lowest level in the config, as the reference's own tests set them:
d <= 1e-13 (rel L2; two FFT libraries and two summation orders at f64),
s <= 1e-5, h <= 2e-2.  The exact Gram matches the port's own composed
``rmatmat(matmat(.))`` to 1e-13 and the circulant Gram the straight-line
spectral oracle of ``tests/test_gram.py`` to 1e-13.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import DispatchTable as JaxTable
from repro.core import ExecOpts as JaxExecOpts
from repro.core import FFTMatvec as JaxFFTMatvec
from repro.core import PrecisionConfig as JaxConfig
from repro.core import pipeline as jpipe
from repro_torch import convert
from repro_torch.core import (FFTMatvec, NAMED_CONFIGS, PrecisionConfig,
                              gram_plan, matvec_plan, record_stages, rel_l2,
                              stage_counts)
from repro_torch.core import pipeline as tpipe
from repro_torch.kernels import _build

SHAPE = (16, 4, 40)                    # N_t, N_d, N_m
TOL = {"d": 1e-13, "s": 1e-5, "h": 2e-2}
NAMED = [c.to_string() for c in NAMED_CONFIGS]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(12)
    N_t, N_d, N_m = SHAPE
    F = rng.standard_normal((N_t, N_d, N_m)) * \
        (0.5 ** np.arange(N_t))[:, None, None] / np.sqrt(N_m)
    return {"F": F, "M": rng.standard_normal((N_m, N_t, 5)),
            "D": rng.standard_normal((N_d, N_t, 5))}


@pytest.fixture(scope="module")
def ops_pair(data):
    """Both packages' ddddd operators over the same block column."""
    return (FFTMatvec.from_block_column(data["F"], device="cpu"),
            JaxFFTMatvec.from_block_column(jnp.asarray(data["F"])))


def _np(a):
    if torch.is_tensor(a):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float64))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# matmat / rmatmat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", NAMED)
@pytest.mark.parametrize("S", [1, 3, 5])
def test_matmat_rmatmat_match_jax(data, cfg, S):
    top = FFTMatvec.from_block_column(
        data["F"], device="cpu", precision=PrecisionConfig.from_string(cfg))
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(data["F"]),
                                         precision=JaxConfig.from_string(cfg))
    M, D = data["M"][..., :S], data["D"][..., :S]
    Y, X = top.matmat(M), top.rmatmat(D)
    assert Y.shape == (SHAPE[1], SHAPE[0], S) and Y.dtype == top.io_dtype
    assert X.shape == (SHAPE[2], SHAPE[0], S)
    tol = TOL[top.precision.lowest()]
    jmatmat, jrmatmat = jop.jitted_block()
    assert _rel(Y, jmatmat(jnp.asarray(M))) <= tol
    assert _rel(X, jrmatmat(jnp.asarray(D))) <= tol


@pytest.mark.parametrize("cfg", ["ddddd", "dssdd", "hhhhh"])
def test_matmat_columns_equal_matvec(data, cfg):
    op = FFTMatvec.from_block_column(
        data["F"], device="cpu", precision=PrecisionConfig.from_string(cfg))
    M, D = torch.as_tensor(data["M"]), torch.as_tensor(data["D"])
    Y, X = op.matmat(M), op.rmatmat(D)
    tol = TOL[op.precision.lowest()]
    for s in range(M.shape[-1]):
        assert rel_l2(Y[..., s], op.matvec(M[..., s])) <= tol
        assert rel_l2(X[..., s], op.rmatvec(D[..., s])) <= tol


def test_block_adjoint_identity(ops_pair, data):
    op, _ = ops_pair
    M, D = torch.as_tensor(data["M"]), torch.as_tensor(data["D"])
    lhs = torch.sum(op.matmat(M) * D)
    rhs = torch.sum(M * op.rmatmat(D))
    assert abs(lhs - rhs) / abs(lhs) < 1e-13


@pytest.mark.parametrize("S", [2, 5])
@pytest.mark.parametrize("to_tosi", [True, False])
def test_reorder_planes_match_jax(S, to_tosi):
    rng = np.random.default_rng(S)
    shape = (S * 3, 9) if to_tosi else (9, 3, S)
    re, im = rng.standard_normal(shape), rng.standard_normal(shape)
    got = tpipe.reorder_planes(torch.as_tensor(re), torch.as_tensor(im), "s",
                               to_tosi=to_tosi, S=S)
    want = jpipe.reorder_planes(jnp.asarray(re), jnp.asarray(im), "s",
                                to_tosi=to_tosi, S=S)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == torch.float32
        np.testing.assert_array_equal(_np(g), _np(w))


def test_record_stages_of_a_block_match_jax(ops_pair, data):
    op, jop = ops_pair
    with jpipe.record_stages() as jc:
        jop.matmat(jnp.asarray(data["M"]))
    with tpipe.record_stages() as tc:
        op.matmat(data["M"])
    assert dict(tc) == dict(jc)


# ---------------------------------------------------------------------------
# Gram plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", NAMED)
@pytest.mark.parametrize("space", ["parameter", "data"])
@pytest.mark.parametrize("mode", ["exact", "circulant"])
def test_gram_plan_stages_match_jax(cfg, space, mode):
    want = jpipe.gram_plan(JaxConfig.from_string(cfg), space=space, mode=mode)
    got = gram_plan(PrecisionConfig.from_string(cfg), space=space, mode=mode)
    key = lambda s: (s.kind, s.level, s.adjoint, s.to_tosi,  # noqa: E731
                     s.operand)
    assert [key(s) for s in got] == [key(s) for s in want]
    assert dict(stage_counts(got)) == dict(jpipe.stage_counts(want))


@pytest.mark.parametrize("space", ["parameter", "data"])
@pytest.mark.parametrize("mode", ["exact", "circulant"])
def test_gram_operator_stage_counts_match_jax(ops_pair, space, mode):
    op, jop = ops_pair
    assert dict(op.gram(space=space, mode=mode).stage_counts()) == \
        dict(jop.gram(space=space, mode=mode).stage_counts())


def test_circulant_halves_fft_and_reorder_stages(ops_pair, data):
    op, _ = ops_pair
    v = torch.as_tensor(data["M"][..., 0])
    with record_stages() as composed:
        op.rmatvec(op.matvec(v))
    with record_stages() as circulant:
        op.gram(mode="circulant").apply(v)
    with record_stages() as exact:
        op.gram(mode="exact").apply(v)
    for kind in ("fft", "ifft", "reorder"):
        assert circulant[kind] * 2 == composed[kind], kind
    assert exact["fft"] == composed["fft"] and exact["mask"] == 1
    assert exact["pad"] + exact["unpad"] + exact["mask"] \
        < composed["pad"] + composed["unpad"]
    assert stage_counts(gram_plan(op.precision, mode="circulant")) \
        == circulant
    assert stage_counts(gram_plan(op.precision, mode="exact")) == exact
    two = stage_counts(matvec_plan(op.precision))
    two.update(stage_counts(matvec_plan(op.precision, adjoint=True)))
    assert two == composed


# ---------------------------------------------------------------------------
# Exact Gram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("space", ["parameter", "data"])
@pytest.mark.parametrize("S", [None, 1, 3, 5])
def test_exact_gram_matches_composed_and_jax(ops_pair, data, space, S):
    op, jop = ops_pair
    key = "M" if space == "parameter" else "D"
    v = data[key][..., 0] if S is None else data[key][..., :S]
    g = op.gram(space=space)
    got = g.apply(v)
    assert got.shape == v.shape
    vt = torch.as_tensor(v)
    composed = (op.rmatmat(op.matmat(vt)) if space == "parameter"
                else op.matmat(op.rmatmat(vt)))
    assert rel_l2(got, composed) <= 1e-13
    want = jop.gram(space=space).jitted()(jnp.asarray(v))
    assert _rel(got, want) <= 1e-13


@pytest.mark.parametrize("cfg", ["dssdd", "sssss", "shhss"])
def test_mixed_exact_gram_matches_jax(data, cfg):
    pc = PrecisionConfig.from_string(cfg)
    op = FFTMatvec.from_block_column(data["F"], device="cpu", precision=pc)
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(data["F"]),
                                         precision=JaxConfig.from_string(cfg))
    for space, key in (("parameter", "M"), ("data", "D")):
        v = data[key][..., :3]
        got = op.gram(space=space).apply(v)
        want = jop.gram(space=space).jitted()(jnp.asarray(v))
        assert got.dtype == op.io_dtype
        assert _rel(got, want) <= TOL[pc.lowest()], space


def test_exact_gram_matches_jax_pallas_interpret(data):
    jopts = JaxExecOpts(backend="cpu-interpret",
                        dispatch=JaxTable(force="pallas"),
                        fuse_pad_cast=True, block_n=128)
    pc = PrecisionConfig.from_string("sssss")
    op = FFTMatvec.from_block_column(data["F"], device="cpu", precision=pc)
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(data["F"]),
                                         precision=JaxConfig.from_string(
                                             "sssss"), opts=jopts)
    v = data["M"][..., :3].astype(np.float32)
    assert _rel(op.gram().apply(v), jop.gram().jitted()(jnp.asarray(v))) \
        <= 1e-5


def test_gram_symmetric_psd(ops_pair, data):
    op, _ = ops_pair
    g = op.gram()
    v = torch.as_tensor(data["M"][..., 0])
    w = torch.as_tensor(data["M"][..., 1])
    assert torch.sum(v * g.apply(v)) >= 0
    lhs, rhs = torch.sum(w * g.apply(v)), torch.sum(g.apply(w) * v)
    assert abs(lhs - rhs) / abs(lhs) < 1e-12


# ---------------------------------------------------------------------------
# Circulant Gram
# ---------------------------------------------------------------------------

def _spectral_oracle(op, v, space):
    """The per-bin G_hat operator in straight-line torch (the oracle of
    ``tests/test_gram.py``), independent of the pipeline and kernels."""
    Nt = op.N_t
    F_hat = torch.complex(op.F_hat_re, op.F_hat_im)
    if space == "parameter":                       # F_hat^H F_hat
        G_hat = torch.einsum("kdm,kdn->kmn", F_hat.conj(), F_hat)
    else:                                          # F_hat F_hat^H
        G_hat = torch.einsum("kdm,kem->kde", F_hat, F_hat.conj())
    v_hat = torch.fft.rfft(torch.nn.functional.pad(v, (0, Nt)), dim=-1)
    return torch.fft.irfft(torch.einsum("kmn,nk->mk", G_hat, v_hat),
                           n=2 * Nt, dim=-1)[:, :Nt]


@pytest.mark.parametrize("space", ["parameter", "data"])
def test_circulant_gram_matches_spectral_oracle(ops_pair, data, space):
    op, _ = ops_pair
    v = torch.as_tensor(data["M" if space == "parameter" else "D"][..., 0])
    got = op.gram(space=space, mode="circulant").apply(v)
    assert rel_l2(got, _spectral_oracle(op, v, space)) <= 1e-13
    # the periodic Gram is not the composed product (the mask matters)
    composed = (op.rmatvec(op.matvec(v)) if space == "parameter"
                else op.matvec(op.rmatvec(v)))
    assert rel_l2(got, composed) > 1e-8


@pytest.mark.parametrize("space", ["parameter", "data"])
@pytest.mark.parametrize("cfg", ["ddddd", "sssss"])
def test_circulant_gram_blocks_and_action_match_jax(data, space, cfg):
    pc = PrecisionConfig.from_string(cfg)
    op = FFTMatvec.from_block_column(data["F"], device="cpu", precision=pc)
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(data["F"]),
                                         precision=JaxConfig.from_string(cfg))
    g, jg = (o.gram(space=space, mode="circulant") for o in (op, jop))
    tol = TOL[pc.lowest()]
    assert g.G_hat_re.dtype == op.F_hat_re.dtype
    assert _rel(g.G_hat_re, jg.G_hat_re) <= tol
    assert _rel(g.G_hat_im, jg.G_hat_im) <= tol
    # the same state in both packages: G_hat carried over from JAX
    carried = convert.gram_from_numpy(op, np.asarray(jg.G_hat_re),
                                      np.asarray(jg.G_hat_im), space=space)
    v = data["M" if space == "parameter" else "D"][..., :3]
    want = jg.jitted()(jnp.asarray(v))
    assert _rel(carried.apply(v), want) <= tol
    assert _rel(g.apply(v), want) <= tol


def test_gram_from_numpy_checks_shapes(ops_pair):
    op, _ = ops_pair
    with pytest.raises(ValueError, match="G_hat planes"):
        convert.gram_from_numpy(op, np.zeros((3, 4, 4)), np.zeros((3, 4, 4)),
                                space="data")


def test_gram_with_precision_recomputes_blocks(ops_pair):
    op, _ = ops_pair
    g = op.gram(space="data", mode="circulant")
    g32 = g.with_precision(PrecisionConfig.from_string("sssss"))
    assert g32.G_hat_re.dtype == torch.float32 and g32.mode == "circulant"
    assert _rel(g32.G_hat_re, g.G_hat_re) <= 1e-6


def test_gram_validation(ops_pair):
    op, _ = ops_pair
    with pytest.raises(ValueError, match="space"):
        op.gram(space="bogus")
    with pytest.raises(ValueError, match="mode"):
        op.gram(mode="bogus")
    with pytest.raises(ValueError, match="space"):
        gram_plan(op.precision, space="bogus")
    with pytest.raises(ValueError, match="mode"):
        gram_plan(op.precision, mode="bogus")
    tiled = gram_plan(PrecisionConfig.from_string("dssdd;tiles=hd|sh"))
    assert [s.tile_map.to_string() for s in tiled if s.kind == "gemv"] == \
        ["hs|sh", "hs|sh"]


def test_gram_on_cpu_launches_no_kernel(ops_pair, data):
    op, _ = ops_pair
    _build.reset_launch_counts()
    op.gram(space="data", mode="circulant").apply(data["D"])
    op.gram().apply(data["M"])
    assert sum(_build.launch_counts.values()) == 0
