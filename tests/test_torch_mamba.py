"""The port's state-space blocks (``repro_torch.models.mamba``) and the SSM
LM (``ssm_lm``) on the CPU, against the JAX package's, on the same numpy
inputs and weights (``convert.lm_params_from_numpy``).

Everything of the recurrences runs in f32 in both packages, summed in
another order (a log-step doubling scan here, ``associative_scan``
there): 2e-4 (rtol and atol), the reference's own bound for its
decode-against-forward check being 5e-4.  The blocks run at ``FULL_F32``;
the SSM LM also at the default policy, within 3e-2 of the largest
|logit|.  Each recurrence is also held against the literal per-step loop
of ``tests/test_models_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import api as japi
from repro.models import mamba as jmamba
from repro.models import ssm_lm as jssm
from repro.models.policy import FULL_F32 as JAX_F32
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import mamba, ssm_lm
from repro_torch.models.policy import FULL_F32

TOL = dict(rtol=2e-4, atol=2e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _np(t):
    return np.asarray(t, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _softplus(a):
    return np.log1p(np.exp(a)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _model(arch, f32=True):
    jc, tc = jax_smoke(arch), get_smoke_config(arch)
    if f32:
        jc, tc = jc.replace(policy=JAX_F32), tc.replace(policy=FULL_F32)
    params = japi.init_params(jc, jax.random.PRNGKey(11))
    model = lm_params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return jc, tc, params, model


def _layer(params, i):
    return jax.tree.map(lambda v: v[i], params["layers"])


@pytest.mark.parametrize("T,chunk", [(24, 8), (13, 8), (7, 16)])
def test_chunked_linear_recurrence(T, chunk):
    """A prime T of 13 at chunk 8 falls back to chunks of 1."""
    rng = np.random.default_rng(0)
    a = np.exp(-np.abs(_rand(rng, 2, T, 3, 4)))
    b = _rand(rng, 2, T, 3, 4)
    got = mamba.chunked_linear_recurrence(_t(a), _t(b), chunk)
    want = jmamba.chunked_linear_recurrence(jnp.asarray(a), jnp.asarray(b),
                                            chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    h, hs = np.zeros((2, 3, 4), np.float32), []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(hs, 1), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state):
    rng = np.random.default_rng(1)
    x, w = _rand(rng, 2, 9, 6), _rand(rng, 6, 4)
    st = _rand(rng, 2, 3, 6) if with_state else None
    got, gst = mamba.causal_conv1d(_t(x), _t(w),
                                   None if st is None else _t(st))
    want, wst = jmamba.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                     None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_array_equal(gst.numpy(), _np(wst))


@pytest.mark.parametrize("T,chunk,with_state", [
    (20, 8, False), (20, 8, True), (13, 8, False), (1, 8, True)])
def test_ssm_selective_matches_jax_and_the_loop(T, chunk, with_state):
    rng = np.random.default_rng(2)
    B, Di, N = 2, 6, 4
    x, Bc, Cc = _rand(rng, B, T, Di), _rand(rng, B, T, N), _rand(rng, B, T, N)
    dt = _softplus(_rand(rng, B, T, Di))
    A_log = np.log(rng.uniform(0.5, 2.0, (Di, N))).astype(np.float32)
    D_skip = _rand(rng, Di)
    h0 = _rand(rng, B, Di, N) if with_state else None
    y, h = mamba._ssm_selective(*map(_t, (x, dt, Bc, Cc, A_log, D_skip)),
                                chunk, None if h0 is None else _t(h0))
    wy, wh = jmamba._ssm_selective(*map(jnp.asarray, (x, dt, Bc, Cc, A_log,
                                                      D_skip)), chunk,
                                   None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), _np(wy), **TOL)
    np.testing.assert_allclose(h.numpy(), _np(wh), **TOL)
    A = -np.exp(A_log)
    hh, ys = (np.zeros((B, Di, N), np.float32) if h0 is None else h0), []
    for t in range(T):
        hh = np.exp(dt[:, t][..., None] * A) * hh + \
            (dt[:, t] * x[:, t])[..., None] * Bc[:, t][:, None, :]
        ys.append(np.einsum("bdn,bn->bd", hh, Cc[:, t]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1) + D_skip * x, **TOL)
    np.testing.assert_allclose(h.numpy(), hh, **TOL)


@pytest.mark.parametrize("T,chunk,with_state", [
    (24, 8, False), (24, 8, True), (13, 8, True), (1, 8, True)])
def test_ssd_chunked_matches_jax_and_the_loop(T, chunk, with_state):
    rng = np.random.default_rng(3)
    B, H, Ph, N = 2, 3, 4, 8
    x, Bc, Cc = _rand(rng, B, T, H, Ph), _rand(rng, B, T, N), \
        _rand(rng, B, T, N)
    dt = _softplus(_rand(rng, B, T, H))
    A_log = _rand(rng, H) * 0.5
    S0 = _rand(rng, B, H, Ph, N) if with_state else None
    y, S = mamba._ssd_chunked(*map(_t, (x, dt, Bc, Cc, A_log)), chunk,
                              None if S0 is None else _t(S0))
    wy, wS = jmamba._ssd_chunked(*map(jnp.asarray, (x, dt, Bc, Cc, A_log)),
                                 chunk, None if S0 is None else
                                 jnp.asarray(S0))
    np.testing.assert_allclose(y.numpy(), _np(wy), **TOL)
    np.testing.assert_allclose(S.numpy(), _np(wS), **TOL)
    a = dt * -np.exp(A_log)
    h, ys = (np.zeros((B, H, Ph, N), np.float32) if S0 is None else S0), []
    for t in range(T):
        h = h * np.exp(a[:, t])[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t][..., None], Bc[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cc[:, t]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), **TOL)
    np.testing.assert_allclose(S.numpy(), h, **TOL)


def _block_case(arch, version, with_state, T):
    jc, tc, params, model = _model(arch)
    rng = np.random.default_rng(4)
    h = _rand(rng, 2, T, tc.d_model)
    state = None
    if with_state:
        one = jmamba.init_ssm_state(jc, 2, version)
        state = {k: _rand(rng, *v.shape) * 0.5 for k, v in one.items()}
    lp, jlp = model.layers[1], _layer(params, 1)
    block = mamba.mamba1_block if version == 1 else mamba.mamba2_block
    jblock = jmamba.mamba1_block if version == 1 else jmamba.mamba2_block
    with torch.inference_mode():
        out, st = block(tc, lp, _t(h), state=None if state is None else
                        {k: _t(v) for k, v in state.items()})
    wout, wst = jax.jit(lambda p, x, s: jblock(jc, p, x, state=s))(
        jlp, jnp.asarray(h), None if state is None else
        {k: jnp.asarray(v) for k, v in state.items()})
    np.testing.assert_allclose(out.numpy(), _np(wout), **TOL)
    for k in ("conv", "ssm"):
        assert tuple(st[k].shape) == tuple(wst[k].shape)
        np.testing.assert_allclose(st[k].numpy(), _np(wst[k]), **TOL)


@pytest.mark.parametrize("with_state,T", [(False, 16), (True, 1),
                                          (True, 5), (False, 11)])
def test_mamba1_block_matches_jax(with_state, T):
    _block_case("falcon_mamba_7b", 1, with_state, T)


@pytest.mark.parametrize("with_state,T", [(False, 16), (True, 1),
                                          (True, 5), (False, 11)])
def test_mamba2_block_matches_jax(with_state, T):
    _block_case("zamba2_1p2b", 2, with_state, T)


def test_lti_fft_block_matches_jax_and_a_direct_convolution():
    """The frozen-(dt, B, C) block through rfft/irfft against the
    reference's, and its SSM term against the causal convolution with the
    impulse response written out as a sum."""
    jc, tc, params, model = _model("falcon_mamba_7b")
    h = _rand(np.random.default_rng(5), 2, 12, tc.d_model)
    with torch.inference_mode():
        got = mamba.mamba1_block_lti_fft(tc, model.layers[0], _t(h))
        kern = mamba.lti_kernel(tc, model.layers[0], 12).numpy()
    want = jax.jit(lambda p, x: jmamba.mamba1_block_lti_fft(jc, p, x))(
        _layer(params, 0), jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    lp = model.layers[0]
    dt = _softplus(lp.dt_bias.detach().numpy().astype(np.float64))
    decay = np.exp(dt[:, None] * -np.exp(lp.A_log.detach().numpy().astype(np.float64)))
    direct = np.stack([(dt[:, None] / tc.ssm_state * decay ** t).sum(-1)
                       for t in range(12)])
    np.testing.assert_allclose(kern, direct, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lti", [False, True])
@pytest.mark.parametrize("f32", [True, False])
def test_ssm_lm_forward_matches_jax(lti, f32):
    jc, tc, params, model = _model("falcon_mamba_7b", f32)
    toks = np.random.default_rng(6).integers(0, tc.vocab, (2, 12),
                                             dtype=np.int32)
    with torch.inference_mode():
        got, aux = ssm_lm.forward(tc, model, torch.as_tensor(
            toks, dtype=torch.long), lti_fft_mode=lti)
    want, _ = jax.jit(lambda p, t: jssm.forward(jc, p, t, lti_fft_mode=lti))(
        params, jnp.asarray(toks))
    want = _np(want)
    assert got.dtype == torch.float32 and aux.item() == 0.0
    if f32:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 3e-2, err


def test_ssm_decode_matches_forward():
    """tests/test_models_smoke.py:test_decode_matches_forward_ssm for the
    port: prefill of S tokens, then decode steps, give the full forward's
    logits at those positions (FULL_F32, 5e-4)."""
    _, tc, _, model = _model("falcon_mamba_7b")
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, tc.vocab, (2, 13)), dtype=torch.long)
    with torch.inference_mode():
        full, _ = ssm_lm.forward(tc, model, toks)
        _, state = ssm_lm.prefill(tc, model, toks[:, :10])
        for i in range(3):
            dl, state = ssm_lm.decode_step(tc, model, state,
                                           toks[:, 10 + i:11 + i])
            np.testing.assert_allclose(dl[:, 0].numpy(),
                                       full[:, 10 + i].numpy(), rtol=5e-4,
                                       atol=5e-4)
    assert state["pos"] == 13


def test_init_draws_the_reference_layout():
    """Random init: A_log = log(1 .. N) in every row, D_skip one, dt_bias
    zero, conv taps at scale 0.5; Mamba-2's A_log zero and norm_w one."""
    tc = get_smoke_config("falcon_mamba_7b")
    model = ssm_lm.init_params(tc, torch.Generator().manual_seed(0),
                               device="cpu")
    lp = model.layers[2]
    N = tc.ssm_state
    np.testing.assert_allclose(lp.A_log.detach().numpy(), np.broadcast_to(
        np.log(np.arange(1, N + 1, dtype=np.float32)), lp.A_log.shape))
    assert lp.A_log.dtype == torch.float32 and lp.in_proj.dtype == torch.float32
    assert torch.all(lp.D_skip == 1) and torch.all(lp.dt_bias == 0)
    assert lp.conv_w.std().item() == pytest.approx(0.5, rel=0.2)
    assert model.lm_head is not None and len(model.layers) == tc.n_layers
    st = ssm_lm.init_decode_state(tc, 3, device="cpu")
    Di = tc.ssm_expand * tc.d_model
    assert tuple(st["state"]["conv"].shape) == (tc.n_layers, 3,
                                                tc.ssm_conv - 1, Di)
    assert tuple(st["state"]["ssm"].shape) == (tc.n_layers, 3, Di, N)
    assert st["state"]["conv"].dtype == tc.policy.c()
