"""The port's LM primitives (``repro_torch.models.layers``) on the
CPU, against the JAX package's ``repro.models.layers``: the same numpy
inputs through both.  Tolerances: 1e-5 at f32 (two summation orders);
2e-2 at bf16, where the two frameworks' f32 sums may round to
neighbouring bf16 values.  ``dense`` with a bias is also held at bf16 on
inputs whose products and sums are exact in f32, where both must give
the same single rounding of (sum + bias) to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _pair(a, tdt, jdt):
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdt), \
        jnp.asarray(np.asarray(a, np.float32)).astype(jdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(params=list(DTYPES))
def dt(request):
    return DTYPES[request.param]


def test_rms_norm(rng, dt):
    tdt, jdt, tol = dt
    x, jx = _pair(rng.standard_normal((2, 7, 48)), tdt, jdt)
    g, jg = _pair(rng.standard_normal(48), torch.float32, jnp.float32)
    _close(L.rms_norm(x, g, 1e-5), JL.rms_norm(jx, jg, 1e-5), tol)


@pytest.mark.parametrize("with_bias", [False, True])
def test_dense(rng, dt, with_bias):
    tdt, jdt, tol = dt
    x, jx = _pair(rng.standard_normal((2, 5, 32)), tdt, jdt)
    w, jw = _pair(rng.standard_normal((32, 24)) / 6, torch.float32,
                  jnp.float32)
    b, jb = _pair(rng.standard_normal(24), torch.float32, jnp.float32) \
        if with_bias else (None, None)
    got = L.dense(x, w, b)
    assert got.dtype == tdt
    _close(got, JL.dense(jx, jw, jb), tol)


@pytest.mark.parametrize("d_in,d_out", [(32, 24), (64, 80)])
def test_dense_bias_rounds_once(rng, d_in, d_out):
    """At the default policy (bf16 compute) the bias is added to the f32
    sums and rounded once, as the reference does.  x and w are small
    dyadic numbers, so every product and partial sum is exact in f32 and
    the summation order cannot matter: the two frameworks must agree to
    f32 resolution (1e-5 of max |y|), far below one bf16 step.  Rounding
    the product to bf16 before adding the bias misses by a bf16 step."""
    x = rng.integers(-8, 9, (2, 5, d_in)) / 4
    w = rng.integers(-16, 17, (d_in, d_out)) / 8
    b = rng.standard_normal(d_out)
    (tx, jx), (tw, jw), (tb, jb) = (
        _pair(x, torch.bfloat16, jnp.bfloat16),
        _pair(w, torch.float32, jnp.float32),
        _pair(b, torch.float32, jnp.float32))
    got = L.dense(tx, tw, tb)
    want = np.asarray(JL.dense(jx, jw, jb), np.float32)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


def test_matmul_f32_keeps_the_f32_sums(rng):
    """``matmul_f32`` on bf16 operands equals the f64 product of the same
    bf16 values to f32 resolution (on the CPU: widened operands)."""
    x = torch.from_numpy(rng.standard_normal((3, 7, 48))).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((48, 40)) / 7).float()
    got = L.matmul_f32(x, w)
    want = x.double() @ w.to(torch.bfloat16).double()
    assert got.dtype == torch.float32 and got.shape == (3, 7, 40)
    err = (got.double() - want).abs().max() / want.abs().max()
    assert err <= 1e-6, err


def test_rope(rng, dt):
    tdt, jdt, tol = dt
    x, jx = _pair(rng.standard_normal((2, 9, 3, 16)), tdt, jdt)
    pos = rng.integers(0, 300, (2, 9))
    _close(L.rope(x, torch.from_numpy(pos), 1e4),
           JL.rope(jx, jnp.asarray(pos), 1e4), tol)


def test_swiglu(rng, dt):
    tdt, jdt, tol = dt
    x, jx = _pair(rng.standard_normal((2, 5, 32)), tdt, jdt)
    ws = [_pair(rng.standard_normal(s) / 6, torch.float32, jnp.float32)
          for s in ((32, 40), (32, 40), (40, 32))]
    _close(L.swiglu(x, *(w for w, _ in ws)),
           JL.swiglu(jx, *(jw for _, jw in ws)), tol)


def test_layer_norm(rng, dt):
    tdt, jdt, tol = dt
    x, jx = _pair(rng.standard_normal((2, 7, 32)) * 3 + 1, tdt, jdt)
    g, jg = _pair(rng.standard_normal(32), torch.float32, jnp.float32)
    b, jb = _pair(rng.standard_normal(32), torch.float32, jnp.float32)
    _close(L.layer_norm(x, g, b, 1e-5), JL.layer_norm(jx, jg, jb, 1e-5), tol)


def test_sinusoid_positions(rng):
    pos = rng.integers(0, 1500, (2, 11))
    got = L.sinusoid_positions(torch.from_numpy(pos), 64)
    assert got.dtype == torch.float32 and got.shape == (2, 11, 64)
    _close(got, JL.sinusoid_positions(jnp.asarray(pos), 64), 1e-5)


def test_gelu_mlp_is_the_tanh_gelu(rng, dt):
    """``jax.nn.gelu`` defaults to the tanh approximation; so does the
    port's, not torch's exact default."""
    tdt, jdt, tol = dt
    x, jx = _pair(rng.standard_normal((2, 5, 32)), tdt, jdt)
    (w1, jw1), (b1, jb1), (w2, jw2), (b2, jb2) = (
        _pair(rng.standard_normal(s) / 6, torch.float32, jnp.float32)
        for s in ((32, 40), (40,), (40, 32), (32,)))
    _close(L.gelu_mlp(x, w1, b1, w2, b2), JL.gelu_mlp(jx, jw1, jb1, jw2, jb2),
           tol)
    h = torch.linspace(-4, 4, 81)
    gelu = L.gelu_mlp(h[:, None], torch.eye(1), torch.zeros(1), torch.eye(1),
                      torch.zeros(1))[:, 0]
    np.testing.assert_allclose(gelu.numpy(), np.asarray(
        jax.nn.gelu(jnp.asarray(h.numpy()))), rtol=1e-6, atol=1e-6)


def test_bmm_f32_keeps_the_f32_sums(rng):
    """``bmm_f32`` on bf16 operands equals the f64 product of the same bf16
    values to f32 resolution, as ``matmul_f32`` for one product."""
    x = torch.from_numpy(rng.standard_normal((5, 7, 48))).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((5, 48, 40)) / 7).float()
    got = L.bmm_f32(x, w)
    want = x.double() @ w.to(torch.bfloat16).double()
    assert got.dtype == torch.float32 and got.shape == (5, 7, 40)
    err = (got.double() - want).abs().max() / want.abs().max()
    assert err <= 1e-6, err


def _qkv(rng, B, Sq, Skv, Hq, Hkv, Dh, tdt, jdt):
    return [_pair(rng.standard_normal((B, s, h, Dh)), tdt, jdt)
            for s, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]


@pytest.mark.parametrize("Sq,Skv,q_offset,causal", [
    (24, 24, 0, True),       # prefill, several chunks each way
    (1, 40, 17, True),       # a decode step against a cache
    (3, 40, 30, True),       # a multi-token step
    (12, 20, 0, False),      # cross lengths, full attention
])
def test_chunked_attention(rng, dt, Sq, Skv, q_offset, causal):
    tdt, jdt, tol = dt
    (q, jq), (k, jk), (v, jv) = _qkv(rng, 2, Sq, Skv, 4, 2, 8, tdt, jdt)
    got = L.chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                              q_chunk=8, kv_chunk=10)
    want = JL.chunked_attention(jq, jk, jv, causal=causal,
                                q_offset=q_offset, q_chunk=8, kv_chunk=10)
    assert got.dtype == tdt
    _close(got, want, tol)


@pytest.mark.parametrize("Sq,Skv,q_offset", [(24, 24, 0), (8, 32, 24)])
def test_block_causal_attention(rng, dt, Sq, Skv, q_offset):
    tdt, jdt, tol = dt
    (q, jq), (k, jk), (v, jv) = _qkv(rng, 1, Sq, Skv, 4, 4, 16, tdt, jdt)
    _close(L.block_causal_attention(q, k, v, q_offset=q_offset, q_chunk=8,
                                    kv_chunk=8),
           JL.block_causal_attention(jq, jk, jv, q_offset=q_offset,
                                     q_chunk=8, kv_chunk=8), tol)


@pytest.mark.parametrize("impl", ["chunked", "block_causal", "flash"])
@pytest.mark.parametrize("Sq,q_offset", [(32, 0), (1, 32)])
def test_attention_dispatch(rng, dt, impl, Sq, q_offset, monkeypatch):
    """``attention`` takes the same branch as the reference under the same
    conditions (flash only for a prefill: q_offset 0 and more than one
    query) and gives its output."""
    tdt, jdt, tol = dt
    cfg = get_smoke_config("llama3_405b").replace(attn_impl=impl)
    jcfg = jax_smoke("llama3_405b").replace(attn_impl=impl)
    Skv = Sq + q_offset
    (q, jq), (k, jk), (v, jv) = _qkv(rng, 2, Sq, Skv, 8, 2, 8, tdt, jdt)
    taken = []
    for name in ("flash_attention", "block_causal_attention",
                 "chunked_attention"):
        fn = getattr(L, name)
        monkeypatch.setattr(L, name, lambda *a, _f=fn, _n=name, **kw:
                            taken.append(_n) or _f(*a, **kw))
    got = L.attention(q, k, v, causal=True, cfg=cfg, q_offset=q_offset)
    want = JL.attention(jq, jk, jv, causal=True, cfg=jcfg, q_offset=q_offset)
    expect = ("flash_attention" if impl == "flash" and q_offset == 0 else
              "block_causal_attention" if impl == "block_causal" and Sq > 1
              else "chunked_attention")
    assert taken == [expect]
    if expect == "flash_attention":     # the flash kernels' own tolerances
        tol = 3e-2 if tdt == torch.bfloat16 else 2e-5
    _close(got, want, tol)


def test_attention_takes_the_position_as_a_python_int():
    cfg = get_smoke_config("qwen1p5_0p5b").replace(attn_impl="flash")
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(TypeError, match="Python int"):
        L.attention(q, q, q, causal=True, cfg=cfg, q_offset=torch.tensor(0))


def test_init_dense_scale_and_dtype():
    gen = torch.Generator().manual_seed(0)
    w = L.init_dense(gen, (512, 256), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (512, 256)
    assert abs(w.float().std().item() - 512 ** -0.5) < 2e-3
    e = L.init_embed(gen, 100, 64, torch.float32)
    assert abs(e.std().item() - 1.0) < 0.05
