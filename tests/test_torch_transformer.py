"""The port's decoder-only transformer (``repro_torch.models.transformer``
through ``repro_torch.models.api``) on the CPU, against the JAX package.

The JAX params pytree goes across as numpy arrays
(``convert.lm_params_from_numpy``), so both packages run the same weights
on the same tokens.  Bounds: at ``FULL_F32`` the reference's own
``test_decode_matches_forward_dense`` bound, 2e-4 (rtol and atol); at the
default policy (bf16 compute) the largest logit difference within 3e-2 of
the largest |logit| at 2 layers (bf16 rounds at other places in the two
frameworks).  The head itself (``unembed``) keeps the f32 sums at the
default policy as the reference does: on the same hidden state the two
agree within 1e-5 of the largest |logit|.  The reference cannot run a decode
step with ``attn_impl="flash"`` (its dispatch tests a traced position),
so the port's flash decode is held against the reference's chunked
decode, which computes the same function.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import api as japi
from repro.models import transformer as jtransformer
from repro.models.policy import FULL_F32 as JAX_F32
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import api, transformer
from repro_torch.models.policy import FULL_F32

MAX_SEQ = 24
S = 16


def _cfgs(arch, impl, f32):
    jc = jax_smoke(arch).replace(attn_impl=impl)
    tc = get_smoke_config(arch).replace(attn_impl=impl)
    if f32:
        jc, tc = jc.replace(policy=JAX_F32), tc.replace(policy=FULL_F32)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _weights(arch, f32):
    """JAX params and the port's module holding them (weights do not depend
    on attn_impl)."""
    jc, tc = _cfgs(arch, "chunked", f32)
    params = japi.init_params(jc, jax.random.PRNGKey(7))
    model = lm_params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return params, model


def _batch(cfg, B, n, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, n), dtype=np.int32)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), dtype=np.float32)
    return batch


def _t(batch):
    return {k: torch.as_tensor(v, dtype=torch.long if k == "tokens" else None)
            for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_logits(got, want, f32):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if f32:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 3e-2, err


def test_params_carried_across():
    params, model = _weights("qwen1p5_0p5b", True)
    assert len(model.layers) == 2 and model.lm_head is None
    for name, p in model.layers[1].named_parameters():
        np.testing.assert_array_equal(p.numpy(),
                                      np.asarray(params["layers"][name][1]))
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(params["embed"]))
    _, untied = _weights("llama3_405b", True)
    assert untied.lm_head is not None and untied.layers[0].bias("bq") is None


CASES = [(a, i, f) for a in ("qwen1p5_0p5b", "llama3_405b")
         for i in ("flash", "chunked") for f in (True, False)]


@pytest.mark.parametrize("arch,impl,f32", CASES)
def test_forward_prefill_decode_match_jax(arch, impl, f32):
    jc, tc = _cfgs(arch, impl, f32)
    jcc = jc.replace(attn_impl="chunked")       # the reference's decode path
    params, model = _weights(arch, f32)
    batch = _batch(tc, 2, S + 2)
    pre = {k: v[:, :S] for k, v in batch.items()}
    with torch.inference_mode():
        logits, _ = api.forward(tc, model, _t(batch))
        want, _ = jax.jit(lambda p, b: japi.forward(jc, p, b))(params,
                                                               _j(batch))
        _assert_logits(logits, want, f32)

        tl, cache = api.prefill_step(tc, model, _t(pre), MAX_SEQ)
        jl, jcache = jax.jit(lambda p, b: japi.prefill_step(jc, p, b,
                                                            MAX_SEQ))(
            params, _j(pre))
        _assert_logits(tl, jl, f32)
        assert cache["pos"] == S and tuple(cache["k"].shape) == \
            tuple(jcache["k"].shape)
        kv_tol = 2e-4 if f32 else 3e-2
        for name in ("k", "v"):
            np.testing.assert_allclose(
                cache[name].float().numpy(),
                np.asarray(jcache[name], np.float32), rtol=kv_tol,
                atol=kv_tol)

        jdec = jax.jit(lambda p, s, t: japi.decode_step(jcc, p, s, t))
        for i in range(2):
            tok = batch["tokens"][:, S + i:S + i + 1]
            tl, cache = api.decode_step(tc, model, cache,
                                        torch.as_tensor(tok, dtype=torch.long))
            jl, jcache = jdec(params, jcache, jnp.asarray(tok))
            _assert_logits(tl, jl, f32)
        assert cache["pos"] == S + 2


@pytest.mark.parametrize("arch", ["qwen1p5_0p5b", "llama3_405b"])
def test_unembed_keeps_f32_sums_at_the_default_policy(arch):
    """Tied (qwen) and untied (llama) heads at the default policy: the
    port's logits against the reference's on the same bf16 hidden state,
    at f32-summation resolution (rel 1e-5 of max |logit|).  Logits rounded
    to bf16 miss this by two orders of magnitude."""
    jc, tc = _cfgs(arch, "chunked", False)
    params, model = _weights(arch, False)
    h = np.random.default_rng(5).standard_normal((2, 9, tc.d_model))
    th = torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16)
    jh = jnp.asarray(h.astype(np.float32)).astype(jnp.bfloat16)
    with torch.inference_mode():
        got = transformer.unembed(tc, model, th)
    want = np.asarray(jax.jit(lambda p, x: jtransformer.unembed(jc, p, x))(
        params, jh), np.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("impl", ["flash", "chunked", "block_causal"])
def test_decode_matches_forward(impl):
    """The port's own KV-cache check: prefill of S tokens then decode steps
    give the full forward pass's logits at those positions (FULL_F32)."""
    _, tc = _cfgs("qwen1p5_0p5b", impl, True)
    _, model = _weights("qwen1p5_0p5b", True)
    toks = torch.as_tensor(_batch(tc, 2, S + 3, seed=2)["tokens"],
                           dtype=torch.long)
    with torch.inference_mode():
        full, _ = model.forward(toks)
        tl, cache = transformer.prefill(tc, model, toks[:, :S], MAX_SEQ)
        np.testing.assert_allclose(tl.numpy(), full[:, :S].numpy(),
                                   rtol=2e-4, atol=2e-4)
        for i in range(3):
            dl, cache = transformer.decode_step(tc, model, cache,
                                                toks[:, S + i:S + i + 1])
            np.testing.assert_allclose(dl[:, 0].numpy(),
                                       full[:, S + i].numpy(),
                                       rtol=2e-4, atol=2e-4)


def test_vlm_prefill_matches_jax():
    """The VLM backbone: stub patch embeddings prepended to the tokens."""
    jc, tc = _cfgs("phi3_vision_4p2b", "flash", True)
    params = japi.init_params(jc, jax.random.PRNGKey(3))
    model = lm_params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                 device="cpu")
    batch = _batch(tc, 2, 6)
    with torch.inference_mode():
        tl, cache = api.prefill_step(tc, model, _t(batch), MAX_SEQ)
    jl, _ = jax.jit(lambda p, b: japi.prefill_step(jc, p, b, MAX_SEQ))(
        params, _j(batch))
    assert cache["pos"] == 6 + tc.n_patches
    _assert_logits(tl, jl, True)


def test_cache_limits():
    _, tc = _cfgs("qwen1p5_0p5b", "flash", True)
    _, model = _weights("qwen1p5_0p5b", True)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="max_seq"):
            model.prefill(toks, 4)
        _, cache = model.prefill(toks, 8)
        with pytest.raises(ValueError, match="cache full"):
            model.decode_step(cache, toks[:, :1])


@pytest.mark.parametrize("arch", ["granite_moe_3b", "grok1_314b",
                                  "falcon_mamba_7b", "zamba2_1p2b",
                                  "whisper_base"])
def test_unported_families_raise(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.init_decode_state(cfg, 1, 8, device="cpu")
    if cfg.n_experts:
        with pytest.raises(NotImplementedError, match="MoE"):
            transformer.Transformer(cfg, device="cpu")


def test_init_params_draws_from_the_generator():
    cfg = get_smoke_config("qwen1p5_0p5b")
    a = api.init_params(cfg, seed=3, device="cpu")
    b = api.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert p.dtype == torch.float32
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    lyr = a.layers[0]
    assert torch.all(lyr.ln1 == 1) and torch.all(lyr.bq == 0)
    assert lyr.wq.std().item() == pytest.approx(cfg.d_model ** -0.5, rel=0.1)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = get_smoke_config("qwen1p5_0p5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_decode_state(cfg, 1, 8)
