"""The port's serving engine (``repro_torch.runtime.ServeEngine``) and its
CLI on the CPU, against the JAX package's, on the same weights
(``convert.lm_params_from_numpy``) and requests.

Greedy tokens must be equal.  The reference engine runs with
``attn_impl="chunked"``: with ``"flash"`` it fails in its first decode step
(its attention dispatch tests a traced cache position), and chunked
attention computes the same function.  Before comparing tokens the tests
assert that every greedy step's top-2 margin in the reference's logits is
above 1e-3, so that a difference is never a tie broken by rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import api as japi
from repro.models.policy import FULL_F32 as JAX_F32
from repro.runtime import Request as JRequest
from repro.runtime import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as cli
from repro_torch.models import api
from repro_torch.models.policy import FULL_F32
from repro_torch.runtime import Request, ServeEngine

MAX_SEQ = 64


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jc = jax_smoke(arch).replace(policy=JAX_F32)
    tc = get_smoke_config(arch).replace(policy=FULL_F32)
    params = japi.init_params(jc, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return jc, tc, params, model


def _prompts(vocab, seed=0, n=4):
    """tests/test_runtime.py's requests: prompt lengths 8 + i."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 8 + i, dtype=np.int32) for i in range(n)]


@pytest.mark.parametrize("arch", ["qwen1p5_0p5b", "llama3_405b"])
@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_greedy_tokens_match_jax_engine(arch, impl):
    jc, tc, params, model = _weights(arch)
    prompts = _prompts(tc.vocab)
    jeng = JServeEngine(jc, params, max_seq=MAX_SEQ)
    steps = []
    sample = jeng._sample
    jeng._sample = lambda logits: (steps.append(
        np.asarray(logits[:, -1], np.float32)), sample(logits))[1]
    want = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=5)
                       for i, p in enumerate(prompts)])
    assert len(steps) == 5 and steps[0].shape == (4, tc.vocab)  # one batch
    for lg in steps:
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3

    eng = ServeEngine(tc.replace(attn_impl=impl), model, max_seq=MAX_SEQ)
    got = eng.serve([Request(uid=i, prompt=p, max_new_tokens=5)
                     for i, p in enumerate(prompts)])
    assert [r.uid for r in got] == [0, 1, 2, 3]
    for g, w in zip(got, want):
        assert g.tokens.dtype == np.int32
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_flash_prefill_matches_jax_flash_prefill():
    """The reference's jitted flash prefill (Pallas in interpret mode)
    against the port's, on a left-padded serving batch: logits and the
    filled cache."""
    jc, tc, params, model = _weights("qwen1p5_0p5b")
    jc, tc = jc.replace(attn_impl="flash"), tc.replace(attn_impl="flash")
    prompts = _prompts(tc.vocab, seed=1)
    S = max(len(p) for p in prompts)
    toks = np.zeros((4, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    jl, jcache = jax.jit(lambda p, b: japi.prefill_step(jc, p, b, MAX_SEQ))(
        params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tl, cache = api.prefill_step(
            tc, model, {"tokens": torch.as_tensor(toks, dtype=torch.long)},
            MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=2e-4,
                                   atol=2e-4)
    assert cache["pos"] == int(jcache["pos"]) == S


def test_serve_buckets_and_orders():
    """tests/test_runtime.py:test_serve_engine_batches_and_orders, and the
    buckets: prompts of 8-11 tokens share one bucket of 16, a 20-token
    prompt gets its own, run as separate batches."""
    _, tc, _, model = _weights("qwen1p5_0p5b")
    eng = ServeEngine(tc, model, max_seq=MAX_SEQ)
    batches = []
    run_batch = eng.run_batch
    eng.run_batch = lambda reqs: (batches.append([r.uid for r in reqs]),
                                  run_batch(reqs))[1]
    prompts = _prompts(tc.vocab) + [np.arange(20, dtype=np.int32)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5 - (i == 4))
            for i, p in reversed(list(enumerate(prompts)))]
    results = eng.serve(reqs, bucket=16)
    assert [r.uid for r in results] == [0, 1, 2, 3, 4]
    assert [len(r.tokens) for r in results] == [5, 5, 5, 5, 4]
    assert batches == [[3, 2, 1, 0], [4]]


def test_serve_partitions_mixed_extras_batches():
    """tests/test_runtime.py:test_serve_partitions_mixed_extras_batches."""
    _, tc, _, model = _weights("qwen1p5_0p5b")
    eng = ServeEngine(tc, model, max_seq=MAX_SEQ)
    rng = np.random.default_rng(1)
    plain = [Request(uid=i, prompt=rng.integers(0, tc.vocab, 8,
                                                dtype=np.int32),
                     max_new_tokens=3) for i in range(2)]
    extra = [Request(uid=2 + i,
                     prompt=rng.integers(0, tc.vocab, 8, dtype=np.int32),
                     max_new_tokens=3,
                     extras={"aux": np.ones((2,), np.float32)})
             for i in range(2)]
    results = eng.serve(plain + extra)
    assert [r.uid for r in results] == [0, 1, 2, 3]
    assert all(len(r.tokens) == 3 for r in results)
    alone = ServeEngine(tc, model, max_seq=MAX_SEQ).serve(plain)
    for a, b in zip(alone, results[:2]):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_run_batch_rejects_mixed_extras():
    _, tc, _, model = _weights("qwen1p5_0p5b")
    eng = ServeEngine(tc, model, max_seq=MAX_SEQ)
    prompt = np.arange(8, dtype=np.int32)
    mixed = [Request(0, prompt, 2),
             Request(1, prompt, 2, extras={"aux": np.ones((2,), np.float32)})]
    with pytest.raises(ValueError, match="mixed extras"):
        eng.run_batch(mixed)


def test_eos_and_temperature():
    """EOS cuts a sequence after its first EOS; temperature sampling is
    reproducible from the engine's seed and stays in the vocabulary."""
    _, tc, _, model = _weights("llama3_405b")
    prompt = _prompts(tc.vocab)[0]
    greedy = ServeEngine(tc, model, max_seq=MAX_SEQ).serve(
        [Request(0, prompt, 6)])[0].tokens
    eos = int(greedy[2])
    cut = ServeEngine(tc, model, max_seq=MAX_SEQ, eos_id=eos).serve(
        [Request(0, prompt, 6)])[0].tokens
    first = int(np.argmax(greedy == eos))
    np.testing.assert_array_equal(cut, greedy[:first + 1])
    hot = [ServeEngine(tc, model, max_seq=MAX_SEQ, temperature=1.0,
                       seed=5).serve([Request(0, prompt, 6)])[0].tokens
           for _ in range(2)]
    np.testing.assert_array_equal(hot[0], hot[1])
    assert hot[0].min() >= 0 and hot[0].max() < tc.vocab


def test_cli_on_cpu(capsys):
    results = cli.main(["--arch", "qwen1p5_0p5b", "--device", "cpu",
                        "--requests", "3", "--max-new", "4"])
    assert [len(r.tokens) for r in results] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 12 tokens" in out and "on cpu" in out
    vlm = cli.main(["--arch", "phi3_vision_4p2b", "--device", "cpu",
                    "--requests", "2", "--max-new", "3"])
    assert [len(r.tokens) for r in vlm] == [3, 3]
