"""The families that serve through the port's non-dense paths, on the CPU
against the JAX package: the MoE transformer (granite-moe), the SSM LM
(falcon-mamba), the hybrid (zamba2) and the encoder-decoder (whisper),
each at its ``SMOKE_CONFIG`` with the reference's weights carried over by
``convert.lm_params_from_numpy``.

Bounds: at ``FULL_F32`` 2e-4 (rtol and atol), the reference's own
decode-against-forward bound; at the default policy (bf16 compute and
caches) the largest difference within 3e-2 of the largest |value|, for
logits and for every decode-state tensor, the reference run op by op
(its layers unrolled and not jitted, see ``_cfgs``).  The port runs
``attn_impl="flash"`` and the reference ``"chunked"``: the reference's
flash engine cannot decode (its dispatch tests a traced cache position),
and chunked attention computes the same function.  At the default policy
an MoE router can flip a near tie between the frameworks, so there the
granite rows are held where the chosen and the kept experts of the
row's token agree in every layer (both routings recorded from the calls).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.policy import FULL_F32 as JAX_F32
from repro.runtime import Request as JRequest
from repro.runtime import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.examples import serve_lm
from repro_torch.launch import serve as cli
from repro_torch.models import api, moe
from repro_torch.models.policy import FULL_F32
from repro_torch.runtime import Request, ServeEngine

FAMILIES = {"moe": "granite_moe_3b", "ssm": "falcon_mamba_7b",
            "hybrid": "zamba2_1p2b", "encdec": "whisper_base"}
ALL_ARCHS = ("qwen1p5_0p5b", "llama3_405b", "granite_moe_3b",
             "falcon_mamba_7b", "zamba2_1p2b", "whisper_base",
             "phi3_vision_4p2b")
MAX_SEQ = 24
S = 16


def _cfgs(arch, f32, impl="flash"):
    """The reference unrolls its layers (``scan_layers=False``, no remat) so
    that it runs op by op, each bf16 op rounding once as the port's do
    (the same function; under ``jit`` XLA fuses elementwise chains and
    rounds less often)."""
    jc = jax_smoke(arch).replace(attn_impl="chunked", scan_layers=False,
                                 remat="none")
    tc = get_smoke_config(arch).replace(attn_impl=impl)
    if f32:
        jc, tc = jc.replace(policy=JAX_F32), tc.replace(policy=FULL_F32)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _weights(arch, f32):
    jc, tc = _cfgs(arch, f32)
    params = japi.init_params(jc, jax.random.PRNGKey(13))
    model = lm_params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return params, model


def _batch(cfg, B, n, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, n), dtype=np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_positions, cfg.d_model), dtype=np.float32)
    return batch


def _t(batch):
    return {k: torch.as_tensor(v, dtype=torch.long if k == "tokens" else None)
            for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, f32, rows=None):
    """``rows``: a boolean mask over the leading (B, S) axes of both."""
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if rows is not None:
        got, want = got[rows], want[rows]
    if f32:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 3e-2, err


def _states(got, want, f32, rows=None):
    """Every tensor of a decode state, the reference's tree walked."""
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key]
        if not torch.is_tensor(g):
            assert g == int(w), path
            continue
        r = None
        if rows is not None and g.ndim == 5:   # (L, B, S_cache, H, Dh)
            r = np.zeros(g.shape[1:3], bool)
            r[:, :rows.shape[1]] = rows
            g, w = g.transpose(0, 1).transpose(1, 2), \
                jnp.moveaxis(jnp.asarray(w), 0, 2)
        _close(g, w, f32, r)


class _Routings:
    """Records each MoE call's chosen and kept experts per token, as (T, E)
    boolean masks, in both packages: the port's ``moe.route`` and the
    reference's ``moe_ffn`` as its transformer calls it (recomputed there
    with the reference's own ops, the model run eagerly)."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        route = moe.route

        def port_route(xg, router_w, **kw):
            r = route(xg, router_w, **kw)
            self.port.append(self._masks(r.idx.numpy(), r.keep.numpy(),
                                         router_w.shape[-1]))
            return r
        monkeypatch.setattr(moe, "route", port_route)
        ffn = jtransformer.moe_ffn

        def ref_ffn(x, router_w, wg, wu, wd, **kw):
            self.ref.append(self._ref_masks(x, router_w, **kw))
            return ffn(x, router_w, wg, wu, wd, **kw)
        monkeypatch.setattr(jtransformer, "moe_ffn", ref_ffn)

    @classmethod
    def _ref_masks(cls, x, router_w, *, top_k, capacity_factor, group_size):
        """The reference's routing, op for op (``moe_ffn`` and its
        ``_dispatch_group``)."""
        B, S_, D = x.shape
        E, T = router_w.shape[-1], B * S_
        gs = min(group_size, T)
        while T % gs:
            gs -= 1
        xg = x.reshape(T // gs, gs, D)
        probs = jax.nn.softmax(jnp.einsum(
            "gsd,de->gse", xg, router_w.astype(x.dtype),
            preferred_element_type=jnp.float32), axis=-1)
        gate, idx = jax.lax.top_k(probs, top_k)
        C = max(1, int(gs * top_k * capacity_factor / E))
        keep = jax.vmap(lambda a, i, g: jmoe._dispatch_group(a, i, g, E, C)[2])(
            xg, idx, gate)
        return cls._masks(np.asarray(idx), np.asarray(keep), E)

    @staticmethod
    def _masks(idx, keep, E):
        oh = np.eye(E, dtype=bool)[idx.reshape(-1, idx.shape[-1])]
        return oh.any(1), (oh & keep.reshape(-1, idx.shape[-1])[..., None]
                           ).any(1)

    def agree(self, B, n):
        """Tokens (B, n) whose masks agree in every call since the last
        ``agree``."""
        assert len(self.port) == len(self.ref) > 0
        ok = np.ones(B * n, bool)
        for (c1, k1), (c2, k2) in zip(self.port, self.ref):
            ok &= (c1 == c2).all(-1) & (k1 == k2).all(-1)
        self.port, self.ref = [], []
        return ok.reshape(B, n)


@pytest.mark.parametrize("f32", [True, False], ids=["full_f32", "default"])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_prefill_decode_match_jax(family, f32, monkeypatch):
    arch = FAMILIES[family]
    jc, tc = _cfgs(arch, f32)
    params, model = _weights(arch, f32)
    batch = _batch(tc, 2, S + 2)
    pre = {k: v[:, :S] if k == "tokens" else v for k, v in batch.items()}
    routes = _Routings(monkeypatch) if family == "moe" else None
    rows = lambda B, n: None if routes is None else \
        routes.agree(B, n)                                    # noqa: E731
    with torch.inference_mode():
        logits, _ = api.forward(tc, model, _t(batch))
        want, _ = japi.forward(jc, params, _j(batch))
        ok = rows(2, S + 2)
        _close(logits, want, f32, ok)

        tl, state = api.prefill_step(tc, model, _t(pre), MAX_SEQ)
        jl, jstate = japi.prefill_step(jc, params, _j(pre), MAX_SEQ)
        ok = rows(2, S)
        _close(tl, jl, f32, ok)
        _states(state, jstate, f32, ok)
        if ok is not None:
            assert ok.mean() >= 0.5 and (not f32 or ok.all()), ok

        for i in range(2):
            tok = batch["tokens"][:, S + i:S + i + 1]
            tl, state = api.decode_step(tc, model, state,
                                        torch.as_tensor(tok, dtype=torch.long))
            jl, jstate = japi.decode_step(jc, params, jstate, jnp.asarray(tok))
            step_ok = rows(2, 1)
            _close(tl, jl, f32, step_ok)
            if ok is not None:
                ok = np.concatenate([ok, step_ok], axis=1)
        _states(state, jstate, f32, ok)
    assert state["pos"] == S + 2


def _extras(cfg, seed):
    if cfg.family != "encdec":
        return None
    return {"frames": np.random.default_rng(seed).standard_normal(
        (cfg.enc_positions, cfg.d_model), dtype=np.float32)}


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_tokens_match_jax_engine(family):
    """tests/test_torch_serve.py's check for the other families: the same
    requests through both engines at FULL_F32, every greedy step's top-2
    margin in the reference's logits above 1e-3 first."""
    arch = FAMILIES[family]
    jc, tc = _cfgs(arch, True)
    params, model = _weights(arch, True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tc.vocab, 8 + i, dtype=np.int32)
               for i in range(4)]
    extras = _extras(tc, 4)
    jeng = JServeEngine(jc, params, max_seq=MAX_SEQ)
    steps = []
    sample = jeng._sample
    jeng._sample = lambda logits: (steps.append(
        np.asarray(logits[:, -1], np.float32)), sample(logits))[1]
    want = jeng.serve([JRequest(uid=i, prompt=p, max_new_tokens=5,
                                extras=extras) for i, p in enumerate(prompts)])
    assert len(steps) == 5 and steps[0].shape == (4, tc.vocab)   # one batch
    for lg in steps:
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3

    got = ServeEngine(tc, model, max_seq=MAX_SEQ).serve(
        [Request(uid=i, prompt=p, max_new_tokens=5, extras=extras)
         for i, p in enumerate(prompts)])
    assert [r.uid for r in got] == [0, 1, 2, 3]
    for g, w in zip(got, want):
        assert g.tokens.dtype == np.int32
        np.testing.assert_array_equal(g.tokens, w.tokens)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_leaf_is_carried_bit_for_bit(arch):
    """Each leaf of the reference's params pytree (a per-layer stack: each
    layer's slice) equals the port's parameter of the same path, bit for
    bit, with its dtype; a leaf the port has no parameter for is refused."""
    jc = jax_smoke(arch)
    params = jax.tree.map(np.asarray, japi.init_params(
        jc, jax.random.PRNGKey(2)))
    model = lm_params_from_numpy(get_smoke_config(arch), params,
                                 device="cpu")
    named = dict(model.named_parameters())
    stacks = ("layers", "enc_layers", "dec_layers")
    n = 0
    for path, leaf in _leaves(params):
        if path[0] in stacks:
            for i in range(leaf.shape[0]):
                p = named[".".join((path[0], str(i), *path[1:]))]
                assert str(p.dtype).split(".")[1] == leaf.dtype.name
                np.testing.assert_array_equal(p.detach().numpy(), leaf[i])
                n += 1
        else:
            p = named[".".join(path)]
            assert str(p.dtype).split(".")[1] == leaf.dtype.name
            np.testing.assert_array_equal(p.detach().numpy(), leaf)
            n += 1
    assert n == len(named)
    with pytest.raises(ValueError, match="no parameter"):
        lm_params_from_numpy(get_smoke_config(arch),
                             {**params, "extra": np.zeros(3)}, device="cpu")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_family_builds_and_serves_its_smoke_config(arch):
    """``api`` on every family: seeded init on the CPU, a decode state of
    the reference's shapes, and the ``serve_lm`` example twin."""
    tc = get_smoke_config(arch)
    model = api.init_params(tc, seed=1, device="cpu")
    assert model.device == torch.device("cpu")
    st = api.init_decode_state(tc, 2, 32, device="cpu")
    jst = japi.init_decode_state(jax_smoke(arch), 2, 32)
    _states({**st}, jax.tree.map(np.zeros_like, jst), True)
    results = serve_lm.main(["--arch", arch, "--device", "cpu",
                             "--requests", "3", "--max-new", "3"])
    assert [len(r.tokens) for r in results] == [3, 3, 3]
    assert all(0 <= r.tokens.min() and r.tokens.max() < tc.vocab
               for r in results)


def test_cli_serves_the_encoder_decoder(capsys):
    """``launch.serve`` hands whisper its stub frames, as the reference's
    launcher does, and serves every other family too."""
    results = cli.main(["--arch", "whisper_base", "--device", "cpu",
                        "--requests", "2", "--max-new", "3",
                        "--prompt-len", "10", "--max-seq", "32"])
    assert [len(r.tokens) for r in results] == [3, 3]
    assert "[serve] 2 requests, 6 tokens" in capsys.readouterr().out
    for arch in ("granite_moe_3b", "falcon_mamba_7b", "zamba2_1p2b"):
        assert len(cli.main(["--arch", arch, "--device", "cpu", "--requests",
                             "1", "--max-new", "2"])[0].tokens) == 2
