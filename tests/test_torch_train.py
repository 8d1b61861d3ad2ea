"""The port's training path (``models.api`` training half, ``optim``)
against the JAX package's, on the CPU.

Every architecture at its ``SMOKE_CONFIG``: the reference's train state
(``init_train_state``) is carried over by ``convert.train_state_from_numpy``,
both packages take the reference pipeline's batch (numpy), and the port's
``loss_fn`` and one ``make_train_step`` are held against the reference's:
loss, ce, aux and grad norm as scalars, the new parameters and the AdamW
moments as whole states (each part's leaves concatenated, the 2-norm of
the difference over the 2-norm of the reference's).

Bounds: at ``FULL_F32`` (here) 1e-5 relative for every scalar and
state, the reference jitted (the port's f32 op order differs from XLA's
by summation order only).  At the default policy (bf16 compute;
``test_torch_train_default.py``, a file of its own so that it runs
beside this one) 3e-2, the forward tests' bound, for the scalars and the
parameters; the moments (the gradient's, and its square's) at 2e-1,
because under ``jit`` XLA fuses bf16 elementwise chains and rounds less
often than either package's op-by-op path (measured: up to 4.6e-2 for mu
and 3.3e-2 for nu, granite, without x64).  zamba2's jitted reference
departs further (8.5e-2 in grad norm with the tests' x64 on), so zamba2
runs the reference op by op (``scan_layers=False``, no remat, not
jitted, as ``test_torch_families.py`` does) and is held at 3e-2
everywhere; each of that reference's ops compiles on first use, so only
where needed.  The port trains under its default ``remat="full"``.

The optimizer pieces are held at 1e-6 relative (the schedules; AdamW
with clipping at both state dtypes at 2e-6: the global norm sums in
another order, so the clipping scale can differ by an ulp) or bit for
bit (the compressor's codecs, on the reference's stacked leaves against
the port's per-layer parameters).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_smoke
from repro.data import SyntheticPipeline as JaxPipeline
from repro.models import api as japi
from repro.models.policy import FULL_F32 as JAX_F32
from repro.optim import AdamW as JaxAdamW
from repro.optim import Compressor as JaxCompressor
from repro.optim import constant_schedule as jax_constant
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import wsd_schedule as jax_wsd
from repro_torch.configs import get_smoke_config
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.models import api, layers
from repro_torch.models.policy import FULL_F32
from repro_torch.optim import (AdamW, Compressor, constant_schedule,
                               cosine_schedule, wsd_schedule)

LR = 1e-3
# (scalars and parameters, moments) per policy
TOL = {"full_f32": (1e-5, 1e-5), "default": (3e-2, 2e-1),
       "default_op_by_op": (3e-2, 3e-2)}


def _cfgs(arch, policy):
    tc = get_smoke_config(arch)
    if policy == "full_f32":
        return jax_smoke(arch).replace(policy=JAX_F32), \
            tc.replace(policy=FULL_F32)
    if policy == "default_op_by_op":
        return jax_smoke(arch).replace(scan_layers=False, remat="none"), tc
    return jax_smoke(arch), tc


def _np32(x):
    return x.float().numpy() if torch.is_tensor(x) else \
        np.asarray(x, np.float32)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=torch.is_tensor)


def _state_rel(got, want) -> float:
    g = np.concatenate([_np32(x).ravel() for x in _leaves(got)])
    w = np.concatenate([_np32(x).ravel() for x in _leaves(want)])
    assert g.shape == w.shape
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _scalar_rel(got, want) -> float:
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-30) if want else abs(got)


def _batch(jc, tc, B=2, S=16, seed=1):
    """The reference pipeline's first batch, as jax arrays and as the
    port's tensors."""
    pipe = JaxPipeline(jc, B, S, seed=seed)
    _, jb = pipe.next(pipe.init_state())
    tb = {}
    for k, v in jb.items():
        a = np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                       else v)
        tb[k] = torch.as_tensor(a).to(torch.long if k in ("tokens", "labels")
                                      else tc.policy.c())
    return jb, tb


def check_train_step(arch, policy):
    """One ``loss_fn`` and one ``make_train_step`` of both packages from
    the same state on the same batch, held at ``TOL[policy]``."""
    jc, tc = _cfgs(arch, policy)
    jopt = JaxAdamW(schedule=jax_constant(LR))
    topt = AdamW(schedule=constant_schedule(LR))
    jstate = japi.init_train_state(jc, jopt, jax.random.PRNGKey(3))
    state = train_state_from_numpy(tc, jax.tree.map(np.asarray, jstate),
                                   device="cpu")
    jb, tb = _batch(jc, tc)
    loss, parts = api.loss_fn(tc, state["params"], tb)

    jstep = japi.make_train_step(jc, jopt)
    jstate2, jm = (jstep if policy == "default_op_by_op" else
                   jax.jit(jstep))(jstate, jb)
    state2, m = api.make_train_step(tc, topt)(state, tb)

    tol, moment_tol = TOL[policy]
    assert _scalar_rel(loss, jm["loss"]) <= tol
    for k in ("ce", "aux"):
        assert _scalar_rel(parts[k], jm[k]) <= tol, k
    assert float(m["loss"]) == float(loss)
    assert _scalar_rel(m["grad_norm"], jm["grad_norm"]) <= tol
    got = train_state_to_numpy(tc, state2)
    want = jax.tree.map(np.asarray, jstate2)
    assert int(got["step"]) == int(want["step"]) == 1
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == 1
    assert _state_rel(got["params"], want["params"]) <= tol
    assert _state_rel(got["opt"]["mu"], want["opt"]["mu"]) <= moment_tol
    assert _state_rel(got["opt"]["nu"], want["opt"]["nu"]) <= moment_tol


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_reference(arch):
    check_train_step(arch, "full_f32")


def test_loss_gathers_what_the_one_hot_contracts():
    """On one device ``log_softmax``'s gather of the label logit is the
    reference's one-hot contraction, bit for bit: each one-hot row sums
    one term and exact zeros."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((2, 5, 33), generator=g) * 4
    labels = torch.randint(0, 33, (2, 5), generator=g)
    onehot = torch.nn.functional.one_hot(labels, 33).to(torch.float32)
    assert torch.equal((logits * onehot).sum(-1),
                       logits.gather(-1, labels[..., None])[..., 0])


# ---------------------------------------------------------------------------
# schedules, AdamW, compression
# ---------------------------------------------------------------------------

SCHEDULES = {"cosine": ((1e-3, 10, 100), cosine_schedule, jax_cosine),
             "cosine_no_warmup": ((3e-4, 0, 50, 0.2), cosine_schedule,
                                  jax_cosine),
             "wsd": ((1e-3, 10, 60, 30), wsd_schedule, jax_wsd),
             "constant": ((2e-4,), constant_schedule, jax_constant)}


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedules_match_reference(name):
    args, port, ref = SCHEDULES[name]
    steps = np.arange(0, 201, dtype=np.int32)
    got = np.array([port(*args)(torch.tensor(int(s), dtype=torch.int32))
                    .item() for s in steps], np.float32)
    want = np.array([ref(*args)(jnp.asarray(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert port(*args)(torch.tensor(3)).dtype == torch.float32


def _grads(rng, scale):
    shapes = {"a": (5, 7), "b": (3,), "c": (2, 4, 3)}
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-2, 10.0], ids=["unclipped",
                                                         "clipped"])
def test_adamw_matches_reference(state_dtype, grad_scale):
    """Three steps of AdamW (cosine warmup, weight decay on every
    parameter, global-norm clipping on or off) from the same parameters
    and gradients."""
    rng = np.random.default_rng(7)
    params = {k: v * 10 for k, v in _grads(rng, 0.1).items()}
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.1, grad_clip=1.0,
              state_dtype=state_dtype)
    jopt = JaxAdamW(schedule=jax_cosine(1e-2, 2, 10), **kw)
    topt = AdamW(schedule=cosine_schedule(1e-2, 2, 10), **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g = _grads(rng, grad_scale)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.tensor(v) for k, v in g.items()}
        assert _scalar_rel(topt.global_norm(tg), jopt.global_norm(jg)) < 1e-6
        upd, js = jopt.update(jg, js, jp)
        jp = jax.tree.map(lambda p, u: (p + u).astype(p.dtype), jp, upd)
        ts = topt.update_(tg, ts, tp)
    assert int(ts["count"]) == int(js["count"]) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=2e-6, atol=1e-7)
        for part in ("mu", "nu"):
            assert ts[part][k].dtype == getattr(torch, state_dtype)
            np.testing.assert_allclose(_np32(ts[part][k]),
                                       _np32(js[part][k]), rtol=2e-6,
                                       atol=1e-12)


def _stacked_grads(rng):
    """A reference gradient tree (a layer stack of 3 whose layers differ
    in size by 100x, so one scale a layer would quantize otherwise) and
    its per-layer twin under the port's parameter names."""
    w = rng.standard_normal((3, 4, 5)).astype(np.float32)
    w *= np.array([1.0, 0.1, 0.001], np.float32)[:, None, None]
    tree = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "layers": {"w": w, "b": rng.standard_normal((3, 5)).astype(
                np.float32)}}
    named = {"embed": tree["embed"],
             **{f"layers.{i}.w": w[i] for i in range(3)},
             **{f"layers.{i}.b": tree["layers"]["b"][i] for i in range(3)}}
    return tree, named


def _per_layer(tree):
    return {"embed": tree["embed"],
            **{f"layers.{i}.{k}": tree["layers"][k][i]
               for i in range(3) for k in ("w", "b")}}


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_compressor_matches_reference_on_stacked_leaves(codec):
    """Five rounds with error feedback: the decompressed gradients and the
    buffers bit for bit (int8: one scale over each reference leaf's
    layers)."""
    rng = np.random.default_rng(11)
    jc, tc = JaxCompressor(codec), Compressor(codec)
    jefb = tefb = None
    for r in range(5):
        tree, named = _stacked_grads(rng)
        jout, jefb = jc.compress_decompress(
            jax.tree.map(jnp.asarray, tree), jefb)
        tout, tefb = tc.compress_decompress(
            {k: torch.tensor(v) for k, v in named.items()}, tefb)
        want = _per_layer(jax.tree.map(np.asarray, jout))
        for k, v in want.items():
            np.testing.assert_array_equal(tout[k].numpy(), v)
        if codec == "int8":
            for k, v in _per_layer(jax.tree.map(np.asarray, jefb)).items():
                np.testing.assert_array_equal(tefb[k].numpy(), v)
            if r == 0:
                # the smallest layer rounds at the largest layer's scale:
                # most of it quantizes to zero, which one scale a layer
                # would not do
                assert (tout["layers.2.w"] == 0).float().mean() > 0.5
        else:
            assert tefb is None and jefb is None


def test_compressor_error_feedback_reduces_bias():
    comp = Compressor("int8")
    g = {"w": torch.linspace(-1, 1, 1000)}
    efb, total = None, torch.zeros(1000)
    for _ in range(20):
        out, efb = comp.compress_decompress(g, efb)
        total += out["w"]
    np.testing.assert_allclose((total / 20).numpy(), g["w"].numpy(),
                               atol=1e-3)


# ---------------------------------------------------------------------------
# the model's training repairs: trainable weights, remat, flash refusal
# ---------------------------------------------------------------------------

def _small(arch="qwen1p5_0p5b", **kw):
    cfg = get_smoke_config(arch).replace(policy=FULL_F32, **kw)
    state = api.init_train_state(cfg, AdamW(constant_schedule(LR)), seed=0,
                                 device="cpu")
    pipe = JaxPipeline(jax_smoke(arch), 2, 32, seed=4)
    _, jb = pipe.next(pipe.init_state())
    return cfg, state, {k: torch.tensor(np.asarray(jb[k])).long()
                        for k in ("tokens", "labels")}


def test_parameters_train_and_serving_builds_no_graph():
    cfg, state, batch = _small()
    model = state["params"]
    assert all(p.requires_grad for p in model.parameters())
    loss, _ = api.loss_fn(cfg, model, batch)
    assert loss.requires_grad
    with torch.enable_grad():
        logits, cache = api.prefill_step(cfg, model, {"tokens":
                                                      batch["tokens"]}, 40)
        step, _ = api.decode_step(cfg, model, cache, batch["tokens"][:, :1])
    assert not logits.requires_grad and not step.requires_grad
    assert not cache["k"].requires_grad


def _saved_and_flops(fn, params):
    """The bytes autograd saves through its hooks in the forward of the
    loss ``fn()``, the matrix-product FLOPs of forward and backward, and
    the gradients."""
    from torch.utils.flop_counter import FlopCounterMode
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with FlopCounterMode(display=False) as fc:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = fn()
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
    return total, fc.get_total_flops(), grads


@pytest.mark.parametrize("arch", ["qwen1p5_0p5b", "falcon_mamba_7b",
                                  "zamba2_1p2b", "whisper_base"])
def test_remat_policies_give_the_same_gradients(arch):
    """``remat`` full / dots / none: the same gradients bit for bit (the
    recomputation repeats the forward's ops), and real rematerialisation:
    "full" and "dots" save less through autograd than "none" (only each
    layer's inputs), "full" runs the layers' products again in backward
    and "dots" does not (it keeps their outputs)."""
    cfg, state, batch = _small(arch)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.enc_positions, cfg.d_model),
                                      generator=torch.Generator()
                                      .manual_seed(2))
    model = state["params"]
    names, params = zip(*model.named_parameters())
    saved, flops, grads = {}, {}, {}
    for remat in ("full", "dots", "none"):
        c = cfg.replace(remat=remat)
        saved[remat], flops[remat], grads[remat] = _saved_and_flops(
            lambda: api.loss_fn(c, model, batch)[0], params)
    for remat in ("dots", "none"):
        for n, a, b in zip(names, grads["full"], grads[remat]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    assert saved["full"] == saved["dots"] < saved["none"], saved
    assert flops["full"] > flops["dots"] == flops["none"], flops


def test_flash_refuses_gradients():
    """The flash kernel has no backward (nor has the reference's): a call
    autograd would differentiate raises, under no_grad it runs."""
    cfg, state, batch = _small(attn_impl="flash")
    with pytest.raises(RuntimeError, match="no backward"):
        api.loss_fn(cfg, state["params"], batch)
    with pytest.raises(RuntimeError, match="no backward"):
        api.make_train_step(cfg, AdamW(constant_schedule(LR)))(state, batch)
    q = torch.randn((1, 8, 4, 16), requires_grad=True)
    k = v = torch.randn((1, 8, 4, 16))
    with pytest.raises(RuntimeError, match="chunked"):
        layers.attention(q, k, v, causal=True, cfg=cfg)
    with torch.no_grad():
        layers.attention(q, k, v, causal=True, cfg=cfg)
        api.loss_fn(cfg, state["params"], batch)
    # the reference's default, chunked attention, trains
    api.loss_fn(cfg.replace(attn_impl="chunked"), state["params"],
                batch)[0].backward()


def test_sharded_training_raises():
    cfg, _, _ = _small()
    opt = AdamW(constant_schedule(LR))
    for call in (lambda: api.make_train_step(cfg, opt, logit_sharding=1),
                 lambda: api.train_state_specs(cfg, opt, {"data": 1}),
                 lambda: opt.state_specs({})):
        with pytest.raises(NotImplementedError, match="item 13"):
            call()
