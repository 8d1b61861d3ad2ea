"""Decoder-only transformer LM: the dense GQA family (qwen1.5, llama3,
minicpm) and the phi-3-vision backbone (stub patch embeddings prepended to
the token embeddings).

Twin of ``src/repro/models/transformer.py``.  The parameters are an
``nn.Module``, :class:`Transformer`: a ``ModuleList`` of decoder layers,
the embedding, the final norm and an untied head where the config asks
for one.  The functions take the config and that module, as the
reference's take the config and its params pytree, so one set of weights
can run under configs that differ in implementation knobs (``attn_impl``,
``policy``).  The layers loop in Python and everything runs eagerly; call
under ``torch.inference_mode()`` to serve.

The KV cache is a dict with the reference's layout, ``k`` and ``v`` of
shape (n_layers, B, max_seq, n_kv, Dh) at the policy's cache dtype, and
its position ``pos`` as a Python int, so attention's dispatch is decided
on the host.  ``decode_step`` writes the new key and value rows into the
cache's buffers in place (no copy of the cache a step) and returns them
with ``pos + 1``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L
from .layers import F32

MOE_ITEM = ("the MoE FFN (models/moe.py) is not ported yet: ROADMAP.md "
            "queue 1 item 15")


class DecoderLayer(nn.Module):
    """One pre-norm attention + SwiGLU block's weights, in the reference's
    per-layer shapes (its stacked arrays without the layer axis)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cfg.policy.p()
        Dh = cfg.head_dim()
        Hq, Hkv, D, Fd = cfg.n_heads, cfg.n_kv, cfg.d_model, cfg.d_ff
        shapes = {"ln1": (D,), "wq": (D, Hq * Dh), "wk": (D, Hkv * Dh),
                  "wv": (D, Hkv * Dh), "wo": (Hq * Dh, D), "ln2": (D,),
                  "wg": (D, Fd), "wu": (D, Fd), "wd": (Fd, D)}
        if cfg.qkv_bias:
            shapes |= {"bq": (Hq * Dh,), "bk": (Hkv * Dh,), "bv": (Hkv * Dh,)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dt, device=device),
                requires_grad=False))

    def bias(self, name: str):
        return getattr(self, name, None)


class Transformer(nn.Module):
    """The LM's weights (see the module docstring); the methods run the
    module-level functions under the config it was built with."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.n_experts:
            raise NotImplementedError(MOE_ITEM)
        self.cfg = cfg
        dt = cfg.policy.p()
        mk = lambda *shape: nn.Parameter(                     # noqa: E731
            torch.empty(shape, dtype=dt, device=device), requires_grad=False)
        self.embed = mk(cfg.vocab, cfg.d_model)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_f = mk(cfg.d_model)
        self.lm_head = None if cfg.tie_embeddings else mk(cfg.d_model,
                                                          cfg.vocab)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # module-level functions of the same names (globals, not these methods)
    def forward(self, tokens, *, extra_embeds=None):
        return forward(self.cfg, self, tokens, extra_embeds=extra_embeds)

    def embed_tokens(self, tokens, extra_embeds=None):
        return embed_tokens(self.cfg, self, tokens, extra_embeds)

    def unembed(self, h):
        return unembed(self.cfg, self, h)

    def init_cache(self, batch: int, max_seq: int):
        return init_cache(self.cfg, batch, max_seq, device=self.device)

    def prefill(self, tokens, max_seq: int, *, extra_embeds=None):
        return prefill(self.cfg, self, tokens, max_seq,
                       extra_embeds=extra_embeds)

    def decode_step(self, cache, tokens):
        return decode_step(self.cfg, self, cache, tokens)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Random weights as the reference draws them (norms one, biases zero,
    matrices N(0, 1/fan_in), the embedding N(0, 1)), from ``gen`` on its
    own device, on ``device`` (default: ``gen``'s).  The stream is not
    ``jax.random``'s: a test hands the reference's weights over with
    ``convert.lm_params_from_numpy``."""
    device = torch.device(device) if device is not None else gen.device
    model = Transformer(cfg, device=device)
    with torch.no_grad():
        for lyr in model.layers:
            for name, p in lyr.named_parameters():
                if name.startswith("ln"):
                    p.fill_(1.0)
                elif name.startswith("b"):
                    p.zero_()
                else:
                    p.copy_(L.init_dense(gen, p.shape, p.dtype))
        model.embed.copy_(L.init_embed(gen, cfg.vocab, cfg.d_model,
                                       model.embed.dtype))
        model.ln_f.fill_(1.0)
        if model.lm_head is not None:
            model.lm_head.copy_(L.init_dense(gen, model.lm_head.shape,
                                             model.lm_head.dtype))
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, lp: DecoderLayer, h, positions, *,
                cache=None, cache_pos: int = 0):
    """Pre-norm attention block.  With ``cache`` ((B, Smax, Hkv, Dh) k and v
    buffers of one layer) it runs decode against the cache, writing the
    new rows in place.  Returns (out, (k, v)) with this call's k and v."""
    B, S, _ = h.shape
    Dh = cfg.head_dim()
    x = L.rms_norm(h, lp.ln1, cfg.norm_eps)
    q = L.dense(x, lp.wq, lp.bias("bq")).reshape(B, S, cfg.n_heads, Dh)
    k = L.dense(x, lp.wk, lp.bias("bk")).reshape(B, S, cfg.n_kv, Dh)
    v = L.dense(x, lp.wv, lp.bias("bv")).reshape(B, S, cfg.n_kv, Dh)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = L.attention(q, k, v, causal=True, cfg=cfg)
    else:
        ck, cv = cache
        ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
        o = L.attention(q, ck.to(q.dtype), cv.to(q.dtype), causal=True,
                        cfg=cfg, q_offset=cache_pos)
    o = o.reshape(B, S, cfg.n_heads * Dh)
    return L.dense(o, lp.wo), (k, v)


def _ffn_block(cfg: ModelConfig, lp: DecoderLayer, h):
    x = L.rms_norm(h, lp.ln2, cfg.norm_eps)
    return L.swiglu(x, lp.wg, lp.wu, lp.wd)


def _layer(cfg: ModelConfig, h, lp: DecoderLayer, positions, cache=None,
           cache_pos: int = 0):
    a, kv = _attn_block(cfg, lp, h, positions, cache=cache,
                        cache_pos=cache_pos)
    h = h + a
    return h + _ffn_block(cfg, lp, h), kv


def embed_tokens(cfg: ModelConfig, params: Transformer, tokens,
                 extra_embeds=None):
    """Token embedding lookup; the VLM prepends stub patch embeddings."""
    h = params.embed[tokens].to(cfg.policy.c())
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    return h


def unembed(cfg: ModelConfig, params: Transformer, h):
    """Logits at the policy's logits dtype: the f32 sums of the head
    product in the compute dtype (``layers.matmul_f32``), cast once, as
    the reference."""
    x = L.rms_norm(h, params.ln_f, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return L.matmul_f32(x, head).to(cfg.policy.l())


def _positions(B: int, S: int, start: int, device):
    return torch.arange(start, start + S, device=device).expand(B, S)


def forward(cfg: ModelConfig, params: Transformer, tokens, *,
            extra_embeds=None):
    """Training/prefill forward: logits (B, S_total, V) and the aux loss
    (0 for the dense family)."""
    h = embed_tokens(cfg, params, tokens, extra_embeds)
    B, S, _ = h.shape
    positions = _positions(B, S, 0, h.device)
    for lp in params.layers:
        h, _ = _layer(cfg, h, lp, positions)
    return unembed(cfg, params, h), torch.zeros((), dtype=F32,
                                                device=h.device)


# ---------------------------------------------------------------------------
# KV cache serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.head_dim())
    kdt = cfg.policy.k()
    return {"k": torch.zeros(shape, dtype=kdt, device=device),
            "v": torch.zeros(shape, dtype=kdt, device=device), "pos": 0}


def decode_step(cfg: ModelConfig, params: Transformer, cache, tokens):
    """One-token decode: tokens (B, 1) + cache -> (logits (B, 1, V), cache).
    Raises when the cache is full (the reference's update would clamp its
    index and overwrite the last row)."""
    pos = int(cache["pos"])
    if pos + tokens.shape[1] > cache["k"].shape[2]:
        raise ValueError(f"KV cache full: position {pos} of "
                         f"{cache['k'].shape[2]}")
    h = embed_tokens(cfg, params, tokens)
    B, S, _ = h.shape
    positions = _positions(B, S, pos, h.device)
    for i, lp in enumerate(params.layers):
        h, _ = _layer(cfg, h, lp, positions,
                      cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
    logits = unembed(cfg, params, h)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + S}


def prefill(cfg: ModelConfig, params: Transformer, tokens, max_seq: int, *,
            extra_embeds=None):
    """Prompt processing: returns (logits, filled cache)."""
    h = embed_tokens(cfg, params, tokens, extra_embeds)
    B, S, _ = h.shape
    if S > max_seq:
        raise ValueError(f"prompt of {S} positions exceeds max_seq={max_seq}")
    positions = _positions(B, S, 0, h.device)
    cache = init_cache(cfg, B, max_seq, device=h.device)
    for i, lp in enumerate(params.layers):
        h, (k, v) = _layer(cfg, h, lp, positions)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    cache["pos"] = S
    return unembed(cfg, params, h), cache
