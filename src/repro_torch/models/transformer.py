"""Decoder-only transformer LM: the dense GQA family (qwen1.5, llama3,
minicpm, grok-1), the MoE family (granite-moe: the FFN is ``moe.moe_ffn``)
and the phi-3-vision backbone (stub patch embeddings prepended to the
token embeddings).

Twin of ``src/repro/models/transformer.py``.  The parameters are an
``nn.Module``, :class:`Transformer`: a ``ModuleList`` of decoder layers,
the embedding, the final norm and an untied head where the config asks
for one.  The functions take the config and that module, as the
reference's take the config and its params pytree, so one set of weights
can run under configs that differ in implementation knobs (``attn_impl``,
``policy``, ``remat``).  The layers loop in Python and everything runs
eagerly.  The parameters are trainable: :func:`forward` is differentiable
(each layer under ``cfg.remat``, ``layers.remat``), and the serving
entry points (:func:`prefill`, :func:`decode_step`) run under
``torch.no_grad()``, so they build no graph and take the flash path.

The KV cache is a dict with the reference's layout, ``k`` and ``v`` of
shape (n_layers, B, max_seq, n_kv, Dh) at the policy's cache dtype, and
its position ``pos`` as a Python int, so attention's dispatch is decided
on the host.  ``decode_step`` writes the new key and value rows into the
cache's buffers in place (no copy of the cache a step) and returns them
with ``pos + 1``.  :func:`_layer` is also the hybrid family's shared
attention block.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L
from .layers import F32
from .moe import moe_ffn


class DecoderLayer(L.Weights):
    """One pre-norm attention + FFN block's weights, in the reference's
    per-layer shapes (its stacked arrays without the layer axis): a SwiGLU
    FFN, or with ``n_experts`` the f32 router (D, E) and the expert stacks
    wg/wu (E, D, F), wd (E, F, D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        dt = cfg.policy.p()
        Dh = cfg.head_dim()
        Hq, Hkv, D, Fd = cfg.n_heads, cfg.n_kv, cfg.d_model, cfg.d_ff
        shapes = {"ln1": (D,), "wq": (D, Hq * Dh), "wk": (D, Hkv * Dh),
                  "wv": (D, Hkv * Dh), "wo": (Hq * Dh, D), "ln2": (D,)}
        E = cfg.n_experts
        shapes |= ({"wg": (E, D, Fd), "wu": (E, D, Fd), "wd": (E, Fd, D)}
                   if E else {"wg": (D, Fd), "wu": (D, Fd), "wd": (Fd, D)})
        if cfg.qkv_bias:
            shapes |= {"bq": (Hq * Dh,), "bk": (Hkv * Dh,), "bv": (Hkv * Dh,)}
        spec = {n: (shape, dt, "one" if n.startswith("ln") else
                    "zero" if n.startswith("b") else "dense")
                for n, shape in shapes.items()}
        if E:
            spec["router"] = ((D, E), F32, "dense")
        super().__init__(spec, device)

    def bias(self, name: str):
        return getattr(self, name, None)


class Transformer(L.Weights):
    """The LM's weights (see the module docstring): embedding, final norm
    and untied head (where the config asks for one) here, the decoder
    layers in ``layers``; the methods run the module-level functions under
    the config it was built with."""

    def __init__(self, cfg: ModelConfig, device=None):
        dt, D = cfg.policy.p(), cfg.d_model
        spec = {"embed": ((cfg.vocab, D), dt, "embed"),
                "ln_f": ((D,), dt, "one")}
        if not cfg.tie_embeddings:
            spec["lm_head"] = ((D, cfg.vocab), dt, "dense")
        super().__init__(spec, device)
        self.cfg = cfg
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        if cfg.tie_embeddings:
            self.lm_head = None

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


Model = Transformer       # each family module's weights class


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Random weights as the reference draws them (norms one, biases zero,
    matrices N(0, 1/fan_in), the embedding N(0, 1)), from ``gen`` on its
    own device, on ``device`` (default: ``gen``'s).  The stream is not
    ``jax.random``'s: a test hands the reference's weights over with
    ``convert.lm_params_from_numpy``."""
    model = Transformer(cfg, device=device if device is not None
                        else gen.device)
    L.reset_all_(model, gen)
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
    """The FFN and its aux loss (0.0 without experts)."""
    x = L.rms_norm(h, lp.ln2, cfg.norm_eps)
    if cfg.n_experts:
        return moe_ffn(x, lp.router, lp.wg, lp.wu, lp.wd, top_k=cfg.top_k,
                       capacity_factor=cfg.capacity_factor,
                       group_size=cfg.moe_group)
    return L.swiglu(x, lp.wg, lp.wu, lp.wd), 0.0


def _layer(cfg: ModelConfig, h, lp: DecoderLayer, positions, cache=None,
           cache_pos: int = 0):
    """One block: returns (h, aux, (k, v) of this call)."""
    a, kv = _attn_block(cfg, lp, h, positions, cache=cache,
                        cache_pos=cache_pos)
    h = h + a
    f, aux = _ffn_block(cfg, lp, h)
    return h + f, aux, kv


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


def position_ids(B: int, S: int, start: int, device):
    return torch.arange(start, start + S, device=device).expand(B, S)


def forward(cfg: ModelConfig, params: Transformer, tokens, *,
            extra_embeds=None):
    """Training/prefill forward: logits (B, S_total, V) and the mean aux
    loss over the layers (0 for the dense family); each layer under
    ``cfg.remat``."""
    h = embed_tokens(cfg, params, tokens, extra_embeds)
    B, S, _ = h.shape
    positions = position_ids(B, S, 0, h.device)

    def body(h, lp):
        h, a, _ = _layer(cfg, h, lp, positions)
        return h, a

    body = L.remat(cfg, body)
    aux = torch.zeros((), dtype=F32, device=h.device)
    for lp in params.layers:
        h, a = body(h, lp)
        aux = aux + a
    return unembed(cfg, params, h), aux / cfg.n_layers


# ---------------------------------------------------------------------------
# KV cache serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.head_dim())
    kdt = cfg.policy.k()
    return {"k": torch.zeros(shape, dtype=kdt, device=device),
            "v": torch.zeros(shape, dtype=kdt, device=device), "pos": 0}


@torch.no_grad()
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
    positions = position_ids(B, S, pos, h.device)
    for i, lp in enumerate(params.layers):
        h, _, _ = _layer(cfg, h, lp, positions,
                         cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
    logits = unembed(cfg, params, h)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + S}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Transformer, tokens, max_seq: int, *,
            extra_embeds=None):
    """Prompt processing: returns (logits, filled cache)."""
    h = embed_tokens(cfg, params, tokens, extra_embeds)
    B, S, _ = h.shape
    if S > max_seq:
        raise ValueError(f"prompt of {S} positions exceeds max_seq={max_seq}")
    positions = position_ids(B, S, 0, h.device)
    cache = init_cache(cfg, B, max_seq, device=h.device)
    for i, lp in enumerate(params.layers):
        h, _, (k, v) = _layer(cfg, h, lp, positions)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    cache["pos"] = S
    return unembed(cfg, params, h), cache
