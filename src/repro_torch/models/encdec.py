"""Whisper-style encoder-decoder.  The audio conv frontend is a stub, as in
the reference: the batch carries precomputed frame embeddings ``frames``
(B, enc_positions, d_model); the transformer backbone (bidirectional
encoder, causal decoder with cross-attention) is implemented fully.

Twin of ``src/repro/models/encdec.py``.  Encoder self-attention and the
decoder's prefill attention (self and cross) go through
``layers.attention``, so ``attn_impl="flash"`` runs them on the flash
kernel; a decode step reads its caches through ``chunked_attention``, as
the reference.  The decode state has the reference's layout,
``{"self_k"/"self_v": (Ld, B, max_seq, n_kv, Dh), "cross_k"/"cross_v":
(Ld, B, enc_positions, n_kv, Dh), "pos": int}``; decode writes the new
self-attention rows in place.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L
from .layers import F32


def _attn(cfg: ModelConfig, device) -> L.Weights:
    dt, D, Dh = cfg.policy.p(), cfg.d_model, cfg.head_dim()
    return L.Weights({"wq": ((D, cfg.n_heads * Dh), dt, "dense"),
                      "wk": ((D, cfg.n_kv * Dh), dt, "dense"),
                      "wv": ((D, cfg.n_kv * Dh), dt, "dense"),
                      "wo": ((cfg.n_heads * Dh, D), dt, "dense")}, device)


def _mlp(cfg: ModelConfig, device) -> L.Weights:
    dt, D, Fd = cfg.policy.p(), cfg.d_model, cfg.d_ff
    return L.Weights({"w1": ((D, Fd), dt, "dense"), "b1": ((Fd,), dt, "zero"),
                      "w2": ((Fd, D), dt, "dense"), "b2": ((D,), dt, "zero")},
                     device)


def _norms(cfg: ModelConfig, names) -> dict:
    dt, D = cfg.policy.p(), cfg.d_model
    return {n: ((D,), dt, "zero" if n.endswith("_b") else "one")
            for n in names}


class EncoderLayer(L.Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(_norms(cfg, ("ln1", "ln2", "ln1_b", "ln2_b")),
                         device)
        self.attn = _attn(cfg, device)
        self.mlp = _mlp(cfg, device)


class DecoderLayer(L.Weights):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(_norms(cfg, ("ln1", "ln1_b", "ln_x", "ln_x_b", "ln2",
                                      "ln2_b")), device)
        self.attn = _attn(cfg, device)
        self.xattn = _attn(cfg, device)
        self.mlp = _mlp(cfg, device)


class EncDec(L.Weights):
    """The model's weights, named as the reference's pytree: ``enc_pos``
    (scale 0.02), the encoder layers and final norm, the (tied) embedding,
    the decoder layers and final norm."""

    def __init__(self, cfg: ModelConfig, device=None):
        dt, D = cfg.policy.p(), cfg.d_model
        super().__init__({"enc_pos": ((cfg.enc_positions, D), dt, 0.02),
                          **_norms(cfg, ("enc_ln", "enc_ln_b")),
                          "embed": ((cfg.vocab, D), dt, "embed"),
                          **_norms(cfg, ("dec_ln", "dec_ln_b"))}, device)
        self.cfg = cfg
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, device)
                                        for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, device)
                                        for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


Model = EncDec


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Random weights as the reference draws them, from ``gen`` on
    ``device`` (default: ``gen``'s); the stream is not ``jax.random``'s."""
    model = EncDec(cfg, device=device if device is not None else gen.device)
    L.reset_all_(model, gen)
    return model


def _mha(cfg: ModelConfig, ap, x, kv_src, *, causal: bool, cache=None,
         cache_pos: int = 0, fixed_cache=None):
    """Multi-head attention of x over itself or ``kv_src``.  With
    ``fixed_cache`` (k, v) it reads a fixed cross-attention cache; with
    ``cache`` (the self-attention buffers of one layer) it writes this
    call's rows at ``cache_pos`` and attends over the cache.  Returns
    (out, (k, v)) with this call's k, v (the cache with ``cache``; None
    with ``fixed_cache``)."""
    B, S, _ = x.shape
    Dh = cfg.head_dim()
    q = L.dense(x, ap.wq).reshape(B, S, cfg.n_heads, Dh)
    chunks = {"q_chunk": cfg.attn_q_chunk, "kv_chunk": cfg.attn_kv_chunk}
    if fixed_cache is not None:
        k, v = fixed_cache
        o = L.chunked_attention(q, k.to(q.dtype), v.to(q.dtype), causal=False,
                                **chunks)
        return L.dense(o.reshape(B, S, -1), ap.wo), None
    src = x if kv_src is None else kv_src
    Skv = src.shape[1]
    k = L.dense(src, ap.wk).reshape(B, Skv, cfg.n_kv, Dh)
    v = L.dense(src, ap.wv).reshape(B, Skv, cfg.n_kv, Dh)
    if cache is not None:
        ck, cv = cache
        ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
        o = L.chunked_attention(q, ck.to(q.dtype), cv.to(q.dtype), causal=True,
                                q_offset=cache_pos, **chunks)
        return L.dense(o.reshape(B, S, -1), ap.wo), (ck, cv)
    o = L.attention(q, k, v, causal=causal, cfg=cfg)
    return L.dense(o.reshape(B, S, -1), ap.wo), (k, v)


def _mlp_block(cfg: ModelConfig, lp, h):
    x = L.layer_norm(h, lp.ln2, lp.ln2_b, cfg.norm_eps)
    m = lp.mlp
    return h + L.gelu_mlp(x, m.w1, m.b1, m.w2, m.b2)


def encode(cfg: ModelConfig, params: EncDec, frames):
    """frames: (B, enc_positions, D) stub embeddings -> encoder output."""
    c = cfg.policy.c()
    h = frames.to(c) + params.enc_pos.to(c)

    def body(h, lp):
        x = L.layer_norm(h, lp.ln1, lp.ln1_b, cfg.norm_eps)
        h = h + _mha(cfg, lp.attn, x, None, causal=False)[0]
        return _mlp_block(cfg, lp, h)

    body = L.remat(cfg, body)
    for lp in params.enc_layers:
        h = body(h, lp)
    return L.layer_norm(h, params.enc_ln, params.enc_ln_b, cfg.norm_eps)


def _decoder_layer(cfg: ModelConfig, lp: DecoderLayer, h, enc_out, *,
                   self_cache=None, cross_cache=None, cache_pos: int = 0):
    """Returns (h, self (k, v), cross (k, v))."""
    x = L.layer_norm(h, lp.ln1, lp.ln1_b, cfg.norm_eps)
    a, new_self = _mha(cfg, lp.attn, x, None, causal=True, cache=self_cache,
                       cache_pos=cache_pos)
    h = h + a
    x = L.layer_norm(h, lp.ln_x, lp.ln_x_b, cfg.norm_eps)
    if cross_cache is not None:
        a, _ = _mha(cfg, lp.xattn, x, None, causal=False,
                    fixed_cache=cross_cache)
        new_cross = cross_cache
    else:
        a, new_cross = _mha(cfg, lp.xattn, x, enc_out, causal=False)
    return _mlp_block(cfg, lp, h + a), new_self, new_cross


def _embed(cfg: ModelConfig, params: EncDec, tokens, start: int):
    h = params.embed[tokens].to(cfg.policy.c())
    B, S = tokens.shape
    pos = torch.arange(start, start + S, device=h.device).expand(B, S)
    return h + L.sinusoid_positions(pos, cfg.d_model).to(h.dtype)


def _unembed(cfg: ModelConfig, params: EncDec, h):
    x = L.layer_norm(h, params.dec_ln, params.dec_ln_b, cfg.norm_eps)
    return L.matmul_f32(x, params.embed.T).to(cfg.policy.l())


def forward(cfg: ModelConfig, params: EncDec, batch):
    """batch: {"frames": (B, T_enc, D), "tokens": (B, S)} -> dec logits;
    the encoder's and the decoder's layers under ``cfg.remat``."""
    enc_out = encode(cfg, params, batch["frames"])
    h = _embed(cfg, params, batch["tokens"], 0)
    body = L.remat(cfg, lambda h, lp: _decoder_layer(cfg, lp, h, enc_out)[0])
    for lp in params.dec_layers:
        h = body(h, lp)
    return _unembed(cfg, params, h), torch.zeros((), dtype=F32,
                                                 device=h.device)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None):
    kdt, Dh, Ld = cfg.policy.k(), cfg.head_dim(), cfg.n_layers
    zeros = lambda n: torch.zeros((Ld, batch, n, cfg.n_kv, Dh),  # noqa: E731
                                  dtype=kdt, device=device)
    return {"self_k": zeros(max_seq), "self_v": zeros(max_seq),
            "cross_k": zeros(cfg.enc_positions),
            "cross_v": zeros(cfg.enc_positions), "pos": 0}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: EncDec, state, tokens):
    pos = int(state["pos"])
    if pos + tokens.shape[1] > state["self_k"].shape[2]:
        raise ValueError(f"KV cache full: position {pos} of "
                         f"{state['self_k'].shape[2]}")
    h = _embed(cfg, params, tokens, pos)
    for i, lp in enumerate(params.dec_layers):
        h, _, _ = _decoder_layer(
            cfg, lp, h, None, self_cache=(state["self_k"][i],
                                          state["self_v"][i]),
            cross_cache=(state["cross_k"][i], state["cross_v"][i]),
            cache_pos=pos)
    return _unembed(cfg, params, h), {**state, "pos": pos + tokens.shape[1]}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: EncDec, batch, max_seq: int):
    """Encode and run the decoder over the prompt, filling the self and
    cross caches."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"prompt of {S} positions exceeds max_seq={max_seq}")
    enc_out = encode(cfg, params, batch["frames"])
    h = _embed(cfg, params, tokens, 0)
    state = init_decode_state(cfg, B, max_seq, device=h.device)
    for i, lp in enumerate(params.dec_layers):
        h, (sk, sv), (xk, xv) = _decoder_layer(cfg, lp, h, enc_out)
        state["self_k"][i, :, :S] = sk
        state["self_v"][i, :, :S] = sv
        state["cross_k"][i] = xk
        state["cross_v"][i] = xv
    state["pos"] = S
    return _unembed(cfg, params, h), state
