"""Zamba2-style hybrid: a Mamba-2 backbone with ONE shared transformer
block invoked after every ``shared_attn_every`` SSM layers (weight reuse
across depth, as in Zamba/Zamba2).  Decode carries per-layer SSM states
and one KV cache slot per shared-block invocation.

Twin of ``src/repro/models/hybrid.py``, with its simplification of the
released checkpoints: the shared block takes the hidden state directly
(no concat-with-embedding projector, no per-invocation LoRA).  The shared
block is ``transformer._layer`` on one ``transformer.DecoderLayer``.  The
decode state has the reference's layout, ``{"mamba": {"conv": (L, B, K-1,
Di+2N), "ssm": (L, B, H, Ph, N)}, "attn_k"/"attn_v": (n_shared, B,
max_seq, n_kv, Dh), "pos": int}``; decode writes into those buffers in
place.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L
from .layers import F32
from .mamba import Mamba2Layer, init_ssm_state, mamba2_block
from .transformer import DecoderLayer, _layer, position_ids, unembed


class Hybrid(L.Weights):
    """The LM's weights: embedding and final norm here (the head is tied),
    the Mamba-2 blocks in ``layers``, the shared block in ``shared_attn``."""

    def __init__(self, cfg: ModelConfig, device=None):
        dt, D = cfg.policy.p(), cfg.d_model
        super().__init__({"embed": ((cfg.vocab, D), dt, "embed"),
                          "ln_f": ((D,), dt, "one")}, device)
        self.cfg = cfg
        self.layers = nn.ModuleList(Mamba2Layer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.shared_attn = DecoderLayer(cfg, device)
        self.lm_head = None

    @property
    def device(self) -> torch.device:
        return self.embed.device


Model = Hybrid


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Random weights as the reference draws them, from ``gen`` on
    ``device`` (default: ``gen``'s); the stream is not ``jax.random``'s."""
    model = Hybrid(cfg, device=device if device is not None else gen.device)
    L.reset_all_(model, gen)
    return model


def group_slices(cfg: ModelConfig):
    """(start, length) of each Mamba-layer group and the number of shared
    invocations: one follows each full group of ``shared_attn_every``."""
    k = cfg.shared_attn_every
    n_full, rem = cfg.n_layers // k, cfg.n_layers % k
    slices = [(g * k, k) for g in range(n_full)]
    if rem:
        slices.append((n_full * k, rem))
    return slices, n_full


def _embed(cfg: ModelConfig, params: Hybrid, tokens):
    return params.embed[tokens].to(cfg.policy.c())


def forward(cfg: ModelConfig, params: Hybrid, tokens):
    h = _embed(cfg, params, tokens)
    B, S = tokens.shape
    positions = position_ids(B, S, 0, h.device)
    slices, n_shared = group_slices(cfg)
    # the Mamba-2 layers under cfg.remat, the shared block not (as the
    # reference)
    body = L.remat(cfg, lambda h, lp: mamba2_block(cfg, lp, h)[0])
    for gi, (start, length) in enumerate(slices):
        for lp in params.layers[start:start + length]:
            h = body(h, lp)
        if gi < n_shared:
            h, _, _ = _layer(cfg, h, params.shared_attn, positions)
    return unembed(cfg, params, h), torch.zeros((), dtype=F32,
                                                device=h.device)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None):
    one = init_ssm_state(cfg, batch, version=2, device=device)
    _, n_shared = group_slices(cfg)
    kv = (n_shared, batch, max_seq, cfg.n_kv, cfg.head_dim())
    return {"mamba": {k: v.new_zeros((cfg.n_layers, *v.shape))
                      for k, v in one.items()},
            "attn_k": torch.zeros(kv, dtype=cfg.policy.k(), device=device),
            "attn_v": torch.zeros(kv, dtype=cfg.policy.k(), device=device),
            "pos": 0}


def _run_groups(cfg: ModelConfig, params: Hybrid, h, positions, state, *,
                decode: bool):
    """The groups of Mamba layers and the shared-block invocations, each
    with its own KV slot: decode runs against the slots (the new rows
    written in place at ``state["pos"]``), prefill runs full-sequence
    attention and writes the fresh k, v into the slots.  Every layer's new
    SSM state goes into ``state["mamba"]``."""
    slices, n_shared = group_slices(cfg)
    pos, st = state["pos"], state["mamba"]
    for gi, (start, length) in enumerate(slices):
        for i in range(start, start + length):
            old = {"conv": st["conv"][i], "ssm": st["ssm"][i]} \
                if decode else None
            h, new = mamba2_block(cfg, params.layers[i], h, state=old)
            st["conv"][i], st["ssm"][i] = new["conv"], new["ssm"]
        if gi >= n_shared:
            continue
        ck, cv = state["attn_k"][gi], state["attn_v"][gi]
        if decode:
            h, _, _ = _layer(cfg, h, params.shared_attn, positions,
                             cache=(ck, cv), cache_pos=pos)
        else:
            h, _, (k, v) = _layer(cfg, h, params.shared_attn, positions)
            ck[:, :k.shape[1]] = k
            cv[:, :v.shape[1]] = v
    return h


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Hybrid, state, tokens):
    pos = int(state["pos"])
    if pos + tokens.shape[1] > state["attn_k"].shape[2]:
        raise ValueError(f"KV cache full: position {pos} of "
                         f"{state['attn_k'].shape[2]}")
    h = _embed(cfg, params, tokens)
    B, S = tokens.shape
    h = _run_groups(cfg, params, h, position_ids(B, S, pos, h.device), state,
                    decode=True)
    return unembed(cfg, params, h), {**state, "pos": pos + S}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Hybrid, tokens, max_seq: int):
    B, S = tokens.shape
    if S > max_seq:
        raise ValueError(f"prompt of {S} positions exceeds max_seq={max_seq}")
    h = _embed(cfg, params, tokens)
    state = init_decode_state(cfg, B, max_seq, device=h.device)
    h = _run_groups(cfg, params, h, position_ids(B, S, 0, h.device), state,
                    decode=False)
    state["pos"] = S
    return unembed(cfg, params, h), state
