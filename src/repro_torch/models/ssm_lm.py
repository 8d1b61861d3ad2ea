"""Pure-SSM language model (falcon-mamba-7b): embed -> N x Mamba-1 blocks
-> norm -> lm_head.  Decode carries per-layer (conv, ssm) states: O(1)
memory a token.

Twin of ``src/repro/models/ssm_lm.py``.  The decode state has the
reference's layout, ``{"state": {"conv": (L, B, K-1, Di), "ssm": (L, B,
Di, N)}, "pos": int}``; ``decode_step`` writes each layer's new state into
those buffers in place and returns them.  The recurrence needs no
position: ``pos`` only counts the tokens seen.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L
from .layers import F32
from .mamba import (Mamba1Layer, init_ssm_state, mamba1_block,
                    mamba1_block_lti_fft)
from .transformer import unembed


class SSMLM(L.Weights):
    """The LM's weights: embedding, final norm and untied head (where the
    config asks for one) here, the Mamba-1 blocks in ``layers``."""

    def __init__(self, cfg: ModelConfig, device=None):
        dt, D = cfg.policy.p(), cfg.d_model
        spec = {"embed": ((cfg.vocab, D), dt, "embed"),
                "ln_f": ((D,), dt, "one")}
        if not cfg.tie_embeddings:
            spec["lm_head"] = ((D, cfg.vocab), dt, "dense")
        super().__init__(spec, device)
        self.cfg = cfg
        self.layers = nn.ModuleList(Mamba1Layer(cfg, device)
                                    for _ in range(cfg.n_layers))
        if cfg.tie_embeddings:
            self.lm_head = None

    @property
    def device(self) -> torch.device:
        return self.embed.device


Model = SSMLM


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Random weights as the reference draws them, from ``gen`` on
    ``device`` (default: ``gen``'s); the stream is not ``jax.random``'s."""
    model = SSMLM(cfg, device=device if device is not None else gen.device)
    L.reset_all_(model, gen)
    return model


def _embed(cfg: ModelConfig, params: SSMLM, tokens):
    return params.embed[tokens].to(cfg.policy.c())


def forward(cfg: ModelConfig, params: SSMLM, tokens, *,
            lti_fft_mode: bool = False):
    h = _embed(cfg, params, tokens)
    body = L.remat(cfg, mamba1_block_lti_fft if lti_fft_mode
                   else lambda c, lp, h: mamba1_block(c, lp, h)[0])
    for lp in params.layers:
        h = body(cfg, lp, h)
    return unembed(cfg, params, h), torch.zeros((), dtype=F32,
                                                device=h.device)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int = 0,
                      device=None):
    one = init_ssm_state(cfg, batch, version=1, device=device)
    return {"state": {k: v.new_zeros((cfg.n_layers, *v.shape))
                      for k, v in one.items()}, "pos": 0}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: SSMLM, state, tokens):
    """tokens (B, 1) -> (logits, new state).  Constant work a token."""
    h = _embed(cfg, params, tokens)
    st = state["state"]
    for i, lp in enumerate(params.layers):
        h, new = mamba1_block(cfg, lp, h, state={"conv": st["conv"][i],
                                                 "ssm": st["ssm"][i]})
        st["conv"][i], st["ssm"][i] = new["conv"], new["ssm"]
    return unembed(cfg, params, h), {"state": st,
                                     "pos": state["pos"] + tokens.shape[1]}


@torch.no_grad()
def prefill(cfg: ModelConfig, params: SSMLM, tokens, max_seq: int = 0):
    """Prompt processing, carrying out the final states for decode."""
    h = _embed(cfg, params, tokens)
    state = init_decode_state(cfg, tokens.shape[0], device=h.device)
    st = state["state"]
    for i, lp in enumerate(params.layers):
        h, new = mamba1_block(cfg, lp, h)
        st["conv"][i], st["ssm"][i] = new["conv"], new["ssm"]
    state["pos"] = tokens.shape[1]
    return unembed(cfg, params, h), state
