"""Uniform model API: family dispatch and the serving adapters.

Twin of the serving half of ``src/repro/models/api.py``:

    prefill_step(cfg, params, batch, max_seq) -> (logits, decode_state)
    decode_step(cfg, params, decode_state, tokens) -> (logits, decode_state)

``params`` is the family's weights module (``transformer.Transformer``,
``ssm_lm.SSMLM``, ``hybrid.Hybrid``, ``encdec.EncDec``) and ``batch`` a
dict of tensors: ``tokens``, and the VLM's ``patch_embeds`` or the
encoder-decoder's ``frames``.  Every family is ported; the training half
(``loss_fn``, ``make_train_step``, the train-state helpers) comes with the
training slice.
"""

from __future__ import annotations

import torch

from ..backend import default_device
from ..configs.base import ModelConfig
from . import encdec, hybrid, ssm_lm, transformer

FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": ssm_lm, "hybrid": hybrid, "encdec": encdec}


def family_module(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return FAMILIES[cfg.family]


def forward(cfg: ModelConfig, params, batch):
    mod = family_module(cfg)
    if cfg.family == "encdec":
        return mod.forward(cfg, params, batch)
    if cfg.family == "vlm":
        return mod.forward(cfg, params, batch["tokens"],
                           extra_embeds=batch["patch_embeds"])
    return mod.forward(cfg, params, batch["tokens"])


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None, *,
                seed: int = 0, device=None):
    """Random weights on ``device`` (None: the card), drawn from
    ``generator``, or from a new one on that device seeded with ``seed``."""
    mod = family_module(cfg)
    dev = default_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return mod.init_params(cfg, generator, device=dev)


# ---------------------------------------------------------------------------
# serving adapters
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None):
    mod, dev = family_module(cfg), default_device(device)
    if mod is transformer:
        return transformer.init_cache(cfg, batch, max_seq, device=dev)
    return mod.init_decode_state(cfg, batch, max_seq, device=dev)


def decode_step(cfg: ModelConfig, params, state, tokens):
    return family_module(cfg).decode_step(cfg, params, state, tokens)


def prefill_step(cfg: ModelConfig, params, batch, max_seq: int):
    mod = family_module(cfg)
    if cfg.family == "encdec":
        return mod.prefill(cfg, params, batch, max_seq)
    if cfg.family == "vlm":
        return mod.prefill(cfg, params, batch["tokens"], max_seq,
                           extra_embeds=batch["patch_embeds"])
    return mod.prefill(cfg, params, batch["tokens"], max_seq)
