"""Uniform model API: family dispatch and the serving adapters.

Twin of the serving half of ``src/repro/models/api.py``:

    prefill_step(cfg, params, batch, max_seq) -> (logits, decode_state)
    decode_step(cfg, params, decode_state, tokens) -> (logits, decode_state)

``params`` is the family's weights module (``transformer.Transformer``)
and ``batch`` a dict of tensors.  The dense and VLM families are ported;
every other family raises ``NotImplementedError`` naming its ROADMAP item.
The training half (``loss_fn``, ``make_train_step``, the train-state
helpers) comes with the training slice.
"""

from __future__ import annotations

import torch

from ..backend import default_device
from ..configs.base import ModelConfig
from . import transformer

_NOT_PORTED = {
    "moe": transformer.MOE_ITEM,
    "ssm": "the SSM family (models/mamba.py, ssm_lm.py) is not ported yet: "
           "ROADMAP.md queue 1 item 15",
    "hybrid": "the hybrid family (models/hybrid.py) is not ported yet: "
              "ROADMAP.md queue 1 item 15",
    "encdec": "the encoder-decoder family (models/encdec.py) is not ported "
              "yet: ROADMAP.md queue 1 item 15",
}


def family_module(cfg: ModelConfig):
    if cfg.family in ("dense", "vlm"):
        return transformer
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[cfg.family])
    raise ValueError(f"unknown model family {cfg.family!r}")


def forward(cfg: ModelConfig, params, batch):
    mod = family_module(cfg)
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
    family_module(cfg)
    return transformer.init_cache(cfg, batch, max_seq,
                                  device=default_device(device))


def decode_step(cfg: ModelConfig, params, state, tokens):
    return family_module(cfg).decode_step(cfg, params, state, tokens)


def prefill_step(cfg: ModelConfig, params, batch, max_seq: int):
    mod = family_module(cfg)
    if cfg.family == "vlm":
        return mod.prefill(cfg, params, batch["tokens"], max_seq,
                           extra_embeds=batch["patch_embeds"])
    return mod.prefill(cfg, params, batch["tokens"], max_seq)
