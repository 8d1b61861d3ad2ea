"""Uniform model API: family dispatch, the loss, and the train and serve
step builders.

Twin of ``src/repro/models/api.py``:

    train_step(state, batch) -> (state, metrics)
    prefill_step(cfg, params, batch, max_seq) -> (logits, decode_state)
    decode_step(cfg, params, decode_state, tokens) -> (logits, decode_state)

``params`` is the family's weights module (``transformer.Transformer``,
``ssm_lm.SSMLM``, ``hybrid.Hybrid``, ``encdec.EncDec``) and ``batch`` a
dict of tensors: ``tokens`` (and ``labels`` to train), and the VLM's
``patch_embeds`` or the encoder-decoder's ``frames``.  A train state is
``{"params": module, "opt": {"mu", "nu", "count"}, "step", ["efb"]}``,
the moments and buffers dicts keyed by parameter name, the counts int32
CPU tensors (``convert.train_state_to_numpy`` gives the reference's
tree).  Every family trains and serves.
"""

from __future__ import annotations

import torch

from ..backend import default_device
from ..configs.base import ModelConfig
from . import encdec, hybrid, ssm_lm, transformer
from .layers import F32

_ONE_DEVICE = ("{} has no meaning on one card: sharded training is ROADMAP "
               "item 13b (multi-device)")

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


def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight: float = 0.01,
            logit_sharding=None):
    """Next-token cross entropy plus ``aux_weight`` times the MoE aux loss;
    the VLM's patch positions are left out.  Returns (loss, {"ce",
    "aux"}), 0-d f32 tensors.

    The reference contracts the f32 logits with an f32 one-hot of the
    labels, a workaround for GSPMD, which would all-gather vocab-sharded
    logits for a gather.  On one card the gather of each row's label
    logit is the same value (each one-hot row sums one term and exact
    zeros) without the (B, S, V) f32 one-hot: 5 GB at qwen1.5-0.5b's
    vocabulary and a (2, 4096) batch."""
    if logit_sharding is not None:
        raise NotImplementedError(_ONE_DEVICE.format("logit_sharding"))
    logits, aux = forward(cfg, params, batch)
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_patches:]
    logits = logits.to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    label = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    ce = -torch.mean(label - logz)
    aux = torch.as_tensor(aux, dtype=F32, device=ce.device)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


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


# ---------------------------------------------------------------------------
# train step builder
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, optimizer, *, grad_compressor=None,
                    logit_sharding=None):
    """Build ``train_step(state, batch) -> (state, metrics)``, which
    updates the state's tensors in place (the reference donates its
    state to the jitted step) and returns it with ``step`` plus one.

    ``grad_compressor`` (``optim.Compressor``) rounds or quantizes the
    gradients before the update, its error-feedback buffers in
    ``state["efb"]``.  The metrics (``loss``, ``ce``, ``aux``,
    ``grad_norm``) stay 0-d tensors on the device: reading them is the
    caller's choice."""
    if logit_sharding is not None:
        raise NotImplementedError(_ONE_DEVICE.format("logit_sharding"))

    def train_step(state, batch):
        model = state["params"]
        names, params = zip(*model.named_parameters())
        loss, metrics = loss_fn(cfg, model, batch)
        grads = dict(zip(names, torch.autograd.grad(
            loss, params, allow_unused=True, materialize_grads=True)))
        efb = state.get("efb")
        if grad_compressor is not None:
            grads, efb = grad_compressor.compress_decompress(grads, efb)
        gnorm = optimizer.global_norm(grads)
        opt = optimizer.update_(grads, state["opt"], dict(zip(names, params)),
                                gnorm=gnorm)
        new_state = {"params": model, "opt": opt, "step": state["step"] + 1}
        if efb is not None:
            new_state["efb"] = efb
        return new_state, {"loss": loss.detach(), **{k: v.detach() for k, v
                                                     in metrics.items()},
                           "grad_norm": gnorm}

    return train_step


def init_train_state(cfg: ModelConfig, optimizer,
                     generator: torch.Generator | None = None, *,
                     seed: int = 0, device=None, with_efb: bool = False):
    """Random weights (:func:`init_params`), zero moments and counts, and
    with ``with_efb`` zero error-feedback buffers."""
    model = init_params(cfg, generator, seed=seed, device=device)
    named = dict(model.named_parameters())
    state = {"params": model, "opt": optimizer.init(named),
             "step": torch.zeros((), dtype=torch.int32)}
    if with_efb:
        state["efb"] = {k: torch.zeros_like(p, requires_grad=False)
                        for k, p in named.items()}
    return state


def train_state_specs(cfg: ModelConfig, optimizer, mesh_shape: dict, *,
                      fsdp="data", tp="model", with_efb=False):
    raise NotImplementedError(_ONE_DEVICE.format("train_state_specs"))
