"""Deterministic synthetic data pipeline.

Twin of ``src/repro/data/pipeline.py``.  Every batch is a pure function of
(seed, step): it is drawn from a CPU ``torch.Generator`` seeded from both,
then moved to the pipeline's device, so

  - restarts are exact: checkpointing the integer ``step`` restores the
    stream (no file offsets to save);
  - the stream does not depend on the device that trains on it;
  - the LM substrate needs no external corpora.

The distributions are the reference's: Zipf-ish tokens ``floor(V u^3)``
with a Markov twist (with p = 0.5 the next token is the previous one plus
one, mod V) so the loss has learnable structure, standard normal VLM
patch embeddings and encoder frames at the compute dtype, and labels the
tokens shifted by one.  The bits are not ``jax.random``'s: a test that
compares the packages hands the reference's batches to both.
"""

from __future__ import annotations

import dataclasses

import torch

from ..backend import default_device
from ..configs.base import ModelConfig


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticPipeline:
    """Yields train batches matching the model family's input dict, on
    ``device`` (None: the card)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.device = default_device(device)

    def init_state(self) -> PipelineState:
        return PipelineState(seed=self.seed, step=0)

    def _tokens(self, gen: torch.Generator, shape):
        V = self.cfg.vocab
        # Zipf-ish marginal: t = floor(V * u^3) mixes frequent/rare tokens
        u = torch.rand(shape, generator=gen)
        base = torch.clamp((V * u ** 3).to(torch.int32), 0, V - 1)
        # Markov structure: with p=0.5, token t+1 = (t + 1) mod V
        copy = torch.rand(shape, generator=gen) < 0.5
        shifted = torch.roll(base, 1, dims=-1) + 1
        return torch.where(copy, shifted % V, base).long()

    def generate(self, step: int) -> dict:
        """The batch of ``step``: tokens and labels (B, S) int64, and the
        VLM's ``patch_embeds`` or the encoder-decoder's ``frames``."""
        gen = torch.Generator().manual_seed(
            (self.seed * 0x9E3779B1 + step) % 2 ** 63)
        cfg = self.cfg
        S = self.seq
        if cfg.family == "vlm":
            S = S - cfg.n_patches
        toks = self._tokens(gen, (self.batch, S + 1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.randn(
                (self.batch, cfg.n_patches, cfg.d_model),
                generator=gen).to(cfg.policy.c())
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(
                (self.batch, cfg.enc_positions, cfg.d_model),
                generator=gen).to(cfg.policy.c())
        return {k: v.to(self.device) for k, v in batch.items()}

    def next(self, state: PipelineState):
        return (PipelineState(state.seed, state.step + 1),
                self.generate(state.step))
