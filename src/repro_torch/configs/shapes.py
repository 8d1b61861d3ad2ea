"""The assigned input-shape set (the same four shapes for every LM arch)
and the abstract input builders of the dry run.

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill (serve)
  decode_32k   seq 32,768  global_batch 128   -> serve_step: ONE new token
                                                 against a filled KV cache
  long_500k    seq 524,288 global_batch 1     -> serve_step; requires
                                                 sub-quadratic attention
                                                 (SSM/hybrid only)

Twin of ``src/repro/configs/shapes.py``.  :func:`input_specs` returns
meta tensors (shape and dtype, no storage) where the reference returns
``ShapeDtypeStruct``s; :func:`launch.dryrun` makes fake tensors of them.
"""

from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k only runs for sub-quadratic families."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full attention is O(S^2); long-context decode skipped"
    return True, ""


def _tok(b, s):
    return torch.empty((b, s), dtype=torch.int32, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Abstract batch (meta tensors: no storage) for a shape.

    VLM: ``seq`` counts patch + text positions; the modality frontend is a
    stub, so patch embeddings arrive precomputed.  Enc-dec: the audio
    frontend stub supplies (B, enc_positions, d_model) frame embeddings and
    ``seq`` is the decoder length."""
    B, S = shape.batch, shape.seq
    emb_dt = cfg.policy.c()
    if shape.kind == "decode":
        return {"tokens": _tok(B, 1)}
    if cfg.family == "encdec":
        batch = {"frames": torch.empty((B, cfg.enc_positions, cfg.d_model),
                                       dtype=emb_dt, device="meta"),
                 "tokens": _tok(B, S)}
    elif cfg.family == "vlm":
        batch = {"patch_embeds": torch.empty((B, cfg.n_patches, cfg.d_model),
                                             dtype=emb_dt, device="meta"),
                 "tokens": _tok(B, S - cfg.n_patches)}
    else:
        batch = {"tokens": _tok(B, S)}
    if shape.kind == "train":
        batch["labels"] = _tok(*batch["tokens"].shape)
    return batch


def input_shard_specs(cfg: ModelConfig, shape: ShapeSpec, *, dp,
                      mesh_shape: dict) -> dict:
    """Batch-dim sharding of the inputs over a device mesh."""
    raise NotImplementedError(
        "input_shard_specs: sharding over a device mesh waits for ROADMAP.md "
        "queue 1 item 13b (multi-GPU); the port runs on one card")
