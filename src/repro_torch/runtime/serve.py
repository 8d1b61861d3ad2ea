"""Batched serving loop: requests grouped into prompt-length buckets, a
prefill to build the decode state, then single-token decode steps until
every sequence hits EOS or its token budget; greedy or temperature
sampling.

Twin of ``src/repro/runtime/serve.py``, with the same bucketing, extras
partitioning, left-padding (with token 0, unmasked, as the reference
does) and EOS handling.  Every family serves through ``models.api``: KV
cache transformers (dense, MoE, VLM), SSM-state decoders (ssm, hybrid)
and the encoder-decoder with its cross-attention cache; the engine never
reads the decode state.  The model runs eagerly under
``torch.inference_mode()`` on the device its weights lie on.  Greedy
decoding takes ``torch.argmax`` (the first maximum, as ``jnp.argmax``);
temperature sampling draws from the engine's own ``torch.Generator`` and
does not reproduce ``jax.random.categorical``'s stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models import api


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    extras: dict | None = None      # vlm patch embeds / encdec frames


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray


class ServeEngine:
    def __init__(self, cfg, params, *, max_seq: int = 512,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: int = 0):
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.max_seq = max_seq
        self.temperature = temperature
        self.eos_id = eos_id
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._prefill = lambda p, b: api.prefill_step(cfg, p, b, max_seq)
        self._decode = lambda p, s, t: api.decode_step(cfg, p, s, t)

    def _sample(self, logits):
        logits = logits[:, -1, :].to(torch.float32)
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    @staticmethod
    def _extras_signature(r: Request) -> frozenset:
        return frozenset(r.extras) if r.extras else frozenset()

    def run_batch(self, requests: list[Request]) -> list[Result]:
        """One round over same-length-bucket requests.

        All requests must carry the same extras keys: a batch mixing
        extras-bearing and plain requests cannot be stacked into one
        model input (``serve`` partitions on the extras signature before
        calling here)."""
        sigs = {self._extras_signature(r) for r in requests}
        if len(sigs) > 1:
            raise ValueError(
                f"mixed extras in one batch ({sorted(map(sorted, sigs))}); "
                f"partition by extras signature first (serve() does)")
        B = len(requests)
        S = max(len(r.prompt) for r in requests)
        prompts = np.full((B, S), 0, np.int64)
        for i, r in enumerate(requests):
            prompts[i, S - len(r.prompt):] = r.prompt      # left-pad
        batch = {"tokens": torch.as_tensor(prompts, device=self.device)}
        for k in sorted(sigs.pop()):
            batch[k] = torch.stack([torch.as_tensor(r.extras[k])
                                    for r in requests]).to(self.device)

        with torch.inference_mode():
            logits, state = self._prefill(self.params, batch)
            tok = self._sample(logits)
            del logits
            max_new = max(r.max_new_tokens for r in requests)
            out = [tok]
            done = np.zeros((B,), bool)
            for _ in range(max_new - 1):
                logits, state = self._decode(self.params, state, tok[:, None])
                tok = self._sample(logits)
                out.append(tok)
                if self.eos_id is not None:
                    done |= tok.cpu().numpy() == self.eos_id
                    if done.all():
                        break
            gen = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        results = []
        for i, r in enumerate(requests):
            t = gen[i][: r.max_new_tokens]
            if self.eos_id is not None and (t == self.eos_id).any():
                t = t[: int(np.argmax(t == self.eos_id)) + 1]
            results.append(Result(r.uid, t))
        return results

    def serve(self, requests: list[Request], bucket: int = 128) -> list[Result]:
        """Group requests into (prompt-length, extras-signature) buckets and
        run each batch; results in uid order."""
        buckets: dict[tuple, list[Request]] = {}
        for r in requests:
            b = (len(r.prompt) + bucket - 1) // bucket
            key = (b, tuple(sorted(self._extras_signature(r))))
            buckets.setdefault(key, []).append(r)
        results = []
        for _, reqs in sorted(buckets.items()):
            results.extend(self.run_batch(reqs))
        return sorted(results, key=lambda r: r.uid)
