"""Gradient compression with error feedback, the paper's 'communicate in
lower precision' phase applied to training.  Two codecs:

  - "bf16": the gradients rounded to bfloat16 and back;
  - "int8": symmetric int8 quantization with one scale a reference leaf,
    and an error-feedback buffer that re-injects the quantization error
    at the next step.

Twin of ``src/repro/optim/grad_compress.py``.  The reference takes one
scale (max |g| / 127) over each pytree leaf, and its per-layer leaves are
stacked over the layers; the port holds one parameter a layer, so the
int8 codec takes one scale over each group of parameters that form one
reference leaf (``convert.stacked_leaf``), and quantizes the same
function.  ``torch.round`` rounds half to even, as ``jnp.round``.  On one
card there is no reduction to compress: the codec runs for its effect on
the update.
"""

from __future__ import annotations

import dataclasses

import torch

from ..convert import stacked_leaf

F32 = torch.float32


def leaf_groups(names) -> dict:
    """Parameter names grouped by the reference leaf they belong to."""
    groups: dict = {}
    for name in names:
        groups.setdefault(stacked_leaf(name)[0], []).append(name)
    return groups


@dataclasses.dataclass(frozen=True)
class Compressor:
    codec: str = "bf16"            # "none" | "bf16" | "int8"

    @torch.no_grad()
    def compress_decompress(self, grads: dict, efb: dict | None = None):
        """Returns (decompressed grads, new error-feedback buffers), both
        dicts keyed as ``grads``."""
        if self.codec == "none":
            return grads, efb
        if self.codec == "bf16":
            return {k: g.to(torch.bfloat16).to(g.dtype)
                    for k, g in grads.items()}, efb
        if self.codec != "int8":
            raise ValueError(self.codec)
        out, new_efb = {}, {}
        for names in leaf_groups(grads).values():
            g32 = {k: grads[k].to(F32) + (efb[k].to(F32) if efb is not None
                                          else 0.0) for k in names}
            amax = torch.stack([v.abs().max() for v in g32.values()]).max()
            scale = torch.clamp(amax, min=1e-12) / 127.0
            for k, v in g32.items():
                q = torch.clamp(torch.round(v / scale), -127, 127).to(
                    torch.int8)
                deq = q.to(F32) * scale
                out[k] = deq.to(grads[k].dtype)
                new_efb[k] = (v - deq).to(grads[k].dtype)
        return out, new_efb
