"""Training/serving precision policy, the paper's per-phase precision
generalised to LMs.

The FFTMatvec framework assigns a precision level to each phase of its
pipeline; for an LM the phases are parameter storage, compute,
accumulation, the gradient all-reduce (comm) and the KV cache.
``PrecisionPolicy`` carries one dtype name per phase, and its accessors
give the ``torch`` dtype.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "int8": torch.int8,
}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    param_dtype: str = "float32"     # master weights
    compute_dtype: str = "bfloat16"  # matmul inputs
    accum_dtype: str = "float32"     # softmax / loss / dot accumulation
    comm_dtype: str = "bfloat16"     # gradient all-reduce payload
    cache_dtype: str = "bfloat16"    # KV cache storage
    logits_dtype: str = "float32"

    def p(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def c(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def a(self) -> torch.dtype:
        return _DTYPES[self.accum_dtype]

    def k(self) -> torch.dtype:
        return _DTYPES[self.cache_dtype]

    def l(self) -> torch.dtype:
        return _DTYPES[self.logits_dtype]

    def comm(self) -> torch.dtype:
        return _DTYPES[self.comm_dtype]


DEFAULT = PrecisionPolicy()
FULL_F32 = PrecisionPolicy(compute_dtype="float32", comm_dtype="float32",
                           cache_dtype="float32")
