"""AdamW with global-norm clipping and decoupled weight decay, plus the
learning-rate schedules (cosine and MiniCPM's WSD).

Twin of ``src/repro/optim/adamw.py``.  Gradients, parameters and moments
are dicts keyed by the model's parameter names (one entry a layer where
the reference stacks the layers on a leading axis); the state is ``{"mu",
"nu", "count"}``, the count an int32 CPU tensor.  The schedules take that
count and compute in f32 as the reference's do; they run on the host, so
the learning rate reaches the update as a number and a step reads nothing
back from the device.  Weight decay applies to every parameter and the
clipping norm covers every gradient, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable            # count (int32 tensor) -> lr (f32 tensor)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # "bfloat16" halves the moments' memory

    def _sdt(self) -> torch.dtype:
        return torch.bfloat16 if self.state_dtype == "bfloat16" else F32

    def init(self, params: dict) -> dict:
        """Zero moments beside each parameter (on its device)."""
        def z(p):
            return torch.zeros(p.shape, dtype=self._sdt(), device=p.device)
        return {"mu": {k: z(p) for k, p in params.items()},
                "nu": {k: z(p) for k, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32)}

    def state_specs(self, param_specs):
        raise NotImplementedError(
            "sharding specs of the optimizer state: the port runs on one "
            "card (ROADMAP item 13c, multi-device)")

    @staticmethod
    def global_norm(grads: dict):
        """sqrt of the sum of every gradient's squares, in f32 (a 0-d
        tensor on the gradients' device)."""
        return torch.stack([torch.sum(torch.square(g.to(F32)))
                            for g in grads.values()]).sum().sqrt()

    def _host_f32(self, x: float, count) -> float:
        """1 - x ** count, computed in f32 as the reference's bias
        correction, as a number."""
        return (1 - torch.tensor(x, dtype=F32) ** count.to(F32)).item()

    @torch.no_grad()
    def update_(self, grads: dict, state: dict, params: dict, *,
                gnorm=None) -> dict:
        """One step, in place: the reference's ``update`` and the train
        step's ``(p + u).astype(p.dtype)``, each parameter and its moments
        overwritten with their new values.  ``gnorm`` is
        :meth:`global_norm` of ``grads`` when the caller has it.  Returns
        the new state (the same moment tensors, the count plus one)."""
        count = state["count"] + 1
        lr = self.schedule(count).item()
        bc1, bc2 = self._host_f32(self.b1, count), self._host_f32(self.b2,
                                                                   count)
        if self.grad_clip:
            gnorm = self.global_norm(grads) if gnorm is None else gnorm
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        else:
            scale = 1.0
        sdt = self._sdt()
        for k, g in grads.items():
            p, mu, nu = params[k], state["mu"][k], state["nu"][k]
            g = g.to(F32) * scale
            mu_n = self.b1 * mu.to(F32) + (1 - self.b1) * g
            nu_n = self.b2 * nu.to(F32) + (1 - self.b2) * g * g
            step = (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + self.eps)
            step = step + self.weight_decay * p.to(F32)
            p.copy_((p.to(F32) + (-lr) * step).to(p.dtype))
            mu.copy_(mu_n.to(sdt))
            nu.copy_(nu_n.to(sdt))
        return {"mu": state["mu"], "nu": state["nu"], "count": count}


# ---------------------------------------------------------------------------
# schedules: step (an integer tensor) -> learning rate (an f32 tensor)
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    def f(step):
        s = torch.as_tensor(step).to(F32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup, warm, cos)
    return f


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 floor_frac: float = 0.01):
    """Warmup-Stable-Decay (MiniCPM): linear warmup, a long flat top, a
    short exponential-ish decay tail."""
    def f(step):
        s = torch.as_tensor(step).to(F32)
        warm = s / max(warmup, 1)
        in_decay = torch.clamp((s - warmup - stable) / max(decay, 1), 0, 1)
        dec = floor_frac ** in_decay        # 1 -> floor_frac
        return peak_lr * torch.where(s < warmup, warm, dec)
    return f


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=F32)
