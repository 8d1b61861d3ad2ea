"""Mixture-of-Experts FFN: top-k routing with capacity-bounded gather and
scatter dispatch (no (tokens x E x C) one-hot product: fine-grained MoE
like granite-3b, 40 experts of d_ff 512, would spend more in that product
than in the experts).

Twin of ``src/repro/models/moe.py``.  The reference vmaps one group's
dispatch over the token groups; here the group axis G is a leading batch
axis of every tensor.  Per group:

  1. router logits (f32 sums) -> top-k experts and renormalised gates
  2. position in expert by an exclusive cumsum over the token-major
     (S * k) flattening; pairs beyond the capacity C drop
  3. a slot -> token table by scatter, an (E, C + 1) table whose last
     column takes the dropped pairs
  4. tokens gathered into (E, C, D), the experts run as batched products
     with f32 sums (``layers.bmm_f32``), their outputs rounded to x's dtype
  5. each token's k slots gathered back and summed with gate * keep

These are XLA ops in the reference (no Pallas kernel), so they stay torch
ops here.  ``torch.topk(sorted=True)`` orders the experts as
``jax.lax.top_k``; ties between equal probabilities may break otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import layers as L
from .layers import F32


class Routing(NamedTuple):
    """One call's routing, every tensor with a leading group axis G:
    ``probs`` (G, gs, E) f32, ``gate`` and ``idx`` (G, gs, k) sorted by
    probability, ``pos`` (G, gs, k) each pair's slot in its expert,
    ``keep`` (G, gs, k) pos < C; ``C`` the capacity of an expert."""
    probs: torch.Tensor
    gate: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    C: int


def pick_group(T: int, size: int) -> int:
    """Tokens a dispatch group: the largest divisor of T that is at most
    ``size`` (the config's ``moe_group``)."""
    gs = min(size, T)
    while T % gs:
        gs -= 1
    return gs


def capacity(gs: int, top_k: int, capacity_factor: float, E: int) -> int:
    return max(1, int(gs * top_k * capacity_factor / E))


def route(xg, router_w, *, top_k: int, capacity_factor: float) -> Routing:
    """xg: (G, gs, D) in the compute dtype; router_w: (D, E), cast to xg's
    dtype, its product kept at f32 sums."""
    G, gs, _ = xg.shape
    E = router_w.shape[-1]
    probs = torch.softmax(L.matmul_f32(xg, router_w), dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    C = capacity(gs, top_k, capacity_factor, E)
    # each pair's count of earlier (token, slot) pairs that chose its expert
    onehot = F.one_hot(idx, E)                                # (G, gs, k, E)
    flat = onehot.reshape(G, gs * top_k, E)
    pos_flat = flat.cumsum(1) - flat                          # exclusive
    pos = pos_flat.reshape(G, gs, top_k, E).gather(3, idx[..., None])[..., 0]
    return Routing(probs, gate, idx, pos, pos < C, C)


def _dispatch_group(x, r: Routing, E: int):
    """x: (G, S, D) -> (expert_in (G, E, C, D), safe_pos (G, S, k))."""
    G, S, D = x.shape
    C = r.C
    safe_pos = torch.where(r.keep, r.pos, C)                  # C = drop slot
    g = torch.arange(G, device=x.device)[:, None, None].expand_as(r.idx)
    token_ids = torch.arange(S, device=x.device)[None, :, None].expand_as(
        r.idx)
    table = torch.full((G, E, C + 1), S, dtype=torch.long, device=x.device)
    # kept pairs own distinct (expert, slot) cells; only the discarded drop
    # column C is written more than once
    table[g, r.idx, safe_pos] = token_ids
    slot_token = table[:, :, :C]                              # S = empty
    x_pad = torch.cat([x, x.new_zeros((G, 1, D))], dim=1)
    gi = torch.arange(G, device=x.device)[:, None, None]
    return x_pad[gi, slot_token], safe_pos                    # (G, E, C, D)


def _combine_group(expert_out, r: Routing, safe_pos):
    """expert_out: (G, E, C, D) -> y (G, S, D) f32, each token's slots
    gathered and weighted by gate * keep."""
    G = expert_out.shape[0]
    out_pad = F.pad(expert_out, (0, 0, 0, 1))                 # drop slot = 0
    gi = torch.arange(G, device=expert_out.device)[:, None, None]
    slots = out_pad[gi, r.idx, safe_pos]                      # (G, S, k, D)
    w = (r.gate * r.keep).to(F32)[..., None]
    return (slots.to(F32) * w).sum(dim=2)


def _experts(e_in, wg, wu, wd, dtype):
    """The E expert FFNs on their slots: e_in (G, E, C, D) -> (G, E, C, D)
    in ``dtype``; each product f32-summed, as the reference's
    ``preferred_element_type=F32``."""
    G, E, C, D = e_in.shape
    xe = e_in.transpose(0, 1).reshape(E, G * C, D)
    h = (F.silu(L.bmm_f32(xe, wg)) * L.bmm_f32(xe, wu)).to(dtype)
    out = L.bmm_f32(h, wd).to(dtype)
    return out.reshape(E, G, C, D).transpose(0, 1)


def moe_ffn(x, router_w, wg, wu, wd, *, top_k: int, capacity_factor: float,
            group_size: int):
    """x: (B, S, D).  Expert weights: wg/wu (E, D, F), wd (E, F, D).
    Returns (y (B, S, D) in x's dtype, the load-balance aux loss, an f32
    scalar)."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    T = B * S
    gs = pick_group(T, group_size)
    xg = x.reshape(T // gs, gs, D)
    r = route(xg, router_w, top_k=top_k, capacity_factor=capacity_factor)
    e_in, safe_pos = _dispatch_group(xg, r, E)
    y = _combine_group(_experts(e_in, wg, wu, wd, x.dtype), r, safe_pos)

    # Switch-style load-balance aux loss
    me = r.probs.reshape(-1, E).mean(dim=0)
    ce = F.one_hot(r.idx[..., 0].reshape(-1), E).to(F32).mean(dim=0)
    aux = E * (me * ce).sum()
    return y.reshape(B, S, D).to(x.dtype), aux
