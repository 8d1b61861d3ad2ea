"""Flash attention (online softmax, causal mask): a CUDA kernel.

Twin of ``src/repro/kernels/flash_attention.py``.  The kernel
(``csrc/flash_attention.cu``) keeps each block of scores, the running max
and denominator and the output accumulator on chip, so device memory sees
q, k and v read once and the output written once.  The wrapper launches
it for CUDA tensors and runs the plain version, the same blocked online
softmax step by step in PyTorch, for CPU tensors.

The kernel addresses heads by strides, so ``flash_attention`` hands it the
(B, S, H, Dh) tensors as they are: no head fold, no grouped-query repeat,
no padding (ragged lengths are masked in the kernel).  ``q_block`` and
``kv_block`` are the reference's tile sizes; the kernels take 64 by 64
tiles whatever they say, which changes only the order of the sums.

Three kernels sit behind the wrapper, chosen by :func:`kernel_for` from
the dtype, the head dim and the alignment alone:
``flash_attention_bh_wgmma`` (bf16, Dh 64 or 128, 16-byte-aligned rows:
Hopper's wgmma), ``flash_attention_bh_f32`` (every f32 call: IEEE FFMA on
the FP32 units) and ``flash_attention_bh`` (the other bf16 calls).  Each
counts its own launches.
"""

from __future__ import annotations

import torch

from ..backend import UnsupportedOnBackend
from . import _build

F32 = torch.float32
NEG_INF = -1e30
MAX_HEAD_DIM = 128
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
WGMMA_HEAD_DIMS = (64, 128)
# the C entries of csrc/flash_attention.cu, one launch counter each
KERNELS = ("flash_attention_bh", "flash_attention_bh_wgmma",
           "flash_attention_bh_f32")


def kernel_for(dtype: torch.dtype, head_dim: int, aligned: bool) -> str:
    """The C entry that takes a call on the card: the f32 kernel for every
    f32 call; for bf16 the wgmma kernel at Dh 64 or 128 when q, k, v and o
    start on 16-byte boundaries and every (batch, head, row) stride is a
    multiple of 16 bytes, nonzero where its axis is longer than one
    (``aligned``: the kernel's TMA copies need both), else the general
    kernel."""
    if dtype == torch.float32:
        return "flash_attention_bh_f32"
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS and aligned:
        return "flash_attention_bh_wgmma"
    return "flash_attention_bh"


def flash_attention_bh_plain(q, k, v, *, causal: bool = True,
                             q_block: int = 256, kv_block: int = 256):
    """Plain version: q (BH, Sq, Dh), k, v (BH, Skv, Dh) -> (BH, Sq, Dh) in
    q's dtype, block by block as the reference kernel: f32 scores, mask to
    -1e30, online softmax with f32 statistics, p rounded to v's dtype
    before the p v product.  Ragged last blocks are taken as they are.
    With ``causal``, key blocks wholly after the query block are skipped:
    they would add p = 0 with alpha = 1 (the first block holds key 0, so
    every row's max is finite by then)."""
    BH, Sq, Dh = q.shape
    Skv = k.shape[1]
    scale = 1.0 / (Dh ** 0.5)
    out = torch.empty_like(q)
    for i0 in range(0, Sq, q_block):
        qb = q[:, i0:i0 + q_block].to(F32)
        n = qb.shape[1]
        acc = torch.zeros((BH, n, Dh), dtype=F32, device=q.device)
        m = torch.full((BH, n, 1), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros((BH, n, 1), dtype=F32, device=q.device)
        for j0 in range(0, Skv, kv_block):
            if causal and j0 > i0 + n - 1:
                break
            kb, vb = k[:, j0:j0 + kv_block], v[:, j0:j0 + kv_block]
            s = (qb @ kb.to(F32).mT) * scale
            if causal:
                qpos = torch.arange(i0, i0 + n, device=q.device)[:, None]
                kpos = torch.arange(j0, j0 + kb.shape[1], device=q.device)
                s = torch.where(qpos >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).to(F32) @ vb.to(F32)
            m = m_new
        out[:, i0:i0 + n] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out


def _check(q, k, v, ndim: int, what: str) -> None:
    if q.ndim != ndim or k.ndim != ndim or v.ndim != ndim:
        raise ValueError(f"{what} takes {ndim}-D q, k, v; got "
                         f"{q.ndim}, {k.ndim}, {v.ndim}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise UnsupportedOnBackend(f"{what}: head dim {q.shape[-1]} > "
                                   f"{MAX_HEAD_DIM}")
    if k.shape[1] < 1:
        raise ValueError(f"{what}: no keys")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"{what}: q, k, v on different devices")
    if dev.type == "cuda":
        if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
                or v.dtype != q.dtype:
            raise UnsupportedOnBackend(
                f"{what}: the kernel takes bf16 or f32 q, k, v of one dtype, "
                f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
            raise ValueError(f"{what}: the head dim must be unit-stride")
    elif dev.type != "cpu":
        raise ValueError(f"{what}: unsupported device {dev}")


def _launch(q, k, v, o, B, Hq, Hkv, qs, ks, vs, os, causal: bool) -> None:
    """Launch the C entry that :func:`kernel_for` names on (batch, head,
    row) strides; counts it."""
    Sq, Skv, Dh = q.shape[1], k.shape[1], q.shape[-1]
    # 16-byte aligned starts and strides, none 0 on an axis of more than one
    # element (a tensor map steps each axis by its stride)
    es, sts = q.element_size(), (*qs, *ks, *vs, *os)
    aligned = ((q.data_ptr() | k.data_ptr() | v.data_ptr() | o.data_ptr()) % 16 == 0
               and all(st * es % 16 == 0 and (st or n == 1) for st, n in zip(
                   sts, (B, Hq, Sq, B, Hkv, Skv, B, Hkv, Skv, B, Hq, Sq))))
    entry = kernel_for(q.dtype, Dh, aligned)
    err = getattr(_build.library("flash_attention"), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq, Hkv, Sq,
        Skv, Dh, *sts, int(bool(causal)), _build.DTYPE_CODES[q.dtype],
        q.device.index, _build.stream_of(q))
    _build.check(err, entry)
    _build.launch_counts[entry] += 1


def flash_attention_bh(q, k, v, *, causal: bool = True, q_block: int = 256,
                       kv_block: int = 256):
    """Attention on folded heads: q (BH, Sq, Dh); k, v (BH, Skv, Dh) ->
    (BH, Sq, Dh) in q's dtype.  Any Sq, Skv >= 1 and Dh <= 128."""
    _check(q, k, v, 3, "flash_attention_bh")
    if q.device.type == "cpu":
        return flash_attention_bh_plain(q, k, v, causal=causal,
                                        q_block=q_block, kv_block=kv_block)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    (qb, qr, _), (kb, kr, _), (vb, vr, _), (ob, orow, _) = (
        q.stride(), k.stride(), v.stride(), o.stride())
    _launch(q, k, v, o, q.shape[0], 1, 1, (qb, 0, qr), (kb, 0, kr), (vb, 0, vr),
            (ob, 0, orow), causal)
    return o


def flash_attention(q, k, v, *, causal: bool = True, q_block: int = 256,
                    kv_block: int = 256):
    """GQA wrapper: q (B, Sq, Hq, Dh); k, v (B, Skv, Hkv, Dh) ->
    (B, Sq, Hq, Dh).  On the CPU it folds heads, repeats kv heads and
    shrinks the blocks to divisors of the lengths, as the reference does."""
    _check(q, k, v, 4, "flash_attention")
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads over {Hkv} kv "
                         f"heads")
    if q.device.type == "cuda":
        o = torch.empty((B, Sq, Hq, Dh), dtype=q.dtype, device=q.device)
        st = lambda t: (t.stride(0), t.stride(2), t.stride(1))  # noqa: E731
        _launch(q, k, v, o, B, Hq, Hkv, st(q), st(k), st(v), st(o), causal)
        return o
    G = Hq // Hkv
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    fold = lambda x: x.transpose(1, 2).reshape(B * Hq, x.shape[1], Dh)  # noqa: E731
    qb = min(q_block, Sq)
    while Sq % qb:
        qb -= 1
    kb = min(kv_block, Skv)
    while Skv % kb:
        kb -= 1
    o = flash_attention_bh_plain(fold(q), fold(k), fold(v), causal=causal,
                                 q_block=qb, kv_block=kb)
    return o.reshape(B, Hq, Sq, Dh).transpose(1, 2)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Oracle: full-score softmax attention with GQA, in f32."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), k.to(F32)) / (Dh ** 0.5)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(F32)).to(q.dtype)
