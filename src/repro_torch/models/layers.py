"""Neural-net primitives of the transformer path: RMS norm, RoPE, GQA
attention (chunked online softmax, a block-causal variant, the flash
kernel) and the gated MLP.

Twin of ``src/repro/models/layers.py``.  Products of the attention
softmax run on f32 operands (a bf16 operand widens exactly, so each
product equals the reference's f32-accumulated one up to summation
order); softmax statistics are always f32.  The reference's sharding
constraints are no-ops on one device and have no twin here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention

F32 = torch.float32


def rms_norm(x, gamma, eps: float = 1e-5):
    h = x.to(F32)
    scale = torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    return (h * scale).to(x.dtype) * gamma.to(x.dtype)


def matmul_f32(x, w):
    """x @ w(cast to x's dtype) with f32 sums and an f32 result, as the
    reference's ``preferred_element_type=F32``.  For bf16/f16 operands the
    device decides how: on the card the f32-output product
    (``torch.mm(..., out_dtype=torch.float32)``, which runs or raises); on
    the CPU, which has no kernel for that overload, the operands widened
    to f32 and an f32 product.  A bf16 x bf16 product is exact in f32, so
    both compute the same f32-summed function."""
    w = w.to(x.dtype)
    if x.dtype not in (torch.bfloat16, torch.float16):
        return torch.matmul(x, w).to(F32)
    if x.device.type == "cpu":
        return torch.matmul(x.to(F32), w.to(F32))
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=F32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def dense(x, w, b=None):
    """x @ w (+ b) in x's dtype.  With a bias, as in the reference, the
    bias is added to the f32 product and the sum rounded once to x's
    dtype; without one, ``torch.matmul`` rounds its f32 sums once.  These
    products lie outside any kernel of the reference, so they stay
    library products."""
    if b is None:
        return torch.matmul(x, w.to(x.dtype))
    return (matmul_f32(x, w) + b.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, Dh); positions: (..., S) int."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=F32,
                                          device=x.device) / d))
    ang = positions[..., :, None].to(F32) * freqs              # (..., S, d/2)
    ang = ang[..., None, :]                                    # (..., S, 1, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention.  q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv, Dh); GQA via reshape.
# ---------------------------------------------------------------------------

def _split_gqa(q, n_kv: int):
    B, S, Hq, Dh = q.shape
    return q.reshape(B, S, n_kv, Hq // n_kv, Dh)


def _attn_chunk(q, k, v, mask, scale: float):
    """One (q-chunk x kv-chunk) block.  q: (B,c,Hkv,G,Dh), k/v: (B,kc,Hkv,Dh).
    Returns (out_unnorm f32, row_max f32, row_sumexp f32)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(F32), k.to(F32)) * scale
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1)                                    # (B,h,g,q)
    # guard fully-masked rows
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).to(F32), v.to(F32))
    return o, m_safe, l


def _perm(a):
    """(B, h, g, q) -> (B, q, h, g)."""
    return torch.movedim(a, (1, 2, 3), (2, 3, 1))


def _combine(o1, m1, l1, o2, m2, l2):
    """Online-softmax combine of two partial attention results."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    o = o1 * _perm(a1)[..., None] + o2 * _perm(a2)[..., None]
    return o, m, l1 * a1 + l2 * a2


def _pick_chunk(S: int, c: int) -> int:
    """Largest divisor of S that is <= c (chunks must tile exactly)."""
    c = min(c, S)
    while S % c:
        c -= 1
    return c


def _init_stats(B, n, Hkv, G, Dh, device):
    return (torch.zeros((B, n, Hkv, G, Dh), dtype=F32, device=device),
            torch.full((B, Hkv, G, n), float("-inf"), dtype=F32, device=device),
            torch.zeros((B, Hkv, G, n), dtype=F32, device=device))


def _finish(o, l, dtype):
    return (o / _perm(l)[..., None].clamp_min(1e-30)).to(dtype)


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """Flash-style attention in plain PyTorch: a loop over q chunks, an
    inner loop over kv chunks with online softmax.  Every kv chunk is
    visited for every q chunk (causal blocks above the diagonal still cost
    FLOPs; see block_causal_attention).  ``q_offset`` is the position of
    the first query (a decode step's cache position)."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qc = _pick_chunk(Sq, q_chunk)
    kc = _pick_chunk(Skv, kv_chunk)
    scale = 1.0 / (Dh ** 0.5)
    qg = _split_gqa(q, Hkv)                                # (B,Sq,Hkv,G,Dh)
    G = qg.shape[3]
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    chunks = []
    for i0 in range(0, Sq, qc):
        qb, qp = qg[:, i0:i0 + qc], q_pos[i0:i0 + qc]
        o, m, l = _init_stats(B, qc, Hkv, G, Dh, q.device)
        for j0 in range(0, Skv, kc):
            kp = kv_pos[j0:j0 + kc]
            mask = (qp[:, None] >= kp[None, :]) if causal else \
                torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            ob, mb, lb = _attn_chunk(qb, k[:, j0:j0 + kc], v[:, j0:j0 + kc],
                                     mask[None, None, None], scale)
            o, m, l = _combine(o, m, l, ob, mb, lb)
        chunks.append(_finish(o, l, q.dtype))
    return torch.cat(chunks, dim=1).reshape(B, Sq, Hkv * G, Dh)


def block_causal_attention(q, k, v, *, q_offset: int = 0, q_chunk: int = 512,
                           kv_chunk: int = 1024):
    """FLOP-exact causal attention: only the (q-chunk, kv-chunk) pairs on
    or below the diagonal, in the reference's pair order, each q chunk's
    online-softmax statistics combined over its pairs."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qc = _pick_chunk(Sq, q_chunk)
    kc = _pick_chunk(Skv, kv_chunk)
    scale = 1.0 / (Dh ** 0.5)
    qg = _split_gqa(q, Hkv)
    G = qg.shape[3]
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    chunks = []
    for i in range(Sq // qc):
        qb, qp = qg[:, i * qc:(i + 1) * qc], q_pos[i * qc:(i + 1) * qc]
        o, m, l = _init_stats(B, qc, Hkv, G, Dh, q.device)
        for j in range(Skv // kc):
            if j * kc > q_offset + (i + 1) * qc - 1:
                continue
            kp = kv_pos[j * kc:(j + 1) * kc]
            mask = (qp[:, None] >= kp[None, :])[None, None, None]
            ob, mb, lb = _attn_chunk(qb, k[:, j * kc:(j + 1) * kc],
                                     v[:, j * kc:(j + 1) * kc], mask, scale)
            o, m, l = _combine(o, m, l, ob, mb, lb)
        chunks.append(_finish(o, l, q.dtype))
    return torch.cat(chunks, dim=1).reshape(B, Sq, Hkv * G, Dh)


def attention(q, k, v, *, causal: bool, cfg, q_offset: int = 0):
    """Dispatch on ``cfg.attn_impl``: chunked (baseline) | block_causal
    (causal FLOP skip) | flash (the CUDA kernel; its plain version on the
    CPU).  Flash takes a prefill (``q_offset == 0``, more than one query);
    a decode step runs chunked attention.  ``q_offset`` is a Python int:
    the condition is decided on the host."""
    if not isinstance(q_offset, int):
        raise TypeError(f"q_offset must be a Python int, got "
                        f"{type(q_offset).__name__}")
    if cfg.attn_impl == "flash" and q_offset == 0 and q.shape[1] > 1:
        return flash_attention(q, k, v, causal=causal,
                               q_block=cfg.attn_q_chunk,
                               kv_block=cfg.attn_kv_chunk)
    if causal and cfg.attn_impl == "block_causal" and q.shape[1] > 1:
        return block_causal_attention(q, k, v, q_offset=q_offset,
                                      q_chunk=cfg.attn_q_chunk,
                                      kv_chunk=cfg.attn_kv_chunk)
    return chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                             q_chunk=cfg.attn_q_chunk,
                             kv_chunk=cfg.attn_kv_chunk)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu(x, wg, wu, wd):
    g = dense(x, wg)
    u = dense(x, wu)
    return dense(F.silu(g.to(F32)).to(x.dtype) * u, wd)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def init_dense(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """N(0, 1) / sqrt(fan_in) (or ``scale``) drawn in f32 from ``gen`` on
    its device, then cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    return (torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
            * s).to(dtype)


def init_embed(gen: torch.Generator, vocab: int, d: int, dtype):
    return torch.randn((vocab, d), generator=gen, dtype=F32,
                       device=gen.device).to(dtype)
