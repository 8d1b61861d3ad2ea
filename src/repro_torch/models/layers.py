"""Neural-net primitives of the LM families: RMS and layer norm, RoPE and
sinusoid positions, GQA attention (chunked online softmax, a block-causal
variant, the flash kernel), the gated and the GELU MLP, the layer
rematerialisation of :func:`remat`, and :class:`Weights`, the holder of a
block's named (trainable) parameters.

Twin of ``src/repro/models/layers.py``.  Products of the attention
softmax run on f32 operands (a bf16 operand widens exactly, so each
product equals the reference's f32-accumulated one up to summation
order); softmax statistics are always f32.  The reference's sharding
constraints are no-ops on one device and have no twin here.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..kernels.flash_attention import flash_attention

F32 = torch.float32


def rms_norm(x, gamma, eps: float = 1e-5):
    h = x.to(F32)
    scale = torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    return (h * scale).to(x.dtype) * gamma.to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    h = x.to(F32)
    mu = h.mean(dim=-1, keepdim=True)
    var = ((h - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (h - mu) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * gamma.to(x.dtype) + beta.to(x.dtype)


def sinusoid_positions(positions, d: int, max_scale: float = 1e4):
    """Sinusoidal positional embedding, length-agnostic.  positions:
    (..., S) int -> (..., S, d) f32."""
    half = d // 2
    freqs = torch.exp(-math.log(max_scale) * torch.arange(
        half, dtype=F32, device=positions.device) / half)
    ang = positions[..., None].to(F32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _ProductF32(torch.autograd.Function):
    """``torch.mm``/``torch.bmm`` of two bf16/f16 operands with
    ``out_dtype=torch.float32``, differentiable: that overload has no
    derivative in autograd.  The backward runs the same f32-output
    products on the cotangent rounded once to the operands' dtype, each
    gradient rounded once to its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return (torch.mm if x.dim() == 2 else torch.bmm)(x, w, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        prod = torch.mm if x.dim() == 2 else torch.bmm
        g = g.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = prod(g, w.mT, out_dtype=F32).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = prod(x.mT, g, out_dtype=F32).to(w.dtype)
        return gx, gw


def matmul_f32(x, w):
    """x @ w(cast to x's dtype) with f32 sums and an f32 result, as the
    reference's ``preferred_element_type=F32``.  For bf16/f16 operands the
    device decides how: on the card the f32-output product
    (``torch.mm(..., out_dtype=torch.float32)``, which runs or raises,
    through :class:`_ProductF32` for its gradient); on the CPU, which has
    no kernel for that overload, the operands widened to f32 and an f32
    product.  A bf16 x bf16 product is exact in f32, so both compute the
    same f32-summed function."""
    w = w.to(x.dtype)
    if x.dtype not in (torch.bfloat16, torch.float16):
        return torch.matmul(x, w).to(F32)
    if x.device.type == "cpu":
        return torch.matmul(x.to(F32), w.to(F32))
    y = _ProductF32.apply(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def bmm_f32(x, w):
    """Batched x (E, M, K) @ w (E, K, N) (cast to x's dtype) with f32 sums
    and an f32 result, as :func:`matmul_f32` for one product: on the card
    ``torch.bmm(..., out_dtype=torch.float32)`` for bf16/f16 operands, on
    the CPU the operands widened to f32."""
    w = w.to(x.dtype)
    if x.dtype not in (torch.bfloat16, torch.float16):
        return torch.bmm(x, w).to(F32)
    if x.device.type == "cpu":
        return torch.bmm(x.to(F32), w.to(F32))
    return _ProductF32.apply(x, w)


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


def gelu_mlp(x, w1, b1, w2, b2):
    """The reference's ``jax.nn.gelu`` is the tanh approximation."""
    h = dense(x, w1, b1)
    return dense(F.gelu(h.to(F32), approximate="tanh").to(x.dtype), w2, b2)


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------

# the products whose outputs remat="dots" keeps (jax's checkpoint_dots)
_DOTS = tuple(op for op in (torch.ops.aten.mm.default,
                            getattr(torch.ops.aten.mm, "dtype", None),
                            torch.ops.aten.bmm.default,
                            getattr(torch.ops.aten.bmm, "dtype", None))
              if op is not None)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(cfg, fn):
    """A layer body under ``cfg.remat``, as the reference's ``_remat``:
    "full" keeps only the body's inputs for backward and runs it again
    there (``torch.utils.checkpoint``, jax's ``nothing_saveable``), "dots"
    keeps the outputs of its matrix products and recomputes the rest
    (jax's ``checkpoint_dots``), "none" keeps everything.  Without grad
    mode the body runs as it is."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    kw = ({"context_fn": functools.partial(
        _ckpt.create_selective_checkpoint_contexts, _dots_policy)}
          if cfg.remat == "dots" else {})

    @functools.wraps(fn)
    def body(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    return body


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

class Weights(nn.Module):
    """A block's named trainable parameters, made empty from a spec
    ``{name: (shape, dtype, init)}`` in the reference's per-block shapes
    and drawn by
    :meth:`reset_`.  ``init`` is "one", "zero", "dense" (:func:`init_dense`),
    a float (:func:`init_dense` at that scale), "embed" (:func:`init_embed`)
    or a function ``(shape, device) -> tensor``.  Submodules added after
    ``__init__`` keep their own parameters and draws."""

    def __init__(self, spec: dict, device=None):
        super().__init__()
        self._init = {}
        for name, (shape, dtype, init) in spec.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device)))
            self._init[name] = init

    def reset_(self, gen: torch.Generator) -> None:
        """Draw this block's own parameters (not its submodules') from
        ``gen``, in spec order."""
        with torch.no_grad():
            for name, init in self._init.items():
                p = getattr(self, name)
                if init == "one":
                    p.fill_(1.0)
                elif init == "zero":
                    p.zero_()
                elif init == "embed":
                    p.copy_(init_embed(gen, *p.shape, p.dtype))
                elif init == "dense" or isinstance(init, float):
                    p.copy_(init_dense(gen, p.shape, p.dtype,
                                       None if init == "dense" else init))
                else:
                    p.copy_(init(p.shape, p.device))


def reset_all_(model: nn.Module, gen: torch.Generator) -> None:
    """Draw every :class:`Weights` block of ``model`` from ``gen``, in
    module order."""
    for m in model.modules():
        if isinstance(m, Weights):
            m.reset_(gen)


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
