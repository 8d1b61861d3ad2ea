"""State-space models: Mamba-1 (falcon-mamba-7b) and Mamba-2/SSD (zamba2).

Twin of ``src/repro/models/mamba.py``.  Both use a chunked formulation so
the (B, L, d_inner, d_state) hidden state sequence is never held whole: a
Python loop over chunks carries the state, and only one chunk's
intermediates are live.

Mamba-1: diagonal selective SSM, an elementwise linear recurrence
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t,   y_t = C_t . h_t + D x_t
solved within a chunk by a log-step scan (:func:`_scan`, the reference's
``jax.lax.associative_scan`` with its combine): the same function, summed
in another order.

Mamba-2 (SSD): scalar-per-head decay; the chunk-parallel product form
(an intra-chunk attention-like term plus inter-chunk state passing).

LTI/FFT mode: with input-independent dt/B/C the recurrence is a bank of
1-D LTI convolutions, a batch of triangular Toeplitz matvecs, computed by
circulant embedding and FFT (``torch.fft``: cuFFT on the card), as the
port's Phases 2 and 4.  The selective default path is not Toeplitz and
runs the scan.  Everything of the recurrences runs in f32; these are XLA
ops in the reference (no Pallas kernel), so they stay torch ops here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import layers as L
from .layers import F32


# ---------------------------------------------------------------------------
# chunked elementwise linear recurrence  h_t = a_t * h_{t-1} + b_t
# ---------------------------------------------------------------------------

def _pick_chunk(T: int, chunk: int) -> int:
    """The reference's chunk: min(chunk, T), lowered until it divides T."""
    c = min(chunk, T)
    while T % c:
        c -= 1
    return c


def _scan(a, b):
    """Inclusive scan along axis 1 under the reference's combine
    ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``, in log2(c) doubling
    steps: returns (A_cum, B_cum) with h_t = B_cum_t + A_cum_t h_{-1}."""
    c, d = a.shape[1], 1
    while d < c:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], b_prev * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], dim=1)
        d *= 2
    return a, b


def chunked_linear_recurrence(a, b, chunk: int):
    """a, b: (B, T, ...) -> h: (B, T, ...) with h_t = a_t h_{t-1} + b_t,
    h_{-1} = 0: a loop over T/chunk chunks carrying the state, a log-step
    scan within each."""
    T = a.shape[1]
    c = _pick_chunk(T, chunk)
    h0 = a.new_zeros((a.shape[0], *a.shape[2:]))
    out = []
    for t0 in range(0, T, c):
        A_cum, B_cum = _scan(a[:, t0:t0 + c], b[:, t0:t0 + c])
        h = B_cum + A_cum * h0[:, None]
        h0 = h[:, -1]
        out.append(h)
    return torch.cat(out, dim=1)


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv.  x: (B, T, C), w: (C, K).  With ``state``
    ((B, K-1, C), decode) uses it as left context and returns the new one.
    The taps are summed in x's dtype, k = 0 first, as the reference."""
    K = w.shape[-1]
    pad = (x.new_zeros((x.shape[0], K - 1, x.shape[2])) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                         # (B, T+K-1, C)
    T = x.shape[1]
    out = sum(xp[:, k:k + T, :] * w[:, k].to(x.dtype) for k in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else pad
    return out, new_state


# ---------------------------------------------------------------------------
# Mamba-1 block
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    D = cfg.d_model
    return D, cfg.ssm_expand * D, cfg.ssm_state, \
        cfg.ssm_dt_rank or max(D // 16, 1)


class Mamba1Layer(L.Weights):
    """One Mamba-1 block's weights in the reference's shapes; A_log starts
    at log(1 .. N) in every row (S4D-real), dt_bias at 0, D_skip at 1."""

    def __init__(self, cfg: ModelConfig, device=None):
        dt = cfg.policy.p()
        D, Di, N, R = _dims(cfg)
        s4d = lambda shape, dev: torch.log(  # noqa: E731
            torch.arange(1, N + 1, dtype=F32, device=dev)).expand(shape)
        super().__init__({
            "ln": ((D,), dt, "one"),
            "in_proj": ((D, 2 * Di), dt, "dense"),
            "conv_w": ((Di, cfg.ssm_conv), dt, 0.5),
            "x_proj": ((Di, R + 2 * N), dt, "dense"),
            "dt_proj": ((R, Di), dt, "dense"),
            "dt_bias": ((Di,), F32, "zero"),
            "A_log": ((Di, N), F32, s4d),
            "D_skip": ((Di,), F32, "one"),
            "out_proj": ((Di, D), dt, "dense"),
        }, device)


def _ssm_selective(x, dt, Bc, Cc, A_log, D_skip, chunk: int, ssm_state=None):
    """Selective scan, chunk by chunk: the (B, c, Di, N) transition and
    input tensors are built inside the chunk loop, so only one chunk's
    state sequence is live (the whole (B, T, Di, N) tensor would be GBs at
    falcon-mamba's widths).

    x: (B,T,Di); dt: (B,T,Di); Bc/Cc: (B,T,N); ssm_state: (B,Di,N) carried
    state (decode).  f32 throughout; returns (y (B,T,Di), last_state)."""
    Bsz, T, Di = x.shape
    N = Bc.shape[-1]
    x, dt, Bc, Cc = (v.to(F32) for v in (x, dt, Bc, Cc))
    c = _pick_chunk(T, chunk)
    A = -torch.exp(A_log.to(F32))                          # (Di, N)
    h0 = (x.new_zeros((Bsz, Di, N)) if ssm_state is None
          else ssm_state.to(F32))
    ys = []
    for t0 in range(0, T, c):
        x_k, dt_k, B_k, C_k = (v[:, t0:t0 + c] for v in (x, dt, Bc, Cc))
        a = torch.exp(dt_k[..., None] * A)                 # (B,c,Di,N)
        b = (dt_k * x_k)[..., None] * B_k[:, :, None, :]
        A_cum, B_cum = _scan(a, b)
        del a, b
        h = B_cum + A_cum * h0[:, None]
        del A_cum, B_cum
        ys.append(torch.einsum("bcdn,bcn->bcd", h, C_k))
        h0 = h[:, -1]
        del h
    y = torch.cat(ys, dim=1)
    return y + D_skip.to(F32) * x, h0


def _in_proj(cfg: ModelConfig, lp, h):
    x = L.rms_norm(h, lp.ln, cfg.norm_eps)
    return L.dense(x, lp.in_proj)


def conv_inputs(cfg: ModelConfig, lp: Mamba1Layer, h, conv_state=None):
    """A Mamba-1 block up to its SSM: the input projection, the causal conv
    and SiLU.  Returns (xi (B,T,Di) f32, the gate z, the new conv
    state)."""
    Di = cfg.ssm_expand * cfg.d_model
    xz = _in_proj(cfg, lp, h)
    xi, new_conv = causal_conv1d(xz[..., :Di], lp.conv_w, conv_state)
    return F.silu(xi.to(F32)), xz[..., Di:], new_conv


def selective_inputs(cfg: ModelConfig, lp: Mamba1Layer, xi, dtype):
    """The input-dependent step and projections of the selective SSM:
    (dt (B,T,Di), B (B,T,N), C (B,T,N)), f32."""
    _, _, N, R = _dims(cfg)
    proj = L.dense(xi.to(dtype), lp.x_proj).to(F32)
    dt_r, Bc, Cc = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    return F.softplus(dt_r @ lp.dt_proj.to(F32) + lp.dt_bias), Bc, Cc


def _out(lp, h, y, z):
    """The gated output projection and the residual."""
    y = y * F.silu(z.to(F32))
    return h + L.dense(y.to(h.dtype), lp.out_proj)


def mamba1_block(cfg: ModelConfig, lp: Mamba1Layer, h, *, state=None):
    """h: (B,T,D).  state (decode): {"conv": (B,K-1,Di), "ssm": (B,Di,N)}.
    Returns (out, new_state)."""
    xi, z, new_conv = conv_inputs(cfg, lp, h, state["conv"]
                                  if state is not None else None)
    dt, Bc, Cc = selective_inputs(cfg, lp, xi, h.dtype)
    y, new_ssm = _ssm_selective(xi, dt, Bc, Cc, lp.A_log, lp.D_skip,
                                cfg.ssm_chunk,
                                state["ssm"] if state is not None else None)
    return _out(lp, h, y, z), {"conv": new_conv.to(h.dtype), "ssm": new_ssm}


# ---------------------------------------------------------------------------
# LTI/FFT path (the paper's operator applied to the SSM family)
# ---------------------------------------------------------------------------

def lti_kernel(cfg: ModelConfig, lp: Mamba1Layer, T: int):
    """The frozen-(dt, B, C) SSM's impulse response (T, Di) f32:
    k[t] = sum_n C_n B_n dt decay^t with dt = softplus(dt_bias) and
    B = C = 1/sqrt(N)."""
    N = cfg.ssm_state
    dt = F.softplus(lp.dt_bias)                            # (Di,)
    A = -torch.exp(lp.A_log)                               # (Di, N)
    decay = torch.exp(dt[:, None] * A)                     # (Di, N)
    t = torch.arange(T, dtype=F32, device=dt.device)
    return torch.einsum("dn,tdn->td", torch.full_like(A, 1.0 / N) * dt[:, None],
                        decay[None] ** t[:, None, None])


def lti_conv_fft(kern, x):
    """The causal convolution y[t] = sum_{s<=t} k[t-s] x[s] of each channel,
    a bank of triangular Toeplitz matvecs, by circulant embedding: kern
    (T, Di), x (B, T, Di) zero-padded to 2T, rfft, a diagonal product,
    irfft, the first T rows."""
    T = x.shape[1]
    K = torch.fft.rfft(F.pad(kern, (0, 0, 0, T)), dim=0)          # (T+1, Di)
    X = torch.fft.rfft(F.pad(x, (0, 0, 0, T)), dim=1)
    return torch.fft.irfft(X * K[None], n=2 * T, dim=1)[:, :T]


def mamba1_block_lti_fft(cfg: ModelConfig, lp: Mamba1Layer, h):
    """Frozen-(dt, B, C) variant: the SSM is LTI, so y = k * x is a bank of
    triangular Toeplitz matvecs, evaluated by circulant embedding and FFT
    (the paper's Phases 1/2/4/5 with a diagonal Fourier-space multiply in
    place of the SBGEMV)."""
    xi, z, _ = conv_inputs(cfg, lp, h)
    y = lti_conv_fft(lti_kernel(cfg, lp, xi.shape[1]), xi)
    return _out(lp, h, y + lp.D_skip * xi, z)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block: zamba2's SSM component
# ---------------------------------------------------------------------------

class Mamba2Layer(L.Weights):
    """One Mamba-2 block's weights; ``in_proj`` columns in the order
    [x (Di), z (Di), B (N), C (N), dt (H)]."""

    def __init__(self, cfg: ModelConfig, device=None):
        dt = cfg.policy.p()
        D, Di, N, _ = _dims(cfg)
        H = Di // cfg.ssm_head_dim
        super().__init__({
            "ln": ((D,), dt, "one"),
            "in_proj": ((D, 2 * Di + 2 * N + H), dt, "dense"),
            "conv_w": ((Di + 2 * N, cfg.ssm_conv), dt, 0.5),
            "A_log": ((H,), F32, "zero"),
            "dt_bias": ((H,), F32, "zero"),
            "D_skip": ((H,), F32, "one"),
            "norm_w": ((Di,), dt, "one"),
            "out_proj": ((Di, D), dt, "dense"),
        }, device)


def _ssd_chunked(x, dt, Bc, Cc, A_log, chunk: int, state=None):
    """SSD chunk-parallel form.  x: (B,T,H,Ph); dt: (B,T,H); Bc/Cc: (B,T,N);
    state: (B,H,Ph,N).  Returns (y (B,T,H,Ph), last_state), f32."""
    Bsz, T, H, Ph = x.shape
    N = Bc.shape[-1]
    x, dt, Bc, Cc = (v.to(F32) for v in (x, dt, Bc, Cc))
    a = dt * (-torch.exp(A_log.to(F32)))                   # (B,T,H) log-decay
    c = _pick_chunk(T, chunk)
    n = T // c
    xb = (x * dt[..., None]).reshape(Bsz, n, c, H, Ph)
    a = a.reshape(Bsz, n, c, H)
    Bb = Bc.reshape(Bsz, n, c, N)
    Cb = Cc.reshape(Bsz, n, c, N)

    cum = torch.cumsum(a, dim=2)                           # within-chunk
    # intra-chunk "attention": L[i,j] = exp(cum_i - cum_j) for i >= j
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,n,i,j,H)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    Ldec = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    del diff
    scores = torch.einsum("bgin,bgjn->bgij", Cb, Bb)        # (B,n,i,j)
    y_intra = torch.einsum("bgijh,bgjhp->bgihp", scores[..., None] * Ldec, xb)
    del Ldec

    # chunk summary state: S_g = sum_j exp(cum_last - cum_j) * B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)      # (B,n,c,H)
    S = torch.einsum("bgjn,bgjhp->bghpn", Bb,
                     decay_to_end[..., None] * xb)         # (B,n,H,Ph,N)
    a_tot = torch.exp(cum[:, :, -1, :])                    # (B,n,H)

    S_prev = (x.new_zeros((Bsz, H, Ph, N)) if state is None
              else state.to(F32))
    prevs = []
    for g in range(n):
        prevs.append(S_prev)
        S_prev = S_prev * a_tot[:, g, :, None, None] + S[:, g]
    S_prevs = torch.stack(prevs, dim=1)                    # (B,n,H,Ph,N)

    # inter-chunk: y_i += C_i . (decay_from_start_i * S_prev)
    y_inter = torch.einsum("bgin,bghpn->bgihp", Cb, S_prevs) * \
        torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, T, H, Ph)
    return y, S_prev


def mamba2_block(cfg: ModelConfig, lp: Mamba2Layer, h, *, state=None):
    """h: (B,T,D).  state (decode): {"conv": (B,K-1,Di+2N), "ssm":
    (B,H,Ph,N)}.  Returns (out, new_state)."""
    D, Di, N, _ = _dims(cfg)
    Ph = cfg.ssm_head_dim
    H = Di // Ph
    proj = _in_proj(cfg, lp, h)
    z = proj[..., Di:2 * Di]
    xBC = torch.cat([proj[..., :Di], proj[..., 2 * Di:2 * Di + 2 * N]], dim=-1)
    dt_r = proj[..., 2 * Di + 2 * N:]
    xBC, new_conv = causal_conv1d(xBC, lp.conv_w,
                                  state["conv"] if state is not None else None)
    xBC = F.silu(xBC.to(F32))
    xi, Bc, Cc = xBC[..., :Di], xBC[..., Di:Di + N], xBC[..., Di + N:]
    dt = F.softplus(dt_r.to(F32) + lp.dt_bias)
    Bsz, T = h.shape[:2]
    xh = xi.reshape(Bsz, T, H, Ph)
    y, new_ssm = _ssd_chunked(xh, dt, Bc, Cc, lp.A_log, cfg.ssm_chunk,
                              state["ssm"] if state is not None else None)
    y = (y + lp.D_skip[:, None] * xh).reshape(Bsz, T, Di)
    # gated RMSNorm (mamba2)
    y = L.rms_norm((y * F.silu(z.to(F32))).to(h.dtype), lp.norm_w,
                   cfg.norm_eps)
    return h + L.dense(y, lp.out_proj), {"conv": new_conv.to(h.dtype),
                                         "ssm": new_ssm}


def init_ssm_state(cfg: ModelConfig, batch: int, version: int, device=None):
    """Zero decode state of one layer: conv at the compute dtype, ssm f32."""
    D, Di, N, _ = _dims(cfg)
    K = cfg.ssm_conv
    conv_w = Di if version == 1 else Di + 2 * N
    ssm = ((batch, Di, N) if version == 1 else
           (batch, Di // cfg.ssm_head_dim, cfg.ssm_head_dim, N))
    return {"conv": torch.zeros((batch, K - 1, conv_w), dtype=cfg.policy.c(),
                                device=device),
            "ssm": torch.zeros(ssm, dtype=F32, device=device)}
