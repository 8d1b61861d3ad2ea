"""Oracles for the hand-written kernels (twins of the JAX ``ref.py``).

They define the semantics every kernel and every other lowering is held
against.  Sums accumulate in f64 for f64 inputs and in f32 otherwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``, with f64 -> bf16 rounded through f32.

    That double rounding is what both frameworks' own casts do on the CPU
    (1 + 2^-8 + 2^-30 -> 1.0), and what the CUDA kernels do, so every
    lowering of a cast agrees bit for bit.
    """
    if x.dtype == torch.float64 and dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.to(dtype)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator dtype for a plane dtype: f64 stays f64, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def complex_contract(A_re, A_im, x_re, x_im, mode: str):
    """Split-plane complex GEMV, or GEMM when x carries a trailing RHS axis,
    at the accumulator dtype, with no output cast: modes "N" (y = A x),
    "T" (y = A^T x), "H" (y = A^H x).  A planes (B, m, n); x planes (B, n)
    or (B, n, S) for "N", (B, m) or (B, m, S) otherwise."""
    acc = acc_dtype(A_re.dtype)
    Ar, Ai = A_re.to(acc), A_im.to(acc)
    xr, xi = x_re.to(acc), x_im.to(acc)
    rhs = "s" if x_re.ndim == 3 else ""
    if mode == "N":
        eq = f"bmn,bn{rhs}->bm{rhs}"
    elif mode in ("T", "H"):
        eq = f"bmn,bm{rhs}->bn{rhs}"
    else:
        raise ValueError(f"bad mode {mode!r}")
    rr, ii = torch.einsum(eq, Ar, xr), torch.einsum(eq, Ai, xi)
    ri, ir = torch.einsum(eq, Ai, xr), torch.einsum(eq, Ar, xi)
    if mode == "H":   # conj(A)^T x
        return rr + ii, ir - ri
    return rr - ii, ir + ri


def gram_contract(A_re, A_im, space: str):
    """Per-batch Gram blocks at the accumulator dtype, with no output cast
    and no symmetrization: ``space="parameter"`` G = A^H A (B, n, n),
    ``space="data"`` G = A A^H (B, m, m)."""
    acc = acc_dtype(A_re.dtype)
    Ar, Ai = A_re.to(acc), A_im.to(acc)
    if space == "parameter":
        eq = "bmn,bmk->bnk"           # (Ar - i Ai)^T (Ar + i Ai)
        return (torch.einsum(eq, Ar, Ar) + torch.einsum(eq, Ai, Ai),
                torch.einsum(eq, Ar, Ai) - torch.einsum(eq, Ai, Ar))
    if space == "data":
        eq = "bmn,bkn->bmk"           # (Ar + i Ai) (Ar^T - i Ai^T)
        return (torch.einsum(eq, Ar, Ar) + torch.einsum(eq, Ai, Ai),
                torch.einsum(eq, Ai, Ar) - torch.einsum(eq, Ar, Ai))
    raise ValueError(f"bad gram space {space!r}")


def sbgemv_complex_ref(A_re, A_im, x_re, x_im, mode: str = "N"):
    """Strided-batched complex GEMV on split re/im planes.

    A planes (B, m, n); mode "N": x (B, n) -> y (B, m); "T"/"H": x (B, m)
    -> y (B, n).  Returns (y_re, y_im) in the input dtype.
    """
    y_re, y_im = complex_contract(A_re, A_im, x_re, x_im, mode)
    return y_re.to(A_re.dtype), y_im.to(A_re.dtype)


def sbgemm_complex_ref(A_re, A_im, X_re, X_im, mode: str = "N"):
    """Strided-batched complex GEMM on split re/im planes: the modes of
    :func:`sbgemv_complex_ref` with the RHS axis last, X (B, n, S) for "N"
    and (B, m, S) otherwise.  Returns (Y_re, Y_im) in the input dtype."""
    return sbgemv_complex_ref(A_re, A_im, X_re, X_im, mode)


def sbgemm_gram_ref(A_re, A_im, space: str = "parameter"):
    """Per-batch Hermitian Gram blocks on split re/im planes: G = A^H A
    ("parameter", (B, n, n)) or A A^H ("data", (B, m, m)).  Returns
    (G_re, G_im) in the input dtype."""
    G_re, G_im = gram_contract(A_re, A_im, space)
    return G_re.to(A_re.dtype), G_im.to(A_re.dtype)


def sbgemv_real_ref(A, x, mode: str = "N"):
    """Strided-batched real GEMV.  A: (B, m, n); mode "N": x (B, n) ->
    y (B, m); mode "T": x (B, m) -> y (B, n).  Returns the input dtype."""
    acc = acc_dtype(A.dtype)
    if mode == "N":
        y = torch.einsum("bmn,bn->bm", A.to(acc), x.to(acc))
    elif mode == "T":
        y = torch.einsum("bmn,bm->bn", A.to(acc), x.to(acc))
    else:
        raise ValueError(f"bad mode {mode!r}")
    return y.to(A.dtype)


def pad_cast_ref(x, pad_to: int, out_dtype):
    """Zero-pad the minor (time) axis to ``pad_to`` and cast: (..., T) ->
    (..., pad_to).  Fused Phase-1 memory op."""
    return F.pad(cast(x, out_dtype), (0, pad_to - x.shape[-1]))


def unpad_cast_ref(x, keep: int, out_dtype):
    """Slice the first ``keep`` entries of the minor axis and cast.  Fused
    Phase-5 memory op."""
    return cast(x[..., :keep], out_dtype)
