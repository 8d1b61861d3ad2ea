"""Strided-batched complex GEMV for short-wide matrices (paper C2), CUDA.

The paper's rocBLAS pathology: for batches of (m x n) matrices with
m << n (N_d sensors << N_m parameters), the stock conjugate-transpose
SBGEMV launches one block per output element, each doing a length-m dot
product.  The fix tiles the columns so a block computes a chunk of
outputs.  The kernels in ``csrc/sbgemv.cu`` do that for the transpose
modes and give the non-transpose mode one warp per output row; complex
data is carried as split re/im planes, each A element read once for both
output planes.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version beside it for CPU tensors.  Sums accumulate in f64 for f64 planes
and in f32 otherwise; the output is stored at ``out_dtype`` (default: the
plane dtype) straight from the accumulator.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import cast, complex_contract


def _check(A_re, A_im, x_re, x_im, x_axis: int, out_dtype, what: str) -> None:
    if A_re.ndim != 3:
        raise ValueError(f"{what}: A planes must be (B, m, n), got "
                         f"{tuple(A_re.shape)}")
    B, x_len = A_re.shape[0], A_re.shape[x_axis]
    if A_im.shape != A_re.shape:
        raise ValueError(f"{what}: A planes differ in shape")
    for x in (x_re, x_im):
        if tuple(x.shape) != (B, x_len):
            raise ValueError(f"{what}: x planes must be {(B, x_len)}, got "
                             f"{tuple(x.shape)}")
    planes = (A_re, A_im, x_re, x_im)
    if any(p.dtype != A_re.dtype for p in planes):
        raise TypeError(f"{what}: all planes must share one dtype")
    for dt in (A_re.dtype, out_dtype):
        if dt not in _build.DTYPE_CODES:
            raise TypeError(f"{what} takes bf16/f32/f64, not {dt}")
    if any(p.device != A_re.device for p in planes):
        raise ValueError(f"{what}: planes on different devices")
    if A_re.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {A_re.device}")
    if not all(p.is_contiguous() for p in planes):
        raise ValueError(f"{what} needs contiguous planes")


def sbgemv_n_complex_plain(A_re, A_im, x_re, x_im, out_dtype):
    """Plain version of ``sbgemv_n_complex``."""
    y_re, y_im = complex_contract(A_re, A_im, x_re, x_im, "N")
    return cast(y_re, out_dtype), cast(y_im, out_dtype)


def sbgemv_th_complex_plain(A_re, A_im, x_re, x_im, conj, out_dtype):
    """Plain version of ``sbgemv_th_complex``."""
    mode = "H" if conj else "T"
    y_re, y_im = complex_contract(A_re, A_im, x_re, x_im, mode)
    return cast(y_re, out_dtype), cast(y_im, out_dtype)


def _launch(entry: str, A_re, A_im, x_re, x_im, y_shape, out_dtype, *ints):
    y_re = torch.empty(y_shape, dtype=out_dtype, device=A_re.device)
    y_im = torch.empty(y_shape, dtype=out_dtype, device=A_re.device)
    fn = getattr(_build.library("sbgemv"), entry)
    err = fn(A_re.data_ptr(), A_im.data_ptr(), x_re.data_ptr(),
             x_im.data_ptr(), y_re.data_ptr(), y_im.data_ptr(),
             *A_re.shape, *ints, _build.DTYPE_CODES[A_re.dtype],
             _build.DTYPE_CODES[out_dtype], A_re.device.index,
             _build.stream_of(A_re))
    _build.check(err, entry)
    _build.launch_counts[entry] += 1
    return y_re, y_im


def sbgemv_n_complex(A_re, A_im, x_re, x_im,
                     out_dtype: Optional[torch.dtype] = None):
    """y = A x per batch on split planes: A (B, m, n), x (B, n) ->
    (y_re, y_im) of shape (B, m)."""
    out_dtype = out_dtype or A_re.dtype
    _check(A_re, A_im, x_re, x_im, 2, out_dtype, "sbgemv_n_complex")
    B, m, n = A_re.shape
    if A_re.device.type == "cpu":
        return sbgemv_n_complex_plain(A_re, A_im, x_re, x_im, out_dtype)
    return _launch("sbgemv_n_complex", A_re, A_im, x_re, x_im, (B, m),
                   out_dtype)


def sbgemv_th_complex(A_re, A_im, x_re, x_im, *, conj: bool,
                      out_dtype: Optional[torch.dtype] = None):
    """y = A^T x, or A^H x with ``conj``, per batch on split planes:
    A (B, m, n), x (B, m) -> (y_re, y_im) of shape (B, n)."""
    out_dtype = out_dtype or A_re.dtype
    _check(A_re, A_im, x_re, x_im, 1, out_dtype, "sbgemv_th_complex")
    B, m, n = A_re.shape
    if A_re.device.type == "cpu":
        return sbgemv_th_complex_plain(A_re, A_im, x_re, x_im, conj,
                                       out_dtype)
    return _launch("sbgemv_th_complex", A_re, A_im, x_re, x_im, (B, n),
                   out_dtype, int(bool(conj)))
