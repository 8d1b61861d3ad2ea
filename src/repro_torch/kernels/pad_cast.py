"""Fused zero-pad + cast and unpad + cast (paper §3.2), CUDA kernels.

"At all possible points, the casting kernels are fused with any nearby
memory operations (zero-padding, unpadding, etc.)": the Phase-1 pad and
the Phase-5 unpad read and write the vector once, casting on the way.
The kernels live in ``csrc/pad_cast.cu``; each wrapper launches its kernel
for a CUDA tensor and runs the plain version beside it for a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import cast


def _check(x: torch.Tensor, out_dtype: torch.dtype, what: str) -> None:
    if x.ndim != 2:
        raise ValueError(f"{what} takes a 2-D (rows, cols) tensor, got "
                         f"shape {tuple(x.shape)}")
    for dt in (x.dtype, out_dtype):
        if dt not in _build.DTYPE_CODES:
            raise TypeError(f"{what} takes bf16/f32/f64, not {dt}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{what} needs unit column stride, got strides "
                         f"{x.stride()}")


def pad_cast_plain(x: torch.Tensor, pad_to: int,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: (R, T) -> (R, pad_to), zero columns >= T, cast."""
    out = x.new_zeros((x.shape[0], pad_to), dtype=out_dtype)
    out[:, :x.shape[1]] = cast(x, out_dtype)
    return out


def unpad_cast_plain(x: torch.Tensor, keep: int,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: (R, P) -> (R, keep), cast."""
    return cast(x[:, :keep], out_dtype).contiguous()


def pad_cast(x: torch.Tensor, pad_to: int,
             out_dtype: torch.dtype) -> torch.Tensor:
    """(R, T) -> (R, pad_to) zero-padded on the minor axis and cast to
    ``out_dtype``.  Rows may be strided; columns must be unit-stride."""
    _check(x, out_dtype, "pad_cast")
    R, T = x.shape
    if pad_to < T:
        raise ValueError(f"pad_cast: pad_to={pad_to} < T={T}")
    if x.device.type == "cpu":
        return pad_cast_plain(x, pad_to, out_dtype)
    if _build.traced(x):
        return _PAD(x, pad_to, out_dtype)
    y = torch.empty((R, pad_to), dtype=out_dtype, device=x.device)
    fn = _build.library("pad_cast").pad_cast
    err = fn(x.data_ptr(), y.data_ptr(), R, T, pad_to, x.stride(0),
             _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[out_dtype],
             x.device.index, _build.stream_of(x))
    _build.check(err, "pad_cast")
    _build.launch_counts["pad_cast"] += 1
    return y


def unpad_cast(x: torch.Tensor, keep: int,
               out_dtype: torch.dtype) -> torch.Tensor:
    """(R, P) -> (R, keep): the leading minor-axis entries, cast to
    ``out_dtype``.  Rows may be strided; columns must be unit-stride."""
    _check(x, out_dtype, "unpad_cast")
    R, P = x.shape
    if keep > P:
        raise ValueError(f"unpad_cast: keep={keep} > P={P}")
    if x.device.type == "cpu":
        return unpad_cast_plain(x, keep, out_dtype)
    if _build.traced(x):
        return _UNPAD(x, keep, out_dtype)
    y = torch.empty((R, keep), dtype=out_dtype, device=x.device)
    fn = _build.library("pad_cast").unpad_cast
    err = fn(x.data_ptr(), y.data_ptr(), R, keep, x.stride(0),
             _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[out_dtype],
             x.device.index, _build.stream_of(x))
    _build.check(err, "unpad_cast")
    _build.launch_counts["unpad_cast"] += 1
    return y


def _fake(x, cols, out_dtype):
    return x.new_empty((x.shape[0], cols), dtype=out_dtype)


# the kernels as custom ops (``_build.kernel_op``), called under a dispatch
# mode or on fake tensors: no FLOPs; pad reads its input and writes the
# padded rows, unpad reads only the kept columns
_PAD = _build.kernel_op(
    "pad_cast", "(Tensor x, int pad_to, ScalarType out_dtype) -> Tensor",
    pad_cast, _fake, lambda *a: 0)
_UNPAD = _build.kernel_op(
    "unpad_cast", "(Tensor x, int keep, ScalarType out_dtype) -> Tensor",
    unpad_cast, _fake, lambda *a: 0,
    nbytes=lambda x, keep, dt: x.shape[0] * keep * (x.element_size()
                                                    + dt.itemsize))
