"""Strided-batched complex GEMV for short-wide matrices (paper C2), CUDA.

The paper's rocBLAS pathology: for batches of (m x n) matrices with
m << n (N_d sensors << N_m parameters), the stock conjugate-transpose
SBGEMV launches one block per output element, each doing a length-m dot
product.  The fix tiles the columns so a block computes a chunk of
outputs.  The kernels in ``csrc/sbgemv.cu`` do that for the transpose
modes and give the non-transpose mode one warp per output row, each lane
loading 16-byte vectors of A and x, four warp-wide steps in flight (two
buffers of them at f64);
complex data is carried as split re/im planes, each A element read once
for both output planes.  Their multi-RHS twins (SBGEMM, S right-hand sides on a
trailing axis) and the per-bin Gram blocks G = A^H A live in
``csrc/sbgemm.cu``; there each A element also serves every column of a
pass, f64 planes run on the FP64 tensor cores, the complex bf16 products
(N, T/H, Gram; the tiled N and Gram too, whose rounding is the identity
at a bf16 carrier) on the bf16 tensor cores (the data-space Gram of P <=
128 on wgmma), and the complex f32 products in staged FP32 kernels.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version beside it for CPU tensors.  Sums accumulate in f64 for f64 planes
and in f32 otherwise; the output is stored at ``out_dtype`` (default: the
plane dtype) straight from the accumulator.

The ``*_tiled`` wrappers are tile-centric precision: ``levels`` is an
(R, C) grid of ladder levels ("h"/"s"/"d", at most 8 x 8) over A's batch
and column axes, and each A element is rounded through its cell's level
(``ref.quantize_tile_cells``) before the contraction.  The kernels round
it as they load it, so no quantized copy of A is made on the card; the
plain versions quantize a copy, cell by cell.

The ``*_real`` wrappers are the same products on one real plane each of
A, x and y (modes N and T), built from the complex kernels' sources with
the imaginary planes compiled away (the SBGEMMs' entries as a library of
their own, ``csrc/sbgemm_real.cu``); their tiled builds exist for S > 1
only (``ops.sbgemv_real(tile_map=)`` runs the SBGEMM with S = 1).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import (LADDER_INDEX, cast, complex_contract, gram_contract,
                  quantize_tile_cells, real_contract, tile_levels)

MAX_TILES = 8          # csrc/common.cuh:kMaxTiles
WGMMA_GRAM_MAX_P = 128  # csrc/sbgemm_bf16.cuh: two 64-row warpgroups


def _check_planes(planes, out_dtype, what: str) -> None:
    if any(p.dtype != planes[0].dtype for p in planes):
        raise TypeError(f"{what}: all planes must share one dtype")
    for dt in (planes[0].dtype, out_dtype):
        if dt not in _build.DTYPE_CODES:
            raise TypeError(f"{what} takes bf16/f32/f64, not {dt}")
    if any(p.device != planes[0].device for p in planes):
        raise ValueError(f"{what}: planes on different devices")
    if planes[0].device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {planes[0].device}")
    if not all(p.is_contiguous() for p in planes):
        raise ValueError(f"{what} needs contiguous planes")


def _check(As, xs, x_axis: int, out_dtype, what: str,
           rhs: bool = False) -> None:
    """Shapes of the A planes ``As`` (one real plane or re and im) and the
    x planes ``xs`` of a GEMV (x (B, len)) or, with ``rhs``, a GEMM (X (B,
    len, S)), ``len`` being A's axis ``x_axis``; then dtypes, device,
    layout."""
    A0 = As[0]
    if A0.ndim != 3:
        raise ValueError(f"{what}: A planes must be (B, m, n), got "
                         f"{tuple(A0.shape)}")
    if any(A.shape != A0.shape for A in As):
        raise ValueError(f"{what}: A planes differ in shape")
    want = (A0.shape[0], A0.shape[x_axis])
    if rhs:
        want += (xs[0].shape[-1] if xs[0].ndim == 3 else -1,)
    for x in xs:
        if tuple(x.shape) != want:
            raise ValueError(f"{what}: x planes must be {want}, got "
                             f"{tuple(x.shape)}")
    _check_planes((*As, *xs), out_dtype, what)


def sbgemv_n_complex_plain(A_re, A_im, x_re, x_im, out_dtype):
    """Plain version of ``sbgemv_n_complex``."""
    y_re, y_im = complex_contract(A_re, A_im, x_re, x_im, "N")
    return cast(y_re, out_dtype), cast(y_im, out_dtype)


def sbgemv_th_complex_plain(A_re, A_im, x_re, x_im, conj, out_dtype):
    """Plain version of ``sbgemv_th_complex``."""
    mode = "H" if conj else "T"
    y_re, y_im = complex_contract(A_re, A_im, x_re, x_im, mode)
    return cast(y_re, out_dtype), cast(y_im, out_dtype)


def _level_grid(levels):
    """A tile map's grid as (R, C, a C int array of ladder indices)."""
    grid = tile_levels(levels)
    R, C = len(grid), len(grid[0])
    if R > MAX_TILES or C > MAX_TILES:
        raise ValueError(f"the tiled kernels take at most {MAX_TILES} x "
                         f"{MAX_TILES} cells, got {R} x {C}")
    flat = [LADDER_INDEX[lvl] for row in grid for lvl in row]
    return R, C, (ctypes.c_int * len(flat))(*flat)


def _launch(source: str, entry: str, inputs, out_shape, out_dtype, sizes,
            *ints, levels=None, n_out: int = 2):
    """Launch C entry ``entry`` of ``csrc/<source>.cu`` on ``inputs`` (A
    planes first) into ``n_out`` new ``out_shape`` planes; counts the
    launch.  ``levels``, a tile map's grid, goes as a host array after the
    outputs and its R and C after ``ints``."""
    A = inputs[0]
    outs = [torch.empty(out_shape, dtype=out_dtype, device=A.device)
            for _ in range(n_out)]
    ptrs = [t.data_ptr() for t in (*inputs, *outs)]
    if levels is not None:
        R, C, grid = _level_grid(levels)   # read by the entry before it returns
        ptrs.append(ctypes.addressof(grid))
        ints = (*ints, R, C)
    fn = getattr(_build.library(source), entry)
    err = fn(*ptrs, *sizes, *ints, _build.DTYPE_CODES[A.dtype],
             _build.DTYPE_CODES[out_dtype], A.device.index, _build.stream_of(A))
    _build.check(err, entry)
    _build.launch_counts[entry] += 1
    return tuple(outs)


def sbgemv_n_complex(A_re, A_im, x_re, x_im,
                     out_dtype: Optional[torch.dtype] = None):
    """y = A x per batch on split planes: A (B, m, n), x (B, n) ->
    (y_re, y_im) of shape (B, m)."""
    out_dtype = out_dtype or A_re.dtype
    _check((A_re, A_im), (x_re, x_im), 2, out_dtype, "sbgemv_n_complex")
    B, m, n = A_re.shape
    if A_re.device.type == "cpu":
        return sbgemv_n_complex_plain(A_re, A_im, x_re, x_im, out_dtype)
    return _launch("sbgemv", "sbgemv_n_complex", (A_re, A_im, x_re, x_im),
                   (B, m), out_dtype, A_re.shape)


def sbgemv_th_complex(A_re, A_im, x_re, x_im, *, conj: bool,
                      out_dtype: Optional[torch.dtype] = None):
    """y = A^T x, or A^H x with ``conj``, per batch on split planes:
    A (B, m, n), x (B, m) -> (y_re, y_im) of shape (B, n)."""
    out_dtype = out_dtype or A_re.dtype
    _check((A_re, A_im), (x_re, x_im), 1, out_dtype, "sbgemv_th_complex")
    B, m, n = A_re.shape
    if A_re.device.type == "cpu":
        return sbgemv_th_complex_plain(A_re, A_im, x_re, x_im, conj,
                                       out_dtype)
    return _launch("sbgemv", "sbgemv_th_complex", (A_re, A_im, x_re, x_im),
                   (B, n), out_dtype, A_re.shape, int(bool(conj)))


def sbgemv_n_complex_tiled_plain(A_re, A_im, x_re, x_im, levels, out_dtype):
    """Plain version of ``sbgemv_n_complex_tiled``."""
    Ar, Ai = quantize_tile_cells(levels, A_re, A_im)
    return sbgemv_n_complex_plain(Ar, Ai, x_re, x_im, out_dtype)


def sbgemv_th_complex_tiled_plain(A_re, A_im, x_re, x_im, levels, conj,
                                  out_dtype):
    """Plain version of ``sbgemv_th_complex_tiled``."""
    Ar, Ai = quantize_tile_cells(levels, A_re, A_im)
    return sbgemv_th_complex_plain(Ar, Ai, x_re, x_im, conj, out_dtype)


def sbgemv_n_complex_tiled(A_re, A_im, x_re, x_im, levels,
                           out_dtype: Optional[torch.dtype] = None):
    """``sbgemv_n_complex`` with A rounded per tile-map cell (``levels``)."""
    out_dtype = out_dtype or A_re.dtype
    _check((A_re, A_im), (x_re, x_im), 2, out_dtype, "sbgemv_n_complex_tiled")
    B, m, n = A_re.shape
    if A_re.device.type == "cpu":
        return sbgemv_n_complex_tiled_plain(A_re, A_im, x_re, x_im, levels,
                                            out_dtype)
    return _launch("sbgemv", "sbgemv_n_complex_tiled",
                   (A_re, A_im, x_re, x_im), (B, m), out_dtype, A_re.shape,
                   levels=levels)


def sbgemv_th_complex_tiled(A_re, A_im, x_re, x_im, levels, *, conj: bool,
                            out_dtype: Optional[torch.dtype] = None):
    """``sbgemv_th_complex`` with A rounded per tile-map cell (``levels``)."""
    out_dtype = out_dtype or A_re.dtype
    _check((A_re, A_im), (x_re, x_im), 1, out_dtype, "sbgemv_th_complex_tiled")
    B, m, n = A_re.shape
    if A_re.device.type == "cpu":
        return sbgemv_th_complex_tiled_plain(A_re, A_im, x_re, x_im, levels,
                                             conj, out_dtype)
    return _launch("sbgemv", "sbgemv_th_complex_tiled",
                   (A_re, A_im, x_re, x_im), (B, n), out_dtype, A_re.shape,
                   int(bool(conj)), levels=levels)


# ---------------------------------------------------------------------------
# Multi-RHS (SBGEMM) and per-bin Gram blocks: csrc/sbgemm.cu
# ---------------------------------------------------------------------------

def sbgemm_n_complex_plain(A_re, A_im, X_re, X_im, out_dtype):
    """Plain version of ``sbgemm_n_complex``."""
    return sbgemv_n_complex_plain(A_re, A_im, X_re, X_im, out_dtype)


def sbgemm_th_complex_plain(A_re, A_im, X_re, X_im, conj, out_dtype):
    """Plain version of ``sbgemm_th_complex``."""
    return sbgemv_th_complex_plain(A_re, A_im, X_re, X_im, conj, out_dtype)


def _check_gram(A_re, A_im, out_dtype, what: str) -> None:
    if A_re.ndim != 3 or A_im.shape != A_re.shape:
        raise ValueError(f"{what}: A planes must be two (B, m, n) tensors, "
                         f"got {tuple(A_re.shape)} and {tuple(A_im.shape)}")
    _check_planes((A_re, A_im), out_dtype, what)


def sbgemm_gram_complex_plain(A_re, A_im, data, out_dtype):
    """Plain version of ``sbgemm_gram_complex``."""
    G_re, G_im = gram_contract(A_re, A_im, "data" if data else "parameter")
    return cast(G_re, out_dtype), cast(G_im, out_dtype)


def sbgemm_n_complex(A_re, A_im, X_re, X_im,
                     out_dtype: Optional[torch.dtype] = None):
    """Y = A X per batch on split planes: A (B, m, n), X (B, n, S) ->
    (Y_re, Y_im) of shape (B, m, S)."""
    out_dtype = out_dtype or A_re.dtype
    _check((A_re, A_im), (X_re, X_im),
           2, out_dtype, "sbgemm_n_complex", rhs=True)
    B, m, n = A_re.shape
    S = X_re.shape[2]
    if A_re.device.type == "cpu":
        return sbgemm_n_complex_plain(A_re, A_im, X_re, X_im, out_dtype)
    return _launch("sbgemm", "sbgemm_n_complex", (A_re, A_im, X_re, X_im),
                   (B, m, S), out_dtype, (B, m, n, S))


def sbgemm_th_complex(A_re, A_im, X_re, X_im, *, conj: bool,
                      out_dtype: Optional[torch.dtype] = None):
    """Y = A^T X, or A^H X with ``conj``, per batch on split planes:
    A (B, m, n), X (B, m, S) -> (Y_re, Y_im) of shape (B, n, S)."""
    out_dtype = out_dtype or A_re.dtype
    _check((A_re, A_im), (X_re, X_im), 1, out_dtype, "sbgemm_th_complex",
           rhs=True)
    B, m, n = A_re.shape
    S = X_re.shape[2]
    if A_re.device.type == "cpu":
        return sbgemm_th_complex_plain(A_re, A_im, X_re, X_im, conj,
                                       out_dtype)
    return _launch("sbgemm", "sbgemm_th_complex", (A_re, A_im, X_re, X_im),
                   (B, n, S), out_dtype, (B, m, n, S), int(bool(conj)))


def gram_kernel_for(dtype: torch.dtype, data: bool, P: int) -> str:
    """The C entry that takes a Gram on the card: the wgmma kernel for the
    data space of bf16 planes with 1 <= P <= WGMMA_GRAM_MAX_P (a bin one
    tile: the paper's P = N_d = 100), else the general entry, which
    refuses the wgmma kernel's calls."""
    if dtype == torch.bfloat16 and data and 1 <= P <= WGMMA_GRAM_MAX_P:
        return "sbgemm_gram_complex_wgmma"
    return "sbgemm_gram_complex"


def sbgemm_gram_complex(A_re, A_im, *, data: bool = False,
                        out_dtype: Optional[torch.dtype] = None):
    """Per-batch Gram blocks on split planes: G = A^H A (B, n, n), or with
    ``data`` G = A A^H (B, m, m), read from A in its stored layout.  The
    kernel computes the tiles on and above the diagonal and writes their
    conjugates below it; neither it nor the plain version symmetrizes
    the diagonal tiles (``ops.sbgemm_gram`` does).  On the card the entry
    is :func:`gram_kernel_for`'s, each counted under its own name."""
    out_dtype = out_dtype or A_re.dtype
    _check_gram(A_re, A_im, out_dtype, "sbgemm_gram_complex")
    B, m, n = A_re.shape
    if A_re.device.type == "cpu":
        return sbgemm_gram_complex_plain(A_re, A_im, data, out_dtype)
    P = m if data else n
    return _launch("sbgemm", gram_kernel_for(A_re.dtype, data, P),
                   (A_re, A_im), (B, P, P), out_dtype, (B, m, n),
                   int(bool(data)))


def sbgemm_n_complex_tiled_plain(A_re, A_im, X_re, X_im, levels, out_dtype):
    """Plain version of ``sbgemm_n_complex_tiled``."""
    return sbgemv_n_complex_tiled_plain(A_re, A_im, X_re, X_im, levels,
                                        out_dtype)


def sbgemm_th_complex_tiled_plain(A_re, A_im, X_re, X_im, levels, conj,
                                  out_dtype):
    """Plain version of ``sbgemm_th_complex_tiled``."""
    return sbgemv_th_complex_tiled_plain(A_re, A_im, X_re, X_im, levels, conj,
                                         out_dtype)


def sbgemm_gram_tiled_plain(A_re, A_im, levels, data, out_dtype):
    """Plain version of ``sbgemm_gram_tiled``."""
    Ar, Ai = quantize_tile_cells(levels, A_re, A_im)
    return sbgemm_gram_complex_plain(Ar, Ai, data, out_dtype)


def sbgemm_n_complex_tiled(A_re, A_im, X_re, X_im, levels,
                           out_dtype: Optional[torch.dtype] = None):
    """``sbgemm_n_complex`` with A rounded per tile-map cell (``levels``)."""
    out_dtype = out_dtype or A_re.dtype
    _check((A_re, A_im), (X_re, X_im), 2, out_dtype, "sbgemm_n_complex_tiled",
           rhs=True)
    B, m, n = A_re.shape
    S = X_re.shape[2]
    if A_re.device.type == "cpu":
        return sbgemm_n_complex_tiled_plain(A_re, A_im, X_re, X_im, levels,
                                            out_dtype)
    return _launch("sbgemm", "sbgemm_n_complex_tiled",
                   (A_re, A_im, X_re, X_im), (B, m, S), out_dtype,
                   (B, m, n, S), levels=levels)


def sbgemm_th_complex_tiled(A_re, A_im, X_re, X_im, levels, *, conj: bool,
                            out_dtype: Optional[torch.dtype] = None):
    """``sbgemm_th_complex`` with A rounded per tile-map cell (``levels``)."""
    out_dtype = out_dtype or A_re.dtype
    _check((A_re, A_im), (X_re, X_im), 1, out_dtype, "sbgemm_th_complex_tiled",
           rhs=True)
    B, m, n = A_re.shape
    S = X_re.shape[2]
    if A_re.device.type == "cpu":
        return sbgemm_th_complex_tiled_plain(A_re, A_im, X_re, X_im, levels,
                                             conj, out_dtype)
    return _launch("sbgemm", "sbgemm_th_complex_tiled",
                   (A_re, A_im, X_re, X_im), (B, n, S), out_dtype,
                   (B, m, n, S), int(bool(conj)), levels=levels)


def sbgemm_gram_tiled(A_re, A_im, levels, *, data: bool = False,
                      out_dtype: Optional[torch.dtype] = None):
    """``sbgemm_gram_complex`` with A rounded per tile-map cell (``levels``,
    over A's (B, n) grid in both spaces): each factor of a product is
    rounded at its own cell."""
    out_dtype = out_dtype or A_re.dtype
    _check_gram(A_re, A_im, out_dtype, "sbgemm_gram_tiled")
    B, m, n = A_re.shape
    if A_re.device.type == "cpu":
        return sbgemm_gram_tiled_plain(A_re, A_im, levels, data, out_dtype)
    P = m if data else n
    return _launch("sbgemm", "sbgemm_gram_tiled", (A_re, A_im), (B, P, P),
                   out_dtype, (B, m, n), int(bool(data)), levels=levels)


# ---------------------------------------------------------------------------
# Real A: one plane each of A, x and y
# ---------------------------------------------------------------------------

def sbgemv_n_real_plain(A, x, out_dtype):
    """Plain version of ``sbgemv_n_real`` (and, with x (B, n, S), of
    ``sbgemm_n_real``)."""
    return cast(real_contract(A, x, "N"), out_dtype)


def sbgemv_th_real_plain(A, x, out_dtype):
    """Plain version of ``sbgemv_th_real`` (and, with x (B, m, S), of
    ``sbgemm_th_real``)."""
    return cast(real_contract(A, x, "T"), out_dtype)


sbgemm_n_real_plain = sbgemv_n_real_plain
sbgemm_th_real_plain = sbgemv_th_real_plain


def sbgemm_n_real_tiled_plain(A, X, levels, out_dtype):
    """Plain version of ``sbgemm_n_real_tiled``."""
    return sbgemv_n_real_plain(quantize_tile_cells(levels, A), X, out_dtype)


def sbgemm_th_real_tiled_plain(A, X, levels, out_dtype):
    """Plain version of ``sbgemm_th_real_tiled``."""
    return sbgemv_th_real_plain(quantize_tile_cells(levels, A), X, out_dtype)


def sbgemv_n_real(A, x, out_dtype: Optional[torch.dtype] = None):
    """y = A x per batch, real: A (B, m, n), x (B, n) -> y (B, m)."""
    out_dtype = out_dtype or A.dtype
    _check((A,), (x,), 2, out_dtype, "sbgemv_n_real")
    B, m, n = A.shape
    if A.device.type == "cpu":
        return sbgemv_n_real_plain(A, x, out_dtype)
    return _launch("sbgemv", "sbgemv_n_real", (A, x), (B, m), out_dtype,
                   A.shape, n_out=1)[0]


def sbgemv_th_real(A, x, out_dtype: Optional[torch.dtype] = None):
    """y = A^T x per batch, real: A (B, m, n), x (B, m) -> y (B, n)."""
    out_dtype = out_dtype or A.dtype
    _check((A,), (x,), 1, out_dtype, "sbgemv_th_real")
    B, m, n = A.shape
    if A.device.type == "cpu":
        return sbgemv_th_real_plain(A, x, out_dtype)
    return _launch("sbgemv", "sbgemv_th_real", (A, x), (B, n), out_dtype,
                   A.shape, n_out=1)[0]


def sbgemm_n_real(A, X, out_dtype: Optional[torch.dtype] = None):
    """Y = A X per batch, real: A (B, m, n), X (B, n, S) -> Y (B, m, S)."""
    out_dtype = out_dtype or A.dtype
    _check((A,), (X,), 2, out_dtype, "sbgemm_n_real", rhs=True)
    B, m, n = A.shape
    S = X.shape[2]
    if A.device.type == "cpu":
        return sbgemm_n_real_plain(A, X, out_dtype)
    return _launch("sbgemm_real", "sbgemm_n_real", (A, X), (B, m, S),
                   out_dtype, (B, m, n, S), n_out=1)[0]


def sbgemm_th_real(A, X, out_dtype: Optional[torch.dtype] = None):
    """Y = A^T X per batch, real: A (B, m, n), X (B, m, S) -> Y (B, n, S)."""
    out_dtype = out_dtype or A.dtype
    _check((A,), (X,), 1, out_dtype, "sbgemm_th_real", rhs=True)
    B, m, n = A.shape
    S = X.shape[2]
    if A.device.type == "cpu":
        return sbgemm_th_real_plain(A, X, out_dtype)
    return _launch("sbgemm_real", "sbgemm_th_real", (A, X), (B, n, S),
                   out_dtype, (B, m, n, S), n_out=1)[0]


def sbgemm_n_real_tiled(A, X, levels, out_dtype: Optional[torch.dtype] = None):
    """``sbgemm_n_real`` with A rounded per tile-map cell (``levels``)."""
    out_dtype = out_dtype or A.dtype
    _check((A,), (X,), 2, out_dtype, "sbgemm_n_real_tiled", rhs=True)
    B, m, n = A.shape
    S = X.shape[2]
    if A.device.type == "cpu":
        return sbgemm_n_real_tiled_plain(A, X, levels, out_dtype)
    return _launch("sbgemm_real", "sbgemm_n_real_tiled", (A, X), (B, m, S),
                   out_dtype, (B, m, n, S), levels=levels, n_out=1)[0]


def sbgemm_th_real_tiled(A, X, levels,
                         out_dtype: Optional[torch.dtype] = None):
    """``sbgemm_th_real`` with A rounded per tile-map cell (``levels``)."""
    out_dtype = out_dtype or A.dtype
    _check((A,), (X,), 1, out_dtype, "sbgemm_th_real_tiled", rhs=True)
    B, m, n = A.shape
    S = X.shape[2]
    if A.device.type == "cpu":
        return sbgemm_th_real_tiled_plain(A, X, levels, out_dtype)
    return _launch("sbgemm_real", "sbgemm_th_real_tiled", (A, X), (B, n, S),
                   out_dtype, (B, m, n, S), levels=levels, n_out=1)[0]
