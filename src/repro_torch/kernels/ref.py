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


def real_contract(A, x, mode: str):
    """Real GEMV, or GEMM when x carries a trailing RHS axis, at the
    accumulator dtype, with no output cast: modes "N" (y = A x) and "T"
    (y = A^T x).  A (B, m, n); x (B, n) or (B, n, S) for "N", (B, m) or
    (B, m, S) for "T"."""
    acc = acc_dtype(A.dtype)
    rhs = "s" if x.ndim == 3 else ""
    if mode == "N":
        eq = f"bmn,bn{rhs}->bm{rhs}"
    elif mode == "T":
        eq = f"bmn,bm{rhs}->bn{rhs}"
    else:
        raise ValueError(f"bad mode {mode!r}")
    return torch.einsum(eq, A.to(acc), x.to(acc))


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
    return real_contract(A, x, mode).to(A.dtype)


def sbgemm_real_ref(A, X, mode: str = "N"):
    """Strided-batched real GEMM (multi-RHS GEMV): the modes of
    :func:`sbgemv_real_ref` with the RHS axis last, X (B, n, S) for "N"
    and (B, m, S) for "T".  Returns the input dtype."""
    return sbgemv_real_ref(A, X, mode)


# -- tile-centric mixed precision ------------------------------------------
#
# A tile map's (R, C) grid partitions the operand's batch axis B and minor
# (column) axis n element-wise: element (b, :, c) belongs to cell
# (b*R // B, c*C // n).  Each element of A is round-tripped through its
# cell's ladder dtype; X and the accumulator stay in the carrier dtype.
# A round trip at or above the carrier is the identity (the mantissas
# nest: bf16 in f32 in f64).  Every lowering matches these oracles bit for
# bit in what it quantizes.

LADDER_INDEX = {"h": 0, "s": 1, "d": 2}
_LADDER_DTYPE = (torch.bfloat16, torch.float32, torch.float64)


def tile_levels(tile_map) -> tuple:
    """The (R, C) level grid of a TileMap or of nested level chars."""
    levels = tuple(tuple(r) for r in getattr(tile_map, "levels", tile_map))
    if not levels or not levels[0] or any(len(r) != len(levels[0])
                                          for r in levels):
        raise ValueError(f"tile map must be a non-empty rectangular grid, "
                         f"got {levels!r}")
    if any(lvl not in LADDER_INDEX for r in levels for lvl in r):
        raise ValueError(f"bad tile level in {levels!r}")
    return levels


def expand_tile_levels(tile_map, B: int, n: int) -> torch.Tensor:
    """Expand a tile-level grid to per-element ladder indices: an int32
    (B, n) tensor (h=0, s=1, d=2), element (b, c) taking cell
    ``(b*R // B, c*C // n)``."""
    levels = tile_levels(tile_map)
    R, C = len(levels), len(levels[0])
    grid = torch.tensor([[LADDER_INDEX[lvl] for lvl in r] for r in levels],
                        dtype=torch.int32)
    rows = (torch.arange(B) * R) // B
    cols = (torch.arange(n) * C) // n
    return grid[rows[:, None], cols[None, :]]


def _round_trip(A: torch.Tensor, index: int) -> torch.Tensor:
    return cast(A, _LADDER_DTYPE[index]).to(A.dtype)


def quantize_tile_planes(lvl_idx, *planes):
    """Round-trip each element of the (B, m, n) A planes through its cell's
    dtype, element-wise: ``lvl_idx`` is the (B, n) array of
    :func:`expand_tile_levels`, broadcast over the row axis m.  Returns
    carrier-dtype planes (one tensor for one plane)."""
    outs = []
    for A in planes:
        sel = torch.as_tensor(lvl_idx, device=A.device)[:, None, :]
        outs.append(torch.where(sel == 0, _round_trip(A, 0),
                                torch.where(sel == 1, _round_trip(A, 1), A)))
    return outs[0] if len(outs) == 1 else tuple(outs)


def tile_bounds(parts: int, extent: int) -> list:
    """Start of each of ``parts`` cells along an axis of ``extent`` and the
    end: cell r holds the indices i with ``i*parts // extent == r``, that
    is ``ceil(r*extent / parts) <= i < ceil((r+1)*extent / parts)``."""
    return [-(-r * extent // parts) for r in range(parts + 1)]


def quantize_tile_cells(tile_map, *planes):
    """:func:`quantize_tile_planes` of ``expand_tile_levels(tile_map, B,
    n)``, bit for bit, computed cell by cell: one copy of each plane and
    cell-sized temporaries, so it serves at the paper shape."""
    levels = tile_levels(tile_map)
    B, _, n = planes[0].shape
    rows, cols = tile_bounds(len(levels), B), tile_bounds(len(levels[0]), n)
    outs = []
    for A in planes:
        out = A.clone()
        carrier = _LADDER_DTYPE.index(A.dtype)
        for r, row in enumerate(levels):
            for c, lvl in enumerate(row):
                if LADDER_INDEX[lvl] >= carrier:
                    continue
                cell = out[rows[r]:rows[r + 1], :, cols[c]:cols[c + 1]]
                cell.copy_(_round_trip(cell, LADDER_INDEX[lvl]))
        outs.append(out)
    return outs[0] if len(outs) == 1 else tuple(outs)


def sbgemm_tiled_ref(A_re, A_im, X_re, X_im, tile_map, mode: str = "N"):
    """Tile-quantized complex GEMM (or GEMV, x (B, len)) oracle: quantize A
    per cell, contract exactly like :func:`sbgemm_complex_ref`."""
    Ar, Ai = quantize_tile_cells(tile_map, A_re, A_im)
    return sbgemm_complex_ref(Ar, Ai, X_re, X_im, mode)


def sbgemm_tiled_real_ref(A, X, tile_map, mode: str = "N"):
    """Tile-quantized real GEMM (or GEMV) oracle: quantize A per cell,
    contract exactly like :func:`sbgemm_real_ref`."""
    return sbgemm_real_ref(quantize_tile_cells(tile_map, A), X, mode)


def sbgemm_gram_tiled_ref(A_re, A_im, tile_map, space: str = "parameter"):
    """Tile-quantized Gram oracle: A is quantized once on its (B, n)
    operand grid, before any data-space transpose, and both factors read
    the quantized operand."""
    Ar, Ai = quantize_tile_cells(tile_map, A_re, A_im)
    return sbgemm_gram_ref(Ar, Ai, space)


def pad_cast_ref(x, pad_to: int, out_dtype):
    """Zero-pad the minor (time) axis to ``pad_to`` and cast: (..., T) ->
    (..., pad_to).  Fused Phase-1 memory op."""
    return F.pad(cast(x, out_dtype), (0, pad_to - x.shape[-1]))


def unpad_cast_ref(x, keep: int, out_dtype):
    """Slice the first ``keep`` entries of the minor axis and cast.  Fused
    Phase-5 memory op."""
    return cast(x[..., :keep], out_dtype)
