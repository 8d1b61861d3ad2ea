"""Backend-dispatched wrappers for the CUDA kernels.

This layer is the repo's rocBLAS *host dispatcher* (paper §2.3): call
sites never choose a kernel.  Every op resolves a
:class:`repro_torch.backend.BackendSpec` (bound to the device its tensors
live on) and a :class:`repro_torch.backend.DispatchTable`, and routes
between three lowerings:

    "kernel"  the hand-written CUDA kernels (``sbgemv.py``, ``pad_cast.py``),
    "torch"   the plain contraction (``ref.complex_contract``),
    "ref"     the oracles (``ref.py``): the forced ``torch-ref`` backend.

On a backend with the kernels every op takes its kernel unless the caller
forces another path for the gemv; a kernel path on tensors that are not on
the card raises :class:`repro_torch.backend.UnsupportedOnBackend`.

``tile_map=`` on the products is tile-centric precision: a TileMap (or a
grid of level chars) whose (R, C) cells split A's batch and column axes
element-wise, each A element rounded through its cell's level before the
contraction (``ref.quantize_tile_cells``).  The tiled kernels round on
load at any map shape, so the kernel path needs no alignment of cells and
kernel blocks and copies nothing; the "torch" path quantizes a copy.  A
backend whose spec lacks ``tile_precision`` raises on a map.
"""

from __future__ import annotations

import torch

from repro_torch.backend import (UnsupportedOnBackend, default_table,
                                 resolve_backend)

from . import pad_cast as _pad_cast
from . import ref as _ref
from . import sbgemv as _sbgemv


def resolve_backend_dispatch(backend=None, dispatch=None, device="cpu"):
    """Resolve ``(BackendSpec, DispatchTable)`` for tensors on ``device``.

    ``backend`` is a spec, a registered name, or None (the probe for
    ``device``, ``REPRO_TORCH_BACKEND`` override applies); ``dispatch``
    defaults to the backend's table.
    """
    spec = resolve_backend(backend, device)
    if dispatch is None:
        dispatch = default_table(spec)
    return spec, dispatch


def _require_card(t: torch.Tensor, spec) -> None:
    if t.device.type != "cuda":
        raise UnsupportedOnBackend(
            f"the CUDA kernel path of backend {spec.fingerprint()!r} was "
            f"selected for a tensor on {t.device}; move the data to the card "
            f"or pick a backend that serves {t.device}")


def _check_tile_support(spec, tile_map) -> None:
    if tile_map is not None and not spec.tile_precision:
        raise UnsupportedOnBackend(
            f"backend {spec.name!r} does not support tile-centric precision "
            f"(tile_map=); see BackendSpec.tile_precision")


def _contract(A_re, A_im, x_re, x_im, mode, out_dtype, backend, dispatch,
              oracle, kernels, tile_map):
    """The dispatch shared by :func:`sbgemv` and :func:`sbgemm`: the
    ``oracle`` on the "ref" path, the host contraction on "torch", else
    ``kernels`` (the N and the T/H wrapper, untiled and tiled) on the
    card."""
    if mode not in ("N", "T", "H"):
        raise ValueError(f"bad mode {mode!r}")
    out_dtype = out_dtype or A_re.dtype
    spec, table = resolve_backend_dispatch(backend, dispatch, A_re.device)
    _check_tile_support(spec, tile_map)
    path = table.gemv_path(A_re.dtype, spec)
    if path == "ref":
        y_re, y_im = (oracle(A_re, A_im, x_re, x_im, mode) if tile_map is None
                      else _ref.sbgemm_tiled_ref(A_re, A_im, x_re, x_im,
                                                 tile_map, mode))
        return _ref.cast(y_re, out_dtype), _ref.cast(y_im, out_dtype)
    if path == "torch":
        if tile_map is not None:
            A_re, A_im = _ref.quantize_tile_cells(tile_map, A_re, A_im)
        y_re, y_im = _ref.complex_contract(A_re, A_im, x_re, x_im, mode)
        return _ref.cast(y_re, out_dtype), _ref.cast(y_im, out_dtype)
    _require_card(A_re, spec)
    n_kernel, th_kernel, n_tiled, th_tiled = kernels
    if tile_map is not None:
        levels = _ref.tile_levels(tile_map)
        if mode == "N":
            return n_tiled(A_re, A_im, x_re, x_im, levels, out_dtype=out_dtype)
        return th_tiled(A_re, A_im, x_re, x_im, levels, conj=(mode == "H"),
                        out_dtype=out_dtype)
    if mode == "N":
        return n_kernel(A_re, A_im, x_re, x_im, out_dtype=out_dtype)
    return th_kernel(A_re, A_im, x_re, x_im, conj=(mode == "H"),
                     out_dtype=out_dtype)


def sbgemv(A_re, A_im, x_re, x_im, mode: str = "N", *, out_dtype=None,
           backend=None, dispatch=None, tile_map=None):
    """Strided-batched complex GEMV on split planes, backend-dispatched.

    A planes (B, m, n); mode "N": x (B, n) -> y (B, m); "T"/"H": x (B, m)
    -> y (B, n).  Returns (y_re, y_im) in ``out_dtype`` (default: A dtype).
    ``tile_map`` rounds A per cell first (the tiled SBGEMV kernels).
    """
    return _contract(A_re, A_im, x_re, x_im, mode, out_dtype, backend,
                     dispatch, _ref.sbgemv_complex_ref,
                     (_sbgemv.sbgemv_n_complex, _sbgemv.sbgemv_th_complex,
                      _sbgemv.sbgemv_n_complex_tiled,
                      _sbgemv.sbgemv_th_complex_tiled), tile_map)


def sbgemm(A_re, A_im, X_re, X_im, mode: str = "N", *, out_dtype=None,
           backend=None, dispatch=None, tile_map=None):
    """Strided-batched complex GEMM (multi-RHS GEMV) on split planes, with
    the dispatch of :func:`sbgemv`.

    A planes (B, m, n); mode "N": X (B, n, S) -> Y (B, m, S); "T"/"H":
    X (B, m, S) -> Y (B, n, S).  Returns (Y_re, Y_im) in ``out_dtype``
    (default: A dtype).  ``tile_map`` rounds A per cell first (the tiled
    SBGEMM kernels); X and the sums stay at the carrier dtype.
    """
    return _contract(A_re, A_im, X_re, X_im, mode, out_dtype, backend,
                     dispatch, _ref.sbgemm_complex_ref,
                     (_sbgemv.sbgemm_n_complex, _sbgemv.sbgemm_th_complex,
                      _sbgemv.sbgemm_n_complex_tiled,
                      _sbgemv.sbgemm_th_complex_tiled), tile_map)


def sbgemm_gram(A_re, A_im, *, space: str = "parameter", out_dtype=None,
                backend=None, dispatch=None, tile_map=None):
    """Per-bin Hermitian Gram blocks: G[k] = A[k]^H A[k] ("parameter",
    (B, n, n)) or A[k] A[k]^H ("data", (B, m, m)), with the dispatch of
    :func:`sbgemv`.

    The returned planes are exactly Hermitian (G_re symmetric, G_im
    antisymmetric with a zero diagonal): the accumulation-order asymmetry
    is averaged away before the output cast, as the reference does.  The
    kernel reads A in its stored layout in both spaces.  Setup-phase code
    (paper Phase 0), run once per operator.

    ``tile_map`` rounds A per cell on its (B, n) operand grid, before any
    data-space transpose, so both factors read the same quantized operand
    (the oracle's rule); the tiled kernel rounds each factor on load.
    """
    if space not in ("parameter", "data"):
        raise ValueError(f"bad gram space {space!r}")
    out_dtype = out_dtype or A_re.dtype
    spec, table = resolve_backend_dispatch(backend, dispatch, A_re.device)
    _check_tile_support(spec, tile_map)
    path = table.gemv_path(A_re.dtype, spec)
    if path == "ref":
        G_re, G_im = (_ref.sbgemm_gram_ref(A_re, A_im, space) if tile_map is None
                      else _ref.sbgemm_gram_tiled_ref(A_re, A_im, tile_map,
                                                      space))
    elif path == "torch":
        if tile_map is not None:
            A_re, A_im = _ref.quantize_tile_cells(tile_map, A_re, A_im)
        G_re, G_im = _ref.gram_contract(A_re, A_im, space)
    else:
        _require_card(A_re, spec)
        acc = _ref.acc_dtype(A_re.dtype)
        data = space == "data"
        G_re, G_im = (
            _sbgemv.sbgemm_gram_complex(A_re, A_im, data=data, out_dtype=acc)
            if tile_map is None else
            _sbgemv.sbgemm_gram_tiled(A_re, A_im, _ref.tile_levels(tile_map),
                                      data=data, out_dtype=acc))
    G_re = 0.5 * (G_re + G_re.transpose(1, 2))
    G_im = 0.5 * (G_im - G_im.transpose(1, 2))
    return _ref.cast(G_re, out_dtype), _ref.cast(G_im, out_dtype)


def pad_cast(x, pad_to: int, out_dtype, *, backend=None):
    """(R, T) -> (R, pad_to) fused zero-pad + cast (Phase-1 memory op)."""
    spec = resolve_backend(backend, x.device)
    if not spec.kernels:
        return _ref.pad_cast_ref(x, pad_to, out_dtype)
    _require_card(x, spec)
    return _pad_cast.pad_cast(x, pad_to, out_dtype)


def unpad_cast(x, keep: int, out_dtype, *, backend=None):
    """(R, P) -> (R, keep) fused unpad + cast (Phase-5 memory op)."""
    spec = resolve_backend(backend, x.device)
    if not spec.kernels:
        return _ref.unpad_cast_ref(x, keep, out_dtype)
    _require_card(x, spec)
    return _pad_cast.unpad_cast(x, keep, out_dtype)
