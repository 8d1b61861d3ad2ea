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


def _contract(A_re, A_im, x_re, x_im, mode, out_dtype, backend, dispatch,
              oracle, kernels):
    """The dispatch shared by :func:`sbgemv` and :func:`sbgemm`: the
    ``oracle`` on the "ref" path, the host contraction on "torch", else
    ``kernels`` (the N and the T/H wrapper) on the card."""
    if mode not in ("N", "T", "H"):
        raise ValueError(f"bad mode {mode!r}")
    out_dtype = out_dtype or A_re.dtype
    spec, table = resolve_backend_dispatch(backend, dispatch, A_re.device)
    path = table.gemv_path(A_re.dtype, spec)
    if path != "kernel":
        fn = oracle if path == "ref" else _ref.complex_contract
        y_re, y_im = fn(A_re, A_im, x_re, x_im, mode)
        return _ref.cast(y_re, out_dtype), _ref.cast(y_im, out_dtype)
    _require_card(A_re, spec)
    n_kernel, th_kernel = kernels
    if mode == "N":
        return n_kernel(A_re, A_im, x_re, x_im, out_dtype=out_dtype)
    return th_kernel(A_re, A_im, x_re, x_im, conj=(mode == "H"),
                     out_dtype=out_dtype)


def sbgemv(A_re, A_im, x_re, x_im, mode: str = "N", *, out_dtype=None,
           backend=None, dispatch=None):
    """Strided-batched complex GEMV on split planes, backend-dispatched.

    A planes (B, m, n); mode "N": x (B, n) -> y (B, m); "T"/"H": x (B, m)
    -> y (B, n).  Returns (y_re, y_im) in ``out_dtype`` (default: A dtype).
    """
    return _contract(A_re, A_im, x_re, x_im, mode, out_dtype, backend,
                     dispatch, _ref.sbgemv_complex_ref,
                     (_sbgemv.sbgemv_n_complex, _sbgemv.sbgemv_th_complex))


def sbgemm(A_re, A_im, X_re, X_im, mode: str = "N", *, out_dtype=None,
           backend=None, dispatch=None):
    """Strided-batched complex GEMM (multi-RHS GEMV) on split planes, with
    the dispatch of :func:`sbgemv`.

    A planes (B, m, n); mode "N": X (B, n, S) -> Y (B, m, S); "T"/"H":
    X (B, m, S) -> Y (B, n, S).  Returns (Y_re, Y_im) in ``out_dtype``
    (default: A dtype).
    """
    return _contract(A_re, A_im, X_re, X_im, mode, out_dtype, backend,
                     dispatch, _ref.sbgemm_complex_ref,
                     (_sbgemv.sbgemm_n_complex, _sbgemv.sbgemm_th_complex))


def sbgemm_gram(A_re, A_im, *, space: str = "parameter", out_dtype=None,
                backend=None, dispatch=None):
    """Per-bin Hermitian Gram blocks: G[k] = A[k]^H A[k] ("parameter",
    (B, n, n)) or A[k] A[k]^H ("data", (B, m, m)), with the dispatch of
    :func:`sbgemv`.

    The returned planes are exactly Hermitian (G_re symmetric, G_im
    antisymmetric with a zero diagonal): the accumulation-order asymmetry
    is averaged away before the output cast, as the reference does.  The
    kernel reads A in its stored layout in both spaces.  Setup-phase code
    (paper Phase 0), run once per operator.
    """
    if space not in ("parameter", "data"):
        raise ValueError(f"bad gram space {space!r}")
    out_dtype = out_dtype or A_re.dtype
    spec, table = resolve_backend_dispatch(backend, dispatch, A_re.device)
    path = table.gemv_path(A_re.dtype, spec)
    if path == "ref":
        G_re, G_im = _ref.sbgemm_gram_ref(A_re, A_im, space)
    elif path == "torch":
        G_re, G_im = _ref.gram_contract(A_re, A_im, space)
    else:
        _require_card(A_re, spec)
        G_re, G_im = _sbgemv.sbgemm_gram_complex(
            A_re, A_im, data=(space == "data"),
            out_dtype=_ref.acc_dtype(A_re.dtype))
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
