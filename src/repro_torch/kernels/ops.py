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


def sbgemv(A_re, A_im, x_re, x_im, mode: str = "N", *, out_dtype=None,
           backend=None, dispatch=None):
    """Strided-batched complex GEMV on split planes, backend-dispatched.

    A planes (B, m, n); mode "N": x (B, n) -> y (B, m); "T"/"H": x (B, m)
    -> y (B, n).  Returns (y_re, y_im) in ``out_dtype`` (default: A dtype).
    """
    if mode not in ("N", "T", "H"):
        raise ValueError(f"bad mode {mode!r}")
    out_dtype = out_dtype or A_re.dtype
    spec, table = resolve_backend_dispatch(backend, dispatch, A_re.device)
    path = table.gemv_path(A_re.dtype, spec)
    if path == "ref":
        y_re, y_im = _ref.sbgemv_complex_ref(A_re, A_im, x_re, x_im, mode)
        return _ref.cast(y_re, out_dtype), _ref.cast(y_im, out_dtype)
    if path == "torch":
        y_re, y_im = _ref.complex_contract(A_re, A_im, x_re, x_im, mode)
        return _ref.cast(y_re, out_dtype), _ref.cast(y_im, out_dtype)
    _require_card(A_re, spec)
    if mode == "N":
        return _sbgemv.sbgemv_n_complex(A_re, A_im, x_re, x_im,
                                        out_dtype=out_dtype)
    return _sbgemv.sbgemv_th_complex(A_re, A_im, x_re, x_im,
                                     conj=(mode == "H"), out_dtype=out_dtype)


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
