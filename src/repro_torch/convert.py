"""State carried across from the JAX package.

The operator's state is its pair of Fourier planes, and a circulant Gram
operator's also its pair of G_hat planes.  Handing the JAX package's
planes over as numpy arrays (``np.asarray(op.F_hat_re)``) lets both
packages compute with the same state.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core import precision as prec
from .core.fftmatvec import FFTMatvec, default_device
from .core.gram import GramOperator
from .core.pipeline import ExecOpts
from .core.precision import PrecisionConfig


def _plane(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # numpy has no bf16: widen (exact)
        a = a.astype(np.float32)
    return torch.tensor(a, device=device).to(dtype)


def fftmatvec_from_numpy(F_hat_re, F_hat_im, N_t: int,
                         precision: PrecisionConfig,
                         opts: Optional[ExecOpts] = None,
                         device=None) -> FFTMatvec:
    """The port's operator over given TOSI planes (K, N_d, N_m), stored at
    the config's gemv level on ``device`` (None = the card)."""
    dev = default_device(device)
    dt = prec.real_dtype(precision.gemv)
    return FFTMatvec(_plane(F_hat_re, dt, dev), _plane(F_hat_im, dt, dev),
                     int(N_t), precision, opts or ExecOpts())


def gram_from_numpy(op: FFTMatvec, G_hat_re, G_hat_im, *,
                    space: str = "parameter") -> GramOperator:
    """The port's circulant Gram of ``op`` over given per-bin blocks
    (K, R, R), R = N_m ("parameter") or N_d ("data"), stored at ``op``'s
    gemv level on its device, instead of computing them."""
    dt = prec.real_dtype(op.precision.gemv)
    R = op.N_m if space == "parameter" else op.N_d
    G_re, G_im = (_plane(g, dt, op.device) for g in (G_hat_re, G_hat_im))
    want = (op.F_hat_re.shape[0], R, R)
    if tuple(G_re.shape) != want or G_im.shape != G_re.shape:
        raise ValueError(f"G_hat planes must be {want} for a {space}-space "
                         f"Gram, got {tuple(G_re.shape)} and "
                         f"{tuple(G_im.shape)}")
    return GramOperator(op, space, "circulant", G_re, G_im)
