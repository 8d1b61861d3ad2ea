"""State carried across from the JAX package.

The operator's state is its pair of Fourier planes.  Handing the JAX
operator's planes over as numpy arrays (``np.asarray(op.F_hat_re)``) lets
both packages compute with the same F_hat.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core import precision as prec
from .core.fftmatvec import FFTMatvec, default_device
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
