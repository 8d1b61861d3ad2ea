"""State carried across from the JAX package.

The operator's state is its pair of Fourier planes, and a circulant Gram
operator's also its pair of G_hat planes; an LM's state is its params
pytree.  Handing the JAX package's arrays over as numpy arrays
(``np.asarray(op.F_hat_re)``, ``jax.tree.map(np.asarray, params)``) lets
both packages compute with the same state.  Nothing here imports JAX.
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
from .configs.base import ModelConfig
from .models.api import family_module


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


def lm_params_from_numpy(cfg: ModelConfig, params, device=None):
    """The port's LM weights module holding the JAX package's params pytree
    (numpy leaves; ``layers`` stacked on a leading layer axis, as
    ``transformer.init_params`` builds it), at the policy's parameter
    dtype on ``device`` (None = the card).  bf16 leaves widen exactly."""
    mod = family_module(cfg)
    dev = default_device(device)
    model = mod.Transformer(cfg, device=dev)
    stacked = params["layers"]
    with torch.no_grad():
        for i, lyr in enumerate(model.layers):
            for name, p in lyr.named_parameters():
                p.copy_(_plane(np.asarray(stacked[name])[i], p.dtype, dev))
        for name in ("embed", "ln_f", "lm_head"):
            p = getattr(model, name)
            if p is not None:
                p.copy_(_plane(params[name], p.dtype, dev))
    return model
