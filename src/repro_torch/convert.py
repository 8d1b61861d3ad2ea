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


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


def lm_params_from_numpy(cfg: ModelConfig, params, device=None):
    """The port's LM weights module holding the JAX package's params pytree
    (numpy leaves, per-layer stacks on a leading layer axis as the
    reference's ``init_params`` builds them), at each parameter's dtype on
    ``device`` (None = the card).  Every family: a parameter named
    ``a.i.b.c`` (``i`` an index into a layer list: ``layers``,
    ``enc_layers``, ``dec_layers``) takes the pytree's ``[a][b][c][i]``,
    any other name ``a.b`` takes ``[a][b]``.  Every leaf of the pytree
    must be taken, and bf16 leaves widen exactly."""
    dev = default_device(device)
    model = family_module(cfg).Model(cfg, device=dev)
    taken = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            path = name.split(".")
            i = int(path.pop(1)) if len(path) > 1 and path[1].isdigit() \
                else None
            leaf = params
            for k in path:
                leaf = leaf[k]
            leaf = np.asarray(leaf) if i is None else np.asarray(leaf)[i]
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"{name}: the pytree's leaf is "
                                 f"{tuple(leaf.shape)}, the port's "
                                 f"parameter {tuple(p.shape)}")
            p.copy_(_plane(leaf, p.dtype, dev))
            taken.add(tuple(path))
    left = [".".join(k) for k, _ in _leaves(params) if k not in taken]
    if left:
        raise ValueError(f"pytree leaves with no parameter in the port: "
                         f"{left}")
    return model
