"""State carried across from the JAX package, and back.

The operator's state is its pair of Fourier planes, and a circulant Gram
operator's also its pair of G_hat planes; an LM's state is its params
pytree, and a training run's its train state (params, AdamW moments,
counts, error-feedback buffers).  Handing the JAX package's arrays over as
numpy arrays (``np.asarray(op.F_hat_re)``, ``jax.tree.map(np.asarray,
params)``) lets both packages compute with the same state;
:func:`train_state_to_numpy` hands a train state back in the reference's
tree, which is also the layout both packages' checkpoints hold.  Nothing
here imports JAX.
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
    if torch.is_tensor(a):
        return a.to(device=device, dtype=dtype, copy=True)
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


def stacked_leaf(name: str):
    """The reference leaf a port parameter belongs to: ``(path, index)``
    for a parameter ``a.i.b.c`` (``i`` an index into a layer list:
    ``layers``, ``enc_layers``, ``dec_layers``), which is row ``i`` of the
    stacked leaf ``[a][b][c]``; ``(path, None)`` for any other name
    ``a.b``, the whole leaf ``[a][b]``."""
    path = name.split(".")
    i = int(path.pop(1)) if len(path) > 1 and path[1].isdigit() else None
    return tuple(path), i


def lm_params_from_numpy(cfg: ModelConfig, params, device=None):
    """The port's LM weights module holding the JAX package's params pytree
    (numpy leaves, per-layer stacks on a leading layer axis as the
    reference's ``init_params`` builds them), at each parameter's dtype on
    ``device`` (None = the card).  Every family: a parameter named
    ``a.i.b.c`` (``i`` an index into a layer list: ``layers``,
    ``enc_layers``, ``dec_layers``) takes the pytree's ``[a][b][c][i]``,
    any other name ``a.b`` takes ``[a][b]`` (:func:`stacked_leaf`).  Every
    leaf of the pytree must be taken, and bf16 leaves widen exactly.
    Leaves may also be tensors."""
    dev = default_device(device)
    model = family_module(cfg).Model(cfg, device=dev)
    with torch.no_grad():
        for name, t in _unstack(params, dict(model.named_parameters()),
                                dev).items():
            model.get_parameter(name).copy_(t)
    return model


def _unstack(tree, like: dict, device) -> dict:
    """``{name: tensor}`` for each name of ``like`` from the reference's
    tree (:func:`stacked_leaf`), at ``like[name]``'s shape and dtype on
    ``device``; every leaf of ``tree`` must be taken."""
    out, taken = {}, set()
    for name, p in like.items():
        path, i = stacked_leaf(name)
        leaf = tree
        for k in path:
            leaf = leaf[k]
        if not torch.is_tensor(leaf):
            leaf = np.asarray(leaf)
        if i is not None:
            leaf = leaf[i]
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"{name}: the pytree's leaf is "
                             f"{tuple(leaf.shape)}, the port's "
                             f"parameter {tuple(p.shape)}")
        out[name] = _plane(leaf, p.dtype, device)
        taken.add(path)
    left = [".".join(k) for k, _ in _leaves(tree) if k not in taken]
    if left:
        raise ValueError(f"pytree leaves with no parameter in the port: "
                         f"{left}")
    return out


def _dtype_of(a) -> torch.dtype:
    """The torch dtype of a numpy array (ml_dtypes' bfloat16 included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


def _host(t: torch.Tensor):
    """A CPU copy: a numpy array, or a CPU tensor for bf16 (numpy has no
    bfloat16)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _stack(named: dict) -> dict:
    """The reference's tree of ``{name: tensor}``: each layer list's
    parameters stacked on a leading layer axis (:func:`stacked_leaf`)."""
    rows: dict = {}
    for name, t in named.items():
        path, i = stacked_leaf(name)
        rows.setdefault(path, {})[i] = t
    tree: dict = {}
    for path, by_i in rows.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _host(by_i[None] if None in by_i else torch.stack(
            [by_i[i] for i in sorted(by_i)]))
    return tree


def train_state_to_numpy(cfg: ModelConfig, state) -> dict:
    """A port train state (``models.api.init_train_state``) as the
    reference's: ``{"params", "opt": {"mu", "nu", "count"}, "step",
    ["efb"]}``, per-layer parameters, moments and buffers stacked on a
    leading layer axis, counts int32.  Leaves are numpy arrays, except
    bf16 ones, which are CPU tensors (numpy has no bfloat16); both
    packages' checkpointers store them as the reference does."""
    named = dict(state["params"].named_parameters())
    tree = {"params": _stack(named),
            "opt": {"mu": _stack(state["opt"]["mu"]),
                    "nu": _stack(state["opt"]["nu"]),
                    "count": np.asarray(int(state["opt"]["count"]),
                                        np.int32)},
            "step": np.asarray(int(state["step"]), np.int32)}
    if state.get("efb") is not None:
        tree["efb"] = _stack(state["efb"])
    return tree


def train_state_from_numpy(cfg: ModelConfig, tree, device=None) -> dict:
    """The port's train state holding the reference's (``jax.tree.map(
    np.asarray, state)``, or :func:`train_state_to_numpy`'s, or a restored
    checkpoint's): the weights module on ``device`` (None = the card), the
    moments and buffers at their leaves' dtypes beside the parameters, the
    counts int32 CPU tensors."""
    dev = default_device(device)
    model = lm_params_from_numpy(cfg, tree["params"], device=dev)
    named = dict(model.named_parameters())

    def like(sub):
        """Parameter-shaped tensors at the dtype of ``sub``'s leaves."""
        leaf = next(iter(_leaves(sub)))[1]
        dt = leaf.dtype if torch.is_tensor(leaf) else _dtype_of(leaf)
        sub_like = {k: torch.empty(p.shape, dtype=dt, device="meta")
                    for k, p in named.items()}
        return _unstack(sub, sub_like, dev)

    state = {"params": model,
             "opt": {"mu": like(tree["opt"]["mu"]),
                     "nu": like(tree["opt"]["nu"]),
                     "count": torch.tensor(int(tree["opt"]["count"]),
                                           dtype=torch.int32)},
             "step": torch.tensor(int(tree["step"]), dtype=torch.int32)}
    if tree.get("efb") is not None:
        state["efb"] = like(tree["efb"])
    return state
