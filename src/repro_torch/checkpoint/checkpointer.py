"""Fault-tolerant checkpointing: atomic, manifest-validated, async-capable.

Twin of ``src/repro/checkpoint/checkpointer.py``, in its on-disk format,
so each package restores the other's checkpoints.  Layout:
``<dir>/step_<N:010d>/arrays.npz`` (``leaf_<i>``, the tree's leaves in
flatten order: dict keys sorted, as ``jax.tree_util`` orders them) and
``manifest.json`` (step, ``n_leaves``, time, extra, dtype names, shapes).
A bf16 leaf is stored as its ``uint16`` bit pattern under the dtype name
``bfloat16``.  Each write goes to a tmp directory renamed into place, so a
crash mid-write never corrupts the latest valid checkpoint; ``restore``
takes the newest step whose manifest reads; ``keep_last`` removes older
steps; at most one asynchronous write is in flight.

Trees are nested dicts (and lists or tuples) whose leaves are numpy
arrays, tensors or numbers: a train state goes through
``convert.train_state_to_numpy`` first.  Restored leaves take the target
leaf's dtype and kind: tensors on the target's device, numpy arrays
otherwise (a bf16 leaf restores as a CPU tensor where the target is
numpy, since numpy has no bfloat16).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

# same-width integer views of the dtypes numpy cannot hold
_VIEW_OF = {"bfloat16": (np.uint16, torch.int16)}


def flatten(tree) -> list:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, sequences in
    order; None is an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [] if tree is None else [tree]


def unflatten(tree, leaves: list):
    """``tree``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(tree)


def _encode(x):
    """(host array to store, dtype name)."""
    if torch.is_tensor(x):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(x)
    name = a.dtype.name
    if name in _VIEW_OF:                 # ml_dtypes' bfloat16
        return a.view(_VIEW_OF[name][0]), name
    return a, name


def _decode(a: np.ndarray, name: str):
    if name in _VIEW_OF:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return a


def _place(a, target):
    """A restored leaf at the target leaf's dtype, as the target's kind."""
    if torch.is_tensor(target):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return t.to(device=target.device, dtype=target.dtype)
    if torch.is_tensor(a):
        return a
    dt = getattr(target, "dtype", None)
    return np.asarray(a).astype(dt) if dt is not None else np.asarray(a)


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_write: bool = False):
        self.dir = directory
        self.keep_last = keep_last
        self.async_write = async_write
        self._pending: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- write ----------------------------------------------------------------
    def save(self, step: int, tree, extra: dict | None = None):
        """Copy every leaf to the host now, then serialize and rename (in
        a thread with ``async_write``)."""
        encoded = [_encode(x) for x in flatten(tree)]
        host_leaves = [e[0] for e in encoded]
        dtype_names = [e[1] for e in encoded]
        if self._pending is not None:
            self._pending.join()                        # one in flight max

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
            manifest = {
                "step": step,
                "n_leaves": len(host_leaves),
                "time": time.time(),
                "extra": extra or {},
                "dtypes": dtype_names,
                "shapes": [list(a.shape) for a in host_leaves],
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = self.step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                       # atomic commit
            self._gc()

        if self.async_write:
            self._pending = threading.Thread(target=write)
            self._pending.start()
        else:
            write()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # -- read -----------------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def available_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if not name.startswith("step_"):
                continue
            path = os.path.join(self.dir, name, "manifest.json")
            try:
                with open(path) as f:
                    steps.append(int(json.load(f)["step"]))
            except Exception:
                continue                                # ignore corrupt dirs
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree, step: int | None = None):
        """Returns (tree, step, extra): ``target_tree``'s structure, each
        leaf at the target leaf's dtype and kind (:func:`_place`)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            leaves = [_decode(data[f"leaf_{i}"], manifest["dtypes"][i])
                      for i in range(manifest["n_leaves"])]
        target_leaves = flatten(target_tree)
        if len(target_leaves) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, target expects "
                f"{len(target_leaves)}")
        placed = [_place(a, t) for a, t in zip(leaves, target_leaves)]
        return unflatten(target_tree, placed), step, manifest.get("extra", {})

    # -- gc ---------------------------------------------------------------------
    def _gc(self):
        steps = self.available_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)
