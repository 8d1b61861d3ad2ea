"""Alignment padding helpers (twins of the JAX package's ``padding.py``).

The CUDA kernels mask their own ragged edges, so no kernel path pads: at
the paper shape a per-call pad of F_hat to a block multiple would copy
4-8 GB per matvec.  Nothing on the matvec path calls these helpers; the
tiled SBGEMM paths of a later slice align their tile grids with them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def round_up(size: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= ``size``."""
    return ((size + multiple - 1) // multiple) * multiple


def pad_to_multiple(x: torch.Tensor, axis: int, multiple: int):
    """Zero-pad ``axis`` up to a multiple; returns ``(padded, orig_size)``."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    axis = axis % x.ndim
    # F.pad lists (left, right) pairs from the last axis backwards
    pad = [0, 0] * (x.ndim - 1 - axis) + [0, rem]
    return F.pad(x, pad), size


def pad_planes(planes, axis: int, multiple: int):
    """Pad each tensor of a plane tuple identically; returns
    ``(padded_planes, orig_size)``."""
    size = planes[0].shape[axis]
    return tuple(pad_to_multiple(p, axis, multiple)[0] for p in planes), size
