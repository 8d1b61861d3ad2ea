"""Error metric of the Pareto analysis (paper §3.2, Fig. 3).

Only ``rel_l2`` is ported so far; the config sweep and the front wait for
the autotuner's slice.
"""

from __future__ import annotations

import torch


def rel_l2(x, ref) -> float:
    """||x - ref||_2 / ||ref||_2 in f64, on the device ``x`` lives on
    (``ref`` is moved there).  A zero reference divides by 1."""
    x64 = torch.as_tensor(x).to(torch.float64)
    r64 = torch.as_tensor(ref).to(device=x64.device, dtype=torch.float64)
    denom = torch.linalg.vector_norm(r64).item()
    num = torch.linalg.vector_norm(x64 - r64).item()
    return num / (denom if denom else 1.0)
