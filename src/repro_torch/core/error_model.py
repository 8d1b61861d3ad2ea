"""First-order error model of the mixed-precision FFTMatvec (paper §3.2.1),
pure math shared with the JAX package's twin (kept as a copy: the port
imports nothing from it).

Implements the paper's final bound, eq. (6):

    ||d_hat - d||/||d|| <= kappa(F_hat) [ c1 e1 + (eF + c2 e2 + c4 e4) log2 N_t
                                         + c3 e3 n_m
                                         + c5 e5 log2(p_c) ]

for the F matvec, with n_m = ceil(N_m / p_c); the F* bound replaces n_m by
n_d = ceil(N_d / p_r) and p_c by p_r.  e_i is the unit roundoff of the
precision used in phase i; the O(1) constants c_i default to 1 and the
tuner fits them from probe runs (``constants=``); c1 = 0 when Phase 1
runs at (or above) the precision that represents the input exactly
(``input_level``).

Two extensions over the paper's formula, as in the JAX twin: the reduce
term is 1 + log2(p_c) rather than log2(p_c), because the Phase-5 unpad
stores at the reduce precision even on a single device; and its two
pieces may run at different levels, the storage cast at the reduce level
and the depth-log2(p) reduction tree (the ``"comm"`` term) at an optional
``comm_level`` (reduced-precision communication).  With
``comm_level=None`` both run at the reduce level.

Tile-centric precision: a config carrying a :class:`TileMap` splits the
gemv term per operand tile, ``c3 * n_local * sum_t w_t * eps(level_t)``,
where the weights ``w_t`` (normalized block-norm fractions of ``F_hat``,
summing to 1; uniform when not supplied) price how much of the
contraction each tile carries.  A uniform map at level L reduces the term
exactly to the phase-level one at ``min(L, gemv)``.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

from .precision import PHASES, PrecisionConfig, machine_eps


def _normalized_weights(tile_weights, shape: tuple[int, int]) -> list:
    """Flatten + normalize per-tile weights to sum 1 (uniform when None);
    validates the grid shape against the tile map's."""
    R, C = shape
    if tile_weights is None:
        return [1.0 / (R * C)] * (R * C)
    rows = [list(r) for r in tile_weights]
    if len(rows) != R or any(len(r) != C for r in rows):
        raise ValueError(f"tile_weights shape {len(rows)}x"
                         f"{len(rows[0]) if rows else 0} does not match the "
                         f"tile map's {R}x{C}")
    flat = [max(float(w), 0.0) for r in rows for w in r]
    total = sum(flat)
    if total <= 0.0:
        return [1.0 / (R * C)] * (R * C)
    return [w / total for w in flat]


def phase_factors(N_t: int, N_d: int, N_m: int, p_r: int = 1, p_c: int = 1,
                  *, adjoint: bool = False, variant: str | None = None,
                  tile_shape: Optional[tuple[int, int]] = None,
                  tile_weights: Optional[Sequence] = None) -> dict:
    """Structural multiplier of each phase's unit roundoff in eq. (6).

    ``variant`` selects the pipeline shape: the matvec/matmat family
    (default; ``adjoint`` flips to the F* factors) or ``"gram"``, the
    fused Gram pipeline, whose phases each run twice (the fft/ifft terms
    double, the gemv term accumulates both local contraction lengths and
    the reduction runs over both grid axes).

    The phase-5 factor is split: ``"reduce"`` is the storage cast (1.0,
    present even on one device) and ``"comm"`` the depth-``log2(p)``
    reduction tree over the ``p`` devices the contraction was partial in,
    which may run at another level (``relative_error_bound``'s
    ``comm_level``).

    ``tile_shape`` (an ``(R_tiles, C_tiles)`` grid) adds ``"gemv_tiles"``:
    the flat row-major tuple ``w_t * factor_gemv`` with the normalized
    ``tile_weights`` (uniform when None), which sums back to the
    phase-level ``"gemv"`` factor."""
    log_nt = math.log2(max(N_t, 2))
    n_m = math.ceil(N_m / max(p_c, 1))
    n_d = math.ceil(N_d / max(p_r, 1))
    if variant in ("gram", "gram_data"):
        p_red = max(p_r, 1) * max(p_c, 1)
        f = {"pad": 1.0, "fft": 2.0 * log_nt, "gemv": float(n_m + n_d),
             "ifft": 2.0 * log_nt, "reduce": 1.0,
             "comm": math.log2(p_red) if p_red > 1 else 0.0}
    else:
        if variant is not None and variant not in ("matvec", "rmatvec",
                                                   "matmat", "rmatmat"):
            raise ValueError(f"unknown variant {variant!r}")
        if variant is not None:
            adjoint = variant in ("rmatvec", "rmatmat")
        n_local, p_red = (n_d, max(p_r, 1)) if adjoint else (n_m, max(p_c, 1))
        f = {"pad": 1.0, "fft": log_nt, "gemv": float(n_local),
             "ifft": log_nt, "reduce": 1.0,
             "comm": math.log2(p_red) if p_red > 1 else 0.0}
    if tile_shape is not None:
        w = _normalized_weights(tile_weights, tuple(tile_shape))
        f["gemv_tiles"] = tuple(wt * f["gemv"] for wt in w)
    return f


def relative_error_bound(cfg: PrecisionConfig, N_t: int, N_d: int, N_m: int,
                         p_r: int = 1, p_c: int = 1, *, adjoint: bool = False,
                         kappa: float = 1.0, input_level: str = "d",
                         constants: dict | None = None,
                         variant: str | None = None,
                         comm_level: str | None = None,
                         tile_weights: Optional[Sequence] = None) -> float:
    """Evaluate eq. (6).  ``input_level`` is the precision at which the
    input vector is exactly representable (paper: double); ``constants``
    may override the O(1) factors c1..c5 and cF (default 1.0).
    ``variant="gram"`` bounds the fused Gram pipeline: doubled structural
    factors (see :func:`phase_factors`) and a squared condition number,
    since the chained F/F* passes each amplify by kappa(F_hat).
    ``comm_level`` prices the reduction tree's ``"comm"`` term at its unit
    roundoff instead of the reduce phase's (None: the reduce level).  For
    a config carrying a tile map the gemv term is the tile-aware sum
    ``c3 * sum_t eps(eff_level_t) * w_t * factor_gemv`` with
    ``tile_weights`` the (optional) per-tile block-norm fractions of
    ``F_hat``."""
    c = {"c1": 1.0, "c2": 1.0, "c3": 1.0, "c4": 1.0, "c5": 1.0, "cF": 1.0}
    if constants:
        c.update(constants)
    e = {p: machine_eps(getattr(cfg, p)) for p in PHASES}
    e_comm = machine_eps(comm_level) if comm_level else e["reduce"]
    e_setup = machine_eps(input_level)   # setup FFT of F runs at input level
    # c1 = 0 if the pad/broadcast phase is lossless for the input.
    c1 = 0.0 if e["pad"] <= e_setup else c["c1"]
    tile_shape = cfg.tiles.shape if cfg.tiles is not None else None
    f = phase_factors(N_t, N_d, N_m, p_r, p_c, adjoint=adjoint,
                      variant=variant, tile_shape=tile_shape,
                      tile_weights=tile_weights)
    amp = kappa ** 2 if variant in ("gram", "gram_data") else kappa
    if cfg.tiles is not None:
        cells = (lvl for row in cfg.gemv_tile_levels() for lvl in row)
        gemv_term = sum(machine_eps(lvl) * f_t
                        for lvl, f_t in zip(cells, f["gemv_tiles"]))
    else:
        gemv_term = e["gemv"] * f["gemv"]
    return amp * (c1 * e["pad"] * f["pad"]
                  + c["cF"] * e_setup * f["fft"]
                  + c["c2"] * e["fft"] * f["fft"]
                  + c["c4"] * e["ifft"] * f["ifft"]
                  + c["c3"] * gemv_term
                  + c["c5"] * (e["reduce"] * f["reduce"]
                               + e_comm * f["comm"]))


def operator_grid(op, p_r: int | None = None,
                  p_c: int | None = None) -> tuple[int, int]:
    """The (p_r, p_c) grid eq. (6) prices for ``op``: explicit values win
    (an explicit (1, 1) too); a missing one comes off the operator's mesh
    (``FFTMatvec.grid_shape``), else 1."""
    if p_r is None or p_c is None:
        grid = op.grid_shape()
        p_r = grid[0] if p_r is None else p_r
        p_c = grid[1] if p_c is None else p_c
    return p_r or 1, p_c or 1


def lattice_bounds(configs: Iterable[PrecisionConfig], N_t: int, N_d: int,
                   N_m: int, **kw) -> dict[str, float]:
    """Eq. (6) over a config lattice: ``{cfg_string: bound}``.  Analytic
    only, no operator runs: what makes model-guided pruning
    (``repro_torch.tune.pruner``) free beside measurement."""
    return {cfg.to_string(): relative_error_bound(cfg, N_t, N_d, N_m, **kw)
            for cfg in configs}


def dominant_phase(cfg: PrecisionConfig, N_t: int, N_d: int, N_m: int,
                   p_r: int = 1, p_c: int = 1, *, adjoint: bool = False,
                   variant: str | None = None,
                   comm_level: str | None = None) -> str:
    """The phase contributing the largest term of eq. (6).  The paper: 'the
    dominant error term comes from the SBGEMV in Phase 3'.  The reduction
    tree is its own ``"comm"`` term at ``comm_level`` (default: the
    reduce level)."""
    f = phase_factors(N_t, N_d, N_m, p_r, p_c, adjoint=adjoint,
                      variant=variant)
    terms = {p: machine_eps(comm_level or cfg.reduce) * f[p] if p == "comm"
             else machine_eps(getattr(cfg, p)) * f[p] for p in f}
    return max(terms, key=terms.get)
