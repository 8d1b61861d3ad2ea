"""First-order error model of the mixed-precision FFTMatvec (paper §3.2.1),
pure math shared with the JAX package's twin (kept as a copy: the port
imports nothing from it).

Implements the paper's final bound, eq. (6), on one device:

    ||dv5|| / ||v5|| <= kappa(F_hat) * [ c1 e1
                                         + (cF ed + c2 e2 + c4 e4) log2(N_t)
                                         + c3 e3 N_m
                                         + c5 e5 ]

for the F matvec; the F* bound replaces N_m by N_d.  e_i is the unit
roundoff of the precision used in phase i; the O(1) constants c_i default
to 1 and the tuner fits them from probe runs (``constants=``); c1 = 0 when
Phase 1 runs at (or above) the precision that represents the input
exactly (``input_level``).  The reduce term is 1 rather than the paper's
log2(p_c) = 0: the Phase-5 unpad stores at the reduce precision even on a
single device.

Tile-centric precision: a config carrying a :class:`TileMap` splits the
gemv term per operand tile, ``c3 * N_local * sum_t w_t * eps(level_t)``,
where the weights ``w_t`` (normalized block-norm fractions of ``F_hat``,
summing to 1; uniform when not supplied) price how much of the
contraction each tile carries.  A uniform map at level L reduces the term
exactly to the phase-level one at ``min(L, gemv)``.  The mesh terms (p_r,
p_c) and reduced-precision communication of the JAX twin come with the
multi-GPU slice.
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


def phase_factors(N_t: int, N_d: int, N_m: int, *, adjoint: bool = False,
                  variant: str | None = None,
                  tile_shape: Optional[tuple[int, int]] = None,
                  tile_weights: Optional[Sequence] = None) -> dict:
    """Structural multiplier of each phase's unit roundoff in eq. (6).

    ``variant`` selects the pipeline shape: the matvec/matmat family
    (default; ``adjoint`` flips to the F* factors) or ``"gram"`` — the
    fused Gram pipeline, whose phases each run twice (the fft/ifft terms
    double and the gemv term accumulates both contraction lengths).

    ``tile_shape`` (an ``(R_tiles, C_tiles)`` grid) adds ``"gemv_tiles"``:
    the flat row-major tuple ``w_t * factor_gemv`` with the normalized
    ``tile_weights`` (uniform when None), which sums back to the
    phase-level ``"gemv"`` factor."""
    log_nt = math.log2(max(N_t, 2))
    if variant in ("gram", "gram_data"):
        f = {"pad": 1.0, "fft": 2.0 * log_nt, "gemv": float(N_m + N_d),
             "ifft": 2.0 * log_nt, "reduce": 1.0}
    else:
        if variant is not None and variant not in ("matvec", "rmatvec",
                                                   "matmat", "rmatmat"):
            raise ValueError(f"unknown variant {variant!r}")
        if variant is not None:
            adjoint = variant in ("rmatvec", "rmatmat")
        f = {"pad": 1.0, "fft": log_nt,
             "gemv": float(N_d if adjoint else N_m), "ifft": log_nt,
             "reduce": 1.0}
    if tile_shape is not None:
        w = _normalized_weights(tile_weights, tuple(tile_shape))
        f["gemv_tiles"] = tuple(wt * f["gemv"] for wt in w)
    return f


def relative_error_bound(cfg: PrecisionConfig, N_t: int, N_d: int, N_m: int,
                         *, adjoint: bool = False, kappa: float = 1.0,
                         input_level: str = "d",
                         constants: dict | None = None,
                         variant: str | None = None,
                         tile_weights: Optional[Sequence] = None) -> float:
    """Evaluate eq. (6).  ``input_level`` is the precision at which the
    input vector is exactly representable (paper: double); ``constants``
    may override the O(1) factors c1..c5 and cF (default 1.0).
    ``variant="gram"`` bounds the fused Gram pipeline: doubled structural
    factors (see :func:`phase_factors`) and a squared condition number,
    since the chained F/F* passes each amplify by kappa(F_hat).  For a
    config carrying a tile map the gemv term is the tile-aware sum
    ``c3 * sum_t eps(eff_level_t) * w_t * factor_gemv`` with
    ``tile_weights`` the (optional) per-tile block-norm fractions of
    ``F_hat``."""
    c = {"c1": 1.0, "c2": 1.0, "c3": 1.0, "c4": 1.0, "c5": 1.0, "cF": 1.0}
    if constants:
        c.update(constants)
    e = {p: machine_eps(getattr(cfg, p)) for p in PHASES}
    e_setup = machine_eps(input_level)   # setup FFT of F runs at input level
    # c1 = 0 if the pad/broadcast phase is lossless for the input.
    c1 = 0.0 if e["pad"] <= e_setup else c["c1"]
    tile_shape = cfg.tiles.shape if cfg.tiles is not None else None
    f = phase_factors(N_t, N_d, N_m, adjoint=adjoint, variant=variant,
                      tile_shape=tile_shape, tile_weights=tile_weights)
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
                  + c["c5"] * e["reduce"] * f["reduce"])


def lattice_bounds(configs: Iterable[PrecisionConfig], N_t: int, N_d: int,
                   N_m: int, **kw) -> dict[str, float]:
    """Eq. (6) over a config lattice: ``{cfg_string: bound}``.  Analytic
    only, no operator runs: what makes model-guided pruning
    (``repro_torch.tune.pruner``) free beside measurement."""
    return {cfg.to_string(): relative_error_bound(cfg, N_t, N_d, N_m, **kw)
            for cfg in configs}


def dominant_phase(cfg: PrecisionConfig, N_t: int, N_d: int, N_m: int, *,
                   adjoint: bool = False, variant: str | None = None) -> str:
    """The phase contributing the largest term of eq. (6).  The paper: 'the
    dominant error term comes from the SBGEMV in Phase 3'."""
    f = phase_factors(N_t, N_d, N_m, adjoint=adjoint, variant=variant)
    terms = {p: machine_eps(getattr(cfg, p)) * f[p] for p in f}
    return max(terms, key=terms.get)
