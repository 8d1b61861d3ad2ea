"""Derive per-tile precision maps from block norms of F_hat.

F_hat is static per operator, so the per-block norms of its spectrum are
computed once at setup and the map they imply is a static artifact: no
runtime data inspection, no data-dependent dispatch inside the kernels.

The derivation extends eq. (6) with a per-tile gemv term (see
:func:`repro_torch.core.error_model.relative_error_bound`): the uniform
config's gemv error budget ``tol - (bound(cfg) - gemv_term(cfg))`` is
split evenly across the map's cells, and each cell takes the *lowest*
ladder level whose weighted contribution ``amp * c3 * w_t * N_local *
eps(level)`` fits its share.  Cells carrying little of the spectrum's
energy (small ``w_t``) can afford bf16; hot cells stay at the phase
level.  :func:`derive_tile_map` re-evaluates the bound to enforce
``tol``, and returns None rather than a map that drops nothing below the
uniform level or misses the tolerance.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import error_model
from repro_torch.core.precision import PrecisionConfig, TileMap, machine_eps
from repro_torch.kernels.ref import tile_bounds

_LADDER = ("h", "s", "d")     # low -> high
_CHUNK = 64                   # bins a step: f64 temporaries of 64 bins


def block_norms(F_re, F_im=None,
                shape: tuple[int, int] = (2, 2)) -> np.ndarray:
    """Per-cell Frobenius norms of the operand spectrum.

    ``F_re``/``F_im`` are the (K, N_d, N_m) split planes of F_hat
    (``F_im`` None for a real operand).  The (R, C) grid partitions the
    frequency-bin axis K and the model axis N_m element-wise, the
    partition the kernels quantize by (``kernels.ref.expand_tile_levels``).
    Computed in f64 on the planes' device, a few bins at a time (at the
    paper shape a whole f64 copy would be 4 GB); returns a numpy (R, C)
    float64 array."""
    return cell_energy(F_re, F_im, shape).sqrt().cpu().numpy()


def cell_energy(F_re, F_im=None,
                shape: tuple[int, int] = (2, 2)) -> torch.Tensor:
    """The squared per-cell norms of :func:`block_norms`, an (R, C) f64
    tensor on the planes' device."""
    R, C = shape
    K, _, n = F_re.shape
    energy = torch.empty((K, n), dtype=torch.float64, device=F_re.device)
    for k0 in range(0, K, _CHUNK):
        sl = slice(k0, k0 + _CHUNK)
        e = F_re[sl].to(torch.float64).square().sum(dim=1)
        if F_im is not None:
            e += F_im[sl].to(torch.float64).square().sum(dim=1)
        energy[sl] = e
    rows, cols = tile_bounds(R, K), tile_bounds(C, n)
    return torch.stack([torch.stack([
        energy[rows[r]:rows[r + 1], cols[c]:cols[c + 1]].sum()
        for c in range(C)]) for r in range(R)])


def tile_weights(norms) -> tuple:
    """Energy fractions of the per-cell norms, ``||A_t||_F^2 / ||A||_F^2``:
    the ``w_t`` of the tile-aware eq.-(6) term, how much of the
    contraction each tile carries.  Nested tuple summing to 1 overall
    (uniform if the operand is identically zero)."""
    sq = np.asarray(norms, dtype=np.float64) ** 2
    total = sq.sum()
    if total <= 0.0:
        sq = np.ones_like(sq)
        total = sq.sum()
    frac = sq / total
    return tuple(tuple(float(v) for v in row) for row in frac)


def derive_tile_map(cfg: PrecisionConfig, tol: float, N_t: int, N_d: int,
                    N_m: int, *, shape: tuple[int, int] = (2, 2),
                    weights: Optional[Sequence] = None,
                    p_r: int = 1, p_c: int = 1, adjoint: bool = False,
                    kappa: float = 1.0, input_level: str = "d",
                    constants: dict | None = None,
                    variant: str | None = None,
                    comm_level: str | None = None) -> Optional[TileMap]:
    """Lowest-precision tile map keeping the eq.-(6) bound within ``tol``.

    ``cfg`` is the (phase-uniform) base config; ``weights`` the per-cell
    block-norm fractions from :func:`tile_weights` (None = uniform).
    Returns None when no admissible map improves on the uniform config:
    the base config is already out of tolerance, no cell can drop below
    the gemv level, or the re-evaluated tile-aware bound misses ``tol``."""
    if cfg.tiles is not None:
        cfg = cfg.replace(tiles=None)
    bound_kw = dict(p_r=p_r, p_c=p_c, adjoint=adjoint, kappa=kappa,
                    input_level=input_level, constants=constants,
                    variant=variant, comm_level=comm_level)
    base = error_model.relative_error_bound(cfg, N_t, N_d, N_m, **bound_kw)
    if base > tol:
        return None
    R, C = shape
    w = error_model._normalized_weights(weights, (R, C))
    f = error_model.phase_factors(N_t, N_d, N_m, p_r, p_c, adjoint=adjoint,
                                  variant=variant)
    c3 = (constants or {}).get("c3", 1.0)
    amp = kappa ** 2 if variant in ("gram", "gram_data") else kappa
    gemv_coeff = amp * c3 * f["gemv"]
    # the uniform config's gemv term is the budget re-spent per tile
    budget_total = tol - (base - gemv_coeff * machine_eps(cfg.gemv))
    budget_cell = budget_total / (R * C)
    cells = []
    for wt in w:
        lvl = "d"       # effective min(d, gemv) = gemv: never worse
        for cand in _LADDER:
            if gemv_coeff * wt * machine_eps(cand) <= budget_cell:
                lvl = cand
                break
        cells.append(lvl)
    tiles = TileMap(tuple(tuple(cells[r * C:(r + 1) * C]) for r in range(R)))
    if all(lvl == cfg.gemv for row in tiles.effective(cfg.gemv)
           for lvl in row):
        return None     # nothing drops below the uniform level: no win
    if error_model.relative_error_bound(cfg.replace(tiles=tiles), N_t, N_d,
                                        N_m, tile_weights=weights,
                                        **bound_kw) > tol:
        return None
    return tiles


def tile_map_for_operator(op, cfg: PrecisionConfig, tol: float, *,
                          shape: tuple[int, int] = (2, 2),
                          p_r: int = 1, p_c: int = 1,
                          adjoint: bool = False, kappa: float = 1.0,
                          input_level: str = "d",
                          constants: dict | None = None,
                          variant: str | None = None,
                          comm_level: str | None = None):
    """Block-norm analysis + derivation for a live ``FFTMatvec``.  Returns
    ``(tile_map_or_None, weights)``; the weights let the caller evaluate
    the matching tile-aware bound.

    On a mesh each rank's gemv rounds its own (K, N_d/p_r, N_m/p_c) block
    through the map (the partition the kernels see, as in the JAX
    package, whose gemv expands the map over the block ``shard_map``
    hands it).  So the cells are cells of a local block: each rank's cell
    energies are summed over the grid, and every rank derives the same
    weights and the same map."""
    energy = cell_energy(op.F_hat_re, op.F_hat_im, shape)
    if op.mesh is not None:
        energy = op.grid_sum(energy)
    w = tile_weights(energy.sqrt().cpu().numpy())
    tiles = derive_tile_map(cfg, tol, op.N_t, op.N_d, op.N_m, shape=shape,
                            weights=w, p_r=p_r, p_c=p_c, adjoint=adjoint,
                            kappa=kappa, input_level=input_level,
                            constants=constants, variant=variant,
                            comm_level=comm_level)
    return tiles, w
