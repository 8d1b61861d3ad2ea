"""Error-model-guided pruning of the precision-config lattice.

The exhaustive Fig.-3 protocol times every config of the 2^5 (or 3^5)
lattice.  Eq. (6) (``core.error_model``), evaluated over the whole
lattice, makes most of that unnecessary.  It certifies

  * **infeasible** configs: model error above the tolerance (granting a
    slack factor for the model's looseness); they can never be selected;
  * **dominated** configs: a model-feasible config ``a`` with every phase
    at a level <= ``b``'s is no more expensive than ``b`` under any
    precision-monotone cost, so ``b`` can never be the fastest feasible
    config; only the minimal elements (the *frontier*) need timing.

The raw eq.-(6) constants are worst-case O(1) placeholders, so the pruner
supports *calibration*: fit ``c1..c5`` from single-phase probe
measurements (one phase lowered at a time from the baseline), then
evaluate eq. (6) with the fitted constants.  ~p*(L-1) probe runs buy a
model accurate enough to prune the lattice to a handful of candidates.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

from repro_torch.core.error_model import lattice_bounds, phase_factors
from repro_torch.core.precision import (PHASES, PrecisionConfig, config_lt,
                                        level_index, machine_eps, max_level)

# Constant name of each phase in eq. (6), in PHASES order.
PHASE_CONSTANTS = dict(zip(PHASES, ("c1", "c2", "c3", "c4", "c5")))


def probe_configs(ladder: Sequence[str]
                  ) -> list[tuple[str, str, PrecisionConfig]]:
    """Single-phase calibration probes: the all-highest baseline with
    exactly one phase lowered to each sub-baseline level.  Returns
    ``(phase, level, config)`` triples, p*(L-1) of them."""
    top = max_level(ladder)
    base = PrecisionConfig(*([top] * 5))
    return [(phase, lvl, base.replace(**{phase: lvl}))
            for phase in PHASES for lvl in ladder
            if level_index(lvl) < level_index(top)]


def calibrate_constants(probe_errors: Mapping[str, Mapping[str, float]],
                        N_t: int, N_d: int, N_m: int, *, p_r: int = 1,
                        p_c: int = 1, adjoint: bool = False,
                        variant: str | None = None,
                        defaults: Mapping[str, float] | None = None
                        ) -> dict[str, float]:
    """Fit the eq.-(6) constants from single-phase probe errors.

    ``probe_errors[phase][level]`` is the measured relative error of the
    baseline with only ``phase`` lowered to ``level``.  That config's bound
    reduces to ``c_p * e_level * factor_p`` (the baseline terms are
    negligible), so ``c_p = err / (e_level * factor_p)``; with several
    probe levels per phase the largest ratio is kept.  A fitted constant
    can still over-estimate a composite config's error (single-phase
    superposition ignores cancellation), which would over-prune: the
    autotuner compensates with a slack factor on the cutoff and a
    measured-error recheck of every surviving candidate.  Phases with no
    usable probe keep their default constant.

    The reduce probe's error covers both pieces of the split phase-5
    factor (the storage cast and the depth-log2(p) comm tree run at the
    probed level together), so c5 is fitted against their sum."""
    c = {"c1": 1.0, "c2": 1.0, "c3": 1.0, "c4": 1.0, "c5": 1.0, "cF": 1.0}
    if defaults:
        c.update(defaults)
    f = phase_factors(N_t, N_d, N_m, p_r, p_c, adjoint=adjoint,
                      variant=variant)
    for phase, name in PHASE_CONSTANTS.items():
        factor = f[phase] + (f["comm"] if phase == "reduce" else 0.0)
        ratios = [float(err) / (machine_eps(lvl) * factor)
                  for lvl, err in probe_errors.get(phase, {}).items()
                  if machine_eps(lvl) * factor > 0.0]
        if ratios:
            c[name] = max(ratios)
    return c


@dataclasses.dataclass
class PruneReport:
    """Outcome of a model-level lattice prune."""
    tol: float
    cutoff: float                              # slack * tol
    bounds: dict[str, float]                   # cfg string -> model bound
    model_feasible: list[PrecisionConfig]      # bound <= cutoff
    infeasible: list[PrecisionConfig]          # bound >  cutoff
    frontier: list[PrecisionConfig]            # minimal feasible elements
    dominated: list[PrecisionConfig]           # feasible but never fastest

    @property
    def n_lattice(self) -> int:
        return len(self.model_feasible) + len(self.infeasible)


def prune_lattice(configs: Iterable[PrecisionConfig], tol: float, N_t: int,
                  N_d: int, N_m: int, *, p_r: int = 1, p_c: int = 1,
                  adjoint: bool = False, variant: str | None = None,
                  kappa: float = 1.0, input_level: str = "d",
                  constants: Mapping[str, float] | None = None,
                  slack: float = 1.0, comm_level: str | None = None,
                  tile_weights=None) -> PruneReport:
    """Prune a config lattice with eq. (6) alone (no measurements).

    A config survives to the *frontier* iff its bound is within
    ``slack * tol`` and no strictly cheaper (lattice-order) config is also
    within the cutoff.  The config with the smallest bound is always kept
    feasible: it is the measurement baseline and the fallback selection.
    ``comm_level`` prices reduced-precision communication into every
    bound; ``tile_weights`` are the per-tile block-norm fractions for any
    tile-mapped configs in the lattice (the tile-aware gemv term)."""
    if tol <= 0.0:
        raise ValueError(f"tolerance must be positive, got {tol}")
    configs = list(configs)
    if not configs:
        raise ValueError("empty config lattice")
    bounds = lattice_bounds(configs, N_t, N_d, N_m, p_r=p_r, p_c=p_c,
                            adjoint=adjoint, variant=variant, kappa=kappa,
                            comm_level=comm_level,
                            input_level=input_level,
                            tile_weights=tile_weights,
                            constants=dict(constants) if constants else None)
    cutoff = slack * tol
    best = min(configs, key=lambda cfg: (bounds[cfg.to_string()],
                                         -cfg.cost_rank()))
    feasible = [cfg for cfg in configs
                if bounds[cfg.to_string()] <= cutoff or cfg == best]
    infeasible = [cfg for cfg in configs if cfg not in feasible]
    frontier, dominated = [], []
    for cfg in feasible:
        if any(config_lt(other, cfg) for other in feasible):
            dominated.append(cfg)
        else:
            frontier.append(cfg)
    return PruneReport(tol=tol, cutoff=cutoff, bounds=bounds,
                       model_feasible=feasible, infeasible=infeasible,
                       frontier=frontier, dominated=dominated)


def minimal_elements(configs: Sequence[PrecisionConfig]
                     ) -> list[PrecisionConfig]:
    """Minimal elements of a config set under the precision lattice order
    (the antichain no member of which is precision-dominated)."""
    return [cfg for cfg in configs
            if not any(config_lt(other, cfg) for other in configs)]
