"""repro_torch.tune: dynamic mixed-precision selection as a runtime service.

The paper's Fig.-3 analysis (pick the fastest per-phase precision config
meeting an error tolerance) as something an application calls at run
time, not an offline sweep:

    op_tuned = op.autotune(tol=1e-7)                       # operator API
    res = autotune(op, tol=1e-7, cache_path="tune.json")   # full result

Pieces (each usable on its own):
    pruner    eq.-(6) bounds over the config lattice, probe-calibrated
              constants, feasibility + precision-dominance pruning
    harness   TimingHarness: CUDA-event timing, throughput/latency modes,
              measurement accounting
    cache     TuningCache: JSON persistence keyed by (shape, ladder,
              variant, backend, card); corrupt/stale entries re-tune
    tile_map  block-norm analysis of F_hat -> per-tile precision maps
    autotune  the orchestrator; TuneResult carries records/front/bounds
"""

from .autotune import TuneResult, autotune, default_input  # noqa: F401
from .cache import CacheKey, TuningCache, default_cache_path  # noqa: F401
from .harness import TimingHarness  # noqa: F401
from .pruner import (PruneReport, calibrate_constants,  # noqa: F401
                     minimal_elements, probe_configs, prune_lattice)
from .tile_map import (block_norms, derive_tile_map,  # noqa: F401
                       tile_map_for_operator, tile_weights)
