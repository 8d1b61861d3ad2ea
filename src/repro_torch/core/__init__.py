"""Core FFTMatvec library on PyTorch: the paper's operator on one device.

Public API:
    PrecisionConfig, ExecOpts, FFTMatvec       mixed-precision matvec
                                               (one device or a DeviceMesh)
    pipeline.Stage / matvec_plan / gram_plan   stage graph + executor
    GramOperator (FFTMatvec.gram)              fused Fourier-domain Gram
    choose_grid / paper_grid                   comm-aware 2-D partitioning
                                               (FFTMatvec mesh="auto")
    GaussianInverseProblem                     MAP points, Hessians, EIG
    error_model.relative_error_bound           paper eq. (6)
    measure_configs / pareto_front             the Fig.-3 Pareto analysis
    time_callable / TimingHarness              CUDA-event timing
    toeplitz helpers                           dense oracles, setup, data

The autotuner built on these lives in :mod:`repro_torch.tune`.
"""

from .precision import (PrecisionConfig, TileMap, all_configs,  # noqa: F401
                        machine_eps, config_le, config_lt, level_index,
                        max_level, tile_le, NAMED_CONFIGS,
                        DOUBLE, SINGLE, TPU_BASELINE, TPU_FAST,
                        PAPER_OPT_F, PAPER_OPT_FSTAR, PAPER_OPT_F_LARGE,
                        TPU_OPT_F)
from .pipeline import (ExecOpts, Stage, COLLECTIVE_KINDS,  # noqa: F401
                       matvec_plan, gram_plan, run_plan, stage_counts,
                       record_stages)
from .fftmatvec import FFTMatvec, phase_callables  # noqa: F401
from .gram import GramOperator  # noqa: F401
from .hessian import GaussianInverseProblem  # noqa: F401
from .partition import (choose_grid, choose_chunks, paper_grid,  # noqa: F401
                        matvec_comm_time, hierarchical_collective_time,
                        NetworkModel, TPU_POD_NETWORK)
from .error_model import (relative_error_bound, dominant_phase,  # noqa: F401
                          lattice_bounds, phase_factors)
from .toeplitz import (dense_from_block_column, dense_matvec,  # noqa: F401
                       dense_rmatvec, fourier_block_column,
                       random_block_column, random_unrepresentable,
                       heat_equation_p2o)
from .pareto import (ConfigRecord, format_table, measure_configs,  # noqa: F401
                     optimal_config, pareto_front, rel_l2)
from .timing import TimingHarness, time_callable  # noqa: F401
