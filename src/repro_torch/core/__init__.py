"""Core FFTMatvec library on PyTorch: the paper's operator on one device.

Public API:
    PrecisionConfig, ExecOpts, FFTMatvec       mixed-precision matvec
    pipeline.Stage / matvec_plan / gram_plan   stage graph + executor
    GramOperator (FFTMatvec.gram)              fused Fourier-domain Gram
    GaussianInverseProblem                     MAP points, Hessians, EIG
    error_model.relative_error_bound           paper eq. (6)
    toeplitz helpers                           dense oracles, setup, data
"""

from .precision import (PrecisionConfig, TileMap, all_configs,  # noqa: F401
                        machine_eps, config_le, config_lt, level_index,
                        max_level, tile_le, NAMED_CONFIGS,
                        DOUBLE, SINGLE, TPU_BASELINE, TPU_FAST,
                        PAPER_OPT_F, PAPER_OPT_FSTAR, PAPER_OPT_F_LARGE,
                        TPU_OPT_F)
from .pipeline import (ExecOpts, Stage, matvec_plan, gram_plan,  # noqa: F401
                       run_plan, stage_counts, record_stages)
from .fftmatvec import FFTMatvec, phase_callables  # noqa: F401
from .gram import GramOperator  # noqa: F401
from .hessian import GaussianInverseProblem  # noqa: F401
from .error_model import relative_error_bound  # noqa: F401
from .toeplitz import (dense_from_block_column, dense_matvec,  # noqa: F401
                       dense_rmatvec, fourier_block_column,
                       random_block_column, random_unrepresentable,
                       heat_equation_p2o)
from .pareto import rel_l2  # noqa: F401
from .timing import time_callable  # noqa: F401
