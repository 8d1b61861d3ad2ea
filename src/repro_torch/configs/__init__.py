from .base import (ModelConfig, ARCH_IDS, ARCH_ALIASES, get_config,  # noqa: F401
                   get_smoke_config)
from .shapes import (SHAPES, ShapeSpec, input_specs, input_shard_specs,  # noqa: F401
                     shape_applicable)
from .fftmatvec_paper import FFTMatvecConfig, PAPER_SINGLE  # noqa: F401
