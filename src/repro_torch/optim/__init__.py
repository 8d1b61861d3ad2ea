from .adamw import AdamW, constant_schedule, cosine_schedule, wsd_schedule  # noqa: F401
from .grad_compress import Compressor  # noqa: F401
