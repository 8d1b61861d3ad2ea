"""Backend layer: capability specs, device probe and dispatch table."""

from .spec import (BackendSpec, UnsupportedOnBackend,  # noqa: F401
                   BUILTIN_SPECS, CPU_TORCH, H100, KERNEL_DTYPES, TORCH_REF)
from .registry import (BACKEND_ENV, known_backends,  # noqa: F401
                       probe_backend, resolve_backend)
from .dispatch import DispatchTable, default_table  # noqa: F401
