"""Backend layer: capability specs, device probe and dispatch table."""

from .spec import (BackendSpec, UnsupportedOnBackend,  # noqa: F401
                   BUILTIN_SPECS, CPU_TORCH, H100, H100_HBM_BYTES_PER_S,
                   KERNEL_DTYPES, TORCH_REF)
from .registry import (BACKEND_ENV, default_device,  # noqa: F401
                       known_backends, probe_backend, resolve_backend)
from .dispatch import DispatchTable, default_table  # noqa: F401
