"""Backend layer: capability specs, device probe and dispatch table."""

from .spec import (BackendSpec, UnsupportedOnBackend,  # noqa: F401
                   BUILTIN_SPECS, CPU_TORCH, H100, KERNEL_DTYPES,
                   TORCH_REF)
from .registry import (BACKEND_ENV, default_device,  # noqa: F401
                       known_backends, probe_backend, resolve_backend)
from .dispatch import (DispatchTable, calibrate_dispatch,  # noqa: F401
                       calibrate_overlap, calibrate_short_wide_ratio,
                       calibrated_network, default_gemv_measure,
                       default_overlap_measure, default_table,
                       overlap_efficiency_from_times)
