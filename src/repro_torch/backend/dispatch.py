"""The dispatch table: which lowering runs an SBGEMV, per backend.

The paper's rocBLAS host dispatcher, ported.  Three paths:

    "kernel"  the hand-written CUDA kernels (``kernels/csrc``),
    "torch"   the plain PyTorch contraction (``kernels.ref.complex_contract``),
    "ref"     the oracles (``kernels.ref``).

Explicit-vs-auto contract: ``force="kernel"`` demands the kernel and
raises :class:`UnsupportedOnBackend` when the backend cannot run it.
Automatic dispatch (``force=None``) takes the kernel on every shape and
mode wherever the backend has the kernels (they mask their own edges), and
raises there for a dtype they do not take: on the card nothing falls back
to plain PyTorch unless the caller forces it.  Elsewhere it takes the
plain contraction.  A shape crossover to cuBLAS waits until one is
measured on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .spec import BackendSpec, UnsupportedOnBackend

_PATHS = ("kernel", "torch", "ref")


@dataclasses.dataclass(frozen=True)
class DispatchTable:
    """An optional forced path: None (auto) or one of
    "kernel"/"torch"/"ref"."""

    force: Optional[str] = None

    def __post_init__(self):
        if self.force is not None and self.force not in _PATHS:
            raise ValueError(f"force must be one of {_PATHS}, "
                             f"got {self.force!r}")

    def gemv_path(self, dtype, spec: BackendSpec) -> str:
        """Path for an SBGEMV on ``dtype`` planes: "kernel"/"torch"/"ref"."""
        if self.force == "kernel" or (self.force is None and spec.kernels):
            # validated before the reference override: a forced kernel the
            # backend cannot run never reports success through another path
            if not spec.kernels:
                raise UnsupportedOnBackend(
                    f"the CUDA kernels were explicitly requested but backend "
                    f"{spec.fingerprint()!r} has none; drop the explicit "
                    f"request or run on the card")
            if not spec.kernel_supports(dtype):
                raise UnsupportedOnBackend(
                    f"the CUDA kernels take bf16/f32/f64 planes, not {dtype}")
            return "kernel"
        if spec.reference or self.force == "ref":
            return "ref"
        return "torch"


def default_table(spec: BackendSpec) -> DispatchTable:
    """The table for a spec (reference backends force the oracle path)."""
    if spec.reference:
        return DispatchTable(force="ref")
    return DispatchTable()
