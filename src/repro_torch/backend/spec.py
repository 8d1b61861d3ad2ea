"""Hardware capability descriptions: what a backend's kernels can run.

:class:`BackendSpec` is a frozen record of one execution backend: its
platform, whether the hand-written CUDA kernels run there and on which
plane dtypes, and whether it forces the oracle lowerings.  The probe that
picks a spec for a device lives in :mod:`repro_torch.backend.registry`;
the shape-dependent kernel choice lives in
:mod:`repro_torch.backend.dispatch`.
"""

from __future__ import annotations

import dataclasses

import torch


class UnsupportedOnBackend(TypeError):
    """The kernel path was chosen but cannot run here.

    Raised for ``force="kernel"`` dispatch on a backend without kernels,
    for a kernel path on a tensor that is not on the card, and for a dtype
    the kernels do not take on a backend that has them (there automatic
    dispatch takes the kernel and never falls back to plain PyTorch).
    """


# The plane dtypes the hand-written kernels are instantiated for.  f64 is
# a native datapath on Hopper, so "d" stages run in the kernels too.
KERNEL_DTYPES = (torch.bfloat16, torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Capabilities of one execution backend.

    ``platform`` is the torch device type the spec serves ("cuda"/"cpu");
    ``device_kind`` is filled from the bound device (``""`` = unbound).
    ``kernels`` says the hand-written CUDA kernels run here; ``reference``
    forces the oracle lowerings (``kernels.ref``), bypassing both the
    kernels and the plain contraction.  ``tile_precision`` says the
    Phase-3 products take a tile map (``tile_map=``, tile-centric
    precision); where it is False a tile map raises
    :class:`UnsupportedOnBackend` and the autotuner skips tile refinement.
    """

    name: str
    platform: str = ""
    device_kind: str = ""
    kernels: bool = False
    reference: bool = False
    tile_precision: bool = False

    def fingerprint(self) -> str:
        """Stable identity for cache keys: backend + hardware it bound to."""
        return f"{self.name}@{self.platform}:{self.device_kind}"

    def kernel_supports(self, *dtypes) -> bool:
        """Whether the hand-written kernels take these dtypes here."""
        return self.kernels and all(dt in KERNEL_DTYPES for dt in dtypes)


H100 = BackendSpec(name="h100", platform="cuda", kernels=True,
                   tile_precision=True)

# Auto-selected for CPU tensors: the kernels' plain versions (the plain
# contraction for the gemv, the oracles for pad/unpad).
CPU_TORCH = BackendSpec(name="cpu-torch", platform="cpu", tile_precision=True)

# Forced reference backend on whatever device the data lives on.
TORCH_REF = BackendSpec(name="torch-ref", reference=True, tile_precision=True)

BUILTIN_SPECS = {s.name: s for s in (H100, CPU_TORCH, TORCH_REF)}
