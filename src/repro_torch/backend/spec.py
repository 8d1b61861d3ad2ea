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

    ``peak_flops`` holds the dense peak rate of each input dtype, as
    ``(dtype name, FLOP/s)`` pairs (a tuple, so the spec stays hashable),
    the first of them the native matmul rate; ``hbm_bandwidth`` is the
    device memory rate and ``link_bandwidth`` one interconnect link's, in
    B/s per direction.  They feed the roofline (``launch.roofline``) and
    every bound the port reports.

    ``overlap_chunks`` is how many chunks ``ExecOpts.overlap="auto"``
    splits a pipelined gemv -> psum super-stage into when the dispatch
    table decides pipelining pays (``DispatchTable.overlap_chunks``): a
    count of collectives kept in flight, the JAX package's 4.
    """

    name: str
    platform: str = ""
    device_kind: str = ""
    kernels: bool = False
    reference: bool = False
    tile_precision: bool = False
    peak_flops: tuple = ()
    hbm_bandwidth: float = 0.0
    link_bandwidth: float = 0.0
    overlap_chunks: int = 4

    def fingerprint(self) -> str:
        """Stable identity for cache keys: backend + hardware it bound to."""
        return f"{self.name}@{self.platform}:{self.device_kind}"

    def kernel_supports(self, *dtypes) -> bool:
        """Whether the hand-written kernels take these dtypes here."""
        return self.kernels and all(dt in KERNEL_DTYPES for dt in dtypes)

    def peak(self, dtype=None) -> float:
        """Peak FLOP/s for operands of ``dtype`` (a torch dtype or its
        name; complex dtypes count at their real part's rate); None, or a
        dtype without its own entry, gives the native matmul rate."""
        rates = dict(self.peak_flops)
        if dtype is not None:
            name = str(dtype).replace("torch.", "")
            name = _REAL_PART.get(name, name)
            if name in rates:
                return rates[name]
        return self.peak_flops[0][1] if self.peak_flops else 0.0


_REAL_PART = {"complex64": "float32", "complex128": "float64",
              "complex32": "float16"}


# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit: the
# fastest rate the card has for each input type.  bf16: the tensor cores
# with f32 sums.  f32: the FP32 vector units ("s" is IEEE f32; TF32 would
# round the inputs).  f64: the FP64 tensor cores (the FP64 vector units
# give 34 TFLOP/s).  HBM3: 3.35 TB/s.  NVLink 4: 900 GB/s a card over both
# directions, so 450 GB/s each way (the collective term).
H100_PEAK_FLOPS = (("bfloat16", 989e12), ("float32", 67e12),
                   ("float64", 67e12))
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 450e9

H100 = BackendSpec(name="h100", platform="cuda", kernels=True,
                   tile_precision=True, peak_flops=H100_PEAK_FLOPS,
                   hbm_bandwidth=H100_HBM_BYTES_PER_S,
                   link_bandwidth=H100_NVLINK_BYTES_PER_S)

# Auto-selected for CPU tensors: the kernels' plain versions (the plain
# contraction for the gemv, the oracles for pad/unpad).
CPU_TORCH = BackendSpec(name="cpu-torch", platform="cpu", tile_precision=True)

# Forced reference backend on whatever device the data lives on.
TORCH_REF = BackendSpec(name="torch-ref", reference=True, tile_precision=True)

BUILTIN_SPECS = {s.name: s for s in (H100, CPU_TORCH, TORCH_REF)}
