"""The dispatch table: which lowering runs an SBGEMV, per backend.

The paper's rocBLAS host dispatcher, ported.  Three paths:

    "kernel"  the hand-written CUDA kernels (``kernels/csrc``),
    "torch"   the plain PyTorch contraction (``kernels.ref.complex_contract``),
    "ref"     the oracles (``kernels.ref``).

Explicit-vs-auto contract: ``force="kernel"`` demands the kernel and
raises :class:`UnsupportedOnBackend` when the backend cannot run it.
Automatic dispatch (``force=None``) on a backend with the kernels raises
for a dtype they do not take and otherwise takes the kernel on every
shape and mode (they mask their own edges): the built-in table is not
calibrated, and on the card nothing falls back to plain PyTorch unless
the caller forces it or hands in a calibrated table.  Elsewhere it takes
the plain contraction.

A table can be *calibrated*: :func:`calibrate_dispatch` times both sides
of the short-wide crossover on the live backend (through
``core.timing.time_callable``) and finds the ratio from which the kernel
stays ahead; a table with ``calibrated=True`` sends a (B, m, n) block with
``m * short_wide_ratio > n`` to the plain contraction.  Calibrated tables
round-trip through :class:`repro_torch.tune.TuningCache`, keyed by the
backend fingerprint, so a later process on the same card reuses them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

from .spec import BackendSpec, UnsupportedOnBackend

_PATHS = ("kernel", "torch", "ref")

# The JAX package's default transition point; a table reads it only once
# calibrated (the uncalibrated table takes the kernel on every shape).
DEFAULT_SHORT_WIDE_RATIO = 4.0


@dataclasses.dataclass(frozen=True)
class DispatchTable:
    """An optional forced path and the short-wide transition point.

    ``force``             None (auto) or one of "kernel"/"torch"/"ref".
    ``short_wide_ratio``  a calibrated table takes the kernel for a block
                          of m rows and n columns when ``m * ratio <= n``
                          (``inf``: the kernel never won).
    ``calibrated``        True when the ratio came from measurements; an
                          uncalibrated table ignores it.
    """

    force: Optional[str] = None
    short_wide_ratio: float = DEFAULT_SHORT_WIDE_RATIO
    calibrated: bool = False

    def __post_init__(self):
        if self.force is not None and self.force not in _PATHS:
            raise ValueError(f"force must be one of {_PATHS}, "
                             f"got {self.force!r}")

    def gemv_path(self, m: int, n: int, mode: str, dtype,
                  spec: BackendSpec) -> str:
        """Path for a (B, m, n) SBGEMV/SBGEMM block on ``dtype`` planes in
        ``mode``: "kernel"/"torch"/"ref"."""
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
            if (self.force is None and self.calibrated
                    and m * self.short_wide_ratio > n):
                return "torch"
            return "kernel"
        if spec.reference or self.force == "ref":
            return "ref"
        return "torch"

    # -- identity / persistence ---------------------------------------------
    def describe(self) -> str:
        """Compact identity string for tuning-cache key details."""
        cal = "cal" if self.calibrated else "def"
        return f"{self.force or 'auto'};swr={self.short_wide_ratio:g};{cal}"

    def to_dict(self) -> dict:
        return {"short_wide_ratio": float(self.short_wide_ratio),
                "force": self.force, "calibrated": bool(self.calibrated)}

    @classmethod
    def from_dict(cls, d: dict) -> "DispatchTable":
        return cls(short_wide_ratio=float(d["short_wide_ratio"]),
                   force=d.get("force"),
                   calibrated=bool(d.get("calibrated", False)))


def default_table(spec: BackendSpec) -> DispatchTable:
    """The table for a spec (reference backends force the oracle path)."""
    if spec.reference:
        return DispatchTable(force="ref")
    return DispatchTable()


# ---------------------------------------------------------------------------
# Calibration: time both sides of the crossover, find the ratio.
# ---------------------------------------------------------------------------

CALIBRATION_BATCH = 8
CALIBRATION_ROWS = 16
CALIBRATION_RATIOS = (1, 2, 4, 8, 16, 32, 64)


def default_gemv_measure(device=None) -> Callable[[str, int, int], float]:
    """``measure(path, m, n) -> ms``: the device time of one complex "H"
    SBGEMV on f32 planes (B = 8) through ``kernels.ops.sbgemv`` forced
    onto ``path``, by ``core.timing.time_callable`` (median of 20 event
    pairs after 3 warm-up calls).  Needs the card.  Imports deferred:
    ``kernels.ops`` consults this module."""
    import torch

    from ..core.timing import time_callable
    from ..kernels import ops
    from .registry import default_device

    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def measure(path: str, m: int, n: int) -> float:
        B = CALIBRATION_BATCH
        Ar, Ai = (torch.randn((B, m, n), generator=gen, device=dev)
                  for _ in range(2))
        xr, xi = (torch.randn((B, m), generator=gen, device=dev)
                  for _ in range(2))
        table = DispatchTable(force=path)
        return time_callable(
            lambda _: ops.sbgemv(Ar, Ai, xr, xi, "H", dispatch=table), None)

    return measure


def calibrate_short_wide_ratio(
        spec: BackendSpec, *,
        measure: Optional[Callable[[str, int, int], float]] = None,
        m: int = CALIBRATION_ROWS,
        ratios: Sequence[float] = CALIBRATION_RATIOS,
        times: Optional[dict] = None) -> float:
    """The smallest ratio from which the kernel stays ahead of the plain
    contraction at every wider shape probed (``inf`` when it never does,
    or when the backend has no kernels).

    ``measure(path, m, n)`` returns a time for one call on path
    "kernel"/"torch" (injectable: the tests drive a cost model through
    the code path the card's timing takes); ``times``, if given, receives
    ``{ratio: {"kernel": t, "torch": t}}``."""
    if not spec.kernels:
        return math.inf
    measure = measure or default_gemv_measure()
    wins = []
    for r in ratios:
        n = int(m * r)
        t = {p: float(measure(p, m, n)) for p in ("kernel", "torch")}
        if times is not None:
            times[r] = t
        wins.append(t["kernel"] < t["torch"])
    for i, r in enumerate(ratios):
        if all(wins[i:]):
            return float(r)
    return math.inf


def calibrate_dispatch(
        spec: BackendSpec, *,
        measure: Optional[Callable[[str, int, int], float]] = None,
        cache=None, times: Optional[dict] = None) -> DispatchTable:
    """A calibrated table for ``spec``.  With ``cache`` (a
    :class:`repro_torch.tune.TuningCache`) a table calibrated before for
    the same backend fingerprint is returned without measuring, and a new
    one is stored for the next process."""
    if cache is not None:
        cached = cache.get_dispatch(spec)
        if cached is not None:
            return cached
    table = DispatchTable(
        short_wide_ratio=calibrate_short_wide_ratio(spec, measure=measure,
                                                    times=times),
        calibrated=True)
    if cache is not None:
        cache.put_dispatch(spec, table)
        cache.save()
    return table
