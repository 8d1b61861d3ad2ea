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

On a process grid the table also decides the chunk count of the
pipelined gemv -> psum super-stage (:meth:`DispatchTable.overlap_chunks`),
and :func:`calibrate_overlap` measures how much of a chunk's reduction
the next chunk's compute hides (the ``overlap_efficiency`` of
:class:`repro_torch.core.partition.NetworkModel`), persisted beside the
crossover.
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

# ``overlap="auto"`` never cuts a chunk thinner than this many output rows
# (the JAX package's default: its backends' sublane, 8).
DEFAULT_OVERLAP_MIN_ROWS = 8


@dataclasses.dataclass(frozen=True)
class DispatchTable:
    """An optional forced path and the short-wide transition point.

    ``force``             None (auto) or one of "kernel"/"torch"/"ref".
    ``short_wide_ratio``  a calibrated table takes the kernel for a block
                          of m rows and n columns when ``m * ratio <= n``
                          (``inf``: the kernel never won).
    ``calibrated``        True when the ratio came from measurements; an
                          uncalibrated table ignores it.
    ``overlap_min_rows``  pipelined collectives: the fewest output rows a
                          chunk may have before ``overlap="auto"`` splits
                          the Phase-3 contraction (0: 8, the default).
    """

    force: Optional[str] = None
    short_wide_ratio: float = DEFAULT_SHORT_WIDE_RATIO
    calibrated: bool = False
    overlap_min_rows: int = 0

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

    def overlap_chunks(self, rows: int, group: Optional[int],
                       spec: BackendSpec, prefer="auto") -> int:
        """Chunk count of a pipelined gemv -> psum super-stage.

        ``rows`` is the local contraction's output-row count (the chunked
        axis), ``group`` the reduction group's size (None: not recorded,
        treated as eligible).  ``prefer`` is ``ExecOpts.overlap``: None
        pins the serial schedule, an int pins that chunk count (clamped
        to ``rows``), and ``"auto"`` declines when there is nothing to
        overlap (a group of 1) and otherwise takes the spec's
        ``overlap_chunks``, never cutting a chunk below
        ``overlap_min_rows`` rows."""
        if prefer is None:
            return 1
        if isinstance(prefer, int) and not isinstance(prefer, bool):
            return max(1, min(prefer, rows))
        if group is not None and group <= 1:
            return 1
        min_rows = self.overlap_min_rows or DEFAULT_OVERLAP_MIN_ROWS
        return max(1, min(spec.overlap_chunks, rows // max(1, min_rows)))

    # -- identity / persistence ---------------------------------------------
    def describe(self) -> str:
        """Compact identity string for tuning-cache key details."""
        cal = "cal" if self.calibrated else "def"
        omr = f";omr={self.overlap_min_rows}" if self.overlap_min_rows else ""
        return (f"{self.force or 'auto'};swr={self.short_wide_ratio:g}"
                f"{omr};{cal}")

    def to_dict(self) -> dict:
        return {"short_wide_ratio": float(self.short_wide_ratio),
                "force": self.force, "calibrated": bool(self.calibrated),
                "overlap_min_rows": int(self.overlap_min_rows)}

    @classmethod
    def from_dict(cls, d: dict) -> "DispatchTable":
        return cls(short_wide_ratio=float(d["short_wide_ratio"]),
                   force=d.get("force"),
                   calibrated=bool(d.get("calibrated", False)),
                   overlap_min_rows=int(d.get("overlap_min_rows", 0)))


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


# ---------------------------------------------------------------------------
# Overlap calibration: how much of a chunk's ring reduction the next
# chunk's compute hides, persisted beside the crossover.
# ---------------------------------------------------------------------------

OVERLAP_LEGS = ("t_serial", "t_pipelined", "t_collective",
                "t_chunk_collective")
# The measurement's shape, the JAX package's: N_t, N_d and N_m per rank.
OVERLAP_SHAPE = (32, 256, 64)


def default_overlap_measure(device=None, *, repeats: int = 5,
                            timer=None) -> Callable[[int], dict]:
    """``measure(chunks) -> {leg: seconds}`` over the default process
    group, which every rank of it calls together: the serial and the
    K-chunk ring matvec on a (1, world) grid at :data:`OVERLAP_SHAPE`,
    then the ring reduction of its whole and of a 1/K payload alone.
    Each leg is the slowest rank's, so every rank computes the same
    efficiency.  ``timer(fn, arg, repeats) -> ms`` defaults to
    ``core.timing.time_callable`` (the card; its ``"latency"`` mode).

    A reduction needs ranks to reduce over: with no default group, or one
    of a single rank, this raises.  Imports deferred: the core builds on
    this module."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..core.fftmatvec import FFTMatvec
    from ..core.pipeline import Stage, run_stages
    from ..core.timing import time_callable
    from ..launch.mesh import make_test_mesh
    from .registry import default_device

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < 2:
        raise RuntimeError(
            f"calibrate_overlap measures a reduction across ranks: it needs "
            f"an initialized default process group of at least 2 ranks, "
            f"found {world}")
    dev = default_device(device)
    if timer is None:
        def timer(fn, arg, n):
            return time_callable(fn, arg, n, warmup=2, mode="latency")

    def measure(chunks: int) -> dict:
        N_t, N_d, n_m = OVERLAP_SHAPE
        rng = np.random.default_rng(0)
        F_col = rng.standard_normal((N_t, N_d, n_m * world))
        m = rng.standard_normal((n_m * world, N_t))
        mesh = make_test_mesh((1, world), ("row", "col"), device_type=dev.type)
        base = FFTMatvec.from_block_column(F_col, mesh=mesh, device=dev,
                                           collective="ring")
        m_loc = base.local_block(m, "m")
        res = {}
        for tag, ov in (("t_serial", None), ("t_pipelined", chunks)):
            res[tag] = 1e-3 * timer(base.with_overlap(ov).matvec, m_loc,
                                    repeats)
        opts = base.resolved_opts()
        st = Stage("psum", "d", axis="col", collective="ring",
                   groups=(world,))
        gen = torch.Generator(device=dev).manual_seed(2)
        for tag, rows in (("t_collective", N_d),
                          ("t_chunk_collective", -(-N_d // chunks))):
            q = torch.randn((rows, N_t), generator=gen, dtype=torch.float64,
                            device=dev)
            res[tag] = 1e-3 * timer(
                lambda v: run_stages((st,), v, {}, N_t=N_t, opts=opts), q,
                repeats)
        legs = torch.tensor([res[k] for k in OVERLAP_LEGS],
                            dtype=torch.float64, device=dev)
        dist.all_reduce(legs, op=dist.ReduceOp.MAX)
        return dict(zip(OVERLAP_LEGS, legs.tolist()))

    return measure


def overlap_efficiency_from_times(times: dict, chunks: int) -> float:
    """Realized overlap efficiency from the four measured legs.

    The pipeline model prices the K-chunk schedule as the serial compute
    plus ``t_chunk * (1 + (1 - eff)(K - 1))`` of exposed reduction, while
    the serial schedule pays the whole ``t_collective``.  The two matvec
    legs differ only in that exposed reduction (their compute is the same
    row partition), so

        exposed = t_pipelined - t_serial + t_collective
        eff     = 1 - (exposed / t_chunk_collective - 1) / (K - 1)

    clamped to [0, 1]: noise can push the raw estimate past either end."""
    K = int(chunks)
    if K <= 1:
        return 0.0
    t_chunk = max(float(times["t_chunk_collective"]), 1e-12)
    exposed = (float(times["t_pipelined"]) - float(times["t_serial"])
               + float(times["t_collective"]))
    eff = 1.0 - (exposed / t_chunk - 1.0) / (K - 1)
    return min(1.0, max(0.0, eff))


def calibrate_overlap(spec: BackendSpec, *,
                      measure: Optional[Callable[[int], dict]] = None,
                      cache=None, chunks: int = 4, repeats: int = 5) -> float:
    """Measured overlap efficiency for ``spec``'s fabric, in [0, 1].

    As :func:`calibrate_dispatch`: with ``cache`` (a
    :class:`repro_torch.tune.TuningCache`) an efficiency measured before
    for the same backend fingerprint is returned without measuring, and a
    new one is stored with its leg times.  ``measure(chunks) -> {leg:
    seconds}`` is injectable; the default, :func:`default_overlap_measure`,
    runs on the default process group (every rank calls this together)."""
    if cache is not None:
        entry = cache.get_overlap(spec)
        if entry is not None:
            return float(entry["efficiency"])
    if measure is None:
        measure = default_overlap_measure(repeats=repeats)
    times = measure(chunks)
    eff = overlap_efficiency_from_times(times, chunks)
    if cache is not None:
        cache.put_overlap(spec, eff, chunks=chunks,
                          times={k: float(v) for k, v in times.items()})
        cache.save()
    return eff


def calibrated_network(spec: BackendSpec, cache=None, base=None):
    """A :class:`repro_torch.core.partition.NetworkModel` whose
    ``overlap_efficiency`` is the persisted :func:`calibrate_overlap`
    measurement for ``spec`` (``overlap_calibrated=True``), or ``base``
    unchanged when nothing is cached."""
    from ..core.partition import NetworkModel
    if base is None:
        base = NetworkModel()
    entry = cache.get_overlap(spec) if cache is not None else None
    if entry is None:
        return base
    return dataclasses.replace(base,
                               overlap_efficiency=float(entry["efficiency"]),
                               overlap_calibrated=True)
