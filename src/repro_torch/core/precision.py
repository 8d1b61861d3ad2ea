"""Per-phase precision configuration for the FFTMatvec pipeline (paper C3).

Each of the five computational phases runs at one level of a three-level
ladder:

    "d" -> torch.float64   (paper-faithful; a native datapath on Hopper)
    "s" -> torch.float32   (IEEE f32 products and sums; TF32 stays off)
    "h" -> torch.bfloat16  (bf16 storage, f32 accumulation)

A configuration is written like the paper's runtime flag, e.g.
``-prec dssdd`` -> ``PrecisionConfig.from_string("dssdd")``.  Complex
data is carried as split re/im planes of the phase's real dtype, so the
Fourier-domain stages can be compared plane by plane with the JAX package.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Optional, Sequence

import torch

PHASES = ("pad", "fft", "gemv", "ifft", "reduce")

_LEVELS = ("h", "s", "d")  # ordered low -> high
_REAL_DTYPE = {"d": torch.float64, "s": torch.float32, "h": torch.bfloat16}
# FFTs always compute in >= f32 (torch.fft has no bf16); "h" phases compute
# f32 and store bf16 at phase boundaries.
_FFT_COMPUTE_DTYPE = {"d": torch.float64, "s": torch.float32,
                      "h": torch.float32}
_COMPLEX_DTYPE = {"d": torch.complex128, "s": torch.complex64,
                  "h": torch.complex64}

# Unit roundoff per level (bf16: 8 mantissa bits incl. implicit -> 2^-8).
MACHINE_EPS = {"d": 2.0 ** -53, "s": 2.0 ** -24, "h": 2.0 ** -8}


def real_dtype(level: str) -> torch.dtype:
    return _REAL_DTYPE[level]


def fft_compute_dtype(level: str) -> torch.dtype:
    return _FFT_COMPUTE_DTYPE[level]


def complex_dtype(level: str) -> torch.dtype:
    return _COMPLEX_DTYPE[level]


def machine_eps(level: str) -> float:
    return MACHINE_EPS[level]


def min_level(a: str, b: str) -> str:
    """Lowest of two precision levels (paper: memory ops between phases run
    at the lowest precision of the adjacent compute phases)."""
    return a if _LEVELS.index(a) <= _LEVELS.index(b) else b


def level_index(level: str) -> int:
    """Position on the h < s < d ladder (0, 1, 2)."""
    return _LEVELS.index(level)


def max_level(levels: Sequence[str]) -> str:
    """Highest of a set of precision levels."""
    return max(levels, key=_LEVELS.index)


@dataclasses.dataclass(frozen=True)
class TileMap:
    """Static per-tile precision levels for the Phase-3 GEMM.

    ``levels`` is a small ``(R_tiles, C_tiles)`` grid of ladder levels over
    the frequency-bin axis and the long model axis of ``F_hat``.  The
    effective level of a cell is ``min(cell, gemv)``.  ``matvec_plan`` and
    ``gram_plan`` put the effective map on the gemv stages that contract
    F_hat, and the tiled kernels round each F_hat element through its
    cell's level as they load it.
    """

    levels: tuple

    def __post_init__(self):
        rows = tuple(tuple(r) for r in self.levels)
        if not rows or not rows[0]:
            raise ValueError("tile map must be non-empty")
        width = len(rows[0])
        for r in rows:
            if len(r) != width:
                raise ValueError("ragged tile map")
            for lvl in r:
                if lvl not in _LEVELS:
                    raise ValueError(f"bad tile precision level {lvl!r}")
        object.__setattr__(self, "levels", rows)

    @property
    def shape(self) -> tuple[int, int]:
        return (len(self.levels), len(self.levels[0]))

    def to_string(self) -> str:
        return "|".join("".join(r) for r in self.levels)

    @classmethod
    def from_string(cls, s: str) -> "TileMap":
        return cls(tuple(tuple(row) for row in s.split("|")))

    @classmethod
    def uniform(cls, level: str, shape: tuple[int, int] = (1, 1)) -> "TileMap":
        return cls(tuple((level,) * shape[1] for _ in range(shape[0])))

    def is_uniform(self) -> bool:
        return len({lvl for row in self.levels for lvl in row}) == 1

    def min_level(self) -> str:
        return min((lvl for row in self.levels for lvl in row),
                   key=_LEVELS.index)

    def effective(self, gemv_level: str) -> tuple:
        """Per-cell effective storage levels: ``min(cell, gemv)``."""
        return tuple(tuple(min_level(lvl, gemv_level) for lvl in row)
                     for row in self.levels)


def tile_le(a: TileMap, b: TileMap) -> bool:
    """Pointwise domination: ``a <= b`` iff every cell of ``a`` is at a
    level no higher than ``b``'s (same shape required)."""
    if a.shape != b.shape:
        return False
    return all(_LEVELS.index(la) <= _LEVELS.index(lb)
               for ra, rb in zip(a.levels, b.levels)
               for la, lb in zip(ra, rb))


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Precision level of each of the five FFTMatvec phases.

    Phase order matches the paper: (1) broadcast+pad, (2) FFT, (3) SBGEMV,
    (4) IFFT, (5) unpad+reduce.  ``tiles`` optionally refines the gemv
    phase below phase granularity (``None`` is the paper's lattice).
    """

    pad: str = "d"
    fft: str = "d"
    gemv: str = "d"
    ifft: str = "d"
    reduce: str = "d"
    tiles: Optional[TileMap] = None

    def __post_init__(self):
        for p in PHASES:
            lvl = getattr(self, p)
            if lvl not in _LEVELS:
                raise ValueError(f"bad precision level {lvl!r} for phase {p!r}")
        if self.tiles is not None and not isinstance(self.tiles, TileMap):
            object.__setattr__(self, "tiles", TileMap(self.tiles))

    @classmethod
    def from_string(cls, s: str) -> "PrecisionConfig":
        base, sep, tail = s.partition(";tiles=")
        if len(base) != 5:
            raise ValueError(f"precision string must have 5 chars, got {s!r}")
        tiles = TileMap.from_string(tail) if sep else None
        return cls(*base, tiles=tiles)

    def to_string(self) -> str:
        s = "".join(getattr(self, p) for p in PHASES)
        if self.tiles is not None:
            s += f";tiles={self.tiles.to_string()}"
        return s

    def levels(self) -> tuple[str, ...]:
        return tuple(getattr(self, p) for p in PHASES)

    def phase_dtype(self, phase: str) -> torch.dtype:
        return real_dtype(getattr(self, phase))

    def reorder_level(self, before: str, after: str) -> str:
        """Precision of the memory-only reorder between two compute phases."""
        return min_level(getattr(self, before), getattr(self, after))

    def highest(self) -> str:
        return max_level(self.levels())

    def lowest(self) -> str:
        return min(self.levels(), key=_LEVELS.index)

    def replace(self, **kw) -> "PrecisionConfig":
        return dataclasses.replace(self, **kw)

    def gemv_tile_levels(self) -> Optional[tuple]:
        """Effective per-tile gemv storage levels, or None when uniform."""
        if self.tiles is None:
            return None
        return self.tiles.effective(self.gemv)

    def cost_rank(self) -> float:
        """Sum of per-phase ladder indices; a tile map replaces the gemv
        index by the mean effective tile index."""
        rank = sum(_LEVELS.index(getattr(self, p)) for p in PHASES)
        eff = self.gemv_tile_levels()
        if eff is not None:
            flat = [_LEVELS.index(lvl) for row in eff for lvl in row]
            rank += sum(flat) / len(flat) - _LEVELS.index(self.gemv)
        return rank


def _gemv_cells_le(a: PrecisionConfig, b: PrecisionConfig) -> bool:
    """gemv-phase comparison cell-wise (tile maps refine the phase level)."""
    ea, eb = a.gemv_tile_levels(), b.gemv_tile_levels()
    if ea is None and eb is None:
        return _LEVELS.index(a.gemv) <= _LEVELS.index(b.gemv)
    if ea is None:
        return all(_LEVELS.index(a.gemv) <= _LEVELS.index(lvl)
                   for row in eb for lvl in row)
    if eb is None:
        return all(_LEVELS.index(lvl) <= _LEVELS.index(b.gemv)
                   for row in ea for lvl in row)
    if a.tiles.shape != b.tiles.shape:
        return False              # different grids: incomparable
    return all(_LEVELS.index(la) <= _LEVELS.index(lb)
               for ra, rb in zip(ea, eb) for la, lb in zip(ra, rb))


def config_le(a: PrecisionConfig, b: PrecisionConfig) -> bool:
    """Lattice partial order: ``a <= b`` iff every phase of ``a`` runs at a
    level no higher than ``b``'s (tile maps compare cell-wise)."""
    if not all(_LEVELS.index(getattr(a, p)) <= _LEVELS.index(getattr(b, p))
               for p in PHASES if p != "gemv"):
        return False
    return _gemv_cells_le(a, b)


def config_lt(a: PrecisionConfig, b: PrecisionConfig) -> bool:
    """Strict lattice order: ``a <= b`` and ``a != b``."""
    return a != b and config_le(a, b)


def all_configs(levels: Sequence[str] = ("d", "s")) -> Iterator[PrecisionConfig]:
    """Every per-phase configuration over the given levels (("d", "s") is
    the paper's 32; all three levels give 243)."""
    for combo in itertools.product(levels, repeat=len(PHASES)):
        yield PrecisionConfig(*combo)


DOUBLE = PrecisionConfig.from_string("ddddd")
SINGLE = PrecisionConfig.from_string("sssss")
TPU_BASELINE = SINGLE
TPU_FAST = PrecisionConfig.from_string("hhhhh")
# The paper's Pareto-optimal configs (Fig. 3): F computes FFT+SBGEMV low;
# F* computes SBGEMV+IFFT low; >= 512 GPUs also reduce low ("dssds").
PAPER_OPT_F = PrecisionConfig.from_string("dssdd")
PAPER_OPT_FSTAR = PrecisionConfig.from_string("ddssd")
PAPER_OPT_F_LARGE = PrecisionConfig.from_string("dssds")
TPU_OPT_F = PrecisionConfig.from_string("shhss")

# The seven named configs, in the order the reports list them.
NAMED_CONFIGS = (DOUBLE, PAPER_OPT_F, PAPER_OPT_FSTAR, PAPER_OPT_F_LARGE,
                 SINGLE, TPU_OPT_F, TPU_FAST)
