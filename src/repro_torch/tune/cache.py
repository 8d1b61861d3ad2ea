"""Persistent tuning cache: measured Pareto data keyed by problem + device.

Tuning results are a property of (problem shape, precision ladder,
variant, backend and card), not of a process: the same operator rebuilt
tomorrow on the same card reuses yesterday's measurements instead of
re-timing the lattice.  Entries serialize to one JSON file holding, per
key, the measured (error, time) records, the Pareto front and the configs
chosen per tolerance; any tolerance is re-answered from the stored records
without re-measuring.  The file is the port's own (``REPRO_TORCH_TUNE_
CACHE``), never the JAX package's: timings of one framework and card
never answer a query for another.

Robustness contract: a corrupted file, an entry with a stale schema
version, or one with unparseable precision strings is a cache *miss* (the
tuner re-tunes and overwrites), never an exception surfaced to the caller.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
import warnings
from typing import Optional, Sequence

import torch

from repro_torch.backend.dispatch import DispatchTable
from repro_torch.core.pareto import ConfigRecord, optimal_config
from repro_torch.core.precision import PrecisionConfig

CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"
# The JAX package's entry schema (its version 4: configs may carry a
# ``;tiles=`` suffix, tile-enabled tunes key on ``;tiles=RxC``).
SCHEMA_VERSION = 4


def default_cache_path() -> pathlib.Path:
    """``$REPRO_TORCH_TUNE_CACHE`` if set, else ``$XDG_CACHE_HOME/
    repro-torch-fftmatvec/tune.json`` (``~/.cache`` fallback)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return pathlib.Path(env).expanduser()
    base = pathlib.Path(os.environ.get("XDG_CACHE_HOME",
                                       "~/.cache")).expanduser()
    return base / "repro-torch-fftmatvec" / "tune.json"


def device_kind(device) -> str:
    """``platform:name`` of a torch device: the card's name on CUDA."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """Identity of one tuning problem.

    ``backend`` is the :meth:`repro_torch.backend.BackendSpec.fingerprint`
    the measurements ran through, so a kernel-path tune never answers a
    ``torch-ref`` query on the same card.  ``detail`` captures the rest
    the measurements depend on (dispatch table, timing mode, RHS count,
    tile grid, input), so a cached selection is never reused for a
    materially different workload."""
    N_t: int
    N_d: int
    N_m: int
    ladder: tuple
    variant: str = "matvec"
    device_kind: str = ""
    detail: str = ""
    backend: str = ""

    @classmethod
    def for_operator(cls, op, ladder: Sequence[str], variant: str = "matvec",
                     *, mode: str = "throughput", n_rhs: int | None = None,
                     input_tag: str = "", synthetic_timer: bool = False,
                     tiles: tuple | None = None) -> "CacheKey":
        r = op.opts.resolve(op.device)
        detail = f"disp={r.table.force or 'auto'};mode={mode}"
        if variant in ("matmat", "rmatmat"):
            detail += f";S={n_rhs}"
        if tiles is not None:
            # tile-enabled tunes explore a larger config space: their
            # selections never answer (or are answered by) a uniform tune
            detail += f";tiles={tiles[0]}x{tiles[1]}"
        if input_tag:
            detail += f";in={input_tag}"
        if synthetic_timer:
            # injected timers give synthetic times: real runs never read
            # (or are read by) those entries
            detail += ";timer=custom"
        return cls(op.N_t, op.N_d, op.N_m, tuple(ladder), variant,
                   device_kind(op.device), detail, r.spec.fingerprint())

    def to_string(self) -> str:
        return (f"{self.N_t}x{self.N_d}x{self.N_m}/{''.join(self.ladder)}/"
                f"{self.variant}/{self.device_kind}/{self.backend}/"
                f"{self.detail}")


def _valid_entry(entry) -> bool:
    """Schema check; anything off is a miss (stale-cache fallback)."""
    if not isinstance(entry, dict) or entry.get("version") != SCHEMA_VERSION:
        return False
    errors, times = entry.get("errors"), entry.get("times")
    if not isinstance(errors, dict) or not isinstance(times, dict) \
            or not times:
        return False
    try:
        for prec in set(errors) | set(times):
            PrecisionConfig.from_string(prec)
        baseline = entry.get("baseline")
        if baseline not in times or baseline not in errors:
            return False
        for d in (errors, times):
            for val in d.values():
                float(val)
        if not isinstance(entry.get("front", []), list):
            return False
    except (ValueError, TypeError):
        return False
    return True


class TuningCache:
    """JSON-backed map ``CacheKey -> measured tuning entry``."""

    def __init__(self, path: os.PathLike | str | None = None):
        self.path = pathlib.Path(path) if path is not None \
            else default_cache_path()
        self._data: Optional[dict] = None

    def _load(self) -> dict:
        if self._data is None:
            try:
                raw = json.loads(self.path.read_text())
                if not isinstance(raw, dict):
                    raise ValueError("top-level JSON is not an object")
            except FileNotFoundError:
                raw = {}
            except (ValueError, OSError) as exc:
                warnings.warn(f"tuning cache {self.path} unreadable "
                              f"({exc}); re-tuning from scratch")
                raw = {}
            self._data = raw
        return self._data

    @staticmethod
    def _mergeable(key: str, entry) -> bool:
        """Whether an entry is kept through a save: dispatch tables by
        their schema, tuning entries by theirs."""
        if key.startswith("dispatch/"):
            return (isinstance(entry, dict)
                    and entry.get("version") == SCHEMA_VERSION
                    and isinstance(entry.get("table"), dict))
        return _valid_entry(entry)

    def save(self) -> None:
        """Merge-on-write + atomic replace (tmp + rename).

        The file is re-read at save time and valid entries another writer
        landed since our load are merged in (ours win per key), so two
        processes tuning different keys lose nothing; a crash mid-write
        never corrupts the file.  Invalid or stale entries are dropped."""
        data = self._load()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        try:
            on_disk = json.loads(self.path.read_text())
            if not isinstance(on_disk, dict):
                on_disk = {}
        except (FileNotFoundError, ValueError, OSError):
            on_disk = {}
        union = {**on_disk, **data}
        merged = {k: v for k, v in union.items() if self._mergeable(k, v)}
        self._data = merged
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, key: CacheKey) -> Optional[dict]:
        """Validated entry for ``key``, or None (miss / corrupt / stale)."""
        entry = self._load().get(key.to_string())
        return entry if _valid_entry(entry) else None

    def put(self, key: CacheKey, *, records: Sequence[ConfigRecord],
            front: Sequence[ConfigRecord], chosen: PrecisionConfig,
            tol: float, baseline: PrecisionConfig, n_lattice: int,
            errors: Optional[dict] = None) -> None:
        """Store a tuning outcome.  ``records`` are the *timed* records;
        ``errors`` may add error-only measurements (probes, pruned
        candidates) on top of the records' own."""
        prior = self.get(key)
        chosen_map = dict(prior.get("chosen", {})) if prior else {}
        chosen_map[repr(float(tol))] = chosen.to_string()
        all_errors = {} if errors is None else {k: float(v)
                                                for k, v in errors.items()}
        all_errors.update({r.prec: float(r.rel_error) for r in records})
        self._load()[key.to_string()] = {
            "version": SCHEMA_VERSION,
            "errors": all_errors,
            "times": {r.prec: float(r.time_s) for r in records},
            "front": [r.prec for r in front],
            "chosen": chosen_map,
            "baseline": baseline.to_string(),
            "n_timed": len(records),
            "n_lattice": int(n_lattice),
        }

    def records(self, key: CacheKey) -> Optional[list[ConfigRecord]]:
        """The timed :class:`ConfigRecord` list stored for ``key``."""
        entry = self.get(key)
        if entry is None:
            return None
        base_t = float(entry["times"][entry["baseline"]])
        return [ConfigRecord(PrecisionConfig.from_string(prec),
                             float(entry["errors"][prec]), float(t),
                             base_t / float(t) if t else float("nan"))
                for prec, t in entry["times"].items()
                if prec in entry["errors"]]

    def lookup_config(self, key: CacheKey,
                      tol: float) -> Optional[PrecisionConfig]:
        """Fastest cached config meeting ``tol`` (any tolerance, answered
        from the stored records), or None when nothing cached qualifies."""
        recs = self.records(key)
        if not recs:
            return None
        try:
            return optimal_config(recs, tol).config
        except ValueError:
            return None

    # -- dispatch calibration ------------------------------------------------
    # Calibrated dispatch tables (backend.calibrate_dispatch) live beside
    # the tuning entries, keyed by the backend fingerprint: a crossover is
    # a property of the card and the kernels, measured once.

    @staticmethod
    def _dispatch_key(spec) -> str:
        return f"dispatch/{spec.fingerprint()}"

    def get_dispatch(self, spec) -> Optional[DispatchTable]:
        """The calibrated table stored for this backend, or None (a miss,
        a stale schema version or a corrupt entry alike)."""
        entry = self._load().get(self._dispatch_key(spec))
        if not isinstance(entry, dict) \
                or entry.get("version") != SCHEMA_VERSION:
            return None
        try:
            return DispatchTable.from_dict(entry["table"])
        except (KeyError, TypeError, ValueError, AttributeError):
            return None

    def put_dispatch(self, spec, table: DispatchTable) -> None:
        self._load()[self._dispatch_key(spec)] = {
            "version": SCHEMA_VERSION,
            "backend": spec.fingerprint(),
            "table": table.to_dict(),
        }
