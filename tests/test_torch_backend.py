"""The port's dispatch calibration (``repro_torch.backend.dispatch``)
against the JAX package's: the twins of the calibration tests of
``tests/test_backend.py`` (a round trip through the tuning cache, a kernel
that never wins, a backend without kernels), the port's rule that an
uncalibrated table takes the kernel on every shape, and a calibrated
table's routing held against the reference's decision at the same ratio.

Timing is a deterministic cost model injected as ``measure`` into both
packages (the kernel wins exactly from a given skew up), so the ratios
and paths compare exactly.  ``chip_smoke.py`` calibrates on the card
with CUDA-event timing.
"""

import json
import math

import jax.numpy as jnp
import pytest
import torch

from repro.backend import TPU_PALLAS
from repro.backend import calibrate_dispatch as jax_calibrate
from repro_torch.backend import (CPU_TORCH, H100, DispatchTable,
                                 UnsupportedOnBackend, calibrate_dispatch,
                                 calibrate_short_wide_ratio)
from repro_torch.tune import TuningCache

F32 = torch.float32
GRID = [(m, n) for m in (1, 4, 7, 16, 100) for n in (3, 16, 64, 128, 400, 5000)]
NAMES = {"pallas": "kernel", "xla": "torch", "ref": "ref"}


def _synthetic_measure(crossover, kernel="kernel", plain="torch"):
    """The kernel wins exactly from ``crossover`` skew upward."""
    def measure(path, m, n):
        if path == plain:
            return 1.0
        assert path == kernel, path
        return 0.5 if n / m >= crossover else 2.0
    return measure


def test_calibrated_threshold_roundtrips_through_tuning_cache(tmp_path):
    cache = TuningCache(tmp_path / "tune.json")
    times = {}
    table = calibrate_dispatch(H100, measure=_synthetic_measure(8),
                               cache=cache, times=times)
    assert table.calibrated and table.short_wide_ratio == 8
    assert times[8] == {"kernel": 0.5, "torch": 1.0}
    assert times[4] == {"kernel": 2.0, "torch": 1.0}
    # the calibrated transition moves auto dispatch
    assert table.gemv_path(16, 16 * 8, "H", F32, H100) == "kernel"
    assert table.gemv_path(16, 16 * 4, "H", F32, H100) == "torch"
    # an explicit request still takes the kernel
    forced = DispatchTable(force="kernel", short_wide_ratio=8,
                           calibrated=True)
    assert forced.gemv_path(16, 16, "H", F32, H100) == "kernel"

    def boom(path, m, n):
        raise AssertionError("re-measured despite a cached table")

    reloaded = calibrate_dispatch(H100, measure=boom,
                                  cache=TuningCache(tmp_path / "tune.json"))
    assert reloaded == table

    # a corrupt or stale stored table reads as a miss -> re-calibrates
    path = tmp_path / "tune.json"
    data = json.loads(path.read_text())
    key = next(k for k in data if k.startswith("dispatch/"))
    assert key == f"dispatch/{H100.fingerprint()}"
    for broken in ("garbage", None):
        data[key]["table"] = broken
        path.write_text(json.dumps(data))
        assert TuningCache(path).get_dispatch(H100) is None
    data[key] = {**data[key], "table": table.to_dict(), "version": -1}
    path.write_text(json.dumps(data))
    assert TuningCache(path).get_dispatch(H100) is None
    re_cal = calibrate_dispatch(H100, measure=_synthetic_measure(16),
                                cache=TuningCache(path))
    assert re_cal.short_wide_ratio == 16
    assert TuningCache(path).get_dispatch(H100) == re_cal


def test_calibration_never_wins_pushes_ratio_out_of_range(tmp_path):
    table = calibrate_dispatch(H100, measure=lambda path, m, n:
                               0.1 if path == "torch" else 1.0)
    assert table.short_wide_ratio == math.inf
    assert table.gemv_path(1, 10 ** 6, "H", F32, H100) == "torch"
    # an infinite ratio survives the cache file
    cache = TuningCache(tmp_path / "tune.json")
    cache.put_dispatch(H100, table)
    cache.save()
    assert TuningCache(tmp_path / "tune.json").get_dispatch(H100) == table


def test_calibration_without_kernels_keeps_torch():
    ratio = calibrate_short_wide_ratio(CPU_TORCH,
                                       measure=_synthetic_measure(2))
    assert ratio == math.inf
    table = DispatchTable(short_wide_ratio=ratio, calibrated=True)
    assert table.gemv_path(1, 10 ** 6, "H", F32, CPU_TORCH) == "torch"


@pytest.mark.parametrize("ratio", [1.0, 4.0, 64.0, math.inf])
def test_uncalibrated_table_takes_the_kernel(ratio):
    """The port's standing rule: an uncalibrated table takes the kernel on
    every shape and mode, whatever its ratio says, and still raises for a
    dtype the kernels do not take."""
    table = DispatchTable(short_wide_ratio=ratio)
    assert not table.calibrated
    for m, n in GRID:
        for mode in "NTH":
            for dt in (torch.float64, F32, torch.bfloat16):
                assert table.gemv_path(m, n, mode, dt, H100) == "kernel"
    with pytest.raises(UnsupportedOnBackend):
        table.gemv_path(16, 16, "H", torch.float16, H100)
    assert DispatchTable().describe() == "auto;swr=4;def"


@pytest.mark.parametrize("crossover", [1, 4, 16, 64])
def test_calibrated_routing_matches_the_reference(crossover):
    """Calibrated from the same cost model, both packages find the same
    ratio, and at every shape and mode the port routes where the
    reference does (its Pallas kernel -> the CUDA kernel, its XLA
    lowering -> the plain contraction)."""
    jt = jax_calibrate(TPU_PALLAS, measure=_synthetic_measure(
        crossover, kernel="pallas", plain="xla"))
    tt = calibrate_dispatch(H100, measure=_synthetic_measure(crossover))
    assert tt.short_wide_ratio == jt.short_wide_ratio == crossover
    assert tt.describe() == f"auto;swr={crossover};cal"
    assert DispatchTable.from_dict(tt.to_dict()) == tt
    for m, n in GRID:
        for mode in "NTH":
            want = NAMES[jt.gemv_path(m, n, mode, jnp.float32, TPU_PALLAS)]
            assert tt.gemv_path(m, n, mode, F32, H100) == want
