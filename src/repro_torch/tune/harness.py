"""Timing harness: re-export.

The implementation lives in :mod:`repro_torch.core.timing` so the layering
stays one-directional (``core.pareto.measure_configs`` uses the harness
too, and core must not depend on tune).  The tuner's public API surfaces
it here as ``repro_torch.tune.TimingHarness``.
"""

from repro_torch.core.timing import (TimedEntry, TimingHarness,  # noqa: F401
                                     VARIANTS, time_callable)
