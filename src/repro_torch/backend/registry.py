"""Backend selection: probe by device, override by name.

``probe_backend(device)`` answers "which spec serves tensors on this
device": ``h100`` for a CUDA device (bound to its name), ``cpu-torch``
for the CPU.  The ``REPRO_TORCH_BACKEND`` environment variable overrides
the probe by spec name (the JAX package reads ``REPRO_BACKEND``; the two
are separate because tests import both packages into one process).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Union

import torch

from .spec import BUILTIN_SPECS, CPU_TORCH, H100, BackendSpec

BACKEND_ENV = "REPRO_TORCH_BACKEND"

_PLATFORM_SPECS = {"cuda": H100, "cpu": CPU_TORCH}


def known_backends() -> tuple[str, ...]:
    return tuple(sorted(BUILTIN_SPECS))


def _bind_device(spec: BackendSpec, device: torch.device) -> BackendSpec:
    """Fill platform/device_kind from the device where unset."""
    if spec.platform and spec.device_kind:
        return spec
    kind = spec.device_kind
    if not kind and device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    return dataclasses.replace(spec, platform=spec.platform or device.type,
                               device_kind=kind or device.type)


def probe_backend(device) -> BackendSpec:
    """The spec for tensors on ``device``; ``REPRO_TORCH_BACKEND``
    short-circuits the probe by registered spec name."""
    device = torch.device(device)
    env = os.environ.get(BACKEND_ENV)
    if env:
        return resolve_backend(env, device)
    spec = _PLATFORM_SPECS.get(device.type)
    if spec is None:
        raise ValueError(f"no backend serves device type {device.type!r}")
    return _bind_device(spec, device)


def resolve_backend(backend: Union[BackendSpec, str, None],
                    device) -> BackendSpec:
    """Spec instance / registered name / None (= probe) -> spec bound to
    ``device``."""
    device = torch.device(device)
    if backend is None:
        return probe_backend(device)
    if isinstance(backend, BackendSpec):
        return _bind_device(backend, device)
    try:
        spec = BUILTIN_SPECS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; known: {known_backends()}"
        ) from None
    return _bind_device(spec, device)
