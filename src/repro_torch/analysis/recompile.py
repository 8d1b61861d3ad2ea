"""Recompile-hazard pass: static arguments that break the caches.

Plans and :class:`ExecOpts` are hashable frozen dataclasses, so a
serving path can key what it builds on them: one operator, plan and
resolved lowering per (plan, opts, shape) key, shared across requests
(the solve server's appliers, the tuner's cache keys).  Anything that
breaks that contract rebuilds on every call:

* an unhashable leaf smuggled into a stage (a list where a tuple
  belongs, a tensor in a static field);
* value-equal objects that do not hash equal (a ``__hash__`` that
  disagrees with ``__eq__``), so every *rebuild* of the same config is a
  fresh cache key;
* a nondeterministic ``ExecOpts.resolve()`` (an unstable probe or
  dispatch-table default would give each call site a different key).

These checks are static.  :func:`trace_stability` is the *executed*
cross-check.  Twin of ``src/repro/analysis/recompile.py``, whose
``trace_stability`` watches ``jax.jit``'s cache; eager PyTorch has none,
so the port's keeps the cache a serving path keys on (see its
docstring).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List

import numpy as np
import torch

from .context import PlanContext
from .findings import ERROR, Finding
from .rules import rule

_MUTABLE = (list, dict, set, bytearray, np.ndarray, torch.Tensor)


def _mutable_leaves(value, path: str):
    """Yield (path, type) for mutable/unhashable leaves inside a static
    value (dataclasses descended field-wise, tuples element-wise)."""
    if isinstance(value, _MUTABLE):
        yield path, type(value).__name__
        return
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            yield from _mutable_leaves(getattr(value, f.name),
                                       f"{path}.{f.name}")
    elif isinstance(value, tuple):
        for i, v in enumerate(value):
            yield from _mutable_leaves(v, f"{path}[{i}]")


@rule("static-unhashable", "recompile",
      "plans and opts must hash (cache-key contract); every mutable leaf "
      "is pinpointed")
def check_hashable(ctx: PlanContext):
    out: List[Finding] = []
    for i, s in enumerate(ctx.plan):
        for path, tname in _mutable_leaves(s, f"plan[{i}]"):
            out.append(Finding(
                "static-unhashable", ERROR,
                f"mutable {tname} at {path} — the stage cannot key a "
                f"cache; every call would rebuild (use a tuple / frozen "
                f"value)",
                stage=i, detail=path))
    for path, tname in _mutable_leaves(ctx.opts, "opts"):
        out.append(Finding(
            "static-unhashable", ERROR,
            f"mutable {tname} at {path} — ExecOpts must stay hashable",
            detail=path))
    if out:
        return out
    for label, value in (("plan", ctx.plan), ("opts", ctx.opts)):
        try:
            hash(value)
        except TypeError as e:
            out.append(Finding(
                "static-unhashable", ERROR,
                f"{label} is unhashable: {e}", detail=label))
    return out


@rule("hash-unstable", "recompile",
      "value-equal plans/opts must hash equal — a rebuilt config may "
      "never be a fresh cache key")
def check_hash_stable(ctx: PlanContext):
    out: List[Finding] = []
    for label, value in (("plan", ctx.plan), ("opts", ctx.opts)):
        try:
            clone = copy.deepcopy(value)
            if clone != value:
                out.append(Finding(
                    "hash-unstable", ERROR,
                    f"a deep copy of the {label} does not compare equal "
                    f"to the original — every rebuild misses the cache",
                    detail=label))
            elif hash(clone) != hash(value):
                out.append(Finding(
                    "hash-unstable", ERROR,
                    f"value-equal {label} copies hash differently "
                    f"(__hash__ disagrees with __eq__) — every rebuild "
                    f"is a fresh cache key",
                    detail=label))
        except TypeError:
            pass        # static-unhashable already reports this
    return out


@rule("resolve-deterministic", "recompile",
      "ExecOpts.resolve() must be deterministic within a process — an "
      "unstable probe gives each lowering a different key")
def check_resolve_deterministic(ctx: PlanContext):
    try:
        a = ctx.opts.resolve(ctx.device)
        b = ctx.opts.resolve(ctx.device)
    except Exception as e:
        return [Finding(
            "resolve-deterministic", ERROR,
            f"ExecOpts.resolve() raised: {e}", detail=type(e).__name__)]
    if a != b or a.spec.fingerprint() != b.spec.fingerprint():
        return [Finding(
            "resolve-deterministic", ERROR,
            "two ExecOpts.resolve() calls disagree — backend probe or "
            "dispatch-table default is nondeterministic, so every "
            "lowering sees a different key",
            detail=f"{a.spec.fingerprint()} vs {b.spec.fingerprint()}")]
    return []


def _signature(value):
    """A tensor's cache signature (shape, dtype, device), else the value."""
    if isinstance(value, torch.Tensor):
        return (tuple(value.shape), value.dtype, value.device.type)
    return value


def trace_stability(fn, *args, calls: int = 2,
                    static_argnums=()) -> List[Finding]:
    """EXECUTED cross-check (not a registered static rule): call ``fn``
    ``calls`` times with the same arguments and report a finding if any
    call after the first adds an entry to the cache an eager serving path
    keys on.  The key holds the ``static_argnums`` arguments by hash and
    equality (as a jit cache keys its static arguments), every other
    argument's (shape, dtype, device), and, when ``fn`` is a bound method
    of an operator, the operator's plan and resolved options
    (``op.plan()``, ``op.opts.resolve(op.device)``): what the port
    builds once per key and reuses."""
    cache: dict = {}
    owner = getattr(fn, "__self__", None)

    def key():
        k = tuple(args[i] if i in static_argnums else _signature(a)
                  for i, a in enumerate(args))
        if owner is not None and hasattr(owner, "plan") \
                and hasattr(owner, "opts"):
            k += (owner.plan(), owner.opts.resolve(owner.device))
        return k

    sizes = []
    for _ in range(calls):
        cache.setdefault(key(), True)
        fn(*args)
        sizes.append(len(cache))
    grown = sizes[-1] - sizes[0]
    if grown:
        return [Finding(
            "retrace-on-identical-call", ERROR,
            f"the cache grew by {grown} on repeated identical calls — a "
            f"static argument is unstable under hashing",
            detail=f"cache {sizes[0]} -> {sizes[-1]}")]
    return []
