"""The declarative rule engine: registry, lint entry points, pytest glue.

A rule is a named check over a :class:`~repro_torch.analysis.context.PlanContext`
returning zero or more :class:`~repro_torch.analysis.findings.Finding`s.  Rules
self-register at import through the :func:`rule` decorator; the three
pass families (``precision-flow``, ``invariants``, ``recompile``) are
just registry tags, so ``lint_plan(plan, opts, families=("invariants",))``
runs one family and the default runs them all.  Twin of
``src/repro/analysis/rules.py``; the trace is a ``make_fx`` graph of aten
ops (``context.py``).

Entry points:

``lint_plan``        lint one lowered plan (traced abstractly, never
                     executed) and return its findings.
``assert_plan_clean``  pytest helper: raise with the formatted findings
                     when the plan is not clean.
``lint_callable``    trace an arbitrary callable and check the aten ops
                     of its graph against allow/block lists.
"""

from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

from repro_torch.core.pipeline import ExecOpts, Plan

from .context import PlanContext, iter_eqns, op_name, trace_callable
from .findings import ERROR, Finding, errors, format_findings

FAMILIES = ("precision-flow", "invariants", "recompile")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered check.

    ``name``         stable identifier findings carry (kebab-case).
    ``family``       one of :data:`FAMILIES`.
    ``description``  one-liner for the catalog (DESIGN.md §11).
    ``check``        ``PlanContext -> Iterable[Finding]``.
    """

    name: str
    family: str
    description: str
    check: Callable[[PlanContext], Iterable[Finding]] = \
        dataclasses.field(compare=False)


_REGISTRY: Dict[str, Rule] = {}


def rule(name: str, family: str, description: str):
    """Register a check function as a named rule (decorator)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown rule family {family!r}")

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"duplicate rule name {name!r}")
        _REGISTRY[name] = Rule(name, family, description, fn)
        return fn

    return deco


def all_rules(families: Optional[Sequence[str]] = None,
              names: Optional[Sequence[str]] = None) -> Tuple[Rule, ...]:
    """The registered rules, optionally filtered by family and/or name."""
    _load()
    out = []
    for r in _REGISTRY.values():
        if families is not None and r.family not in families:
            continue
        if names is not None and r.name not in names:
            continue
        out.append(r)
    if names is not None:
        missing = set(names) - {r.name for r in out}
        if missing:
            raise KeyError(f"unknown rule(s): {sorted(missing)}")
    return tuple(out)


def _load():
    # rule modules self-register on import; deferred to dodge the cycle
    from . import invariants, precision_flow, recompile  # noqa: F401


def lint_plan(plan: Plan, opts: Optional[ExecOpts] = None, *, N_t: int,
              N_d: int, N_m: int, S: int = 1, rows: Optional[int] = None,
              families: Optional[Sequence[str]] = None,
              names: Optional[Sequence[str]] = None,
              device=None,
              groups: Optional[Mapping] = None) -> List[Finding]:
    """Statically lint one lowered plan; returns its findings.

    The plan is traced abstractly at the given dims (fake planes through
    ``make_fx``: nothing executes, nothing allocates).  ``rows``
    overrides the derived input row count (square "G"-operand plans);
    ``device`` is where an operator's data lives, for opts that probe the
    backend from it.  A mesh plan's collectives trace over ``groups`` (an
    operator's process groups), or over a fake process group made for
    the lint where the process has none (:meth:`PlanContext.grid`).  A
    plan that fails to *trace* is itself reported as a ``trace-failure``
    error finding.
    """
    ctx = PlanContext.from_plan(plan, opts, N_t=N_t, N_d=N_d, N_m=N_m,
                                S=S, rows=rows, device=device, groups=groups)
    findings: List[Finding] = []
    with ctx.grid():
        for r in all_rules(families, names):
            try:
                findings.extend(r.check(ctx))
            except Exception as e:  # a rule that cannot run is a finding
                findings.append(Finding(
                    "trace-failure", ERROR,
                    f"rule {r.name!r} could not inspect the plan: {e}",
                    detail=type(e).__name__))
    findings.sort(key=lambda f: (f.severity != ERROR, f.rule,
                                 f.stage if f.stage is not None else -1))
    return findings


def assert_plan_clean(plan: Plan, opts: Optional[ExecOpts] = None, *,
                      allow_warnings: bool = False, **kw) -> None:
    """Pytest helper: fail with the formatted findings unless the plan
    lints clean (``allow_warnings=True`` tolerates warning-severity
    findings)."""
    found = lint_plan(plan, opts, **kw)
    bad = errors(found) if allow_warnings else tuple(found)
    assert not bad, "plan is not clean:\n" + format_findings(bad)


def lint_callable(fn, args: Sequence, *,
                  allowed: Optional[Iterable[str]] = None,
                  forbidden: Optional[Iterable[str]] = None,
                  name: str = "primitive-set") -> List[Finding]:
    """Trace ``fn(*args)`` (args are tensors, real or fake; nothing
    executes) and check its ops (:func:`context.op_name`: "cat",
    "_to_copy", "repro_torch.sbgemv_n_complex") against an allowlist
    and/or blocklist."""
    jx = trace_callable(fn, *args)
    findings: List[Finding] = []
    allowed = None if allowed is None else set(allowed)
    forbidden = set() if forbidden is None else set(forbidden)
    for node, _, path in iter_eqns(jx):
        prim = op_name(node)
        if allowed is not None and prim not in allowed:
            findings.append(Finding(
                name, ERROR,
                f"op {prim!r} is outside the allowed set "
                f"{sorted(allowed)}", detail=path))
        if prim in forbidden:
            findings.append(Finding(
                name, ERROR, f"forbidden op {prim!r} emitted",
                detail=path))
    return findings


def rule_catalog() -> Tuple[Rule, ...]:
    """Every registered rule, family-major — the basis of the DESIGN.md
    §11 catalog and the CLI's ``--rules`` listing."""
    _load()
    return tuple(sorted(_REGISTRY.values(),
                        key=lambda r: (FAMILIES.index(r.family), r.name)))
