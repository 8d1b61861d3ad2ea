"""Structured findings: what every analysis pass returns.

A :class:`Finding` is one violation of one named rule, pinned to a plan
stage (when the rule is stage-scoped) or to a node path of the traced
graph (when it is trace-scoped).  Findings are plain frozen dataclasses so
test suites can compare them structurally and the CLI can serialize them
as JSON.  Twin of ``src/repro/analysis/findings.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    ``rule``      the registered rule name (e.g. ``"ring-permutation"``).
    ``severity``  :data:`ERROR` (a contract violation — the plan computes
                  something other than what it declares) or
                  :data:`WARNING` (legal but wasteful or fragile).
    ``message``   one-line human-readable statement of the defect.
    ``stage``     index into the linted plan when the rule is
                  stage-scoped; None for whole-plan / trace findings.
    ``detail``    supporting evidence: the offending node path,
                  primitive name, dtype pair, ...
    """

    rule: str
    severity: str
    message: str
    stage: Optional[int] = None
    detail: str = ""

    def __str__(self) -> str:
        where = f" [stage {self.stage}]" if self.stage is not None else ""
        tail = f"  ({self.detail})" if self.detail else ""
        return f"{self.severity.upper()} {self.rule}{where}: " \
               f"{self.message}{tail}"


class PlanLintError(ValueError):
    """A plan failed static analysis where a caller demanded cleanliness
    (e.g. ``autotune(..., lint=True)`` pre-flighting a candidate before
    spending timing budget on it).  Carries the findings."""

    def __init__(self, message: str, findings: Sequence[Finding] = ()):
        super().__init__(message)
        self.findings = tuple(findings)


def errors(findings: Sequence[Finding]) -> tuple:
    return tuple(f for f in findings if f.severity == ERROR)


def format_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "clean"
    return "\n".join(str(f) for f in findings)
