"""Static analysis of lowered plans and their traces.

Three pass families over a :class:`repro_torch.core.pipeline.Plan`, all
static: plans are traced abstractly (``make_fx`` on fake planes) and
never executed.

``precision-flow``   the declared dtype lattice (PrecisionConfig, TileMap,
                     carrier dtype) vs the traced one: silent output
                     downgrades, stray f64 in a sub-double plan,
                     accumulators below the declared gemv level,
                     footnote-8 reorder levels, tile/stage consistency.
``invariants``       lowering shape: no zero-fill chunk assembly, no
                     useless convert round trips, no device transfers.
``recompile``        cache-key hygiene: hashability, hash/eq stability,
                     deterministic ``ExecOpts.resolve()``, plus
                     :func:`trace_stability`, the executed cross-check.

Entry points: :func:`lint_plan` / :func:`assert_plan_clean` for plans,
:func:`lint_operator` for FFTMatvec/Gram operators (both directions),
:func:`lint_callable` for op allow/block lists over a traced callable,
and ``python -m repro_torch.analysis`` to sweep the paper-shape plan
families across the registered backends.

Twin of ``src/repro/analysis``; the mesh rules and mesh plans wait for
item 13b (multi-GPU).
"""

from typing import List, Optional

from .context import (PlanContext, float_level, iter_eqns, op_name,
                      trace_callable, traceable)
from .findings import (ERROR, WARNING, Finding, PlanLintError, errors,
                       format_findings)
from .recompile import trace_stability
from .rules import (FAMILIES, Rule, all_rules, assert_plan_clean,
                    lint_callable, lint_plan, rule, rule_catalog)

__all__ = [
    "ERROR", "WARNING", "FAMILIES", "Finding", "PlanContext",
    "PlanLintError", "Rule",
    "all_rules", "assert_plan_clean", "errors", "float_level",
    "format_findings", "iter_eqns", "lint_callable", "lint_operator",
    "lint_plan", "op_name", "rule", "rule_catalog", "trace_callable",
    "trace_stability", "traceable",
]


def lint_operator(op, *, adjoint: Optional[bool] = None,
                  **kw) -> List[Finding]:
    """Lint the plan(s) an operator actually executes.

    ``op`` is a :class:`repro_torch.core.FFTMatvec` (both directions by
    default; pass ``adjoint=True/False`` for one) or a
    :class:`repro_torch.core.gram.GramOperator`.  The plans trace on fake
    planes on the operator's device (on the card: its kernels' nodes).
    """
    dims = dict(N_t=op.N_t, N_d=op.N_d, N_m=op.N_m, device=op.device)
    if hasattr(op, "rows"):                      # GramOperator
        # the circulant mode's square "G" operand has op.rows rows; exact
        # mode derives its rows from the plan
        rows = op.rows if op.mode == "circulant" else None
        return lint_plan(op.plan(), op.opts, rows=rows, **dims, **kw)
    directions = (False, True) if adjoint is None else (adjoint,)
    found: List[Finding] = []
    for adj in directions:
        found.extend(lint_plan(op.plan(adjoint=adj), op.opts,
                               **dims, **kw))
    return found
