"""Precision-flow pass: the declared dtype lattice vs the traced one.

Every precision demotion is *declared*: a phase level in the
:class:`PrecisionConfig` or a tile level in a :class:`TileMap`, and priced
by the eq.-(6) error model.  These rules check that the lowered plan
computes exactly the lattice it declares: no silent output downgrades,
no stray f64 in a sub-double plan, no contraction accumulating below its
declared stage level, reorders at the footnote-8 level, tiles at or
below their stage.

Twin of ``src/repro/analysis/precision_flow.py``.  A hand-written kernel
is one node of the trace (a ``repro_torch`` custom op): its CUDA body
cannot be walked as the reference walks a Pallas body, so
``accum-below-stage`` reads its output dtype, which the kernel stores
straight from its accumulator.

Deliberate idioms the pass must NOT flag:

* narrowing ``_to_copy -> _to_copy`` round trips: the tile quantization
  idiom, a declared rounding event (the invariants pass handles the
  widening and no-op round trips);
* solver dot products accumulating *above* the recurrence dtype:
  accumulating high is never a downgrade, and those graphs are not plans.
"""

from __future__ import annotations

import torch

from repro_torch.core import precision as prec

from .context import (DATA_KINDS, PlanContext, float_level, node_dtypes,
                      op_name)
from .findings import ERROR, WARNING, Finding
from .rules import rule

# aten products (einsum and matmul decompose to these in the trace) and
# the kernels' custom ops: the contractions whose outputs are sums
CONTRACTIONS = ("mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
                "dot", "vdot", "matmul", "einsum")


def _name(dt) -> str:
    return str(dt).replace("torch.", "")


def is_contraction(name: str) -> bool:
    return name in CONTRACTIONS or name.startswith(
        ("repro_torch.sbgemv", "repro_torch.sbgemm"))


@rule("silent-output-downgrade", "precision-flow",
      "traced output dtype must match the last data stage's declared "
      "level (a lower dtype is the silent-downgrade bug class)")
def check_output_level(ctx: PlanContext):
    declared = ctx.declared_output_level
    want = prec.real_dtype(declared)
    out = []
    for av in ctx.out_avals:
        lg, lw = float_level(av.dtype), float_level(want)
        if lg is None:
            continue
        if lg < lw:
            out.append(Finding(
                "silent-output-downgrade", ERROR,
                f"plan declares its output at level {declared!r} "
                f"({_name(want)}) but the trace produces {_name(av.dtype)} "
                f"— a downstream consumer silently loses precision",
                detail=f"out {tuple(av.shape)} {_name(av.dtype)}"))
        elif lg > lw:
            out.append(Finding(
                "silent-output-downgrade", WARNING,
                f"traced output dtype {_name(av.dtype)} sits above the "
                f"declared level {declared!r} — an undeclared promotion "
                f"wastes bandwidth and hides the contract",
                detail=f"out {tuple(av.shape)} {_name(av.dtype)}"))
    return out


@rule("x64-promotion", "precision-flow",
      "a sub-double plan must not materialize float64 values (a Python "
      "float or a dtype-less constructor promoted to f64)")
def check_x64_promotion(ctx: PlanContext):
    if ctx.highest_level == "d":
        return []        # f64 is declared somewhere in the ladder
    out = []
    for node, _, path in ctx.eqns():
        if torch.float64 in node_dtypes(node):
            out.append(Finding(
                "x64-promotion", ERROR,
                f"float64 value appears in a plan whose highest declared "
                f"level is {ctx.highest_level!r} — a Python scalar or "
                f"dtype-less constructor promoted it",
                detail=path))
    return out


@rule("accum-below-stage", "precision-flow",
      "contraction accumulator dtypes must not sit below the declared "
      "gemv stage level (tiles may store low; sums may not)")
def check_accum_level(ctx: PlanContext):
    gemvs = ctx.stages("gemv")
    if not gemvs:
        return []
    floor = min(prec.level_index(s.level) for _, s in gemvs)
    out = []
    for node, _, path in ctx.eqns():
        if not is_contraction(op_name(node)):
            continue
        for dt in node_dtypes(node):
            lv = float_level(dt)
            if lv is not None and lv < floor:
                out.append(Finding(
                    "accum-below-stage", ERROR,
                    f"contraction accumulates at {_name(dt)}, below the "
                    f"lowest declared gemv level "
                    f"{('h', 's', 'd')[floor]!r} — per-tile storage may "
                    f"sit low, accumulation may not",
                    detail=path))
                break
    return out


@rule("reorder-level", "precision-flow",
      "reorder stages run at the min of the adjacent compute levels "
      "(paper footnote 8): lower silently downgrades, higher wastes")
def check_reorder_level(ctx: PlanContext):
    seq = [(i, s) for i, s in ctx.expanded if s.kind in DATA_KINDS]
    out = []
    for pos, (idx, s) in enumerate(seq):
        if s.kind != "reorder" or pos == 0 or pos == len(seq) - 1:
            continue
        prev_l, next_l = seq[pos - 1][1].level, seq[pos + 1][1].level
        want = prec.min_level(prev_l, next_l)
        have = prec.level_index(s.level)
        if have < prec.level_index(want):
            out.append(Finding(
                "reorder-level", ERROR,
                f"reorder at level {s.level!r} sits below both adjacent "
                f"compute levels ({prev_l!r}/{next_l!r}) — the memory "
                f"stage silently rounds the carrier",
                stage=idx))
        elif have > prec.level_index(want):
            out.append(Finding(
                "reorder-level", WARNING,
                f"reorder at level {s.level!r} above the adjacent "
                f"compute min ({want!r}) — pure memory traffic at a "
                f"precision nothing consumes",
                stage=idx))
    return out


@rule("tile-above-stage", "precision-flow",
      "TileMap levels must be min'd against the gemv stage level "
      "(PrecisionConfig/TileMap.effective contract)")
def check_tile_levels(ctx: PlanContext):
    out = []
    for idx, s in ctx.stages("gemv", "gemv_psum"):
        if s.tile_map is None:
            continue
        cap = prec.level_index(s.level)
        bad = sorted({lvl for row in s.tile_map.levels for lvl in row
                      if prec.level_index(lvl) > cap})
        if bad:
            out.append(Finding(
                "tile-above-stage", WARNING,
                f"tile map carries level(s) {bad} above the gemv stage "
                f"level {s.level!r} — tiles are stored above the compute "
                f"precision; derive maps with TileMap.effective",
                stage=idx))
    return out
