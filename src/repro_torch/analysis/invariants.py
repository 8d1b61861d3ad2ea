"""Lowering-invariant rules: what a well-formed lowered plan looks like.

These generalize one-off graph assertions into declarative checks over
the whole traced plan:

* chunk assembly joins with ``cat``: never the zeros-then-write chain
  (the reference's ``dynamic_update_slice``: here ``slice_scatter``,
  ``index_put`` or a ``copy_`` into a ``zeros`` buffer) whose dead
  zero-fill the reference removed;
* no useless ``_to_copy`` dtype chains (widening or same-width round
  trips; *narrowing* round trips are the declared tile quantization idiom
  and exempt, see the precision-flow pass);
* no device transfers inside a plan body (a ``_to_copy`` to another
  device is a host round trip on the hot path).

and four over the collective stages of mesh plans:

* collective stages name non-duplicate axes with positive groups, and a
  comm level only where a reduction consumes it;
* a requested reduce-scatter or ring that lowers to the flat all-reduce
  is surfaced (the executor's ``:fallback`` counters);
* the ring's traced send and receive hops form one Hamiltonian cycle
  over its group;
* every reduction restores the carrier's dtype after a reduced-precision
  collective.

Twin of ``src/repro/analysis/invariants.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from repro_torch.core import precision as prec

from .context import DATA_KINDS, PlanContext, float_level, node_val, op_name
from .findings import ERROR, WARNING, Finding
from .rules import rule

# the zero-fill chunk-assembly signature: the reference's
# dynamic_update_slice as aten ops (a copy_ counts when it writes into a
# zeros buffer)
ASSEMBLY_FORBIDDEN = ("slice_scatter", "index_put", "index_put_",
                      "_index_put_impl_")
_ZEROS = ("zeros", "zeros_like", "new_zeros")


def _is_convert(node) -> bool:
    """``_to_copy`` with a dtype and nothing else (the reference's
    ``convert_element_type``)."""
    if node.op != "call_function" or op_name(node) != "_to_copy":
        return False
    kw = node.kwargs
    return "dtype" in kw and kw.get("device") is None and \
        kw.get("layout") is None


def _is_transfer(node) -> bool:
    """``_to_copy`` with a device (the reference's ``device_put``) that
    differs from its input's."""
    if node.op != "call_function" or op_name(node) != "_to_copy":
        return False
    dev = node.kwargs.get("device")
    src = node_val(node.args[0]) if node.args else None
    return dev is not None and getattr(src, "device", dev) != dev


def _base(node):
    """The node a chain of views starts from."""
    while node.op == "call_function" and node.args \
            and getattr(node.target, "is_view", False):
        node = node.args[0]
    return node


@rule("no-zero-fill-assembly", "invariants",
      "plans never assemble into a zero-filled buffer — chunked outputs "
      "join with one cat per carrier plane")
def check_no_update_slice(ctx: PlanContext):
    out = []
    for node, _, path in ctx.eqns():
        name = op_name(node)
        into_zeros = (name == "copy_" and node.args
                      and op_name(_base(node.args[0])) in _ZEROS)
        if name in ASSEMBLY_FORBIDDEN or into_zeros:
            out.append(Finding(
                "no-zero-fill-assembly", ERROR,
                f"{name!r} writes into a zero-filled buffer — the zeros + "
                f"update assembly pays a dead zero-fill and serializes the "
                f"chunk writes (use cat)",
                detail=path))
    return out


@rule("no-device-transfer", "invariants",
      "no device transfers inside a plan body")
def check_no_transfer(ctx: PlanContext):
    out = []
    for node, _, path in ctx.eqns():
        if _is_transfer(node):
            out.append(Finding(
                "no-device-transfer", ERROR,
                f"a copy to {node.kwargs.get('device')} inside the plan "
                f"trace — a host/device round trip on the hot path",
                detail=path))
    return out


@rule("convert-round-trip", "invariants",
      "no widening or same-dtype _to_copy round trips (narrowing round "
      "trips are the quantization idiom and exempt)")
def check_convert_round_trips(ctx: PlanContext):
    out = []
    for node, _, path in ctx.eqns():
        if not _is_convert(node) or not node.args:
            continue
        producer = node.args[0]
        if not _is_convert(producer) or not producer.args:
            continue
        a = node_val(producer.args[0]).dtype
        b = node_val(producer).dtype
        c = node_val(node).dtype
        la, lb = float_level(a), float_level(b)
        if a == c and la is not None and lb is not None and lb < la:
            continue        # narrowing round trip: a declared quantization
        if a == c and b != a:
            out.append(Finding(
                "convert-round-trip", WARNING,
                f"convert round trip {a} -> {b} -> {c} with no consumer "
                f"between — two casts of pure memory traffic",
                detail=path))
        elif b == a:
            out.append(Finding(
                "convert-round-trip", WARNING,
                f"no-op convert chain at {a}", detail=path))
    return out


@rule("collective-stage-valid", "invariants",
      "collective stages name non-duplicate axes with positive static "
      "groups; comm levels only appear where they apply")
def check_collective_stages(ctx: PlanContext):
    out = []
    for idx, s in ctx.stages("psum", "gemv_psum"):
        axes = s.axes
        if not axes:
            out.append(Finding(
                "collective-stage-valid", ERROR,
                f"{s.kind} stage has no mesh axis to reduce over",
                stage=idx))
            continue
        if len(set(axes)) != len(axes):
            out.append(Finding(
                "collective-stage-valid", ERROR,
                f"duplicate mesh axes in collective axis tuple {axes}",
                stage=idx))
        if s.groups is not None and any(g < 1 for g in s.groups):
            out.append(Finding(
                "collective-stage-valid", ERROR,
                f"non-positive static group size in {s.groups}",
                stage=idx))
        if s.collective in ("reduce_scatter", "ring") and s.groups is None:
            out.append(Finding(
                "collective-stage-valid", WARNING,
                f"{s.collective!r} requested without static groups — "
                f"the lowering cannot build its schedule and will fall "
                f"back to the flat all-reduce",
                stage=idx))
    for idx, s in ctx.stages(*DATA_KINDS):
        if s.comm is not None:
            out.append(Finding(
                "collective-stage-valid", WARNING,
                f"comm level set on a {s.kind!r} stage — only the "
                f"gemv_psum super-stage consumes it",
                stage=idx))
    return out


@rule("collective-fallback", "invariants",
      "a requested reduce_scatter/ring decomposition that lowers to the "
      "flat all-reduce is surfaced, not silent")
def check_collective_fallback(ctx: PlanContext):
    # the executor's own fallback counters, recorded while the trace ran
    # the stage loop, are the ground truth (pipeline._psum_start)
    wanted = {s.collective for _, s in ctx.stages("psum")
              if s.collective in ("reduce_scatter", "ring")}
    if not wanted:
        return []
    counters = ctx.trace_counters
    out = []
    for kind in sorted(wanted):
        n = counters.get(f"collective:{kind}:fallback", 0)
        if n:
            out.append(Finding(
                "collective-fallback", WARNING,
                f"plan requests collective={kind!r} but {n} stage "
                f"lowering(s) fell back to the flat all-reduce (a "
                f"mis-sized carrier or missing static groups) — see the "
                f"'collective:{kind}:fallback' counter"))
    return out


def _ring_findings(perm: Sequence[Tuple[int, int]], g: int,
                   where: str) -> list:
    """Validate a permutation as one Hamiltonian ring over g ranks: every
    rank once a source and once a destination, and the edges from rank 0
    visiting all g ranks."""
    srcs = [src for src, _ in perm]
    dsts = [dst for _, dst in perm]
    if sorted(srcs) != list(range(g)) or sorted(dsts) != list(range(g)):
        return [Finding(
            "ring-permutation", ERROR,
            f"permutation does not cover every rank of the {g}-group "
            f"exactly once as source and destination — partials are "
            f"dropped or double-counted",
            detail=f"{where}: perm={list(perm)}")]
    step = dict(perm)
    seen, r = set(), 0
    while r not in seen:
        seen.add(r)
        r = step[r]
    if len(seen) != g:
        return [Finding(
            "ring-permutation", ERROR,
            f"permutation splits the {g}-group into disjoint cycles "
            f"(visited {len(seen)} of {g} ranks from rank 0) — the ring "
            f"reduction never sees the missing ranks' partials",
            detail=f"{where}: perm={list(perm)}")]
    return []


@rule("ring-permutation", "invariants",
      "the send/receive hops of a ring form one Hamiltonian cycle over the "
      "minor-axis group, each receive matching a send")
def check_ring_permutation(ctx: PlanContext):
    # the peers of the traced c10d send / recv_ nodes, hop by hop: on the
    # fake grid every rank of the group (the whole permutation, as the
    # reference's traced ppermute eqns carry it); over an operator's own
    # groups this rank alone, held to the step the canonical-order sum
    # assumes (send to me + 1, receive from me - 1)
    out = []
    for idx, s in ctx.stages("psum"):
        if s.collective != "ring" or not s.groups:
            continue
        g = s.groups[-1]
        hops = ctx.ring_hops(s)
        found = []
        for k in range(max((len(h) for h in hops.values()), default=0)):
            sends = [(me, h[k][0]) for me, h in sorted(hops.items())]
            recvs = [(h[k][1], me) for me, h in sorted(hops.items())]
            where = f"hop {k}: sends={sends} receives={recvs}"
            if len(hops) < g:
                if any((dst, src) != ((me + 1) % g, (me - 1) % g)
                       for (me, dst), (src, _) in zip(sends, recvs)):
                    found.append(Finding(
                        "ring-permutation", ERROR,
                        f"a rank hops off the ring's step over its "
                        f"{g}-group (send to rank + 1, receive from rank "
                        f"- 1) — the canonical-order sum adds the wrong "
                        f"partials", detail=where))
            else:
                found += _ring_findings(sends, g, f"hop {k}")
                if sorted(recvs) != sorted(sends):
                    found.append(Finding(
                        "ring-permutation", ERROR,
                        f"a rank receives from a rank that does not send "
                        f"to it — the hop waits forever", detail=where))
            if found:       # the first hop that goes wrong
                break
        out += [Finding(f.rule, f.severity, f.message, stage=idx,
                        detail=f.detail) for f in found]
    return out


@rule("comm-restores-carrier", "invariants",
      "every collective stage restores the carrier dtype after a "
      "reduced-precision reduction")
def check_comm_restore(ctx: PlanContext):
    out = []
    prev_level = ctx.highest_level
    for idx, s in ctx.expanded:
        if s.kind in DATA_KINDS:
            prev_level = s.level
            continue
        if s.kind != "psum":
            continue
        want = prec.real_dtype(prev_level)
        for got in ctx.trace_stage_group((s,), prev_level):
            if got.dtype != want:
                out.append(Finding(
                    "comm-restores-carrier", ERROR,
                    f"collective at comm level {s.level!r} returns the "
                    f"carrier at {str(got.dtype).replace('torch.', '')} "
                    f"instead of restoring "
                    f"{str(want).replace('torch.', '')} — every downstream "
                    f"stage silently runs degraded",
                    stage=idx))
    return out
