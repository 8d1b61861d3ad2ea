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

Twin of ``src/repro/analysis/invariants.py``.  Its four mesh rules
(``collective-stage-valid``, ``collective-fallback``,
``ring-permutation``, ``comm-restores-carrier``) judge the collective
stages of mesh plans: they wait for item 13b.
"""

from __future__ import annotations

from .context import PlanContext, float_level, node_val, op_name
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
