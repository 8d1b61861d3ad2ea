"""PlanContext: a lowered plan plus everything needed to inspect it.

The context owns the *abstract trace*:
``torch.fx.experimental.proxy_tensor.make_fx(..., tracing_mode="fake")``
over the port's :func:`repro_torch.core.pipeline.run_plan`, on fake
planes at the plan's declared dtypes, runs the whole plan lowering
(backend dispatch, kernel choice) without allocating a buffer or running
an op, so linting the paper-shape plans (N_m = 5000, K = 1001) is as
cheap as linting the smoke shapes.  The trace is an fx graph of aten ops;
each node's dtype comes from its ``meta["val"]``.

The planes live on the device the backend serves: the card's for a CUDA
backend (``h100``: the wrappers take the kernel path, and each kernel is
one node, a ``repro_torch`` custom op with its input and output dtypes),
the CPU's otherwise.  A CPU-only torch cannot fake views of card tensors,
so the card's plans trace only where a card is present
(:func:`traceable`).

Twin of ``src/repro/analysis/context.py``.  The reference traces under
``jax.experimental.enable_x64()`` so that an x64-disabled process cannot
clamp the declared f64 levels before a rule sees them; torch has f64
natively, so nothing here needs that switch.  Linting mesh plans (their
psum and gemv_psum stages) waits for item 13b: the linter takes
single-device plans.

Derived shape conventions: input rows follow the first contraction stage,
``N_m`` for a forward gemv, ``N_d`` for an adjoint one (``rows``
overrides, e.g. for the square circulant-Gram "G" operand).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Iterator, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.backend import resolve_backend
from repro_torch.core import pipeline
from repro_torch.core import precision as prec
from repro_torch.core.pipeline import ExecOpts, Plan, Stage

# Stage kinds whose ``level`` is a *data* (compute/storage) precision.
DATA_KINDS = ("pad", "fft", "reorder", "gemv", "ifft", "mask", "unpad")


def expand(plan: Plan) -> Tuple[Tuple[Optional[int], Stage], ...]:
    """Each stage tagged with its index in the plan (the reference also
    flattens ``gemv_psum`` super-stages here; the port lints no mesh plan
    until item 13b)."""
    return tuple(enumerate(plan))


def op_name(node) -> str:
    """The name rules key on: the aten overload packet ("mm", "_to_copy",
    "cat"), or ``"<namespace>.<op>"`` outside aten (the kernels:
    "repro_torch.sbgemv_n_complex")."""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    if packet is None:
        return getattr(target, "__name__", str(target))
    ns = target.namespace
    name = packet.__name__
    return name if ns == "aten" else f"{ns}.{name}"


def node_val(node):
    """A node's traced value (a fake tensor, a tuple of them, or None)."""
    return node.meta.get("val")


def node_dtypes(node):
    """The dtypes of a node's tensor outputs."""
    val = node_val(node)
    vals = val if isinstance(val, (tuple, list)) else (val,)
    return tuple(v.dtype for v in vals if isinstance(v, torch.Tensor))


def iter_eqns(graph, path: str = "") -> Iterator[tuple]:
    """Yield ``(node, graph, path)`` for every op node of an fx graph (or
    a ``GraphModule``: ``make_fx`` traces are flat); ``path`` is
    ``"<path>/<index>:<op name>"``."""
    g = getattr(graph, "graph", graph)
    for i, node in enumerate(g.nodes):
        if node.op == "call_function":
            yield node, g, f"{path}/{i}:{op_name(node)}"


def _on_card(backend) -> bool:
    spec = backend if hasattr(backend, "platform") else \
        resolve_backend(backend, "cpu")
    return spec.platform == "cuda"


def traceable(backend) -> bool:
    """Whether plans of ``backend`` (a spec or registered name) can be
    traced in this process: a CUDA backend needs a card (a CPU-only torch
    cannot fake views of card tensors)."""
    return not _on_card(backend) or torch.cuda.is_available()


def trace_device(opts: ExecOpts, device=None) -> torch.device:
    """The device a plan's fake planes live on: ``device`` (an operator's)
    when the backend is probed from the data, else the card for a CUDA
    backend and the CPU for the others."""
    if opts.backend is None:
        return torch.device(device or "cpu")
    return torch.device("cuda" if _on_card(opts.backend) else "cpu")


@dataclasses.dataclass
class PlanContext:
    """One plan bound to concrete dims/opts, with a lazily-built trace."""

    plan: Plan
    opts: ExecOpts
    N_t: int
    N_d: int
    N_m: int
    S: int = 1
    rows: Optional[int] = None        # input-rows override (square "G" plans)
    data_device: Optional[torch.device] = None   # where opts probe from

    @classmethod
    def from_plan(cls, plan: Plan, opts: Optional[ExecOpts] = None, *,
                  N_t: int, N_d: int, N_m: int, S: int = 1,
                  rows: Optional[int] = None,
                  device=None) -> "PlanContext":
        return cls(tuple(plan), opts if opts is not None else ExecOpts(),
                   N_t, N_d, N_m, S, rows, device)

    # -- static structure ---------------------------------------------------
    @functools.cached_property
    def expanded(self):
        return expand(self.plan)

    def stages(self, *kinds) -> Tuple[Tuple[Optional[int], Stage], ...]:
        return tuple((i, s) for i, s in self.expanded
                     if not kinds or s.kind in kinds)

    @functools.cached_property
    def operand_tags(self) -> Tuple[str, ...]:
        tags = []
        for _, s in self.expanded:
            if s.kind == "gemv" and s.operand not in tags:
                tags.append(s.operand)
        return tuple(tags)

    def _gemv_level(self, tag: str) -> str:
        for _, s in self.expanded:
            if s.kind == "gemv" and s.operand == tag:
                return s.level
        return self.highest_level

    @functools.cached_property
    def input_rows(self) -> int:
        if self.rows is not None:
            return self.rows
        for _, s in self.expanded:
            if s.kind == "gemv":
                if s.operand != "F":
                    # square precomputed-block operand (circulant Gram)
                    return self.N_m
                return self.N_d if s.adjoint else self.N_m
        return self.N_m

    @functools.cached_property
    def highest_level(self) -> str:
        return prec.max_level([s.level for _, s in self.expanded])

    @functools.cached_property
    def declared_output_level(self) -> str:
        """The level of the last *data* stage: what the plan promises its
        output carrier runs at."""
        for _, s in reversed(self.expanded):
            if s.kind in DATA_KINDS:
                return s.level
        return self.highest_level

    @functools.cached_property
    def device(self) -> torch.device:
        return trace_device(self.opts, self.data_device)

    # -- the abstract trace --------------------------------------------------
    def _operand_shapes(self):
        K = self.N_t + 1
        out = []
        for tag in self.operand_tags:
            dt = prec.real_dtype(self._gemv_level(tag))
            shape = ((K, self.N_d, self.N_m) if tag == "F"
                     else (K, self.input_rows, self.input_rows))
            out.append((tag, shape, dt))
        return out

    @functools.cached_property
    def _trace(self):
        """(graph module, stage counters): the plan traced on fake planes
        (never executed), with the executor's stage counters recorded as
        tracing runs the stage loop."""
        plan, opts, N_t, S = self.plan, self.opts, self.N_t, self.S
        tags = self.operand_tags
        io_dt = prec.real_dtype(self.highest_level)
        xshape = (self.input_rows, N_t) if S == 1 \
            else (self.input_rows, N_t, S)
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty(xshape, dtype=io_dt, device=self.device)
            planes = [torch.empty(shape, dtype=dt, device=self.device)
                      for _, shape, dt in self._operand_shapes()
                      for _ in range(2)]

        def f(x, *flat):
            operands = {tag: (flat[2 * i], flat[2 * i + 1])
                        for i, tag in enumerate(tags)}
            return pipeline.run_plan(plan, x, operands, N_t=N_t, opts=opts)

        with pipeline.record_stages() as counters:
            gm = make_fx(f, tracing_mode="fake")(x, *planes)
        return gm, collections.Counter(counters)

    @property
    def graph(self):
        """The plan's traced graph module (never executed)."""
        return self._trace[0]

    jaxpr = graph       # the reference's name for the trace

    @property
    def trace_counters(self) -> collections.Counter:
        """Stage counters the executor recorded while the trace ran."""
        return self._trace[1]

    @property
    def out_avals(self):
        """The traced outputs (fake tensors: shape and dtype)."""
        out = next(n for n in self.graph.graph.nodes if n.op == "output")
        vals = []
        for a in torch.utils._pytree.tree_leaves(out.args[0]):
            v = node_val(a) if hasattr(a, "meta") else a
            if isinstance(v, torch.Tensor):
                vals.append(v)
        return tuple(vals)

    def eqns(self) -> Iterator[tuple]:
        return iter_eqns(self.graph)


def trace_callable(fn, *args):
    """``make_fx`` convenience for callable-scoped lint rules: ``args`` are
    tensors (real, fake or meta); nothing is executed."""
    return make_fx(fn, tracing_mode="fake")(*args)


def float_level(dtype) -> Optional[int]:
    """Index of a float dtype on the h < s < d ladder (None: not a ladder
    dtype: integers, bools, complex intermediates)."""
    table = {torch.bfloat16: 0, torch.float16: 0, torch.float32: 1,
             torch.float64: 2}
    return table.get(dtype)
