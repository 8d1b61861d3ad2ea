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
natively, so nothing here needs that switch.

Mesh plans (``psum`` and ``gemv_psum`` stages) trace SPMD, as one rank
of the grid: over the process groups of an operator's mesh
(``lint_operator``: under fake tensors the ``c10d`` ops trace as nodes
and communicate nothing), or, in a process with no process group, over
groups of torch's fake process group (``fake_pg``, world = the grid's
size), made for the lint and torn down after it (:meth:`PlanContext.
grid`).  The reference binds each mesh axis with ``vmap`` instead.

Derived shape conventions:

* input rows follow the first contraction stage: ``N_m`` for a forward
  gemv, ``N_d`` for an adjoint one (``rows`` overrides, e.g. for the
  square circulant-Gram "G" operand);
* collective group sizes shard the dimension their gemv contracts over
  (a forward gemv's completing collective spans the col tiers, an
  adjoint one's the row tiers), so local operand planes are
  ``(K, N_d / p_r, N_m / p_c)``, as each rank holds them.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.backend import resolve_backend
from repro_torch.core import pipeline
from repro_torch.core import precision as prec
from repro_torch.core.fftmatvec import axis_groups
from repro_torch.core.pipeline import ExecOpts, Plan, Stage

# Stage kinds whose ``level`` is a *data* (compute/storage) precision.
DATA_KINDS = ("pad", "fft", "reorder", "gemv", "ifft", "mask", "unpad")


def expand(plan: Plan) -> Tuple[Tuple[Optional[int], Stage], ...]:
    """Flatten ``gemv_psum`` super-stages into their constituent (gemv,
    *body, psum) sequence, each constituent tagged with the index of the
    plan stage it came from."""
    out = []
    for i, stage in enumerate(plan):
        if stage.kind == "gemv_psum":
            out.append((i, stage.gemv_stage()))
            out.extend((i, b) for b in stage.body)
            out.append((i, stage.psum_stage()))
        else:
            out.append((i, stage))
    return tuple(out)


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
    # the process group of each psum axis spec (``ResolvedOpts.groups``):
    # an operator's own; None builds fake ones for the trace (grid())
    groups: Optional[Mapping] = None
    # the global rank the fake grid is up as, while it is
    fake_rank: Optional[int] = dataclasses.field(default=None, init=False,
                                                 repr=False)

    @classmethod
    def from_plan(cls, plan: Plan, opts: Optional[ExecOpts] = None, *,
                  N_t: int, N_d: int, N_m: int, S: int = 1,
                  rows: Optional[int] = None, device=None,
                  groups: Optional[Mapping] = None) -> "PlanContext":
        return cls(tuple(plan), opts if opts is not None else ExecOpts(),
                   N_t, N_d, N_m, S, rows, device, groups)

    # -- static structure ---------------------------------------------------
    @functools.cached_property
    def expanded(self):
        return expand(self.plan)

    def stages(self, *kinds) -> Tuple[Tuple[Optional[int], Stage], ...]:
        return tuple((i, s) for i, s in self.expanded
                     if not kinds or s.kind in kinds)

    @functools.cached_property
    def axis_sizes(self) -> Dict[str, int]:
        """Mesh axis name -> static group size, from the collective
        stages' ``groups``.  An axis named without a static group size
        binds at size 1 (the collective still traces; group-dependent
        lowerings surface their fallback, see the invariants pass)."""
        sizes: Dict[str, int] = {}
        for _, s in self.expanded:
            groups = s.groups or (1,) * len(s.axes)
            for ax, g in zip(s.axes, groups):
                sizes[ax] = max(sizes.get(ax, 1), g)
        return sizes

    @functools.cached_property
    def bound_axes(self) -> Tuple[str, ...]:
        """All collective axis names in first-appearance order: the dims
        of the grid the trace runs on."""
        seen = []
        for _, s in self.expanded:
            for ax in s.axes:
                if ax not in seen:
                    seen.append(ax)
        return tuple(seen)

    @functools.cached_property
    def _contraction_shards(self) -> Tuple[int, int]:
        """(row_shard, col_shard): how many ways N_d / N_m are split
        locally, from each collective's completing gemv direction."""
        row_p = col_p = 1
        last_adjoint = False
        for _, s in self.expanded:
            if s.kind == "gemv":
                last_adjoint = s.adjoint
            elif s.kind == "psum" and s.groups:
                g = math.prod(s.groups)
                if last_adjoint:
                    row_p = max(row_p, g)
                else:
                    col_p = max(col_p, g)
        return row_p, col_p

    @property
    def N_d_local(self) -> int:
        return self.N_d // self._contraction_shards[0]

    @property
    def N_m_local(self) -> int:
        return self.N_m // self._contraction_shards[1]

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
                    return self.N_m_local
                return self.N_d_local if s.adjoint else self.N_m_local
        return self.N_m_local

    @functools.cached_property
    def highest_level(self) -> str:
        return prec.max_level([s.level for _, s in self.expanded])

    @functools.cached_property
    def declared_output_level(self) -> str:
        """The level of the last *data* stage: what the plan promises its
        output carrier runs at (a psum stage restores the carrier, so a
        trailing reduction inherits its predecessor's level)."""
        for _, s in reversed(self.expanded):
            if s.kind in DATA_KINDS:
                return s.level
        return self.highest_level

    @functools.cached_property
    def device(self) -> torch.device:
        return trace_device(self.opts, self.data_device)

    # -- the grid -------------------------------------------------------------
    @contextlib.contextmanager
    def grid(self, rank: int = 0):
        """The process groups the plan's collectives trace over, for the
        duration of the block: ``groups`` when given (or none wanted, a
        plan without collectives); otherwise a fake process group of the
        grid's size (as global rank ``rank``; nothing communicates) with a
        ``DeviceMesh`` over :attr:`bound_axes`, torn down at exit.
        Re-entrant: a block at another rank swaps the fake grid for its
        own and brings the outer one back after it."""
        if not self.bound_axes or self.on_operator_groups \
                or self.fake_rank == rank:
            yield self.groups
            return
        outer = self.fake_rank
        if outer is not None:
            self._fake_down()
        self._fake_up(rank)
        try:
            yield self.groups
        finally:
            self._fake_down()
            if outer is not None:
                self._fake_up(outer)

    @property
    def on_operator_groups(self) -> bool:
        """Whether the trace runs over an operator's own process groups
        (one real rank's view) rather than the fake grid."""
        return self.groups is not None and self.fake_rank is None

    def _fake_up(self, rank: int) -> None:
        if dist.is_initialized():
            raise RuntimeError(
                "this process has a process group: lint a mesh plan over "
                "its operator's groups (lint_operator, or groups=)")
        from torch.distributed.device_mesh import init_device_mesh
        from torch.testing._internal.distributed.fake_pg import FakeStore
        sizes = tuple(self.axis_sizes[a] for a in self.bound_axes)
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=math.prod(sizes))
        self.fake_rank = rank
        try:
            mesh = init_device_mesh("cpu", sizes,
                                    mesh_dim_names=self.bound_axes)
            self.groups = axis_groups(
                mesh, {s.axis for _, s in self.stages("psum")})
        except (RuntimeError, ValueError):
            # a malformed collective stage (collective-stage-valid names
            # it): every trace then fails, a trace-failure each
            self.groups = None

    def _fake_down(self) -> None:
        self.groups = self.fake_rank = None
        dist.destroy_process_group()

    def _resolved(self) -> pipeline.ResolvedOpts:
        """``opts`` bound to the trace's device, with the grid's groups."""
        return dataclasses.replace(self.opts.resolve(self.device),
                                   groups=self.groups)

    # -- the abstract trace --------------------------------------------------
    def _operand_shapes(self):
        K = self.N_t + 1
        out = []
        for tag in self.operand_tags:
            dt = prec.real_dtype(self._gemv_level(tag))
            shape = ((K, self.N_d_local, self.N_m_local) if tag == "F"
                     else (K, self.input_rows, self.input_rows))
            out.append((tag, shape, dt))
        return out

    @functools.cached_property
    def _trace(self):
        """(graph module, stage counters): the plan traced on fake planes
        (never executed), with the executor's stage counters recorded as
        tracing runs the stage loop."""
        plan, N_t, S = self.plan, self.N_t, self.S
        tags = self.operand_tags
        io_dt = prec.real_dtype(self.highest_level)
        xshape = (self.input_rows, N_t) if S == 1 \
            else (self.input_rows, N_t, S)
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty(xshape, dtype=io_dt, device=self.device)
            planes = [torch.empty(shape, dtype=dt, device=self.device)
                      for _, shape, dt in self._operand_shapes()
                      for _ in range(2)]

        with self.grid():
            opts = self._resolved()

            def f(x, *flat):
                operands = {tag: (flat[2 * i], flat[2 * i + 1])
                            for i, tag in enumerate(tags)}
                return pipeline.run_plan(plan, x, operands, N_t=N_t,
                                         opts=opts)

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

    def _stage_graph(self, stages: Tuple[Stage, ...], in_level: str):
        """A stage subsequence traced abstractly on a dummy carrier at
        ``in_level`` (rows x 2 N_t), over the current grid."""
        N_t = self.N_t
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty((max(1, self.input_rows), 2 * N_t),
                            dtype=prec.real_dtype(in_level),
                            device=self.device)
        opts = self._resolved()

        def f(x):
            return pipeline.run_stages(stages, x, {}, N_t=N_t, opts=opts)

        return make_fx(f, tracing_mode="fake")(x)

    def trace_stage_group(self, stages: Tuple[Stage, ...], in_level: str):
        """Trace a stage subsequence abstractly on a dummy carrier at
        ``in_level``: what per-stage contract rules read (e.g. "a psum
        stage restores the carrier dtype").  Returns the traced outputs
        (fake tensors)."""
        with self.grid():
            gm = self._stage_graph(stages, in_level)
        out = next(n for n in gm.graph.nodes if n.op == "output")
        return tuple(node_val(a) for a in
                     torch.utils._pytree.tree_leaves(out.args[0])
                     if hasattr(a, "meta"))

    def ring_hops(self, stage: Stage) -> Dict[int, Tuple[Tuple[int, int],
                                                        ...]]:
        """The hops of the ring psum ``stage`` as the ranks of its minor
        group trace them: ``{group rank: ((send peer, receive peer), one
        pair a hop)}``, read off the ``c10d.send`` and ``c10d.recv_``
        nodes.  A trace is one rank's view, so on the fake grid every rank
        of global rank 0's minor group is traced; over an operator's own
        groups, this rank alone.  Empty where the grid cannot be built."""
        fake = not self.on_operator_groups

        def one(rank):
            with self.grid(rank) as groups:
                if not groups:
                    return None
                group = groups[stage.axes[-1]]
                gm = self._stage_graph((stage,), stage.level)
                me = dist.get_rank(group)
                members = dist.get_process_group_ranks(group)
            peers = collections.defaultdict(list)
            for node, _, _ in iter_eqns(gm):
                name = op_name(node)
                if name in ("c10d.send", "c10d.recv_"):
                    peers[name].append(node.args[2])
            return me, members, tuple(zip(peers["c10d.send"],
                                          peers["c10d.recv_"]))

        first = one(0)
        if first is None:
            return {}
        me, members, hops = first
        out = {me: hops}
        for rank in (r for r in members if fake and r != 0):
            me, _, hops = one(rank)
            out[me] = hops
        return out


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
