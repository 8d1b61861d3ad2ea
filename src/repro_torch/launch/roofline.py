"""Roofline terms of a step on one H100, and the op counter that feeds them.

Three terms per (arch x shape x mesh) cell, in seconds per step on the
target card (``backend.H100``: the NVIDIA H100 SXM data sheet's dense
peaks):

    compute    = sum over dtypes of FLOPs[dtype] / peak[dtype]
                 (bf16 989 TFLOP/s, f32 67, f64 67)
    memory     = bytes / HBM rate                       (3.35 TB/s)
    collective = collective bytes / link rate           (NVLink)

Twin of ``src/repro/launch/roofline.py``.  The reference reads its counts
from XLA: ``compiled.cost_analysis()`` and the optimized HLO text
(``parse_collectives``, ``hbm_floor_bytes``).  Eager PyTorch compiles
nothing, so its twin is :class:`OpCounter`, a ``TorchDispatchMode`` that
records every aten op a step runs (under ``FakeTensorMode`` nothing is
allocated):

* FLOPs by dtype, with the formulas of ``torch.utils.flop_counter`` (the
  products), plus the cuFFT transforms (:func:`fft_flops`: 5 n log2 n
  for a complex transform of length n, half that for a real one) and the
  hand-written kernels (each reports its own count, see
  ``kernels._build.kernel_op``);
* raw bytes: every op's inputs plus its outputs (views and allocations
  move nothing);
* floor bytes: only the ops that must materialize on any backend
  (``_MATERIALIZE_OPS``, the reference's set mapped onto aten: the
  products, the FFTs, gathers, scatters and index ops, the reductions,
  ``cat`` and ``constant_pad_nd``, and every kernel), plus the step's
  argument reads and output writes that no such op already counted
  (:meth:`OpCounter.count_io`);
* collectives: ``c10d`` ops, each op's operand bytes, as the
  reference's ``parse_collectives`` counts them: what the op reads and
  sends, never the buffer it receives into (a ring hop's ``recv_``, the
  output of a reduce-scatter or an all-gather).  A meshed plan's
  reductions; none on one card.  Gloo's staging of a card tensor through
  host memory runs as ``_to_copy`` and ``copy_``, raw bytes only, never
  floor bytes (:func:`plan_collective_bytes` gives a meshed matvec's
  count).

A kernel counts each input byte read once and each output byte written
once, and a complex GEMV or GEMM 8 FLOPs per complex multiply-add.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.backend import H100, BackendSpec
from repro_torch.kernels import _build

# The target card's peaks (``backend.H100``).
TARGET_SPEC = H100
PEAK_FLOPS = TARGET_SPEC.peak()           # bf16, the native matmul rate
HBM_BW = TARGET_SPEC.hbm_bandwidth        # B/s
LINK_BW = TARGET_SPEC.link_bandwidth      # B/s per NVLink direction


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_type: dict
    total_bytes: int

    def to_dict(self):
        return {"counts": self.counts, "bytes_by_type": self.bytes_by_type,
                "total_bytes": self.total_bytes}


# ---------------------------------------------------------------------------
# The op counter
# ---------------------------------------------------------------------------

def _names(*names):
    return frozenset(names)


# The reference's _MATERIALIZE_OPS (dot, fft, convolution, scatter,
# gather, dynamic-slice, dynamic-update-slice, reduce, sort, pad,
# concatenate, iota, the collectives) as aten overload packets.
_MATERIALIZE_OPS = _names(
    # products
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
    "_scaled_mm", "convolution", "_convolution", "convolution_backward",
    # transforms
    "_fft_r2c", "_fft_c2r", "_fft_c2c",
    # gathers, scatters, index ops, sorts
    "gather", "scatter", "scatter_add", "scatter_reduce", "index",
    "_unsafe_index", "index_put", "index_put_", "_index_put_impl_",
    "_unsafe_index_put", "index_select", "index_add", "index_add_",
    "index_copy", "index_copy_", "embedding", "embedding_dense_backward",
    "take", "slice_scatter", "select_scatter", "sort", "topk", "argsort",
    # reductions
    "sum", "mean", "prod", "amax", "amin", "max", "min", "argmax", "argmin",
    "logsumexp", "var", "var_mean", "std", "norm", "linalg_vector_norm",
    "cumsum", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "any", "all",
    # joins, pads, iota
    "cat", "constant_pad_nd", "arange")

# ops that move nothing: allocations and aliases (views are found from
# their schemas, ``OpOverload.is_view``)
_NO_TRAFFIC = _names(
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_unsafe_view", "lift_fresh", "lift_fresh_copy",
    "set_", "resize_", "_local_scalar_dense", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "device", "is_same_size")

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
# c10d ops whose first argument is the buffer they write: their operand
# is the second; ops that send nothing add no operand bytes, and a wait
# is no collective
_OUTPUT_FIRST = _names(
    "_allgather_base_", "allgather_", "allgather_coalesced_",
    "allgather_into_tensor_coalesced_", "_reduce_scatter_base_",
    "reduce_scatter_", "reduce_scatter_tensor_coalesced_", "alltoall_base_",
    "alltoall_", "gather_", "scatter_")
_NO_OPERAND = _names("recv_", "recv_any_source_", "barrier",
                     "monitored_barrier_")


def fft_flops(func_name: str, args, out) -> int:
    """FLOPs of a cuFFT transform: 5 n log2 n per complex transform of
    length n (the radix-2 count), half that for a real one (r2c, c2r).
    ``n`` is the product of the transformed lengths."""
    x, dims = args[0], args[1]
    if func_name == "_fft_c2r":
        n_last = args[3]
        lengths = [x.shape[d] for d in dims[:-1]] + [n_last]
        batch = out.numel() // math.prod(lengths)
        scale = 2.5
    else:
        lengths = [x.shape[d] for d in dims]
        batch = x.numel() // math.prod(lengths)
        scale = 2.5 if func_name == "_fft_r2c" else 5.0
    n = math.prod(lengths)
    return int(round(scale * batch * n * math.log2(n))) if n > 1 else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))



def _collective_operand_bytes(name: str, args) -> int:
    """The bytes a collective op reads and sends (its operand), not the
    buffer it receives into."""
    if name in _NO_OPERAND:
        return 0
    return _nbytes(args[1] if name in _OUTPUT_FIRST else args[0])


def _dtype_key(tensors) -> str:
    """The operand dtype an op's FLOPs run at: its first float input's
    (a complex one at its real part's)."""
    dt = next((t.dtype for t in tensors if t.is_floating_point()
               or t.is_complex()), None)
    if dt is None:
        return "other"
    if dt.is_complex:
        dt = dt.to_real()
    return str(dt).replace("torch.", "")


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs (by operand dtype), the raw and floor bytes and the
    collectives of every op run inside it (see the module docstring).
    ``by_op`` keeps, per aten op or kernel, its calls, FLOPs and bytes.

    Hand-written kernels report to the counter where they launch (or
    where their fake implementation stands in for a launch), through
    ``kernels._build.active_counters``; the counter does not look inside
    them."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: collections.Counter = collections.Counter()
        self.raw_bytes = 0
        self.floor_bytes = 0
        self.n_ops = 0
        self.by_op: dict = {}
        self.coll_counts: collections.Counter = collections.Counter()
        self.coll_bytes: collections.Counter = collections.Counter()
        # storages a floor op read or wrote, while they live (a weak
        # reference drops each when it is freed, so a new storage at the
        # same address is not mistaken for it)
        self._touched: dict = {}

    # -- results ------------------------------------------------------------
    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    @property
    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.coll_counts), dict(self.coll_bytes),
                               int(sum(self.coll_bytes.values())))

    def cost(self) -> dict:
        """The counts as ``roofline_terms`` takes them."""
        return {"flops": float(self.flops),
                "flops_by_dtype": {k: float(v) for k, v
                                   in self.flops_by_dtype.items()},
                "bytes accessed": float(self.raw_bytes)}

    def to_dict(self) -> dict:
        return {"flops": self.flops,
                "flops_by_dtype": dict(self.flops_by_dtype),
                "raw_bytes": self.raw_bytes, "floor_bytes": self.floor_bytes,
                "n_ops": self.n_ops, "collectives": self.collectives.to_dict(),
                "by_op": self.by_op}

    # -- recording ----------------------------------------------------------
    def _add(self, name, flops, dtype, nbytes, floor, tensors=()):
        self.n_ops += 1
        if flops:
            self.flops_by_dtype[dtype] += flops
        self.raw_bytes += nbytes
        row = self.by_op.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        if floor:
            self.floor_bytes += nbytes
            for t in tensors:
                self._touch(t)

    def _touch(self, t: torch.Tensor) -> bool:
        """Mark ``t``'s storage as counted; False if it already was."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._touched:
            return False
        self._touched[key] = weakref.ref(
            st, functools.partial(self._untouch, key))
        return True

    def _untouch(self, key, _ref) -> None:
        self._touched.pop(key, None)

    def add_kernel(self, name: str, flops: int, dtype, tensors,
                   nbytes=None) -> None:
        """A hand-written kernel's launch: ``flops`` at ``dtype``'s rate,
        ``tensors`` (its inputs and outputs) each moved once, or
        ``nbytes`` where the kernel reads only part of them."""
        tensors = list(tensors)
        self._add(name, int(flops), str(dtype).replace("torch.", ""),
                  _nbytes(tensors) if nbytes is None else int(nbytes), True,
                  tensors)

    def count_io(self, *trees) -> int:
        """Add the reads of a step's arguments and the writes of its
        outputs (``trees`` of tensors) that no floor op counted; returns
        the bytes added."""
        added = 0
        for t in _tensors(trees):
            if self._touch(t):
                added += t.numel() * t.element_size()
        self.floor_bytes += added
        return added

    def __enter__(self):
        _build.active_counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.active_counters.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "repro_torch":          # the kernel reports itself
            return out
        name = func.overloadpacket.__name__
        if ns in _COLLECTIVE_NAMESPACES:
            if name != "wait_tensor":
                self.coll_counts[name] += 1
                self.coll_bytes[name] += _collective_operand_bytes(name,
                                                                   args)
            return out
        if ns == "prim" or func.is_view or name in _NO_TRAFFIC:
            return out
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        flops = 0
        from torch.utils.flop_counter import flop_registry
        if func.overloadpacket in flop_registry:
            # mm.dtype / bmm.dtype take their out_dtype third, which the
            # formulas would read as a shape: the two operands make the count
            fargs = args[:2] if name in ("mm", "bmm") else args
            flops = flop_registry[func.overloadpacket](*fargs, **kwargs,
                                                       out_val=out)
        elif name in ("_fft_r2c", "_fft_c2r", "_fft_c2c"):
            flops = fft_flops(name, args, out)
        elif name in ("mv", "dot", "vdot", "addmv"):
            a = args[1] if name == "addmv" else args[0]
            flops = 2 * a.numel()
        self._add(f"aten.{name}", int(flops), _dtype_key(ins),
                  _nbytes(ins) + _nbytes(outs), name in _MATERIALIZE_OPS,
                  ins + outs)
        return out


def plan_collective_bytes(op, *, adjoint: bool = False) -> int:
    """The ``c10d`` operand bytes :class:`OpCounter` counts on one rank for
    one ``matvec`` (``rmatvec`` with ``adjoint``) of the meshed operator
    ``op`` on one right-hand side, as the reference's ``parse_collectives``
    counts them on its lowering.  B is the plan's reduction operand, this
    rank's output rows x N_t at the comm level; each collective the
    lowering launches counts what it sends: hierarchical, B a mesh dim; a
    reduce-scatter B, then the all-gather B/g, and B/g more over an outer
    tier; a ring B a hop, g - 1 hops, and B more over an outer tier; its
    fallback, or a plain psum, B.  Chunking splits B, never adds to it.
    0 off a mesh."""
    from repro_torch.core import precision as prec
    total = 0
    for stage in op.plan(adjoint=adjoint):
        if stage.kind != "gemv_psum":
            continue
        psum = stage.psum_stage()
        rows = op.local_rows("m" if adjoint else "d")
        B = rows * op.N_t * prec.real_dtype(psum.level).itemsize
        g = psum.groups[-1] if psum.groups else None
        outer = len(psum.axes) > 1
        if psum.collective == "hierarchical":
            total += len(psum.axes) * B
        elif psum.collective == "reduce_scatter" and g and rows % g == 0:
            total += B + B // g + (B // g if outer else 0)
        elif psum.collective == "ring" and g:
            total += (g - 1) * B + (B if outer else 0)
        else:
            total += B
    return total


# ---------------------------------------------------------------------------
# Roofline terms (the reference's formulas)
# ---------------------------------------------------------------------------

def roofline_terms(cost: dict, coll: CollectiveStats,
                   bytes_floor: float | None = None,
                   spec: BackendSpec | None = None) -> dict:
    """Three roofline terms against ``spec``'s peaks (default: the H100).
    ``cost`` holds ``flops`` and ``bytes accessed``, and may hold
    ``flops_by_dtype``: then the compute term sums each dtype's FLOPs over
    its own peak (a train step mixes f32 score products with bf16
    products), else all FLOPs run at the native matmul rate.  The memory
    term uses the floor when provided (the raw bytes kept as
    ``memory_raw_s``)."""
    spec = spec or TARGET_SPEC
    flops = float(cost.get("flops", 0.0))
    bytes_raw = float(cost.get("bytes accessed", 0.0))
    bytes_mem = float(bytes_floor) if bytes_floor is not None else bytes_raw
    by_dtype = cost.get("flops_by_dtype")
    if by_dtype:
        t_compute = sum(f / spec.peak(dt) for dt, f in by_dtype.items()
                        if f)
    else:
        t_compute = flops / spec.peak()
    t_memory = bytes_mem / spec.hbm_bandwidth
    t_coll = coll.total_bytes / spec.link_bandwidth
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms.update({
        "dominant": dom.replace("_s", ""),
        "step_time_bound_s": bound,
        "memory_raw_s": bytes_raw / spec.hbm_bandwidth,
        "flops_per_device": flops,
        "bytes_per_device": bytes_mem,
        "bytes_raw_per_device": bytes_raw,
        "collective_bytes_per_device": coll.total_bytes,
    })
    if by_dtype:
        terms["flops_by_dtype"] = dict(by_dtype)
    return terms


def model_flops(n_params: int, n_active_params: int, tokens: int,
                kind: str) -> float:
    """MODEL_FLOPS: 6*N*D for training (fwd+bwd), 2*N*D forward
    (prefill/decode); MoE uses active params."""
    n = n_active_params or n_params
    per_tok = 6 * n if kind == "train" else 2 * n
    return float(per_tok) * tokens


def useful_ratio(mf: float, flops_per_device: float, n_devices: int) -> float:
    hlo_global = flops_per_device * n_devices
    return mf / hlo_global if hlo_global else float("nan")


def roofline_fraction(mf: float, bound_s: float, n_devices: int,
                      spec: BackendSpec | None = None) -> float:
    """Achieved fraction of the compute roofline: useful FLOPs per second
    at the modeled step time vs the native matmul peak."""
    if bound_s <= 0:
        return float("nan")
    return (mf / n_devices / bound_s) / (spec or TARGET_SPEC).peak()
