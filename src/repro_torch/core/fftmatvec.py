"""FFTMatvec: the paper's 5-phase mixed-precision matvec pipeline (C1+C3).

Phases (paper §2.4), for ``d = F m``:

  1. zero-pad the input block vector + cast       (CUDA kernel pad_cast)
  2. batched FFT  m -> m_hat                      (cuFFT via torch.fft)
  3. block-diagonal matvec in Fourier space       (CUDA kernel sbgemv_*)
  4. batched IFFT d_hat -> d_padded               (cuFFT)
  5. unpad + cast                                 (CUDA kernel unpad_cast)

plus the SOTI<->TOSI reorders between phases 2-3 and 3-4, which are pure
memory ops at the lower of the adjacent phases' precisions (paper
footnote 8).  The adjoint ``m = F* d`` runs the same phases with a
conjugate-transpose SBGEMV.  Blocks of S right-hand sides
(``matmat``/``rmatmat``) run the same plans with an SBGEMM in Phase 3, and
:meth:`FFTMatvec.gram` returns the fused Gram operator
(:mod:`repro_torch.core.gram`).  Every variant compiles to a
:mod:`repro_torch.core.pipeline` plan and runs through its executor.

A config may carry a tile map (``"ddddd;tiles=ds|sh"``): the stored
F_hat stays at the gemv level and Phase 3 rounds each tile through its
cell's level (the tiled kernels).  :meth:`FFTMatvec.autotune` picks the
fastest config within a tolerance (:mod:`repro_torch.tune`).

Distribution (paper §2.4, §3.7): a 2-D ``(row, col)`` process grid, a
``torch.distributed`` ``DeviceMesh``; rows shard N_d, cols shard N_m, and
every rank runs the same plan on its own shard (SPMD).  ``m`` lives
sharded over cols and replicated over rows, ``d`` sharded over rows and
replicated over cols: each rank passes its shard (:meth:`FFTMatvec.
local_block`) and gets its shard back (:meth:`FFTMatvec.gather_block`
assembles the global block).  F reduces its partial products over cols
(Phase 5), F* over rows.  Either side of the grid may be a tuple of mesh
dims (slow -> fast); with more than one row the reductions are
hierarchical (staged per tier, the executed form of the comm-aware
blocking :mod:`repro_torch.core.partition` models), and ``mesh="auto"``
picks the grid with :func:`choose_grid` over the world size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from . import pipeline
from . import precision as prec
from .partition import NetworkModel, choose_grid
from .pipeline import ExecOpts, reorder_planes  # noqa: F401  (public API)
from .precision import PrecisionConfig
from .toeplitz import default_device, fourier_block_column

AxisSpec = Union[str, Tuple[str, ...], None]


def as_tensor(x, device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor on ``device`` (no
    copy when it already is one)."""
    return torch.as_tensor(x, device=device).contiguous()


def _as_axes(axis: AxisSpec) -> Tuple[str, ...]:
    """An axis spec (a name, a tuple of names, None or ()) as a tuple."""
    if axis is None or axis == ():
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _axis_key(axes: Tuple[str, ...]):
    return axes[0] if len(axes) == 1 else axes


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _flat_group(mesh, axes: Tuple[str, ...]):
    """This rank's group over several mesh dims at once, its ranks in
    row-major order over ``axes``.  ``dist.new_group`` is collective: every
    rank makes every such group, in the same order."""
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(len(names)) if d not in dims]
    table = mesh.mesh.permute(*rest, *dims).reshape(-1, math.prod(
        mesh.shape[d] for d in dims))
    me, mine = dist.get_rank(), None
    for ranks in table.tolist():
        group = dist.new_group(ranks)
        if me in ranks:
            mine = group
    return mine


def axis_groups(mesh, specs) -> dict:
    """This rank's process group for each axis spec in ``specs`` (a mesh
    dim name or a tuple of them), its dims' own groups and the groups of
    a tuple's outer dims (a reduction's outer tiers): what the psum stages
    look up in ``ResolvedOpts.groups``."""
    out = {}
    for spec in specs:
        axes = _as_axes(spec)
        for ax in axes:
            out.setdefault(ax, mesh.get_group(ax))
        for sub in (axes, axes[:-1]):
            if len(sub) > 1 and sub not in out:
                out[sub] = _flat_group(mesh, sub)
    return out


def _auto_mesh(shape, row_axis, col_axis, device):
    """The comm-aware 2-D ``DeviceMesh`` of ``mesh="auto"`` over the
    default process group's ranks: :func:`choose_grid` under the default
    :class:`NetworkModel`.  A caller that wants another grid passes its
    own ``DeviceMesh``."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("mesh='auto' builds its grid over the default "
                           "process group: call dist.init_process_group "
                           "first")
    if not (isinstance(row_axis, str) and isinstance(col_axis, str)):
        raise ValueError("mesh='auto' needs single row/col axis names")
    p = dist.get_world_size()
    N_t, N_d, N_m = shape
    grid = choose_grid(p, N_t, N_d, N_m, net=NetworkModel())
    return init_device_mesh(device.type, tuple(grid),
                            mesh_dim_names=(row_axis, col_axis))


@dataclasses.dataclass
class FFTMatvec:
    """Block-triangular Toeplitz matvec operator.

    Single-device by default; with ``mesh`` (a ``DeviceMesh``, and the
    names of its row and col dims) each rank holds its F_hat shard and
    applies the operator to its shard of the input.  Input/output block
    vectors are SOTI: ``m`` (N_m, N_t), ``d`` (N_d, N_t) (on a mesh, this
    rank's rows of them).  The I/O dtype is the highest level the config
    uses.  ``comm_level`` runs the mesh reductions at another level (one
    rounding a reduction, the carrier's dtype restored), ``collective``
    pins their lowering (:data:`pipeline.COLLECTIVE_KINDS`).
    """

    F_hat_re: torch.Tensor       # (K, N_d, N_m) TOSI at gemv level; a shard
    F_hat_im: torch.Tensor       # (K, N_d/p_r, N_m/p_c) on a mesh
    N_t: int
    precision: PrecisionConfig = PrecisionConfig()
    opts: ExecOpts = ExecOpts()
    mesh: object = None
    row_axis: AxisSpec = "row"
    col_axis: AxisSpec = "col"
    comm_level: Optional[str] = None
    collective: Optional[str] = None
    # this rank's process group of each psum axis (axis_groups)
    groups: Optional[dict] = dataclasses.field(default=None, repr=False,
                                               compare=False)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_block_column(cls, F_col, precision=PrecisionConfig(),
                          opts=ExecOpts(), device=None, backend=None,
                          mesh=None, row_axis="row", col_axis="col",
                          comm_level=None, collective=None) -> "FFTMatvec":
        """Phase-0 setup in f64 (paper §3.2.1), storing F_hat at the gemv
        level.  ``F_col`` is a numpy array or a tensor (N_t, N_d, N_m);
        ``device=None`` means the card.  ``backend`` is folded into
        ``opts`` (a spec or a registered name such as ``"torch-ref"``).

        ``mesh`` is a 2-D ``DeviceMesh`` or ``"auto"`` (:func:`choose_grid`
        over the world size).
        Every rank passes the same global ``F_col`` and runs Phase 0 on its
        own (N_t, N_d/p_r, N_m/p_c) block only; the grid must divide N_d
        and N_m.  ``row_axis``/``col_axis`` may be tuples of mesh dims
        (slow -> fast)."""
        if backend is not None:
            opts = dataclasses.replace(opts, backend=backend)
        device = default_device(device)
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"unknown mesh spec {mesh!r}")
            mesh = _auto_mesh(tuple(F_col.shape), row_axis, col_axis, device)
        op = cls(None, None, F_col.shape[0], precision, opts, mesh,
                 row_axis, col_axis, comm_level, collective)
        if mesh is not None:
            p_r, p_c = op.grid_shape()
            _, N_d, N_m = F_col.shape
            if N_d % p_r or N_m % p_c:
                raise ValueError(f"a {p_r}x{p_c} grid must divide N_d = "
                                 f"{N_d} and N_m = {N_m}")
            r, c = op._grid_coords()
            nd, nm = N_d // p_r, N_m // p_c
            F_col = F_col[:, r * nd:(r + 1) * nd, c * nm:(c + 1) * nm]
            op.groups = axis_groups(mesh, (row_axis, col_axis))
        col = as_tensor(F_col, device)
        op.F_hat_re, op.F_hat_im = fourier_block_column(
            col, dtype=prec.real_dtype(precision.gemv))
        return op

    def with_precision(self, precision: PrecisionConfig) -> "FFTMatvec":
        """Same operator retuned to another per-phase config: the stored
        Fourier blocks are recast to the new gemv level (an upcast cannot
        restore bits lost when the operator was stored low)."""
        dt = prec.real_dtype(precision.gemv)
        return dataclasses.replace(self, precision=precision,
                                   F_hat_re=self.F_hat_re.to(dt),
                                   F_hat_im=self.F_hat_im.to(dt))

    def with_backend(self, backend, dispatch=None) -> "FFTMatvec":
        """Same operator lowered through another backend and, optionally,
        another dispatch table.  Numerics are unchanged to roundoff."""
        opts = dataclasses.replace(self.opts, backend=backend)
        if dispatch is not None:
            opts = dataclasses.replace(opts, dispatch=dispatch)
        return dataclasses.replace(self, opts=opts)

    def with_comm(self, comm_level: Optional[str],
                  collective: Optional[str] = None) -> "FFTMatvec":
        """Same operator with another reduction level (None: the reduce
        level) and, optionally, another collective lowering."""
        return dataclasses.replace(
            self, comm_level=comm_level,
            collective=self.collective if collective is None else collective)

    def with_overlap(self, overlap) -> "FFTMatvec":
        """Same operator with another pipelined-collective preference
        (``ExecOpts.overlap``: "auto", a chunk count, or None for the
        serial schedule).  It changes a plan's timing, never its math."""
        return dataclasses.replace(
            self, opts=dataclasses.replace(self.opts, overlap=overlap))

    def autotune(self, tol: float, *, full_result: bool = False, **kw):
        """Dynamic mixed-precision selection (paper §3.2 at run time): the
        operator retuned to the fastest per-phase config whose measured
        error stays within ``tol``, the lattice pruned by the calibrated
        eq.-(6) model so only a small frontier is timed.
        ``full_result=True`` returns the :class:`repro_torch.tune.
        TuneResult` instead.  Keywords go to :func:`repro_torch.tune.
        autotune` (``ladder``, ``variant``, ``tiles``, ``cache``, ...)."""
        from repro_torch.tune import autotune as _autotune  # tune builds on core
        res = _autotune(self, tol=tol, **kw)
        return res if full_result else res.op

    def gram(self, space: str = "parameter", mode: str = "exact"):
        """The fused Fourier-domain Gram operator
        (:class:`repro_torch.core.gram.GramOperator`): ``space="parameter"``
        is F*F, ``space="data"`` is F F*; ``mode="exact"`` matches the
        composed ``rmatvec(matvec(v))`` to roundoff, ``mode="circulant"``
        applies precomputed per-bin blocks G_hat[k] in one 5-phase pass
        (periodic-Gram semantics, one device only)."""
        from .gram import GramOperator  # deferred: gram builds on this class
        return GramOperator.from_matvec(self, space=space, mode=mode)

    # -- shapes --------------------------------------------------------------
    @property
    def N_d(self) -> int:
        """The global N_d (the local rows times p_r on a mesh)."""
        return self.F_hat_re.shape[1] * self.grid_shape()[0]

    @property
    def N_m(self) -> int:
        """The global N_m (the local columns times p_c on a mesh)."""
        return self.F_hat_re.shape[2] * self.grid_shape()[1]

    @property
    def device(self) -> torch.device:
        return self.F_hat_re.device

    @property
    def io_dtype(self) -> torch.dtype:
        return prec.real_dtype(self.precision.highest())

    # -- the grid --------------------------------------------------------------
    def grid_shape(self) -> Tuple[int, int]:
        """(p_r, p_c) of the process grid, (1, 1) on one device.  A row or
        col axis the mesh lacks is a construction error, raised here."""
        if self.mesh is None:
            return (1, 1)
        sizes = _mesh_sizes(self.mesh)
        for a in (*_as_axes(self.row_axis), *_as_axes(self.col_axis)):
            if a not in sizes:
                raise ValueError(f"grid axis {a!r} is not a mesh dim (mesh "
                                 f"has {tuple(sizes)})")
        p_r = math.prod(sizes[a] for a in _as_axes(self.row_axis))
        p_c = math.prod(sizes[a] for a in _as_axes(self.col_axis))
        return (max(p_r, 1), max(p_c, 1))

    def _axis_index(self, axis: AxisSpec) -> int:
        """This rank's index along the row or col group (row-major over a
        tuple of dims)."""
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        sizes = _mesh_sizes(self.mesh)
        idx = 0
        for a in _as_axes(axis):
            idx = idx * sizes[a] + coord[a]
        return idx

    def _grid_coords(self) -> Tuple[int, int]:
        return self._axis_index(self.row_axis), self._axis_index(self.col_axis)

    def _space_axis(self, space: str) -> AxisSpec:
        if space not in ("m", "d"):
            raise ValueError(f"space must be 'm' or 'd', got {space!r}")
        return self.col_axis if space == "m" else self.row_axis

    def local_block(self, x, space: str) -> torch.Tensor:
        """This rank's shard of a global block on the operator's device:
        ``space="m"`` an (N_m, N_t[, S]) block, sharded over the cols;
        ``"d"`` an (N_d, N_t[, S]) block, sharded over the rows.  Off a
        mesh, the whole block."""
        if self.mesh is None:
            return as_tensor(x, self.device)
        axis = self._space_axis(space)
        n = (self.N_m // self.grid_shape()[1] if space == "m"
             else self.N_d // self.grid_shape()[0])
        i = self._axis_index(axis)
        return as_tensor(x[i * n:(i + 1) * n], self.device)

    def gather_block(self, y: torch.Tensor, space: str) -> torch.Tensor:
        """The global block assembled from every rank's ``space`` shard
        (``local_block``'s inverse; every rank of the group calls it)."""
        if self.mesh is None:
            return y
        axes = _as_axes(self._space_axis(space))
        if not axes:
            return y
        group = self.groups[_axis_key(axes)]
        g = dist.get_world_size(group)
        y = y.contiguous()
        out = y.new_empty((g * y.shape[0],) + tuple(y.shape[1:]))
        return pipeline._start_collective("all_gather", out, y, group)()

    # -- plan ------------------------------------------------------------------
    def _collective_kind(self, psum_axes: Tuple[str, ...],
                         adjoint: bool = False) -> str:
        """The emitted lowering: the override, else for F hierarchical
        when the grid has more than one row or the group spans several
        mesh dims; for F*, whose reduction runs over the rows, only when
        the row group spans several dims (a single row dim has no inner
        tier to stage through)."""
        if self.collective is not None:
            return self.collective
        if adjoint:
            return "hierarchical" if len(psum_axes) > 1 else "psum"
        p_r, _ = self.grid_shape()
        return "hierarchical" if (p_r > 1 or len(psum_axes) > 1) else "psum"

    def _psum_args(self, adjoint: bool) -> dict:
        """The psum parameters of one matvec plan on this mesh."""
        psum_axes = _as_axes(self.row_axis if adjoint else self.col_axis)
        if not psum_axes:
            return {"psum_axis": None}
        sizes = _mesh_sizes(self.mesh)
        return {"psum_axis": _axis_key(psum_axes),
                "psum_groups": tuple(sizes[a] for a in psum_axes),
                "collective": self._collective_kind(psum_axes, adjoint),
                "comm_level": self.comm_level}

    def plan(self, *, adjoint: bool = False) -> pipeline.Plan:
        """The plan :meth:`matvec` / :meth:`rmatvec` run: on a mesh the
        same pipeline ending in its reduction (axes, group sizes, lowering
        and comm level bound)."""
        if self.mesh is None:
            return pipeline.matvec_plan(self.precision, adjoint=adjoint)
        return pipeline.matvec_plan(self.precision, adjoint=adjoint,
                                    **self._psum_args(adjoint))

    def resolved_opts(self) -> pipeline.ResolvedOpts:
        """``opts`` bound to this operator's device, with its process
        groups."""
        return dataclasses.replace(self.opts.resolve(self.device),
                                   groups=self.groups)

    def _local_input(self, x, rows: int, what: str) -> torch.Tensor:
        x = as_tensor(x, self.device)
        if self.mesh is not None and x.shape[0] != rows:
            raise ValueError(f"{what} on a mesh takes this rank's shard of "
                             f"{rows} rows (local_block), got {x.shape[0]}")
        return x

    def _apply(self, x, *, adjoint: bool):
        rows = self.F_hat_re.shape[1 if adjoint else 2]
        x = self._local_input(x, rows, "rmatvec" if adjoint else "matvec")
        y = pipeline.run_plan(self.plan(adjoint=adjoint), x,
                              {"F": (self.F_hat_re, self.F_hat_im)},
                              N_t=self.N_t, opts=self.resolved_opts())
        return y.to(self.io_dtype)

    # -- public API ------------------------------------------------------------
    def matvec(self, m):
        """d = F m.   m: (N_m, N_t) SOTI -> d: (N_d, N_t) SOTI."""
        return self._apply(m, adjoint=False)

    def rmatvec(self, d):
        """m = F* d.  d: (N_d, N_t) SOTI -> m: (N_m, N_t) SOTI."""
        return self._apply(d, adjoint=True)

    def matmat(self, M):
        """D = F M over S stacked right-hand sides: M (N_m, N_t, S) ->
        D (N_d, N_t, S), RHS axis minor.  A 2-D input is promoted to S = 1
        and squeezed back, so ``matvec`` is its S = 1 case."""
        if M.ndim == 2:
            return self.matmat(M[..., None])[..., 0]
        return self._apply(M, adjoint=False)

    def rmatmat(self, D):
        """M = F* D over S stacked right-hand sides: D (N_d, N_t, S) ->
        M (N_m, N_t, S)."""
        if D.ndim == 2:
            return self.rmatmat(D[..., None])[..., 0]
        return self._apply(D, adjoint=True)


# ---------------------------------------------------------------------------
# Per-phase callables for the runtime breakdown (paper Fig. 2)
# ---------------------------------------------------------------------------

def phase_callables(op: FFTMatvec, adjoint: bool = False):
    """Per-phase functions keyed by the paper's phase names, each consuming
    the previous phase's output.  The reorders time with the gemv they
    wrap, matching the paper's breakdown."""
    plan = op.plan(adjoint=adjoint)
    operands = {"F": (op.F_hat_re, op.F_hat_im)}
    opts = op.opts.resolve(op.device)
    group_of = {"pad": "pad", "fft": "fft", "reorder": "gemv",
                "gemv": "gemv", "ifft": "ifft", "unpad": "reduce"}
    groups = {name: tuple(s for s in plan if group_of[s.kind] == name)
              for name in ("pad", "fft", "gemv", "ifft", "reduce")}

    def make(stages, final: bool):
        def f(x):
            y = pipeline.run_stages(stages, x, operands, N_t=op.N_t,
                                    opts=opts)
            return y.to(op.io_dtype) if final else y
        return f

    return {name: make(stages, final=(name == "reduce"))
            for name, stages in groups.items()}
