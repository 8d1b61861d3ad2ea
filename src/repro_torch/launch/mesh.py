"""Process meshes over ``torch.distributed`` for the operator path.

Functions, not module constants: importing this module touches no process
group.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh``; the
functions that only read one use its ``shape`` and ``mesh_dim_names``.
The LM's production meshes (pod/data/model) wait for ROADMAP.md item 13b.
"""

from __future__ import annotations

import math


def make_production_mesh(*, multi_pod: bool = False):
    """The LM's 16x16 (or 2x16x16 multi-pod) mesh: not ported."""
    raise NotImplementedError("the LM's production meshes wait for ROADMAP.md "
                              "item 13b (the LM's sharding)")


def mesh_shape_dict(mesh) -> dict:
    """``{dim name: size}`` of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh):
    """Data-parallel axes: the batch shards over ('pod', 'data') when the
    mesh has a pod dim."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device_type="cpu"):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` over the
    default process group (``init_device_mesh``; every rank calls it)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def fftmatvec_grid(mesh, *, N_t: int = 1000, N_d: int = 100,
                   n_m_per_device: int = 5000, net=None, chunks: int = 1,
                   hide_s=None, spec=None, cache=None):
    """Map a mesh onto FFTMatvec's 2-D (row, col) grid: the cost model
    :func:`repro_torch.core.choose_grid` searches, restricted to the grids
    this mesh can realize.

    A mesh with dims ``(a1, .., ak)`` realizes the grids whose row group is
    a leading run of dims (rows = ``dims[:k]``, cols = the rest; the outer
    dims are the slow tiers).  The split minimizing
    :func:`repro_torch.core.matvec_comm_time` under ``net`` (default
    :data:`repro_torch.core.TPU_POD_NETWORK`, the JAX package's default,
    so both pick the same grids) wins.  The shape defaults are the
    weak-scaled paper workload (N_m = 5000 a device).  ``chunks`` prices
    the pipelined-collective schedule and ``hide_s`` (seconds of local
    compute a super-stage) bounds the hiding per chunk.  With ``cache`` (a
    :class:`repro_torch.tune.TuningCache`) the model's overlap efficiency
    is the one ``calibrate_overlap`` persisted for ``spec`` (default: the
    backend probed for the mesh's device type).  Returns ``(row_dims,
    col_dims)`` name tuples (the row tuple may be empty)."""
    from repro_torch.core import TPU_POD_NETWORK, matvec_comm_time
    net = net or TPU_POD_NETWORK
    if cache is not None:
        from repro_torch.backend import calibrated_network, resolve_backend
        spec = spec or resolve_backend(None, mesh.device_type)
        net = calibrated_network(spec, cache, base=net)
    sizes = tuple(mesh.shape)
    axes = tuple(mesh.mesh_dim_names)
    p = math.prod(sizes)
    if p <= net.flat_grid_max:          # choose_grid's flat regime
        return (), axes
    N_m = n_m_per_device * p
    best, best_t = 0, float("inf")
    for k in range(len(axes)):          # rows = axes[:k], cols = axes[k:]
        p_r = math.prod(sizes[:k]) if k else 1
        if p_r > min(p, N_d):           # a row without sensors does no work
            break
        t = matvec_comm_time(p_r, p // p_r, N_t, N_d, N_m, net=net,
                             chunks=chunks, hide_s=hide_s)
        if t < best_t - 1e-15:
            best, best_t = k, t
    return axes[:best], axes[best:]
