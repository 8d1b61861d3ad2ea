"""The port's grid model, its mesh map and the error model's mesh terms
against the JAX package, in one process.

``core.partition``, ``launch.mesh.fftmatvec_grid`` and eq. (6) are Python
float arithmetic copied from the JAX package, so every figure must be the
same float: the grids at every published device count (8, 512, 1,024,
2,048, 4,096) and over a seeded sweep, the two-tier collective costs with
and without chunking and a compute window, the phase factors and bounds
with ``p_r``/``p_c``/``comm_level``.  The overlap calibration's arithmetic
and persistence run here too; its measurement needs ranks
(``tests/test_torch_mesh.py``).
"""

import dataclasses
import types

import numpy as np
import pytest

from repro.core import error_model as jem
from repro.core import partition as jpart
from repro.core import precision as jprec
from repro.launch import mesh as jmesh
from repro.backend import overlap_efficiency_from_times as jax_eff
from repro_torch.backend import (CPU_TORCH, calibrate_overlap,
                                 calibrated_network, default_overlap_measure,
                                 overlap_efficiency_from_times)
from repro_torch.backend.dispatch import DispatchTable
from repro_torch.core import all_configs, error_model, partition
from repro_torch.launch import mesh as tmesh
from repro_torch.tune import TuningCache

PUBLISHED = (8, 512, 1024, 2048, 4096)
NETS = {"default": {}, "tpu": {"devices_per_tier": 256, "flat_grid_max": 256},
        "slow": {"alpha_inter": 1e-3, "overlap_efficiency": 0.3},
        "no_overlap": {"overlap_efficiency": 0.0},
        "calibrated": {"overlap_efficiency": 0.91,
                       "overlap_calibrated": True}}


def _nets(key):
    kw = NETS[key]
    return partition.NetworkModel(**kw), jpart.NetworkModel(**kw)


def _sweep(seed: int, n: int):
    """Seeded (p, N_t, N_d, N_m, bytes, chunks, hide_s) cases."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        p = int(2 ** rng.integers(0, 14)) * int(rng.choice([1, 3]))
        yield (p, int(rng.integers(2, 2000)), int(rng.integers(1, 300)),
               int(rng.integers(1, 10000)) * p, int(rng.choice([2, 4, 8])),
               int(rng.integers(1, 9)),
               None if rng.random() < 0.5 else float(rng.random() * 1e-3))


def test_network_model_and_constants_are_the_references():
    assert dataclasses.asdict(partition.NetworkModel()) == \
        dataclasses.asdict(jpart.NetworkModel())
    assert dataclasses.asdict(partition.TPU_POD_NETWORK) == \
        dataclasses.asdict(jpart.TPU_POD_NETWORK)


@pytest.mark.parametrize("p", PUBLISHED)
def test_published_grids(p):
    assert partition.paper_grid(p) == jpart.paper_grid(p)
    shape = (1000, 100, 5000 * p)
    assert partition.choose_grid(p, *shape) == jpart.choose_grid(p, *shape) \
        == partition.paper_grid(p)
    for r in (1, 8, 16):
        if p % r == 0:
            got = partition.matvec_comm_time(r, p // r, *shape)
            assert got == jpart.matvec_comm_time(r, p // r, *shape)


@pytest.mark.parametrize("net", sorted(NETS))
def test_grid_choice_and_costs_over_a_seeded_sweep(net):
    tnet, jnet = _nets(net)
    for p, N_t, N_d, N_m, b, K, hide in _sweep(sorted(NETS).index(net), 60):
        kw = dict(bytes_per_elem=b, chunks=K, hide_s=hide)
        assert partition.choose_grid(p, N_t, N_d, N_m, net=tnet, **kw) == \
            jpart.choose_grid(p, N_t, N_d, N_m, net=jnet, **kw)
        for p_r in (1, 2, 8):
            if p % p_r:
                continue
            assert partition.matvec_comm_time(
                p_r, p // p_r, N_t, N_d, N_m, net=tnet, **kw) == \
                jpart.matvec_comm_time(p_r, p // p_r, N_t, N_d, N_m,
                                       net=jnet, **kw)
            assert partition.hierarchical_collective_time(
                p_r, p // p_r, N_d * b, tnet, K, hide) == \
                jpart.hierarchical_collective_time(p_r, p // p_r, N_d * b,
                                                   jnet, K, hide)
            assert partition.choose_chunks(
                p_r, p // p_r, N_t, N_d, N_m, b, tnet, max_chunks=K + 4,
                hide_s=hide) == jpart.choose_chunks(
                p_r, p // p_r, N_t, N_d, N_m, b, jnet, max_chunks=K + 4,
                hide_s=hide)
        for spans in (False, True):
            assert tnet.collective_cost(p, N_d * b, spans, K, hide) == \
                jnet.collective_cost(p, N_d * b, spans, K, hide)


def _mesh(shape, names):
    """What ``fftmatvec_grid`` reads of a mesh, in each package's form."""
    return (types.SimpleNamespace(shape=shape, mesh_dim_names=names),
            types.SimpleNamespace(devices=types.SimpleNamespace(shape=shape),
                                  axis_names=names))


@pytest.mark.parametrize("shape,names", [
    ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
    ((4, 16, 16), ("pod", "data", "model")), ((1, 8), ("row", "col")),
    ((2, 4), ("row", "col")), ((8, 32, 16), ("pod", "data", "model"))])
@pytest.mark.parametrize("kw", [{}, {"chunks": 4}, {"chunks": 4,
                                                    "hide_s": 2e-4},
                                {"net_key": "default"}])
def test_fftmatvec_grid_matches_the_reference(shape, names, kw):
    kw = dict(kw)
    key = kw.pop("net_key", None)
    t, j = _mesh(shape, names)
    if key is not None:
        kw_t, kw_j = dict(kw, net=_nets(key)[0]), dict(kw, net=_nets(key)[1])
    else:
        kw_t = kw_j = kw
    assert tmesh.fftmatvec_grid(t, **kw_t) == jmesh.fftmatvec_grid(j, **kw_j)
    assert tmesh.mesh_shape_dict(t) == dict(zip(names, shape))
    assert tmesh.dp_axes(t) == jmesh.dp_axes(j)


def test_fftmatvec_grid_reads_a_calibrated_cache(tmp_path):
    cache = TuningCache(tmp_path / "tune.json")
    cache.put_overlap(CPU_TORCH, 0.2, chunks=4)
    t, _ = _mesh((4, 16, 16), ("pod", "data", "model"))
    want = tmesh.fftmatvec_grid(
        t, chunks=4, hide_s=1e-4,
        net=dataclasses.replace(partition.TPU_POD_NETWORK,
                                overlap_efficiency=0.2,
                                overlap_calibrated=True))
    assert tmesh.fftmatvec_grid(t, chunks=4, hide_s=1e-4, spec=CPU_TORCH,
                                cache=cache) == want
    with pytest.raises(NotImplementedError, match="item 13c"):
        tmesh.make_production_mesh()


GRIDS = [(1, 1), (1, 8), (4, 1), (2, 4), (16, 256), (8, 128), (3, 5)]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("variant", [None, "rmatvec", "matmat", "gram"])
def test_error_model_mesh_terms_match_the_reference(grid, variant):
    p_r, p_c = grid
    shape = (1000, 100, 5000 * p_c)
    for adjoint in (False, True):
        got = error_model.phase_factors(*shape, p_r, p_c, adjoint=adjoint,
                                        variant=variant)
        want = jem.phase_factors(*shape, p_r, p_c, adjoint=adjoint,
                                 variant=variant)
        assert got == want
    for cfg in all_configs(("h", "s", "d")):
        jcfg = jprec.PrecisionConfig.from_string(cfg.to_string())
        for comm in (None, "d", "s", "h"):
            kw = dict(variant=variant, comm_level=comm)
            assert error_model.relative_error_bound(cfg, *shape, p_r, p_c,
                                                    **kw) == \
                jem.relative_error_bound(jcfg, *shape, p_r, p_c, **kw)
            assert error_model.dominant_phase(cfg, *shape, p_r, p_c, **kw) \
                == jem.dominant_phase(jcfg, *shape, p_r, p_c, **kw)
    lattice = list(all_configs(("d", "s")))
    jlat = [jprec.PrecisionConfig.from_string(c.to_string()) for c in lattice]
    assert error_model.lattice_bounds(lattice, *shape, p_r=p_r, p_c=p_c,
                                      comm_level="s") == \
        jem.lattice_bounds(jlat, *shape, p_r=p_r, p_c=p_c, comm_level="s")


def test_comm_term_grows_with_the_grid_and_prices_the_comm_level():
    cfg = error_model.PrecisionConfig.from_string("ddddd")
    one = error_model.relative_error_bound(cfg, 1000, 100, 5000)
    flat = error_model.relative_error_bound(cfg, 1000, 100, 5000, 1, 4096,
                                            comm_level="h")
    assert error_model.phase_factors(1000, 100, 5000, 1, 4096)["comm"] == 12
    assert flat > one
    assert error_model.dominant_phase(cfg, 1000, 100, 5000, 1, 4096,
                                      comm_level="h") == "comm"


def test_overlap_efficiency_and_its_persistence(tmp_path):
    legs = {"t_serial": 1.0, "t_pipelined": 1.05, "t_collective": 0.2,
            "t_chunk_collective": 0.08}
    for K in (1, 2, 4, 8):
        assert overlap_efficiency_from_times(legs, K) == jax_eff(legs, K)
    for noisy in ({**legs, "t_pipelined": 0.0}, {**legs, "t_pipelined": 9.0}):
        assert overlap_efficiency_from_times(noisy, 4) in (0.0, 1.0)
    cache = TuningCache(tmp_path / "tune.json")
    calls = []

    def measure(chunks):
        calls.append(chunks)
        return legs
    eff = calibrate_overlap(CPU_TORCH, measure=measure, cache=cache)
    assert calls == [4] and eff == overlap_efficiency_from_times(legs, 4)
    entry = cache.get_overlap(CPU_TORCH)
    assert entry["efficiency"] == eff and entry["chunks"] == 4
    assert set(entry["times"]) == set(legs)
    fresh = TuningCache(cache.path)         # reloaded from disk, not measured

    def boom(chunks):
        raise AssertionError("a persisted calibration must not re-measure")
    assert calibrate_overlap(CPU_TORCH, measure=boom, cache=fresh) == eff
    net = calibrated_network(CPU_TORCH, fresh)
    assert net.overlap_calibrated and net.overlap_efficiency == eff
    assert calibrated_network(CPU_TORCH, None) == partition.NetworkModel()
    with pytest.raises(ValueError, match="outside"):
        cache.put_overlap(CPU_TORCH, 1.5, chunks=4)
    # one rank has nothing to reduce over: the real measure says why
    with pytest.raises(RuntimeError, match="at least 2 ranks"):
        default_overlap_measure("cpu")


@pytest.mark.parametrize("prefer,rows,group,want", [
    (None, 64, 4, 1), (3, 64, 4, 3), (9, 5, 4, 5), ("auto", 64, 1, 1),
    ("auto", 64, 4, 4), ("auto", 16, 4, 2), ("auto", 7, 4, 1),
    ("auto", 64, None, 4)])
def test_overlap_chunks_match_the_reference(prefer, rows, group, want):
    from repro.backend import DispatchTable as JaxTable
    from repro.backend import resolve_backend as jax_resolve
    got = DispatchTable().overlap_chunks(rows, group, CPU_TORCH,
                                         prefer=prefer)
    assert got == want == JaxTable().overlap_chunks(
        rows, group, jax_resolve("cpu-xla"), prefer=prefer)
    assert DispatchTable(overlap_min_rows=32).overlap_chunks(
        64, 4, CPU_TORCH) == 2
