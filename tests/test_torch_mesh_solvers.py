"""The port's inverse-problem solve path on a 2-D process grid, over
``torch.distributed`` with gloo on the CPU, against the JAX package's
single-device solvers, inverse problem and solve engine.

One module-scoped spawn of 4 ranks ((2, 2) and a (1, 2, 2) grid whose
cols span two mesh dims) and one of 2 ranks ((1, 2), (2, 1)) run every
case: every rank the same solves on its shards, each writing its own
results, so the tests hold every rank, not only rank 0:

* ``pcg`` on the exact parameter Gram, ``cg_normal_equations`` (the
  fused Gram and the composed product) and ``lsqr``, within X_TOL of the
  JAX solvers with equal ``n_iters`` and ``col_iters``; among them the
  probe that showed the shard-local dot products (``lsqr`` at tol 1e-12,
  30 iterations, fed ``local_block`` shards);
* ``GaussianInverseProblem``'s ``map_point`` (CG and dense),
  ``map_point_krylov`` (LSQR and CGNR) and EIG, the assembled Hessian the
  same on every rank;
* ``SolveEngine`` against the JAX engine, its fingerprint equal on every
  rank and moved by the data, a cold tune then warm hits on every rank;
* ``autotune(tiles=True)`` choosing alike on every rank, and the tiled
  config's meshed apply against the ``kernels/ref.py`` oracle rounded per
  local block; ``autotune(lint=True)`` and ``lint_operator`` on a mesh;
* the meshed roofline: the ``c10d`` operand bytes ``OpCounter`` counts
  equal the plan's (``plan_collective_bytes``) and what the reference's
  ``parse_collectives`` counts on its own lowering, one for each
  collective kind and direction, and the collectives add no floor
  bytes.

The reference's own mesh tests do not run on this jax; the single-device
reference is the yardstick.  Every spawn joins with a timeout of its own
and fails rather than hangs.
"""

import dataclasses
import datetime
import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SHAPE = (16, 8, 24)          # N_t, N_d, N_m: every grid here divides it
S = 3
DAMP = 0.01
NOISE = 0.05                 # the inverse problem's noise variance
TOL = 1e-10
MAXITER = 200
X_TOL = 1e-9
TOL_LEVEL = {"d": 1e-12, "s": 1e-5, "h": 2e-2}   # tests/test_torch_mesh.py
GRIDS = {4: ((2, 2), (1, 2, 2)), 2: ((1, 2), (2, 1))}
JOIN_S = 150                 # seconds a spawn may take before it fails
ENGINE_DECADES = (1e-5, 1e-8)
# rel_l2 of an engine's x against the JAX engine's, by the served
# config's lowest level (tests/test_torch_solve_serve.py)
ENGINE_X_TOL = {"d": 1e-10, "s": 1e-5}
TILE_SHAPE = (16, 4, 48)     # the tile-refinement operator
TILED = "ddddd;tiles=ds|sh"  # a fixed tiled config, held at f64 sums
KINDS = ("psum", "hierarchical", "reduce_scatter", "ring")


def _grid_name(grid):
    return "x".join(map(str, grid))


def _data(seed=5):
    """The seeded block column and blocks every rank and the reference
    share: a geometrically decaying impulse response (a well-conditioned
    damped normal operator, so two frameworks' iterates stay within
    roundoff)."""
    rng = np.random.default_rng(seed)
    N_t, N_d, N_m = SHAPE
    F = rng.standard_normal((N_t, N_d, N_m)) * \
        (0.5 ** np.arange(N_t))[:, None, None] / np.sqrt(N_m)
    return {"F": F, "M_true": rng.standard_normal((N_m, N_t, S)),
            "noise": 1e-3 * rng.standard_normal((N_d, N_t, S)),
            "B": rng.standard_normal((N_m, N_t, S)),
            "D2": rng.standard_normal((N_d, N_t, 2)),
            "prior": rng.standard_normal((N_m, N_t)),
            "d1": rng.standard_normal((N_d, N_t))}


def _skewed(seed=9, p_c=2):
    """The tile-refinement column: inside every rank's (of up to p_c
    cols) local block, the right half of the model axis carries ~no
    energy, so the summed cell energies favour a mixed map."""
    rng = np.random.default_rng(seed)
    N_t, N_d, N_m = TILE_SHAPE
    F = rng.standard_normal((N_t, N_d, N_m)) / np.sqrt(N_m)
    n_loc = N_m // p_c
    cold = (np.arange(N_m) % n_loc) >= n_loc // 2
    return F * np.where(cold, 1e-6, 1.0)[None, None, :], \
        rng.standard_normal((N_m, N_t))


def _rank_timer(cfg, fn, arg):
    h = int(hashlib.sha1(cfg.to_string().encode()).hexdigest()[:6], 16)
    return 1e-3 * cfg.cost_rank() + 1e-8 * (h / 0xFFFFFF)


def _np(t):
    return t.detach().to(torch.float64).cpu().numpy()


class _Composed:
    """A callable-pair operator (no ``gram``): CGNR's composed mode."""

    def __init__(self, op):
        self.matmat, self.rmatmat = op.matmat, op.rmatmat
        self.dot_group = op.dot_group


def _solve_record(op, res, space):
    return {"x": _np(op.gather_block(res.x, space)), "n_iters": res.n_iters,
            "col_iters": np.asarray(res.col_iters),
            "history": res.residual_history, "converged": res.converged}


def _solves(op, x, D):
    from repro_torch import solvers
    out = {}
    gram = op.gram("parameter")
    B = op.local_block(x["B"], "m")
    out["pcg"] = _solve_record(op, solvers.pcg(
        lambda v: gram.apply(v) + DAMP * v, B, tol=TOL, maxiter=MAXITER,
        group=op.dot_group("m")), "m")
    Dl = op.local_block(D, "d")
    for name, o in (("cgnr", op), ("cgnr_composed", _Composed(op))):
        out[name] = _solve_record(op, solvers.cg_normal_equations(
            o, Dl, damp=DAMP, tol=TOL, maxiter=MAXITER), "m")
    out["lsqr"] = _solve_record(op, solvers.lsqr(
        op, Dl, damp=DAMP ** 0.5, tol=TOL, maxiter=MAXITER), "m")
    out["lsqr_probe"] = _probe(op, x)
    return out


def _probe(op, x):
    """The probe that showed shard-local dot products: undamped LSQR at
    tol 1e-12, 30 iterations, fed ``local_block`` shards."""
    from repro_torch import solvers
    return _solve_record(op, solvers.lsqr(
        op, op.local_block(x["D2"], "d"), tol=1e-12, maxiter=30), "m")


def _inverse(op, x, D):
    from repro_torch.core import GaussianInverseProblem
    p = GaussianInverseProblem(op, noise_var=NOISE, prior_var=1.0)
    d1 = op.local_block(x["d1"], "d")
    out = {"map_cg": _np(op.gather_block(p.map_point(
               d1, method="cg", tol=1e-13, maxiter=MAXITER), "m")),
           "map_dense": _np(op.gather_block(p.map_point(
               d1, method="dense"), "m"))}
    prior = op.local_block(x["prior"], "m")
    for method in ("lsqr", "cgnr"):
        m, res = p.map_point_krylov(op.local_block(D, "d"), prior,
                                    method=method, tol=TOL, maxiter=MAXITER)
        out[f"krylov_{method}"] = {
            "x": _np(op.gather_block(m, "m")), "n_iters": res.n_iters,
            "col_iters": np.asarray(res.col_iters)}
    H = p.assemble_data_space_hessian()
    out["hessian_sha"] = hashlib.sha1(_np(H).tobytes()).hexdigest()
    out["eig"] = float(p.expected_information_gain())
    return out


def _engine(op, x, D, out_dir, tag):
    from repro_torch.core import FFTMatvec
    from repro_torch.core.timing import TimingHarness
    from repro_torch.runtime import (SolveEngine, SolveRequest,
                                     operator_fingerprint)
    from repro_torch.tune import TuningCache
    out = {}
    for decade in ENGINE_DECADES:
        reqs = [SolveRequest(uid=i, d_obs=D[..., i],
                             tol=(decade, 3 * decade)[i % 2],
                             max_iters=400, damp=DAMP)
                for i in reversed(range(S))]
        got = SolveEngine(op, harness=TimingHarness(timer=_rank_timer)
                          ).serve(reqs)
        out[decade] = [{"uid": o.uid, "x": _np(o.x), "config": o.config,
                        "n_iters": o.n_iters, "converged": o.converged,
                        "coalesced": o.coalesced,
                        "history": o.residual_history} for o in got]
    # the fingerprint: one on every rank, moved by the data
    out["fp"] = operator_fingerprint(op)
    moved = FFTMatvec.from_block_column(
        x["F"] * (1.0 + 1e-12), device="cpu", mesh=op.mesh,
        row_axis=op.row_axis, col_axis=op.col_axis)
    out["fp_moved"] = operator_fingerprint(moved)
    # a cold tune, then a second engine on the same cache: warm hits
    path = pathlib.Path(out_dir) / f"cache_{tag}_{dist.get_rank()}.json"
    reqs = [SolveRequest(uid=0, d_obs=D[..., 0], tol=1e-6, max_iters=400,
                         damp=DAMP)]
    stats = []
    for _ in range(2):
        eng = SolveEngine(op, cache=TuningCache(path),
                          harness=TimingHarness(timer=_rank_timer))
        res = eng.serve(reqs)
        stats.append((eng.stats["cold_tunes"], eng.stats["warm_hits"],
                      res[0].config))
    out["cache"] = stats
    return out


def _p_c(grid):
    return grid[1] * (grid[2] if len(grid) == 3 else 1)


def _tiles(mesh, grid, res):
    """``autotune(tiles=True)`` on a meshed operator, and the gathered
    meshed applies of its tiled config and of TILED, for the oracle."""
    from repro_torch.core import FFTMatvec, PrecisionConfig
    F, m = _skewed(p_c=_p_c(grid))
    op = FFTMatvec.from_block_column(F, device="cpu", mesh=mesh,
                                     **_axes(grid))
    tuned = op.autotune(1e-5, ladder=("d", "s"), timer=_rank_timer,
                        tiles=(2, 2), v=torch.as_tensor(m), full_result=True)
    out = {"config": tuned.config.to_string(), "errors": tuned.errors}
    d = np.random.default_rng(3).standard_normal(
        (TILE_SHAPE[1], TILE_SHAPE[0]))
    for key, t in (("tuned", tuned.op),
                   ("fixed", op.with_precision(
                       PrecisionConfig.from_string(TILED)))):
        out[key] = (
            _np(t.gather_block(t.matvec(t.local_block(m, "m")), "d")),
            _np(t.gather_block(t.rmatvec(t.local_block(d, "d")), "m")))
    res["tiles"] = out


def _axes(grid):
    if len(grid) == 3:
        return {"row_axis": "row", "col_axis": ("c1", "c2")}
    return {}


def _mesh_for(grid):
    from repro_torch.launch.mesh import make_test_mesh
    names = ("row", "c1", "c2") if len(grid) == 3 else ("row", "col")
    return make_test_mesh(grid, names)


def _roofline(op, x, res):
    """One matvec and one rmatvec of each collective kind under
    OpCounter: its c10d bytes, and its floor bytes against the local
    plan's on this rank's blocks alone."""
    from repro_torch.launch.roofline import OpCounter, plan_collective_bytes
    m, d = op.local_block(x["B"][..., 0], "m"), op.local_block(x["d1"], "d")
    local = dataclasses.replace(op, mesh=None, groups=None)
    out = {}
    for kind in KINDS:
        o = op.with_comm(None, kind).with_overlap(None)
        for adjoint, v in ((False, m), (True, d)):
            with OpCounter() as c:
                (o.rmatvec if adjoint else o.matvec)(v)
            with OpCounter() as c1:
                (local.rmatvec if adjoint else local.matvec)(v)
            out[kind, adjoint] = {
                "coll": c.collectives.total_bytes,
                "want": plan_collective_bytes(o, adjoint=adjoint),
                "floor": c.floor_bytes, "local_floor": c1.floor_bytes,
                "counts": dict(c.coll_counts)}
    res["roofline"] = out


def _rank_main(rank, world, init_file, out_dir):
    from repro_torch import analysis
    from repro_torch.core import FFTMatvec
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=JOIN_S))
    try:
        x = _data()
        res = {}
        single = FFTMatvec.from_block_column(x["F"], device="cpu")
        D = (single.matmat(torch.as_tensor(x["M_true"]))
             + torch.as_tensor(x["noise"])).numpy()
        if world == 4:
            # the fault's probe first, on its own and saved at once: it
            # needs nothing a solver on a mesh did not already have
            op = FFTMatvec.from_block_column(x["F"], device="cpu",
                                             mesh=_mesh_for((2, 2)))
            torch.save(_probe(op, x),
                       pathlib.Path(out_dir) / f"probe{rank}.pt")
        for grid in GRIDS[world]:
            g = _grid_name(grid)
            mesh = _mesh_for(grid)
            op = FFTMatvec.from_block_column(x["F"], device="cpu", mesh=mesh,
                                             **_axes(grid))
            r = res[g] = {"grid": op.grid_shape()}
            r["solves"] = _solves(op, x, D)
            r["inverse"] = _inverse(op, x, D)
            r["engine"] = _engine(op, x, D, out_dir, g)
            _tiles(mesh, grid, r)
            if world == 4:
                _roofline(op, x, r)
            if grid == (2, 2):
                r["lint_operator"] = [str(f) for f in
                                      analysis.lint_operator(op)]
                tuned = op.autotune(1e-5, timer=_rank_timer, lint=True,
                                    full_result=True)
                r["lint_autotune"] = tuned.config.to_string()
        torch.save(res, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _start(world, tmp):
    """Start ``world`` ranks of :func:`_rank_main`, not waiting for them."""
    return mp.start_processes(_rank_main,
                              args=(world, str(tmp / "store"), str(tmp)),
                              nprocs=world, join=False, start_method="spawn")


def _join(ctx, world, tmp, deadline):
    """Wait for the ranks; fail (and kill them) past ``deadline``, or when
    any rank raises; then every rank's results."""
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"{world} ranks did not finish in {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _refs():
    """The JAX package's single-device results on the same numpy data
    (its operator's blocks and Gram jitted).  JAX is imported here, not at
    the top: the spawned ranks import this module and run the port
    alone."""
    import jax
    import jax.numpy as jnp

    from repro import solvers as jsolvers
    from repro.core import FFTMatvec as JaxFFTMatvec
    from repro.core import GaussianInverseProblem as JaxProblem
    from repro.core.timing import TimingHarness as JaxTimingHarness
    from repro.runtime import SolveEngine as JaxSolveEngine
    from repro.runtime import SolveRequest as JaxSolveRequest

    x = _data()
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(x["F"]),
                                         backend="cpu-xla")

    class Jitted:
        def __init__(self):
            self.matmat, self.rmatmat = jop.jitted_block()
            self._gram = jop.gram(space="parameter", mode="exact")
            self._gram.apply = jax.jit(self._gram.apply)

        def gram(self, space="parameter", mode="exact"):
            return self._gram

    jit = Jitted()
    D = np.asarray(jit.matmat(jnp.asarray(x["M_true"]))) + x["noise"]
    jD = jnp.asarray(D)
    out = {"D": D}

    def rec(r):
        return {"x": np.asarray(r.x, np.float64), "n_iters": r.n_iters,
                "col_iters": np.asarray(r.col_iters),
                "history": np.asarray(r.residual_history),
                "converged": r.converged}

    g = jit._gram.apply
    out["pcg"] = rec(jsolvers.pcg(lambda v: g(v) + DAMP * v,
                                  jnp.asarray(x["B"]), tol=TOL,
                                  maxiter=MAXITER))
    out["cgnr"] = rec(jsolvers.cg_normal_equations(
        jit, jD, damp=DAMP, tol=TOL, maxiter=MAXITER))
    out["lsqr"] = rec(jsolvers.lsqr(jit, jD, damp=DAMP ** 0.5, tol=TOL,
                                    maxiter=MAXITER))
    out["lsqr_probe"] = rec(jsolvers.lsqr(jit, jnp.asarray(x["D2"]),
                                          tol=1e-12, maxiter=30))
    p = JaxProblem(jop, noise_var=NOISE, prior_var=1.0)
    jd1 = jnp.asarray(x["d1"])
    out["map_cg"] = np.asarray(p.map_point(jd1, method="cg", tol=1e-13,
                                           maxiter=MAXITER))
    out["map_dense"] = np.asarray(p.map_point(jd1, method="dense"))
    for method in ("lsqr", "cgnr"):
        m, res = p.map_point_krylov(jD, jnp.asarray(x["prior"]),
                                    method=method, tol=TOL, maxiter=MAXITER)
        out[f"krylov_{method}"] = {"x": np.asarray(m),
                                   "n_iters": res.n_iters,
                                   "col_iters": np.asarray(res.col_iters)}
    out["eig"] = float(p.expected_information_gain())
    for decade in ENGINE_DECADES:
        reqs = [JaxSolveRequest(uid=i, d_obs=D[..., i],
                                tol=(decade, 3 * decade)[i % 2],
                                max_iters=400, damp=DAMP) for i in range(S)]
        got = JaxSolveEngine(jop, harness=JaxTimingHarness(
            timer=_rank_timer)).serve(reqs)
        out["engine", decade] = [
            {"uid": o.uid, "x": np.asarray(o.x), "config": o.config,
             "n_iters": o.n_iters, "converged": o.converged,
             "history": np.asarray(o.residual_history)} for o in got]
    return out


# The reference's collective operand bytes on its own meshed lowering:
# one matvec and one rmatvec of each kind on 4 forced host devices,
# counted by its parse_collectives on the compiled HLO.  This jax cannot
# infer the replication of the reduce-scatter and ring outputs, so its
# shard_map runs with the check off, as the reference's compat shim
# already runs it on an older jax.
_REF_COLLECTIVES = r"""
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import repro.core.fftmatvec as fm
fm.shard_map = lambda f, *, mesh, in_specs, out_specs: jax.shard_map(
    f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
from repro.core import FFTMatvec
from repro.jax_compat import make_mesh
from repro.launch.roofline import parse_collectives
Nt, Nd, Nm = %(shape)r
kinds, out = %(kinds)r, {}
for grid in %(grids)r:
    names = ("row", "c1", "c2") if len(grid) == 3 else ("row", "col")
    axes = (dict(row_axis="row", col_axis=("c1", "c2")) if len(grid) == 3
            else {})
    mesh = make_mesh(grid, names)
    F = jnp.zeros((Nt, Nd, Nm), jnp.float64)
    for kind in kinds:
        op = FFTMatvec.from_block_column(F, mesh=mesh, collective=kind, **axes)
        for adj in (False, True):
            f, shape, sh = ((op.rmatvec, (Nd, Nt), op.d_sharding()) if adj
                            else (op.matvec, (Nm, Nt), op.m_sharding()))
            lo = jax.jit(f, in_shardings=sh).lower(
                jax.ShapeDtypeStruct(shape, jnp.float64)).compile()
            key = "x".join(map(str, grid)) + f",{kind},{int(adj)}"
            out[key] = parse_collectives(lo.as_text()).total_bytes
print(json.dumps(out))
"""


def _start_ref_collectives():
    from repro.jax_compat import forced_host_devices_env
    code = _REF_COLLECTIVES % {"shape": SHAPE, "kinds": KINDS,
                               "grids": GRIDS[4]}
    return subprocess.Popen([sys.executable, "-c", code],
                            env=forced_host_devices_env(4),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _ref_collectives(proc, deadline):
    try:
        out, err = proc.communicate(
            timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"the reference's lowering did not finish in {JOIN_S} s")
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.splitlines()[-1])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both spawns and the reference's lowering, started together, and the
    reference computed while they run: ``{world: [each rank's results],
    or what stopped the ranks}``, the references and the ranks' folders."""
    dirs = {w: tmp_path_factory.mktemp(f"solve_ranks{w}") for w in (4, 2)}
    deadline = time.monotonic() + JOIN_S
    ctxs = {w: _start(w, d) for w, d in dirs.items()}
    lowering = _start_ref_collectives()
    out = {}
    try:
        refs = _refs()
        refs["collectives"] = _ref_collectives(lowering, deadline)
    finally:
        if lowering.poll() is None:
            lowering.kill()
            lowering.communicate()
        for w in (4, 2):
            try:
                out[w] = _join(ctxs[w], w, dirs[w], deadline)
            except (Exception, pytest.fail.Exception) as e:
                out[w] = e
    return out, refs, dirs


@pytest.fixture(scope="module")
def runs(spawned):
    """``{world: [each rank's results]}`` and the references; the ranks'
    error where they stopped."""
    out, refs, _ = spawned
    for got in out.values():
        if isinstance(got, BaseException):
            raise got
    return out, refs


@pytest.fixture(scope="module")
def probe(spawned):
    """Each (2, 2) rank's probe, saved before anything else ran, and the
    reference's: whatever stopped the ranks later."""
    _, refs, dirs = spawned
    return [torch.load(dirs[4] / f"probe{r}.pt", weights_only=False)
            for r in range(4)], refs["lsqr_probe"]


ALL_GRIDS = [(w, g) for w in (4, 2) for g in GRIDS[w]]
IDS = [_grid_name(g) for _, g in ALL_GRIDS]


def _ranks(runs, world, grid):
    return [r[_grid_name(grid)] for r in runs[0][world]]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("world,grid", ALL_GRIDS, ids=IDS)
def test_the_grids_are_what_the_ranks_ran(runs, world, grid):
    want = (grid[0], grid[1] * (grid[2] if len(grid) == 3 else 1))
    assert all(r["grid"] == want for r in _ranks(runs, world, grid))


@pytest.mark.parametrize("solver", ["pcg", "cgnr", "cgnr_composed", "lsqr",
                                    "lsqr_probe"])
@pytest.mark.parametrize("world,grid", ALL_GRIDS, ids=IDS)
def test_meshed_solvers_match_the_reference(runs, world, grid, solver):
    want = runs[1]["cgnr" if solver == "cgnr_composed" else solver]
    for rank, r in enumerate(_ranks(runs, world, grid)):
        got = r["solves"][solver]
        # every rank steers on the global scalars: same iterations
        assert got["n_iters"] == want["n_iters"], rank
        np.testing.assert_array_equal(got["col_iters"], want["col_iters"])
        assert got["converged"] == want["converged"]
        assert got["history"].shape == want["history"].shape
        assert _rel(got["x"], want["x"]) <= X_TOL, (rank, solver)


def test_meshed_lsqr_fed_its_shards_matches_the_reference(probe):
    # the fault's five facts: lsqr fed local_block shards on a (2, 2) grid
    # at ddddd, shape (16, 8, 24), against the reference's single-device
    # lsqr; shard-local dot products left it 0.433 (ranks 0-1) and 0.408
    # (ranks 2-3) away
    got, want = probe
    xs = [r["x"] for r in got]
    for x in xs:
        assert _rel(x, want["x"]) <= X_TOL
        assert np.array_equal(x, xs[0])


@pytest.mark.parametrize("world,grid", ALL_GRIDS, ids=IDS)
def test_every_rank_agrees(runs, world, grid):
    ranks = _ranks(runs, world, grid)
    for r in ranks[1:]:
        for solver, got in r["solves"].items():
            np.testing.assert_array_equal(
                got["col_iters"], ranks[0]["solves"][solver]["col_iters"])
            np.testing.assert_array_equal(
                got["history"], ranks[0]["solves"][solver]["history"])
        assert r["inverse"]["hessian_sha"] == ranks[0]["inverse"][
            "hessian_sha"]
        assert r["inverse"]["eig"] == ranks[0]["inverse"]["eig"]
        assert r["engine"]["fp"] == ranks[0]["engine"]["fp"]
        assert r["tiles"]["config"] == ranks[0]["tiles"]["config"]


@pytest.mark.parametrize("world,grid", ALL_GRIDS, ids=IDS)
def test_meshed_inverse_problem_matches_the_reference(runs, world, grid):
    ref = runs[1]
    for r in _ranks(runs, world, grid):
        inv = r["inverse"]
        for key in ("map_cg", "map_dense"):
            assert _rel(inv[key], ref[key]) <= X_TOL, key
        for method in ("lsqr", "cgnr"):
            got, want = inv[f"krylov_{method}"], ref[f"krylov_{method}"]
            assert got["n_iters"] == want["n_iters"]
            np.testing.assert_array_equal(got["col_iters"],
                                          want["col_iters"])
            assert _rel(got["x"], want["x"]) <= X_TOL, method
        assert inv["eig"] == pytest.approx(ref["eig"], rel=X_TOL)


@pytest.mark.parametrize("decade", ENGINE_DECADES)
@pytest.mark.parametrize("world,grid", ALL_GRIDS, ids=IDS)
def test_meshed_engine_matches_the_jax_engine(runs, world, grid, decade):
    want = runs[1]["engine", decade]
    for r in _ranks(runs, world, grid):
        got = r["engine"][decade]
        assert [o["uid"] for o in got] == [o["uid"] for o in want] == \
            list(range(S))
        for o, j in zip(got, want):
            assert o["config"] == j["config"]
            assert o["n_iters"] == j["n_iters"] and o["n_iters"] > 0
            assert o["converged"] == j["converged"] is True
            assert o["coalesced"] == S
            assert o["x"].shape == (SHAPE[2], SHAPE[0])
            lvl = min(o["config"], key="hsd".index)
            assert _rel(o["x"], j["x"]) < ENGINE_X_TOL[lvl]
            np.testing.assert_allclose(o["history"], j["history"],
                                       rtol=1e-3 if lvl == "s" else 1e-6)


@pytest.mark.parametrize("world,grid", ALL_GRIDS, ids=IDS)
def test_meshed_engine_fingerprint_and_cache(runs, world, grid):
    for r in _ranks(runs, world, grid):
        e = r["engine"]
        assert e["fp_moved"] != e["fp"]
        assert f"grid={r['grid']}" in e["fp"]
        # a cold tune, then the second engine answered from the cache
        (cold1, warm1, cfg1), (cold2, warm2, cfg2) = e["cache"]
        assert (cold1, warm1) == (1, 0) and (cold2, warm2) == (0, 1)
        assert cfg1 == cfg2


@pytest.mark.parametrize("world,grid", ALL_GRIDS, ids=IDS)
def test_meshed_tile_refinement_and_its_oracle(runs, world, grid):
    from repro_torch.core import FFTMatvec, PrecisionConfig
    from repro_torch.kernels import ref
    ranks = _ranks(runs, world, grid)
    tiles = ranks[0]["tiles"]
    cfg = PrecisionConfig.from_string(tiles["config"])
    # the skewed blocks make a mixed map worth it, on every grid
    assert cfg.tiles is not None and cfg.tiles.shape == (2, 2)
    assert tiles["errors"][tiles["config"]] <= 1e-5
    # the oracle: F_hat at the gemv level, each rank's local block rounded
    # through the map's cells (kernels/ref.py), then the untiled plan
    F, m = _skewed(p_c=_p_c(grid))
    d = np.random.default_rng(3).standard_normal(
        (TILE_SHAPE[1], TILE_SHAPE[0]))
    p_r, p_c = grid[0], _p_c(grid)
    nd, nm = TILE_SHAPE[1] // p_r, TILE_SHAPE[2] // p_c

    def oracle(c):
        base = FFTMatvec.from_block_column(
            F, precision=c.replace(tiles=None), device="cpu")
        planes = [p.clone() for p in (base.F_hat_re, base.F_hat_im)]
        levels = c.tiles.effective(c.gemv)
        for r in range(p_r):
            for k in range(p_c):
                blk = (slice(None), slice(r * nd, (r + 1) * nd),
                       slice(k * nm, (k + 1) * nm))
                q = ref.quantize_tile_cells(levels, *(p[blk] for p in planes))
                for p, qp in zip(planes, q):
                    p[blk] = qp
        o = dataclasses.replace(base, F_hat_re=planes[0], F_hat_im=planes[1])
        return _np(o.matvec(torch.as_tensor(m))), \
            _np(o.rmatvec(torch.as_tensor(d)))

    # the tuned config (f32 here: the grid's partial sums round elsewhere
    # than one device's, so the level's tolerance) and TILED, held at
    # 1e-12: where the cols are split, the map laid over the whole model
    # axis instead gives a matvec 5.8e-4 away (the map's cells span K and
    # the model axis only, so a split of the rows alone changes none)
    for key, c, tol in (("tuned", cfg, TOL_LEVEL[cfg.lowest()]),
                        ("fixed", PrecisionConfig.from_string(TILED), 1e-12)):
        want = oracle(c)
        for r in ranks:
            for got, w in zip(r["tiles"][key], want):
                assert _rel(got, w) <= tol, (key, _rel(got, w))


@pytest.mark.parametrize("grid", GRIDS[4], ids=[_grid_name(g)
                                                  for g in GRIDS[4]])
def test_meshed_roofline_counts_the_plan_collectives(runs, grid):
    from repro_torch.backend import H100
    from repro_torch.launch.roofline import CollectiveStats, roofline_terms
    ref = runs[1]["collectives"]
    for r in _ranks(runs, 4, grid):
        for (kind, adjoint), c in r["roofline"].items():
            # the counter, the plan's operands and the reference's
            # parse_collectives on its lowering: one count
            want = ref[f"{_grid_name(grid)},{kind},{int(adjoint)}"]
            assert c["coll"] == c["want"] == want, (kind, adjoint, c, want)
            # a ring over a group of one makes no hop
            assert c["want"] > 0 or (kind, adjoint) == ("ring", True)
            # the reductions' operands move over the link, not the HBM
            assert c["floor"] == c["local_floor"], (kind, adjoint)
            terms = roofline_terms({"flops": 0.0, "bytes accessed": 0.0},
                                   CollectiveStats(c["counts"], {},
                                                   c["coll"]))
            assert terms["collective_s"] == c["coll"] / H100.link_bandwidth


def test_lint_on_a_mesh(runs):
    for r in _ranks(runs, 4, (2, 2)):
        assert r["lint_operator"] == []
        assert r["lint_autotune"] == _ranks(runs, 4, (2, 2))[0][
            "lint_autotune"]
