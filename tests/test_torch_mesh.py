"""The port's FFTMatvec and its exact Gram on a 2-D process grid, over
``torch.distributed`` with gloo on the CPU, against the JAX package's
single-device operator.

One module-scoped spawn of 4 ranks and one of 2 run every case (every
rank the same plan on its own shard; rank 0 writes the assembled global
outputs and its stage census); the tests here compare them with the
reference's ``FFTMatvec`` on the same seeded numpy inputs:

* every grid ((1, 2), (2, 1), (2, 2), (1, 4)), collective kind (the
  four lowerings; ``mesh="auto"`` and the census take the defaults),
  overlap K (1, 4) and level
  (ddddd, sssss, hhhhh): ``matvec``, ``rmatvec``, ``matmat``/``rmatmat``
  (S = 3) and the exact Gram in both spaces at S = 1 and 3, within 1e-12
  (d), 1e-5 (s) and 2e-2 (h) relative L2;
* a reduce-scatter fallback shape (N_d = 6 over a group of 4);
* the censuses the reference's own mesh tests assert
  (``tests/test_distributed.py``: pipelined and ring schedules, the
  chunked Gram, auto overlap engaging and declining, the two-tier
  reduction), the ring chunked vs serial bit for bit, the flat reduction
  chunked vs serial within 1e-15;
* a reduced comm level restoring the carrier's dtype, ``mesh="auto"``,
  the overlap calibration's measurement on ranks, and ``autotune`` on a
  meshed operator choosing as on one device.

The reference's own mesh subprocess tests do not run on this jax, so they
are not the yardstick: the single-device reference is.  Every spawn joins
with a timeout of its own and fails rather than hangs.
"""

import datetime
import hashlib
import pathlib
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SHAPE = (16, 8, 24)          # N_t, N_d, N_m: every grid here divides it
FALLBACK = (16, 6, 24)       # F's carrier (6 rows) does not tile 4 ranks
CENSUS = (16, 64, 128)       # the reference's census shape
S = 3
LEVELS = ("ddddd", "sssss", "hhhhh")
TOL = {"d": 1e-12, "s": 1e-5, "h": 2e-2}
KINDS = ("psum", "hierarchical", "reduce_scatter", "ring")
OVERLAPS = (1, 4)
GRIDS = {4: ((2, 2), (1, 4)), 2: ((1, 2), (2, 1))}
OPS = ("matvec", "rmatvec", "matmat", "rmatmat", "gram_p", "gram_p_S",
       "gram_d", "gram_d_S")
JOIN_S = 150                 # seconds a spawn may take before it fails


def _data(shape, seed=7):
    """The seeded block column and inputs every rank and the reference
    share."""
    rng = np.random.default_rng(seed)
    N_t, N_d, N_m = shape
    F = rng.standard_normal((N_t, N_d, N_m)) * \
        (0.5 ** np.arange(N_t))[:, None, None] / np.sqrt(N_m)
    return {"F": F, "m": rng.standard_normal((N_m, N_t)),
            "d": rng.standard_normal((N_d, N_t)),
            "M": rng.standard_normal((N_m, N_t, S)),
            "D": rng.standard_normal((N_d, N_t, S))}


def _np(t):
    return t.detach().to(torch.float64).numpy()


def _apply_all(op, x):
    """Every entry point on this rank's shards, each assembled globally,
    with the stage census of each."""
    from repro_torch.core import record_stages
    calls = {
        "matvec": (op.matvec, "m", x["m"], "d"),
        "rmatvec": (op.rmatvec, "d", x["d"], "m"),
        "matmat": (op.matmat, "m", x["M"], "d"),
        "rmatmat": (op.rmatmat, "d", x["D"], "m"),
        "gram_p": (op.gram("parameter").apply, "m", x["m"], "m"),
        "gram_p_S": (op.gram("parameter").apply, "m", x["M"], "m"),
        "gram_d": (op.gram("data").apply, "d", x["d"], "d"),
        "gram_d_S": (op.gram("data").apply, "d", x["D"], "d")}
    out, counts = {}, {}
    for key, (fn, space_in, v, space_out) in calls.items():
        with record_stages() as c:
            y = fn(op.local_block(v, space_in))
        out[key] = _np(op.gather_block(y, space_out))
        counts[key] = dict(c)
    return out, counts


def _matrix(mesh, grid, res):
    """The grid x level x kind x K parity matrix, and the fallback shape."""
    from repro_torch.core import FFTMatvec, PrecisionConfig
    x = _data(SHAPE)
    for level in LEVELS:
        base = FFTMatvec.from_block_column(
            x["F"], precision=PrecisionConfig.from_string(level),
            device="cpu", mesh=mesh)
        for kind in KINDS:
            op = base.with_comm(None, kind)
            for K in OVERLAPS:
                key = f"{grid[0]}x{grid[1]}/{level}/{kind}/{K}"
                res[key] = _apply_all(op.with_overlap(K), x)
    if grid[0] * grid[1] == 4:
        fb = _data(FALLBACK)
        op = FFTMatvec.from_block_column(fb["F"], device="cpu", mesh=mesh,
                                         collective="reduce_scatter")
        res[f"fallback/{grid[0]}x{grid[1]}"] = _apply_all(op, fb)


def _census(res):
    """The reference's census and parity cases on a (1, 4) grid (its
    2 x 4 mesh's col group of 4), the two-tier reduction on a (1, 2, 2)
    mesh, the comm level, ``mesh="auto"`` and the psum carrier."""
    from repro_torch.core import FFTMatvec, record_stages
    from repro_torch.core.pipeline import Stage, run_stages
    from repro_torch.launch.mesh import make_test_mesh
    x = _data(CENSUS)
    mesh = make_test_mesh((1, 4), ("row", "col"))

    def run(op, name, v, space_in, space_out):
        fn = (op.gram("parameter").apply if name == "gram"
              else getattr(op, name))
        with record_stages() as c:
            y = fn(op.local_block(v, space_in))
        return _np(op.gather_block(y, space_out)), dict(c)

    plans = {"mv": ("matvec", x["m"], "m", "d"),
             "rmv": ("rmatvec", x["d"], "d", "m"),
             "mm": ("matmat", x["M"], "m", "d"),
             "rmm": ("rmatmat", x["D"], "d", "m"),
             "gram": ("gram", x["m"], "m", "m")}
    base = FFTMatvec.from_block_column(x["F"], device="cpu", mesh=mesh)
    ring = base.with_comm(None, "ring")
    for tag, op in (("pipe", base.with_overlap(4)),
                    ("ser", base.with_overlap(None)),
                    ("auto", base), ("ring", ring.with_overlap(4)),
                    ("ring_ser", ring.with_overlap(None)),
                    ("ring_auto", ring)):
        for p, args in plans.items():
            res[f"census/{tag}/{p}"] = run(op, *args)
    # the thin shape: 4 local rows, auto declines
    thin = _data(SHAPE)
    op = FFTMatvec.from_block_column(
        thin["F"], device="cpu", mesh=make_test_mesh((2, 2), ("row", "col")))
    res["census/thin"] = run(op, "matvec", thin["m"], "m", "d")
    # the two-tier reduction: cols over two mesh dims
    mesh3 = make_test_mesh((1, 2, 2), ("row", "c1", "c2"))
    op = FFTMatvec.from_block_column(x["F"], device="cpu", mesh=mesh3,
                                     row_axis="row", col_axis=("c1", "c2"))
    res["census/two_tier"] = run(op.with_overlap(None), "matvec", x["m"],
                                 "m", "d")
    res["census/two_tier_grid"] = op.grid_shape()
    res["census/two_tier_ring"] = run(
        op.with_comm(None, "ring").with_overlap(4), "matvec", x["m"], "m",
        "d")
    # reduced-precision communication on a d carrier
    for comm in ("s", "h"):
        y, _ = run(base.with_comm(comm).with_overlap(None), "matvec",
                   x["m"], "m", "d")
        res[f"census/comm_{comm}"] = y
    res["census/comm_dtype"] = str(base.with_comm("h").matvec(
        base.local_block(x["m"], "m")).dtype)
    # mesh="auto": choose_grid over 4 ranks
    auto = FFTMatvec.from_block_column(x["F"], device="cpu", mesh="auto")
    res["census/auto_grid"] = auto.grid_shape()
    res["census/auto_mv"] = run(auto, "matvec", x["m"], "m", "d")[0]
    # the psum carrier: 1 + 2^-40 is exact in f64 and rounds to 1 in f32
    opts = base.resolved_opts()
    v = torch.tensor([[1.0 + 2.0 ** -40], [1.0]], dtype=torch.float64)
    for lvl in ("s", "d"):
        out = run_stages((Stage("psum", lvl, axis="col"),), v, {}, N_t=1,
                         opts=opts)
        res[f"census/carrier_{lvl}"] = (str(out.dtype), float(out[0, 0]))
    pair = (torch.ones((2, 3)), 2.0 * torch.ones((2, 3)))
    out = run_stages((Stage("psum", "h", axis="col",
                            collective="hierarchical"),), pair, {}, N_t=1,
                     opts=opts)
    res["census/pair"] = [(str(p.dtype), float(p[0, 0])) for p in out]


def _on_two(res, out_dir):
    """The overlap calibration's measurement and ``autotune`` on a meshed
    operator, over 2 ranks."""
    from repro_torch.backend import (CPU_TORCH, calibrate_overlap,
                                     default_overlap_measure)
    from repro_torch.core import FFTMatvec
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tune import TuningCache

    def host_timer(fn, arg, n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(arg)
        return 1e3 * (time.perf_counter() - t0) / n
    measure = default_overlap_measure("cpu", repeats=2, timer=host_timer)
    cache = TuningCache(out_dir / f"tune{dist.get_rank()}.json")
    res["calibrate"] = (calibrate_overlap(CPU_TORCH, measure=measure,
                                          cache=cache),
                        cache.get_overlap(CPU_TORCH))
    x = _data(SHAPE)
    mesh = make_test_mesh((1, 2), ("row", "col"))
    op = FFTMatvec.from_block_column(x["F"], device="cpu", mesh=mesh)
    tuned = op.autotune(1e-5, timer=_rank_timer, full_result=True)
    res["autotune"] = (tuned.config.to_string(), tuned.errors,
                       tuned.op.grid_shape())


def _rank_timer(cfg, fn, arg):
    h = int(hashlib.sha1(cfg.to_string().encode()).hexdigest()[:6], 16)
    return 1e-3 * cfg.cost_rank() + 1e-8 * (h / 0xFFFFFF)


def _rank_main(rank, world, init_file, out_dir):
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=JOIN_S))
    try:
        res = {}
        for grid in GRIDS[world]:
            _matrix(make_test_mesh(grid, ("row", "col")), grid, res)
        if world == 4:
            _census(res)
        else:
            _on_two(res, pathlib.Path(out_dir))
        if rank == 0:
            torch.save(res, pathlib.Path(out_dir) / "results.pt")
    finally:
        dist.destroy_process_group()


def _start(world, tmp):
    """Start ``world`` ranks of :func:`_rank_main`, not waiting for them."""
    return mp.start_processes(_rank_main,
                              args=(world, str(tmp / "store"), str(tmp)),
                              nprocs=world, join=False, start_method="spawn")


def _join(ctx, world, tmp, deadline):
    """Wait for the ranks; fail (and kill them) past ``deadline``, or when
    any rank raises; then rank 0's results."""
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
    return torch.load(tmp / "results.pt", weights_only=False)


def _refs():
    """The JAX package's single-device outputs, per shape and level (each
    entry point jitted: op by op, eager JAX compiles every primitive).
    JAX is imported here, not at the top: the spawned ranks import this
    module and run the port alone."""
    import jax
    import jax.numpy as jnp

    from repro.core import FFTMatvec as JaxFFTMatvec
    from repro.core import PrecisionConfig as JaxConfig
    out = {}
    for shape in (SHAPE, FALLBACK, CENSUS):
        x = {k: jnp.asarray(v) for k, v in _data(shape).items()}
        for level in LEVELS if shape == SHAPE else ("ddddd",):
            op = JaxFFTMatvec.from_block_column(
                x["F"], precision=JaxConfig.from_string(level),
                backend="cpu-xla")
            gp = jax.jit(op.gram("parameter").apply)
            gd = jax.jit(op.gram("data").apply)
            ys = {"matvec": jax.jit(op.matvec)(x["m"]),
                  "rmatvec": jax.jit(op.rmatvec)(x["d"]),
                  "matmat": jax.jit(op.matmat)(x["M"]),
                  "rmatmat": jax.jit(op.rmatmat)(x["D"]),
                  "gram_p": gp(x["m"]), "gram_p_S": gp(x["M"]),
                  "gram_d": gd(x["d"]), "gram_d_S": gd(x["D"])}
            out[shape, level] = {k: np.asarray(v.astype(jnp.float64))
                                 for k, v in ys.items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, started together, and the reference computed while
    they run: ``(four ranks' results, two ranks' results, references)``."""
    dirs = {w: tmp_path_factory.mktemp(f"ranks{w}") for w in (4, 2)}
    deadline = time.monotonic() + JOIN_S
    ctxs = {w: _start(w, d) for w, d in dirs.items()}
    try:
        refs = _refs()
    finally:
        try:
            four = _join(ctxs[4], 4, dirs[4], deadline)
        finally:
            two = _join(ctxs[2], 2, dirs[2], deadline)
    return four, two, refs


@pytest.fixture(scope="module")
def four(runs):
    return runs[0]


@pytest.fixture(scope="module")
def two(runs):
    return runs[1]


@pytest.fixture(scope="module")
def refs(runs):
    return runs[2]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _results(four, two, grid):
    return four if grid[0] * grid[1] == 4 else two


@pytest.mark.parametrize("K", OVERLAPS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("grid", [g for w in (4, 2) for g in GRIDS[w]])
def test_grid_matches_the_single_device_reference(four, two, refs, grid,
                                                  level, kind, K):
    outs, counts = _results(four, two, grid)[
        f"{grid[0]}x{grid[1]}/{level}/{kind}/{K}"]
    tol = TOL[min(level, key="hsd".index)]
    for name in OPS:
        e = _rel(outs[name], refs[SHAPE, level][name])
        assert e <= tol, (name, e)
    # every entry point ran its reductions (F* over a single row has a
    # group of one, reduced all the same)
    for name in OPS:
        assert counts[name]["psum"] >= 1, name
        assert not counts[name].get("collective:host_staged")
    # the exact Gram's mid and final reductions, each in K chunks
    assert counts["gram_p"]["psum"] == counts["gram_d"]["psum"] == 2 * K


@pytest.mark.parametrize("grid", GRIDS[4])
def test_reduce_scatter_fallback_shape(four, refs, grid):
    outs, counts = four[f"fallback/{grid[0]}x{grid[1]}"]
    for name in OPS:
        assert _rel(outs[name], refs[FALLBACK, "ddddd"][name]) <= 1e-12
    # F's carrier of 6 (or 3) rows does not tile the col group: the flat
    # all-reduce ran instead, and said so
    assert counts["matvec"]["collective:reduce_scatter:fallback"] == 1
    assert "collective:reduce_scatter" not in counts["matvec"]


def test_pipelined_census_matches_the_reference(four, refs):
    y_p, c_p = four["census/pipe/mv"]
    y_s, c_s = four["census/ser/mv"]
    # one super-stage launching four chunk reductions
    assert c_p["gemv_psum"] == 1 and c_p["collective:pipelined:4"] == 1
    assert c_p["psum"] == 4 and c_p["gemv"] == 4
    assert c_s["gemv_psum"] == 1 and c_s["psum"] == 1
    assert not any(k.startswith("collective:pipelined") for k in c_s)
    # the flat reduction, chunked against serial: the same rows, the
    # buffer's segmentation may differ
    for p in ("mv", "rmv", "mm", "rmm", "gram"):
        assert _rel(four[f"census/pipe/{p}"][0],
                    four[f"census/ser/{p}"][0]) < 1e-15, p
    assert _rel(y_p, refs[CENSUS, "ddddd"]["matvec"]) < 1e-13
    assert _rel(four["census/pipe/gram"][0],
                refs[CENSUS, "ddddd"]["gram_p"]) < 1e-12
    # the exact Gram chunks both reductions
    assert four["census/pipe/gram"][1]["collective:pipelined:4"] == 2
    # auto engages at 64 local rows (8 a chunk at most 4 chunks)
    keys = [k for k in four["census/auto/mv"][1]
            if k.startswith("collective:pipelined:")]
    assert keys == ["collective:pipelined:4"]


def test_ring_census_and_bits(four, refs):
    y_r, c_r = four["census/ring/mv"]
    y_s, c_s = four["census/ring_ser/mv"]
    # K = 4 chunks x 3 hops over the col group of 4
    assert c_r["gemv_psum"] == 1 and c_r["collective:ring:4"] == 1
    assert c_r["collective:ring"] == 12
    assert c_r["psum"] == 4 and c_r["gemv"] == 4
    assert c_s["psum"] == 1 and c_s["collective:ring"] == 3
    assert not any(k.startswith("collective:ring:4") for k in c_s)
    assert not any(k.endswith(":fallback") for k in c_r)
    # bit for bit against the serial ring (canonical origin order)
    for p in ("mv", "rmv", "mm", "rmm", "gram"):
        assert np.array_equal(four[f"census/ring/{p}"][0],
                              four[f"census/ring_ser/{p}"][0]), p
    assert _rel(y_r, refs[CENSUS, "ddddd"]["matvec"]) < 1e-13
    assert _rel(four["census/ring/rmv"][0],
                refs[CENSUS, "ddddd"]["rmatvec"]) < 1e-13
    assert _rel(y_r, four["census/pipe/mv"][0]) < 1e-15
    keys = [k for k in four["census/ring_auto/mv"][1]
            if k.startswith("collective:ring:")]
    assert keys == ["collective:ring:4"]


def test_auto_overlap_declines_at_thin_shapes(four, refs):
    y, c = four["census/thin"]
    assert _rel(y, refs[SHAPE, "ddddd"]["matvec"]) < 1e-13
    assert c["gemv_psum"] == 1 and c["psum"] == 1 and c["gemv"] == 1
    assert not any(k.startswith("collective:pipelined") for k in c)


def test_two_tier_reduction(four, refs):
    y, c = four["census/two_tier"]
    assert four["census/two_tier_grid"] == (1, 4)
    assert _rel(y, refs[CENSUS, "ddddd"]["matvec"]) < 1e-13
    # the one psum stage launched two staged collectives (c2, then c1)
    assert c["psum"] == 1 and c["collective:hierarchical"] == 2
    # the ring over c2, then a flat all-reduce over c1: one hop and one
    y_r, c_r = four["census/two_tier_ring"]
    assert _rel(y_r, refs[CENSUS, "ddddd"]["matvec"]) < 1e-13
    assert c_r["collective:ring"] == 4 * 2


def test_comm_level_rounds_once_and_restores_the_carrier(four, refs):
    want = refs[CENSUS, "ddddd"]["matvec"]
    assert 1e-10 < _rel(four["census/comm_s"], want) < 1e-6
    assert 1e-6 < _rel(four["census/comm_h"], want) < 2e-2
    assert four["census/comm_dtype"] == "torch.float64"
    # 1 + 2^-40 (and 1) from each of 4 ranks: f32 drops the bit, f64 keeps
    assert four["census/carrier_s"] == ("torch.float64", 4.0)
    assert four["census/carrier_d"] == ("torch.float64",
                                        4.0 + 4 * 2.0 ** -40)
    assert four["census/pair"] == [("torch.float32", 4.0),
                                   ("torch.float32", 8.0)]


def test_mesh_auto_builds_the_modeled_grid(four, refs):
    assert four["census/auto_grid"] == (1, 4)
    assert _rel(four["census/auto_mv"], refs[CENSUS, "ddddd"]["matvec"]) \
        < 1e-13


def test_calibrate_overlap_measures_on_ranks(two):
    eff, entry = two["calibrate"]
    assert 0.0 <= eff <= 1.0
    assert entry["efficiency"] == eff and entry["chunks"] == 4
    assert set(entry["times"]) == {"t_serial", "t_pipelined",
                                   "t_collective", "t_chunk_collective"}
    assert all(t > 0 for t in entry["times"].values())


def test_autotune_on_a_mesh_chooses_as_on_one_device(two):
    from repro_torch.core import FFTMatvec
    config, errors, grid = two["autotune"]
    assert grid == (1, 2)
    one = FFTMatvec.from_block_column(_data(SHAPE)["F"], device="cpu")
    # the same grid priced on one device: the measured errors are the
    # same operator's, to roundoff
    ref = one.autotune(1e-5, timer=_rank_timer, full_result=True, p_c=2)
    assert config == ref.config.to_string()
    assert set(errors) == set(ref.errors)
    # the grid's partial sums round elsewhere than one device's: the
    # errors agree in magnitude, not in bits
    for cfg, e in errors.items():
        assert 0.0 <= e < 1e-2 and (e == 0.0) == (ref.errors[cfg] == 0.0)
