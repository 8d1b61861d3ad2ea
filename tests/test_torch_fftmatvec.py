"""The port's FFTMatvec against the JAX package, end to end on the CPU.

Both packages get the same numpy block column and vectors.  Tolerances
go by the lowest level in the config, as the reference's own tests set
them: d <= 1e-13 (rel L2; two FFT libraries and two summation orders at
f64), s <= 1e-5, h <= 2e-2 (bf16 rounds at other places in the two
frameworks).  The ddddd operator also matches the dense oracle to 1e-13
and satisfies the adjoint identity.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import DispatchTable as JaxTable
from repro.core import ExecOpts as JaxExecOpts
from repro.core import FFTMatvec as JaxFFTMatvec
from repro.core import PrecisionConfig as JaxConfig
from repro.core import pipeline as jpipe
from repro_torch import convert
from repro_torch.core import (FFTMatvec, NAMED_CONFIGS, PrecisionConfig,
                              all_configs, dense_matvec, dense_rmatvec,
                              phase_callables, rel_l2)
from repro_torch.core import pipeline as tpipe
from repro_torch.kernels import _build
from repro_torch.configs.shapes import input_shard_specs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

SHAPE = (16, 4, 40)                    # N_t, N_d, N_m: short-wide, m*4 <= n
# a stand-in mesh: the dims a grid reads (no process group behind it)
_FAKE_MESH = types.SimpleNamespace(mesh_dim_names=("row", "col"),
                                   shape=(1, 2))
TOL = {"d": 1e-13, "s": 1e-5, "h": 2e-2}
PALLAS_INTERPRET = JaxExecOpts(backend="cpu-interpret",
                               dispatch=JaxTable(force="pallas"),
                               fuse_pad_cast=True, block_n=128)

NAMED = [c.to_string() for c in NAMED_CONFIGS]
_rest = [c.to_string() for c in all_configs(("h", "s", "d"))
         if c.to_string() not in NAMED]
SEEDED = [_rest[i] for i in
          sorted(np.random.default_rng(0).choice(len(_rest), 8,
                                                 replace=False))]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    N_t, N_d, N_m = SHAPE
    F = rng.standard_normal((N_t, N_d, N_m)) * \
        (0.5 ** np.arange(N_t))[:, None, None] / np.sqrt(N_m)
    return {"F": F, "m": rng.standard_normal((N_m, N_t)),
            "d": rng.standard_normal((N_d, N_t))}


@pytest.fixture(scope="module")
def op_d(data):
    return FFTMatvec.from_block_column(data["F"], device="cpu")


def _np(a):
    if torch.is_tensor(a):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float64))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _check_against_jax(data, cfg, jopts):
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(data["F"]),
                                         precision=JaxConfig.from_string(cfg),
                                         opts=jopts)
    top = FFTMatvec.from_block_column(data["F"], device="cpu",
                                      precision=PrecisionConfig.from_string(
                                          cfg))
    tol = TOL[top.precision.lowest()]
    y, yj = top.matvec(data["m"]), jop.matvec(jnp.asarray(data["m"]))
    x, xj = top.rmatvec(data["d"]), jop.rmatvec(jnp.asarray(data["d"]))
    assert y.dtype == top.io_dtype and y.shape == (SHAPE[1], SHAPE[0])
    assert x.shape == (SHAPE[2], SHAPE[0])
    assert _rel(y, yj) <= tol, (cfg, _rel(y, yj))
    assert _rel(x, xj) <= tol, (cfg, _rel(x, xj))


@pytest.mark.parametrize("cfg", NAMED + SEEDED)
def test_matvec_rmatvec_match_jax_default_backend(data, cfg):
    _check_against_jax(data, cfg, JaxExecOpts())


@pytest.mark.parametrize("cfg", NAMED)
def test_matvec_rmatvec_match_jax_pallas_interpret(data, cfg):
    _check_against_jax(data, cfg, PALLAS_INTERPRET)


@pytest.mark.parametrize("Nt,Nd,Nm", [(4, 3, 5), (16, 2, 8), (13, 5, 7),
                                      (32, 4, 40)])
def test_ddddd_matches_dense(Nt, Nd, Nm):
    rng = np.random.default_rng(Nt + Nm)
    F = torch.as_tensor(rng.standard_normal((Nt, Nd, Nm)))
    m = torch.as_tensor(rng.standard_normal((Nm, Nt)))
    d = torch.as_tensor(rng.standard_normal((Nd, Nt)))
    op = FFTMatvec.from_block_column(F, device="cpu")
    assert rel_l2(op.matvec(m), dense_matvec(F, m)) < 1e-13
    assert rel_l2(op.rmatvec(d), dense_rmatvec(F, d)) < 1e-13


def test_adjoint_identity(op_d, data):
    m, d = torch.as_tensor(data["m"]), torch.as_tensor(data["d"])
    lhs = torch.dot(op_d.matvec(m).flatten(), d.flatten())
    rhs = torch.dot(m.flatten(), op_d.rmatvec(d).flatten())
    assert abs(lhs - rhs) / abs(lhs) < 1e-13


@pytest.mark.parametrize("cfg", NAMED)
@pytest.mark.parametrize("adjoint", [False, True])
def test_plan_stages_match_jax(cfg, adjoint):
    want = jpipe.matvec_plan(JaxConfig.from_string(cfg), adjoint=adjoint)
    got = tpipe.matvec_plan(PrecisionConfig.from_string(cfg),
                            adjoint=adjoint)
    key = lambda s: (s.kind, s.level, s.adjoint, s.to_tosi)  # noqa: E731
    assert [key(s) for s in got] == [key(s) for s in want]
    assert dict(tpipe.stage_counts(got)) == dict(jpipe.stage_counts(want))


def test_record_stages_counts_match_jax(data):
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(data["F"]))
    top = FFTMatvec.from_block_column(data["F"], device="cpu")
    with jpipe.record_stages() as jc:
        jop.matvec(jnp.asarray(data["m"]))
        jop.rmatvec(jnp.asarray(data["d"]))
    with tpipe.record_stages() as tc:
        top.matvec(data["m"])
        top.rmatvec(data["d"])
    assert dict(tc) == dict(jc)
    assert tc["gemv"] == 2 and tc["reorder"] == 4


@pytest.mark.parametrize("cfg", ["ddddd", "dssdd", "hhhhh"])
def test_convert_from_jax_planes_matches_own_setup(data, cfg):
    jop = JaxFFTMatvec.from_block_column(jnp.asarray(data["F"]),
                                         precision=JaxConfig.from_string(cfg))
    pc = PrecisionConfig.from_string(cfg)
    got = convert.fftmatvec_from_numpy(np.asarray(jop.F_hat_re),
                                       np.asarray(jop.F_hat_im), jop.N_t,
                                       pc, device="cpu")
    own = FFTMatvec.from_block_column(data["F"], precision=pc, device="cpu")
    assert got.F_hat_re.dtype == own.F_hat_re.dtype
    tol = TOL[pc.gemv] if pc.gemv != "h" else 2.0 ** -8
    assert _rel(got.F_hat_re, own.F_hat_re) <= tol
    assert _rel(got.F_hat_im, own.F_hat_im) <= tol
    assert _rel(got.matvec(data["m"]), own.matvec(data["m"])) <= \
        TOL[pc.lowest()]


def test_from_block_column_without_device_raises_on_cpu_only_host(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FFTMatvec.from_block_column(data["F"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.fftmatvec_from_numpy(np.zeros((2, 1, 1)), np.zeros((2, 1, 1)),
                                     1, PrecisionConfig())


@pytest.mark.parametrize("cfg", ["ddddd", "dssdd"])
@pytest.mark.parametrize("adjoint", [False, True])
def test_phase_callables_compose_to_matvec(op_d, data, cfg, adjoint):
    op = op_d.with_precision(PrecisionConfig.from_string(cfg))
    x = torch.as_tensor(data["d"] if adjoint else data["m"])
    phases = phase_callables(op, adjoint=adjoint)
    assert list(phases) == ["pad", "fft", "gemv", "ifft", "reduce"]
    y = x
    for fn in phases.values():
        y = fn(y)
    want = op.rmatvec(x) if adjoint else op.matvec(x)
    assert torch.equal(y, want)


def test_with_precision_and_backend(op_d, data):
    op = op_d.with_precision(PrecisionConfig.from_string("shhss"))
    assert op.F_hat_re.dtype == torch.bfloat16 and op.io_dtype == torch.float32
    ref = op.with_backend("torch-ref")
    assert ref.opts.backend == "torch-ref"
    assert rel_l2(ref.matvec(data["m"]), op.matvec(data["m"])) <= 2e-2
    _build.reset_launch_counts()
    op.rmatvec(data["d"])
    assert sum(_build.launch_counts.values()) == 0


def test_single_column_blocks_match_matvec(op_d, data):
    m = torch.as_tensor(data["m"])
    assert torch.equal(op_d.matmat(m[..., None])[..., 0], op_d.matvec(m))
    assert torch.equal(op_d.matmat(m), op_d.matvec(m))
    d = torch.as_tensor(data["d"])
    assert torch.equal(op_d.rmatmat(d), op_d.rmatvec(d))


@pytest.mark.parametrize("call", [
    # the operator runs on a process grid since item 13a
    # (tests/test_torch_mesh.py); the LM's sharding, the dry run's
    # multi-pod meshes and tile refinement on a mesh wait for item 13b
    lambda op, m: dryrun.lower_fftmatvec_cell(mesh="pod16x16", op=op),
    lambda op, m: make_production_mesh(),
    lambda op, m: input_shard_specs(None, None, dp=("data",),
                                    mesh_shape={"data": 2}),
    lambda op, m: dataclasses.replace(op, mesh=_FAKE_MESH).autotune(
        1e-3, tiles=True),
])
def test_later_slices_raise_not_implemented(op_d, data, call):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call(op_d, torch.as_tensor(data["m"]))


def test_exec_opts_resolve_per_device():
    spec = tpipe.ExecOpts().resolve("cpu").spec
    assert spec.name == "cpu-torch" and spec.platform == "cpu"
    r = dataclasses.replace(tpipe.ExecOpts(), backend="torch-ref").resolve(
        "cpu")
    assert r.spec.reference and r.table.force == "ref"
