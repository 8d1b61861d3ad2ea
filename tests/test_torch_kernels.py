"""The port's kernel modules on the CPU, against the JAX package.

On a CPU tensor every kernel wrapper runs its plain version, so these
tests hold the plain versions (and the dispatch around them) against the
JAX Pallas kernels in interpret mode and the JAX oracles.  The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.  Tolerances:

- pad/unpad: bitwise (a copy and one rounding per element);
- sbgemv: f32 1e-4 and bf16 2e-2 against interpret-mode Pallas (the
  reference's own ``tests/test_kernels.py`` tolerances: f32 accumulation
  in another order), f64 1e-12 against the f64 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import TPU_PALLAS
from repro.backend import DispatchTable as JaxTable
from repro.kernels import ops as jops
from repro.kernels import padding as jpadding
from repro.kernels import ref as jref
from repro.kernels.pad_cast import pad_cast as jax_pad_cast
from repro.kernels.pad_cast import unpad_cast as jax_unpad_cast
from repro_torch.backend import (H100, DispatchTable, UnsupportedOnBackend,
                                 probe_backend, resolve_backend)
from repro_torch.kernels import _build, ops, padding, ref
from repro_torch.kernels import pad_cast as tpad
from repro_torch.kernels import sbgemv as tsb

PALLAS = dict(backend="cpu-interpret", dispatch=JaxTable(force="pallas"),
              block_n=128)
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32,
       torch.bfloat16: jnp.bfloat16}
SMALL = [torch.bfloat16, torch.float32]


def _both(x64: np.ndarray, dt: torch.dtype):
    """The same values in both frameworks at ``dt``.  bf16 is made from
    f32 so both sides round once, in the same way."""
    src = x64 if dt == torch.float64 else x64.astype(np.float32)
    return jnp.asarray(src).astype(JNP[dt]), torch.as_tensor(src).to(dt)


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float64))


def _data(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape)
    # values whose f64 -> bf16 cast rounds differently once vs through f32
    x.flat[:2] = [1 + 2.0 ** -8 + 2.0 ** -30, -(1 + 2.0 ** -8 + 2.0 ** -30)]
    return x


# ---------------------------------------------------------------------------
# pad_cast / unpad_cast
# ---------------------------------------------------------------------------

# (7, 96, 200): rows of whole 16-byte vectors at every dtype pair, the
# kernel's vector path on the card
@pytest.mark.parametrize("R,T,P", [(8, 100, 200), (16, 33, 66), (7, 96, 200)])
@pytest.mark.parametrize("din", SMALL)
@pytest.mark.parametrize("dout", SMALL)
def test_pad_cast_plain_matches_pallas(R, T, P, din, dout):
    jx, tx = _both(_data((R, T), 0), din)
    got = tpad.pad_cast(tx, P, dout)
    # the JAX kernel takes whole blocks of rows: one block where R % 8 != 0
    want = jax_pad_cast(jx, P, JNP[dout], block_rows=8 if R % 8 == 0 else R,
                        interpret=True)
    assert got.dtype == dout and got.shape == (R, P)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("R,P,keep", [(8, 200, 100), (16, 66, 33)])
@pytest.mark.parametrize("din", SMALL)
@pytest.mark.parametrize("dout", SMALL)
def test_unpad_cast_plain_matches_pallas(R, P, keep, din, dout):
    jx, tx = _both(_data((R, P), 1), din)
    got = tpad.unpad_cast(tx, keep, dout)
    want = jax_unpad_cast(jx, keep, JNP[dout], interpret=True)
    assert got.is_contiguous()
    np.testing.assert_array_equal(_np(got), _np(want))


F64_PAIRS = [(torch.float64, d) for d in (torch.float64, torch.float32,
                                          torch.bfloat16)] + \
    [(d, torch.float64) for d in SMALL]


@pytest.mark.parametrize("din,dout", F64_PAIRS)
def test_pad_unpad_f64_pairs_match_reference_oracles(din, dout):
    jx, tx = _both(_data((5, 7), 2), din)
    np.testing.assert_array_equal(_np(tpad.pad_cast(tx, 12, dout)),
                                  _np(jref.pad_cast_ref(jx, 12, JNP[dout])))
    np.testing.assert_array_equal(_np(tpad.unpad_cast(tx, 4, dout)),
                                  _np(jref.unpad_cast_ref(jx, 4, JNP[dout])))
    # the port's own oracles are the same function
    assert torch.equal(tpad.pad_cast(tx, 12, dout),
                       ref.pad_cast_ref(tx, 12, dout))


def test_f64_to_bf16_rounds_through_f32():
    x = torch.tensor([1 + 2.0 ** -8 + 2.0 ** -30], dtype=torch.float64)
    assert ref.cast(x, torch.bfloat16).item() == 1.0
    assert tpad.pad_cast(x[None], 2, torch.bfloat16)[0, 0].item() == 1.0


def test_pad_cast_takes_row_strided_views():
    wide = torch.randn(6, 20, dtype=torch.float64)
    got = tpad.pad_cast(wide[:, :9], 14, torch.float32)
    assert torch.equal(got[:, :9], wide[:, :9].to(torch.float32))
    assert not got[:, 9:].any()
    # a view one column in (the kernel's element path on the card), held
    # against the JAX kernel on the same values
    x = wide[:, 1:1 + 8]
    got = tpad.pad_cast(x, 16, torch.float32)
    want = jax_pad_cast(jnp.asarray(x.numpy()), 16, jnp.float32,
                        block_rows=x.shape[0], interpret=True)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("bad", [
    lambda: tpad.pad_cast(torch.zeros(4, 6).T, 8, torch.float32),
    lambda: tpad.pad_cast(torch.zeros(4, 6, dtype=torch.float16), 8,
                          torch.float32),
    lambda: tpad.pad_cast(torch.zeros(4, 6), 5, torch.float32),
    lambda: tpad.unpad_cast(torch.zeros(4, 6), 7, torch.float32),
    lambda: tpad.unpad_cast(torch.zeros(2, 4, 6), 3, torch.float32),
])
def test_pad_wrappers_reject_what_the_kernel_does_not_take(bad):
    with pytest.raises((ValueError, TypeError)):
        bad()


# ---------------------------------------------------------------------------
# sbgemv
# ---------------------------------------------------------------------------

# (3, 5, 264) and (2, 7, 1000): whole 16-byte vectors at every dtype and a
# lane tail in the N kernel on the card
SHAPES = [(3, 4, 128), (2, 7, 130), (2, 16, 256), (3, 5, 264), (2, 7, 1000)]


def _planes(B, m, n, mode, dt, seed):
    rng = np.random.default_rng(seed)
    xlen = n if mode == "N" else m
    arrays = [rng.standard_normal((B, m, n)), rng.standard_normal((B, m, n)),
              rng.standard_normal((B, xlen)), rng.standard_normal((B, xlen))]
    pairs = [_both(a, dt) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _plain(tp, mode, out_dtype):
    if mode == "N":
        return tsb.sbgemv_n_complex(*tp, out_dtype=out_dtype)
    return tsb.sbgemv_th_complex(*tp, conj=(mode == "H"), out_dtype=out_dtype)


@pytest.mark.parametrize("B,m,n", SHAPES)
@pytest.mark.parametrize("dt", SMALL)
@pytest.mark.parametrize("mode", ["N", "T", "H"])
def test_sbgemv_plain_matches_pallas_interpret(B, m, n, dt, mode):
    jp, tp = _planes(B, m, n, mode, dt, seed=B * m + n)
    want = jops.sbgemv(*jp, mode, out_dtype=jnp.float32, **PALLAS)
    got = _plain(tp, mode, torch.float32)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        # N sums over the long axis: scale atol with n, as the reference does
        atol = tol * (n / 64 if mode == "N" else 1)
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=atol)


@pytest.mark.parametrize("B,m,n", SHAPES)
@pytest.mark.parametrize("mode", ["N", "T", "H"])
def test_sbgemv_plain_matches_oracle_f64(B, m, n, mode):
    jp, tp = _planes(B, m, n, mode, torch.float64, seed=7)
    want = jref.sbgemv_complex_ref(*jp, mode)
    got = _plain(tp, mode, torch.float64)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["N", "T", "H"])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("force", [None, "torch", "ref"])
def test_ops_sbgemv_paths_on_cpu_match_oracle(mode, dt, force):
    jp, tp = _planes(2, 5, 40, mode, dt, seed=3)
    got = ops.sbgemv(*tp, mode, dispatch=DispatchTable(force=force))
    want = jref.sbgemv_complex_ref(*jp, mode)
    tol = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2e-2}[dt]
    for g, w in zip(got, want):
        assert g.dtype == dt
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("bad", [
    lambda A, x: tsb.sbgemv_n_complex(A, A, x, x),                # x length
    lambda A, x: tsb.sbgemv_th_complex(A.transpose(1, 2).contiguous()
                                       .transpose(1, 2), A, x, x, conj=True),
    lambda A, x: tsb.sbgemv_th_complex(A, A.float(), x, x, conj=True),
    lambda A, x: tsb.sbgemv_th_complex(A[0], A[0], x, x, conj=True),
    lambda A, x: tsb.sbgemv_th_complex(A.half(), A.half(), x.half(),
                                       x.half(), conj=True),
])
def test_sbgemv_wrappers_reject_what_the_kernel_does_not_take(bad):
    A = torch.zeros(2, 3, 8, dtype=torch.float64)
    x = torch.zeros(2, 3, dtype=torch.float64)
    with pytest.raises((ValueError, TypeError)):
        bad(A, x)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

GRID = [(m, n) for m in (1, 4, 7, 100, 512) for n in (3, 16, 128, 400, 5000)]
NAMES = {"pallas": "kernel", "xla": "torch", "ref": "ref"}


@pytest.mark.parametrize("mode", ["N", "T", "H"])
@pytest.mark.parametrize("force", [None, "ref"])
def test_gemv_path_matches_jax_dispatch(mode, force):
    """Where the TPU table picks its kernel or the oracle, the H100 table
    picks the same.  Where the TPU table's short-wide crossover sends a
    shape to XLA, the H100 table keeps the kernel: on the card no shape
    falls back to plain PyTorch (the kernels mask their own edges)."""
    jt, tt = JaxTable(force=force), DispatchTable(force=force)
    jax_paths = set()
    for m, n in GRID:
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = NAMES[jt.gemv_path(m, n, mode, jdt, TPU_PALLAS)]
            jax_paths.add(want)
            got = tt.gemv_path(tdt, H100)
            assert got == ("kernel" if want == "torch" else want)
            # f64 is a native kernel datapath on the card
            assert tt.gemv_path(torch.float64, H100) == got
    # the grid crosses the TPU table's crossover in auto mode
    assert jax_paths == ({"kernel", "torch"} if force is None else {"ref"})


def test_paper_shape_takes_the_kernels():
    t = DispatchTable()
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        assert t.gemv_path(dt, H100) == "kernel"
    # auto dispatch on the card raises for a dtype the kernels do not take
    with pytest.raises(UnsupportedOnBackend):
        t.gemv_path(torch.float16, H100)
    assert DispatchTable(force="torch").gemv_path(torch.float16,
                                                  H100) == "torch"


def test_cpu_tensors_take_the_plain_paths():
    spec = probe_backend("cpu")
    assert spec.name == "cpu-torch" and not spec.kernels
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        assert DispatchTable().gemv_path(dt, spec) == "torch"
    x = torch.randn(3, 10)
    assert torch.equal(ops.pad_cast(x, 16, torch.float32),
                       ref.pad_cast_ref(x, 16, torch.float32))
    ref_spec = resolve_backend("torch-ref", "cpu")
    assert DispatchTable().gemv_path(torch.float32, ref_spec) == "ref"


def test_backend_env_override(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BACKEND", "torch-ref")
    assert probe_backend("cpu").name == "torch-ref"
    monkeypatch.delenv("REPRO_TORCH_BACKEND")
    assert probe_backend("cpu").name == "cpu-torch"


def test_forced_kernel_on_cpu_raises():
    A = torch.zeros(2, 3, 40)
    x = torch.zeros(2, 40)
    with pytest.raises(UnsupportedOnBackend):
        ops.sbgemv(A, A, x, x, "N", dispatch=DispatchTable(force="kernel"))
    # the h100 spec picks the kernel, but the data is not on the card
    with pytest.raises(UnsupportedOnBackend):
        ops.sbgemv(A, A, x, x, "N", backend="h100")
    with pytest.raises(UnsupportedOnBackend):
        ops.pad_cast(x, 80, torch.float32, backend="h100")
    with pytest.raises(UnsupportedOnBackend):
        ops.unpad_cast(x, 20, torch.float32, backend="h100")
    with pytest.raises(UnsupportedOnBackend):
        DispatchTable(force="kernel").gemv_path(torch.float16, H100)
    with pytest.raises(UnsupportedOnBackend):
        DispatchTable(force="kernel").gemv_path(torch.float32,
                                                probe_backend("cpu"))
    with pytest.raises(ValueError):
        DispatchTable(force="pallas")


def test_launch_counters_stay_zero_on_cpu():
    _build.reset_launch_counts()
    A = torch.randn(2, 3, 40)
    x, xm = torch.randn(2, 40), torch.randn(2, 3)
    tsb.sbgemv_n_complex(A, A, x, x)
    tsb.sbgemv_th_complex(A, A, xm, xm, conj=True)
    tpad.pad_cast(x, 80, torch.float32)
    tpad.unpad_cast(x, 20, torch.float32)
    ops.sbgemv(A, A, x, x, "N")
    assert sum(_build.launch_counts.values()) == 0


@pytest.mark.parametrize("axis,multiple", [(0, 8), (1, 128), (-1, 5),
                                           (2, 3)])
def test_padding_helpers_match_jax(axis, multiple):
    x = np.random.default_rng(5).standard_normal((3, 7, 10))
    got, n0 = padding.pad_to_multiple(torch.as_tensor(x), axis, multiple)
    want, j0 = jpadding.pad_to_multiple(jnp.asarray(x), axis, multiple)
    assert n0 == j0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    planes, size = padding.pad_planes((torch.as_tensor(x),) * 2, axis,
                                      multiple)
    assert size == j0 and all(p.shape == want.shape for p in planes)
    assert padding.round_up(13, multiple) == jpadding.round_up(13, multiple)

