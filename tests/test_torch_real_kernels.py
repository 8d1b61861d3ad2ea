"""The port's real-A products (``ops.sbgemv_real`` / ``ops.sbgemm_real``
and the six real kernels' plain versions) on the CPU, against the JAX
package, and the Fig. 1 twin.

On a CPU tensor each real wrapper runs its plain version (the one host
contraction, ``ref.real_contract``), so these tests hold the plain versions
and the dispatch around them against the JAX Pallas kernels in interpret
mode and the JAX oracles.  The CUDA kernels are held against the plain
versions, and each tiled build bit for bit against its untiled build on
planes quantized up front, on the card by ``chip_smoke.py``.  Tolerances:

- against interpret-mode Pallas: the reference's own ``tests/
  test_kernels.py`` tolerances, f32 1e-4 and bf16 2e-2, atol 4x (S = 1)
  and 8x (S > 1);
- f64 against the JAX oracles under x64: 1e-12 (two summation orders);
- quantization: bit for bit; tiled products against the JAX tiled oracle
  at 1e-5 (the same quantized operand, two f32 summation orders).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import DispatchTable as JaxTable
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.backend import CPU_TORCH, DispatchTable, UnsupportedOnBackend
from repro_torch.examples import fig1_sbgemv as fig1
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import sbgemv as tsb

PALLAS = dict(backend="cpu-interpret", dispatch=JaxTable(force="pallas"),
              block_n=128)
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32,
       torch.bfloat16: jnp.bfloat16}
# the reference's shape (tests/test_kernels.py) and a ragged one
SHAPES = [(3, 24, 384), (2, 7, 130)]
# the four patterns of tests/test_tile_precision.py
PATTERNS = {
    "all-low": (("h", "h"), ("h", "h")),
    "all-high": (("d", "d"), ("d", "d")),
    "checkerboard": (("h", "s"), ("s", "h")),
    "single-hot": (("d", "h"), ("h", "h")),
}
GATED = dataclasses.replace(CPU_TORCH, name="cpu-torch-nogate",
                            tile_precision=False)


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float64))


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 8: np.int64}[a.itemsize])


def _inputs(B, m, n, mode, S, dt, seed):
    """A and x (S None: (B, len)) or X (B, len, S), the same values in both
    frameworks at ``dt`` (bf16 made from f32, so both sides round once)."""
    rng = np.random.default_rng(seed)
    xlen = n if mode == "N" else m
    arrays = [rng.standard_normal((B, m, n)),
              rng.standard_normal((B, xlen) if S is None else (B, xlen, S))]
    if dt != torch.float64:
        arrays = [a.astype(np.float32) for a in arrays]
    return ([jnp.asarray(a).astype(JNP[dt]) for a in arrays],
            [torch.as_tensor(a).to(dt) for a in arrays])


def _plain(A, x, mode, out_dtype):
    """The wrapper of the kernel ``ops`` takes for this product (its plain
    version on the CPU)."""
    d = "n" if mode == "N" else "th"
    fn = getattr(tsb, f"sbgemv_{d}_real" if x.ndim == 2 else f"sbgemm_{d}_real")
    return fn(A, x, out_dtype=out_dtype)


def _ops(A, x, mode, **kw):
    return (ops.sbgemv_real if x.ndim == 2 else ops.sbgemm_real)(A, x, mode,
                                                                 **kw)


@functools.lru_cache(maxsize=None)
def _jax_pallas(shape, dt, mode, S):
    jp, _ = _inputs(*shape, mode, S, dt, seed=sum(shape) + (S or 1))
    if S is None:
        y = jops.sbgemv_real(*jp, mode, out_dtype=jnp.float32, **PALLAS)
    else:
        y = jops.sbgemm_real(*jp, mode, block_s=8, out_dtype=jnp.float32,
                             **PALLAS)
    return _np(y)


# ---------------------------------------------------------------------------
# Against the JAX Pallas kernels (interpret mode) and oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["plain", "ops"])
@pytest.mark.parametrize("S", [None, 6])
@pytest.mark.parametrize("mode", ["N", "T"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_real_products_match_pallas_interpret(shape, dt, mode, S, which):
    _, (A, x) = _inputs(*shape, mode, S, dt, seed=sum(shape) + (S or 1))
    got = (_plain(A, x, mode, torch.float32) if which == "plain"
           else _ops(A, x, mode, out_dtype=torch.float32))
    want = _jax_pallas(shape, dt, mode, S)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * (4 if S is None else 8))


# The real SBGEMMs' layouts on the card, whose edges these shapes straddle
# (every pass 8, 16 or 32 columns wide: S = 8, 9, 16, 17, 32, 33):
# - bf16 N (zgemm_bf16_kernel, REAL): 7 warps of 16-row tiles, items of
#   112 rows, k-chunks of 256 (192 at S > 16), 16-byte copies where n % 8
#   == 0, else element copies;
# - bf16 T: items of 224 output rows (warp w: tiles w and w + 7), k = m in
#   112-wide chunks;
# - f32 N (zgemm_f32_kernel, REAL): 3 warps of 40-row bands (a band of at
#   most 24 rows: a 3-row lane tile), items of 100 rows, k-chunks of 64 (32
#   at S > 16), 16-byte copies where n % 4 == 0;
# - f32 T (zgemm_th_f32_kernel, REAL): items of 256 output rows, 64-row warp
#   bands, k-chunks of 20 (16 at S > 16).
REAL_GEMM_EDGES = [
    # bf16 N: m around the 16-row tiles and the 112-row item; n odd, n % 8
    # != 0, past the 256-wide chunk
    (torch.bfloat16, "N", 15, 130, 8), (torch.bfloat16, "N", 16, 264, 9),
    (torch.bfloat16, "N", 17, 133, 16), (torch.bfloat16, "N", 111, 257, 17),
    (torch.bfloat16, "N", 112, 520, 32), (torch.bfloat16, "N", 113, 40, 33),
    # f32 N: m around the 3-row tile (24), the 40-row bands and the 100-row
    # item; n past the 64-wide chunk, odd, n % 4 != 0
    (torch.float32, "N", 24, 65, 8), (torch.float32, "N", 25, 64, 9),
    (torch.float32, "N", 39, 130, 17), (torch.float32, "N", 41, 133, 32),
    (torch.float32, "N", 99, 263, 33), (torch.float32, "N", 100, 65, 16),
    (torch.float32, "N", 101, 129, 8),
    # bf16 T: n around the 112 rows of the first tiles and the 224-row
    # item; k = m past one 112-wide chunk
    (torch.bfloat16, "T", 7, 111, 8), (torch.bfloat16, "T", 16, 112, 9),
    (torch.bfloat16, "T", 113, 113, 16), (torch.bfloat16, "T", 100, 127, 17),
    (torch.bfloat16, "T", 17, 128, 32), (torch.bfloat16, "T", 129, 225, 33),
    # f32 T: n around the 64-row bands, the 128 rows of the complex item and
    # the 256-row item; k = m past one 20- or 16-wide chunk
    (torch.float32, "T", 21, 63, 9), (torch.float32, "T", 17, 64, 16),
    (torch.float32, "T", 100, 255, 32), (torch.float32, "T", 7, 256, 33),
    (torch.float32, "T", 129, 257, 17), (torch.float32, "T", 20, 129, 8),
]


@pytest.mark.parametrize("dt, mode, m, n, S", REAL_GEMM_EDGES,
                         ids=[f"{str(c[0])[6:]}-{c[1]}-{c[2]}x{c[3]}-S{c[4]}"
                              for c in REAL_GEMM_EDGES])
def test_real_sbgemm_layout_edges_match_pallas_interpret(dt, mode, m, n, S):
    shape = (2, m, n)
    _, (A, X) = _inputs(*shape, mode, S, dt, seed=sum(shape) + S)
    got = _plain(A, X, mode, torch.float32)
    want = _jax_pallas(shape, dt, mode, S)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("mode", ["N", "T"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_bf16_carrier_tiled_real_is_the_untiled_product(pattern, mode):
    """At a bf16 carrier every cell's rounding is the identity, so the tiled
    real product is the untiled one bit for bit (the card's tiled bf16
    builds run the untiled kernel on this ground), in the port's plain
    versions and in the JAX oracles; the port's tiled product agrees with
    the JAX tiled oracle at the bf16 tolerance."""
    levels = PATTERNS[pattern]
    jp, (A, X) = _inputs(4, 16, 256, mode, 6, torch.bfloat16, seed=11)
    d = "n" if mode == "N" else "th"
    tiled = getattr(tsb, f"sbgemm_{d}_real_tiled")
    untiled = getattr(tsb, f"sbgemm_{d}_real")
    for od in (torch.bfloat16, torch.float32):
        assert torch.equal(tiled(A, X, levels, out_dtype=od),
                           untiled(A, X, out_dtype=od))
    jt = jref.sbgemm_tiled_real_ref(*jp, levels, mode)
    assert jt.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(jt), _np(jref.sbgemm_real_ref(*jp, mode)))
    np.testing.assert_allclose(
        _np(tiled(A, X, levels, out_dtype=torch.float32)), _np(jt),
        rtol=2e-2, atol=2e-2 * 8)


@pytest.mark.parametrize("force", [None, "torch", "ref", "plain"])
@pytest.mark.parametrize("S", [None, 6])
@pytest.mark.parametrize("mode", ["N", "T"])
@pytest.mark.parametrize("shape", SHAPES)
def test_real_products_f64_match_jax_oracle(shape, mode, S, force):
    jp, (A, x) = _inputs(*shape, mode, S, torch.float64, seed=5)
    want = _np((jref.sbgemv_real_ref if S is None
                else jref.sbgemm_real_ref)(*jp, mode))
    got = (_plain(A, x, mode, torch.float64) if force == "plain"
           else _ops(A, x, mode, dispatch=DispatchTable(force=force)))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    err = np.linalg.norm(_np(got) - want) / np.linalg.norm(want)
    assert err <= 1e-12, err


@pytest.mark.parametrize("S", [None, 3])
@pytest.mark.parametrize("mode", ["N", "T"])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32, torch.bfloat16])
def test_real_oracles_match_jax_oracles(dt, mode, S):
    """The port's ``sbgemv_real_ref`` / ``sbgemm_real_ref`` and the JAX
    ones give the input dtype and agree at its level."""
    jp, tp = _inputs(2, 5, 33, mode, S, dt, seed=6)
    fj, ft = ((jref.sbgemv_real_ref, ref.sbgemv_real_ref) if S is None
              else (jref.sbgemm_real_ref, ref.sbgemm_real_ref))
    got, want = ft(*tp, mode), _np(fj(*jp, mode))
    assert got.dtype == dt
    tol = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2e-2}[dt]
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * 10)


# ---------------------------------------------------------------------------
# Tile-centric precision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 131])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_real_quantized_A_bitwise_equal_jax(pattern, dt, n):
    rng = np.random.default_rng(2)
    B, m = 4, 16
    A = rng.standard_normal((B, m, n)).astype(
        np.float64 if dt == torch.float64 else np.float32)
    levels = PATTERNS[pattern]
    want = np.asarray(jref.quantize_tile_planes(
        jref.expand_tile_levels(levels, B, n), jnp.asarray(A)))
    got = ref.quantize_tile_cells(levels, torch.as_tensor(A)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("lowering", ["ref", "torch", "plain"])
@pytest.mark.parametrize("S", [1, 6])
@pytest.mark.parametrize("mode", ["N", "T"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_real_tiled_products_match_jax_oracle(pattern, mode, S, lowering):
    levels = PATTERNS[pattern]
    B, m, n = 4, 16, 256                # C = 2: a cell boundary at 128
    jp, (A, X) = _inputs(B, m, n, mode, S, torch.float32, seed=7)
    want = _np(jref.sbgemm_tiled_real_ref(*jp, levels, mode))
    if lowering == "plain":
        tiled = tsb.sbgemm_n_real_tiled if mode == "N" else \
            tsb.sbgemm_th_real_tiled
        got = tiled(A, X, levels)
    else:
        got = ops.sbgemm_real(A, X, mode, tile_map=levels,
                              dispatch=DispatchTable(force=lowering))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = np.linalg.norm(_np(got) - want) / np.linalg.norm(want)
    assert err <= 1e-5, err
    # the port's own oracle is its "ref" lowering, bit for bit
    if lowering == "ref":
        assert torch.equal(got, ref.sbgemm_tiled_real_ref(A, X, levels, mode))


@pytest.mark.parametrize("force", [None, "torch", "ref"])
@pytest.mark.parametrize("mode", ["N", "T"])
def test_sbgemv_real_tiled_delegates_to_sbgemm(mode, force):
    """``sbgemv_real(tile_map=)`` is the S = 1 column of the tiled SBGEMM,
    bit for bit (no S = 1 real tiled build exists)."""
    _, (A, x) = _inputs(2, 8, 256, mode, None, torch.float32, seed=8)
    table = DispatchTable(force=force)
    levels = PATTERNS["checkerboard"]
    y = ops.sbgemv_real(A, x, mode, tile_map=levels, dispatch=table)
    Y = ops.sbgemm_real(A, x[..., None], mode, tile_map=levels, dispatch=table)
    assert torch.equal(y, Y[..., 0])


def test_tile_map_on_a_backend_without_tile_precision_raises():
    A, x = torch.zeros(2, 3, 8), torch.zeros(2, 8)
    levels = PATTERNS["checkerboard"]
    with pytest.raises(UnsupportedOnBackend):
        ops.sbgemv_real(A, x, "N", tile_map=levels, backend=GATED)
    with pytest.raises(UnsupportedOnBackend):
        ops.sbgemm_real(A, x[..., None], "N", tile_map=levels, backend=GATED)
    # without a map the same backend serves the product
    assert ops.sbgemv_real(A, x, "N", backend=GATED).shape == (2, 3)


# ---------------------------------------------------------------------------
# Dispatch contract (as tests/test_backend.py's explicit-vs-auto test)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda A, x, X, **kw: ops.sbgemv_real(A, x, "T", **kw),
    lambda A, x, X, **kw: ops.sbgemm_real(A, X, "T", **kw),
    lambda A, x, X, **kw: ops.sbgemm_real(A, X, "T", tile_map=(("h",),), **kw),
], ids=["sbgemv_real", "sbgemm_real", "sbgemm_real_tiled"])
def test_explicit_kernel_raises_auto_takes_the_plain_path(call):
    A = torch.ones(2, 4, 64, dtype=torch.float64)
    x = torch.ones(2, 4, dtype=torch.float64)
    X = torch.ones(2, 4, 3, dtype=torch.float64)
    with pytest.raises(UnsupportedOnBackend):
        call(A, x, X, dispatch=DispatchTable(force="kernel"))
    with pytest.raises(UnsupportedOnBackend):
        call(A, x, X, backend="h100")
    out = call(A, x, X)                  # auto on the CPU: plain, keeps f64
    assert out.dtype == torch.float64 and out.shape[:2] == (2, 64)


@pytest.mark.parametrize("force", [None, "torch", "ref"])
def test_real_out_dtype_defaults_to_A_and_casts_from_the_accumulator(force):
    _, (A, x) = _inputs(2, 3, 20, "T", None, torch.bfloat16, seed=9)
    table = DispatchTable(force=force)
    assert ops.sbgemv_real(A, x, "T", dispatch=table).dtype == torch.bfloat16
    y64 = ops.sbgemv_real(A, x, "T", out_dtype=torch.float64, dispatch=table)
    y32 = ops.sbgemv_real(A, x, "T", out_dtype=torch.float32, dispatch=table)
    assert y64.dtype == torch.float64
    if force != "ref":     # the oracle returns A's dtype, then casts
        assert torch.equal(y64, y32.to(torch.float64))


@pytest.mark.parametrize("bad", [
    lambda A, x, X: ops.sbgemv_real(A, x, "H"),
    lambda A, x, X: ops.sbgemm_real(A, X, "X"),
    lambda A, x, X: ops.sbgemv_real(A, x, "H", tile_map=(("h",),)),
    lambda A, x, X: tsb.sbgemv_n_real(A, x),                     # x length
    lambda A, x, X: tsb.sbgemv_th_real(A, X),                    # RHS axis
    lambda A, x, X: tsb.sbgemm_th_real(A, x),                    # no RHS axis
    lambda A, x, X: tsb.sbgemm_n_real(A, X),                     # X length
    lambda A, x, X: tsb.sbgemm_th_real(A.float(), X),            # dtypes
    lambda A, x, X: tsb.sbgemm_th_real(A.half(), X.half()),
    lambda A, x, X: tsb.sbgemm_th_real(A, X.transpose(0, 1)),
    lambda A, x, X: tsb.sbgemm_th_real_tiled(A[0], X, (("h",),)),
    lambda A, x, X: tsb.sbgemv_th_real(A.transpose(1, 2).contiguous()
                                       .transpose(1, 2), x),     # layout
])
def test_real_wrappers_reject_what_the_kernels_do_not_take(bad):
    A = torch.zeros(2, 3, 8, dtype=torch.float64)
    x = torch.zeros(2, 3, dtype=torch.float64)
    X = torch.zeros(2, 3, 4, dtype=torch.float64)
    with pytest.raises((ValueError, TypeError)):
        bad(A, x, X)


def test_real_launch_counters_stay_zero_on_cpu():
    _build.reset_launch_counts()
    A = torch.randn(2, 3, 40)
    x, xm = torch.randn(2, 40), torch.randn(2, 3)
    tsb.sbgemv_n_real(A, x)
    tsb.sbgemv_th_real(A, xm)
    tsb.sbgemm_n_real(A, x[..., None])
    tsb.sbgemm_th_real_tiled(A, xm[..., None], (("h",),))
    ops.sbgemv_real(A, x, "N")
    ops.sbgemm_real(A, xm[..., None], "T", tile_map=(("h", "s"),))
    assert sum(_build.launch_counts.values()) == 0


@pytest.mark.parametrize("source", ["sbgemv", "sbgemm_real"])
def test_real_entries_are_declared_as_their_sources_define(source):
    """Each real C entry is in the build table with the argument counts
    its source defines (a tiled entry's level array is its one
    ``const int*``); ``sbgemm_real.cu`` builds the entries of
    ``sbgemm.cu`` under ``SBGEMM_REAL_ENTRIES``."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    if source == "sbgemm_real":
        assert '#define SBGEMM_REAL_ENTRIES\n#include "sbgemm.cu"' in src
        full = (_build.CSRC / "sbgemm.cu").read_text()
        src = full[full.index("#else  // sbgemm_real.cu"):]
    real = {k: v for k, v in _build.ENTRIES[source].items() if "_real" in k}
    assert set(real) == ({"sbgemv_n_real", "sbgemv_th_real"}
                         if source == "sbgemv" else set(_build.ENTRIES[source]))
    assert len(real) == (2 if source == "sbgemv" else 4)
    for entry, (n_ptrs, n_sizes, n_ints) in real.items():
        head = src[src.index(f"int {entry}("):]
        sig = head[:head.index(")")]
        assert sig.count("void*") + sig.count("int*") == n_ptrs + 1  # + stream
        assert sig.count("int64_t") == n_sizes
        assert sig.count("int ") - 1 == n_ints            # - the return


@pytest.mark.parametrize("source, want", [
    ("pad_cast", ["common.cuh", "pad_cast.cu"]),
    ("sbgemv", ["common.cuh", "sbgemv.cu"]),
    ("sbgemm", ["common.cuh", "sbgemm.cu", "sbgemm_bf16.cuh",
                "sbgemm_f32.cuh", "wgmma.cuh"]),
    ("sbgemm_real", ["common.cuh", "sbgemm.cu", "sbgemm_bf16.cuh",
                     "sbgemm_f32.cuh", "sbgemm_real.cu", "wgmma.cuh"]),
    ("flash_attention", ["common.cuh", "flash_attention.cu", "wgmma.cuh"]),
])
def test_each_library_hashes_only_its_own_sources(source, want):
    """A library's build name covers its source and what it includes, so
    an edit to another kernel's source rebuilds nothing else."""
    assert _build._sources(source) == want


def test_default_device_lives_in_the_backend():
    from repro_torch.backend import default_device
    from repro_torch.core import toeplitz
    assert toeplitz.default_device is default_device
    assert default_device("cpu") == torch.device("cpu")


def test_resolve_backend_dispatch_defaults_to_the_card(monkeypatch):
    spec, table = ops.resolve_backend_dispatch(device="cpu")
    assert spec.name == "cpu-torch" and spec.platform == "cpu"
    assert table == DispatchTable()
    spec, table = ops.resolve_backend_dispatch("torch-ref", device="cpu")
    assert spec.reference and table == DispatchTable(force="ref")
    # no device named: the card, as every entry point of the port
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.resolve_backend_dispatch()


# ---------------------------------------------------------------------------
# The Fig. 1 twin
# ---------------------------------------------------------------------------

def test_fig1_cases_extend_the_reference():
    assert fig1.CASES[:-1] == [
        (16, 4096, "c32"), (64, 4096, "c32"), (100, 5000, "c32"),
        (256, 4096, "c32"), (100, 5000, "c64"), (64, 4096, "r32")]
    assert fig1.CASES[-1] == (100, 5000, "r64")
    assert fig1.SMOKE_CASES == [(16, 512, "c32"), (16, 512, "r32")]
    assert fig1.BATCH == 100


def test_fig1_smoke_on_the_cpu(capsys):
    assert fig1.main(["--device", "cpu", "--smoke"]) == 0
    out = capsys.readouterr().out
    assert "host clock" in out and "HBM" not in out
    rows = fig1.run("cpu", smoke=True, verbose=False)
    assert [(r["m"], r["n"], r["dtype"]) for r in rows] == fig1.SMOKE_CASES
    for r in rows:
        assert r["batch"] == fig1.BATCH
        # CPU tensors take the plain version: no kernel launched
        assert r["launches"] == {}
        paths = ("kernel", "stock") + (("library",) if r["dtype"][0] == "c"
                                       else ())
        for p in paths:
            assert r[f"{p}_ms"] > 0 and f"{p}_hbm_share" not in r
        # on the CPU ops runs the plain version itself
        assert r["max_abs_err"] == 0.0 and r["rel_err"] == 0.0


@pytest.mark.parametrize("dname", ["c32", "r32"])
def test_fig1_stock_passes_compute_the_kernel_function(dname):
    """The stock pass and the library call compute A^H x (A^T x, real),
    as the JAX benchmark's ``_split_pass`` does."""
    rng = np.random.default_rng(10)
    B, m, n = 3, 5, 17
    Ar, Ai = rng.standard_normal((B, m, n)), rng.standard_normal((B, m, n))
    xr, xi = rng.standard_normal((B, m)), rng.standard_normal((B, m))
    t = [torch.as_tensor(a) for a in (Ar, Ai, xr, xi)]
    if dname == "r32":
        want = jref.sbgemv_real_ref(jnp.asarray(Ar), jnp.asarray(xr), "T")
        got = torch.bmm(t[0].mT, t[2][..., None])[..., 0]
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12)
        return
    want = jref.sbgemv_complex_ref(*map(jnp.asarray, (Ar, Ai, xr, xi)), "H")
    for g, w in zip(fig1.split_pass(*t), want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=1e-12)
