"""The port's SBGEMM and Gram kernel modules on the CPU, against the JAX
package.

On a CPU tensor each wrapper runs its plain version (the one host
contraction, ``ref.complex_contract`` / ``ref.gram_contract``), so these
tests hold the plain versions and the dispatch around them against the
JAX oracles and the JAX Pallas kernels in interpret mode.  The CUDA
kernels are held against the plain versions on the card by
``chip_smoke.py``.  Tolerances:

- against the JAX oracles at the inputs' dtype: f64 1e-12 (two summation
  orders), f32 1e-5, bf16 2e-2 (one bf16 rounding of the output);
- against interpret-mode Pallas (f32 accumulation in another order): the
  reference's own ``tests/test_kernels.py`` tolerances, f32 1e-4 and bf16
  2e-2, atol scaled by n / 64;
- the Gram against interpret-mode Pallas: 1e-4, as ``tests/test_gram.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend import DispatchTable as JaxTable
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.backend import DispatchTable, UnsupportedOnBackend
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import sbgemv as tsb

PALLAS = dict(backend="cpu-interpret", dispatch=JaxTable(force="pallas"),
              block_n=128)
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32,
       torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float64, torch.float32, torch.bfloat16]
SMALL = [torch.float32, torch.bfloat16]
TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the reference's GEMM_SHAPES (tests/test_kernels.py), the last unaligned
GEMM_SHAPES = [(3, 4, 128, 4), (2, 100, 640, 1), (1, 8, 512, 16),
               (2, 7, 130, 5)]


def _both(x64: np.ndarray, dt: torch.dtype):
    """The same values in both frameworks at ``dt`` (bf16 made from f32,
    so both sides round once, the same way)."""
    src = x64 if dt == torch.float64 else x64.astype(np.float32)
    return jnp.asarray(src).astype(JNP[dt]), torch.as_tensor(src).to(dt)


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float64))


def _gemm_planes(B, m, n, S, mode, dt, seed):
    rng = np.random.default_rng(seed)
    xlen = n if mode == "N" else m
    arrays = [rng.standard_normal((B, m, n)), rng.standard_normal((B, m, n)),
              rng.standard_normal((B, xlen, S)),
              rng.standard_normal((B, xlen, S))]
    pairs = [_both(a, dt) for a in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _plain(tp, mode, out_dtype):
    if mode == "N":
        return tsb.sbgemm_n_complex(*tp, out_dtype=out_dtype)
    return tsb.sbgemm_th_complex(*tp, conj=(mode == "H"), out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# sbgemm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,m,n,S", GEMM_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mode", ["N", "T", "H"])
def test_sbgemm_plain_matches_oracle(B, m, n, S, dt, mode):
    jp, tp = _gemm_planes(B, m, n, S, mode, dt, seed=B * n + S)
    want = jref.sbgemm_complex_ref(*jp, mode)
    got = _plain(tp, mode, dt)
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == w.shape
        atol = TOL[dt] * (n / 64 if mode == "N" else 1)
        np.testing.assert_allclose(_np(g), _np(w), rtol=TOL[dt], atol=atol)


@pytest.mark.parametrize("B,m,n,S", GEMM_SHAPES)
@pytest.mark.parametrize("dt", SMALL)
@pytest.mark.parametrize("mode", ["N", "T", "H"])
def test_sbgemm_plain_matches_pallas_interpret(B, m, n, S, dt, mode):
    jp, tp = _gemm_planes(B, m, n, S, mode, dt, seed=7 * B + m)
    want = jops.sbgemm(*jp, mode, block_s=8, out_dtype=jnp.float32,
                       **PALLAS)
    got = _plain(tp, mode, torch.float32)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol,
                                   atol=tol * n / 64)


# The edges of the card's bf16 T/H kernel (k = m across its 16-deep
# k-steps and past its 112-wide k-chunk, n around its 112-row items), of
# its f32 N kernel (m around its 20-row warp bands and 100-row items, S
# past its 8- and 32-column passes) and of its f32 T/H kernel (k = m past
# its 16- and 20-wide k-chunks, n around its 128-row items, S past the
# 8- and 32-column passes): the plain versions those kernels are held
# against on the card, against interpret-mode Pallas.
EDGE_CASES = (
    [pytest.param(mode, 2, m, n, 8, torch.bfloat16, id=f"{mode}-bf16-{m}x{n}")
     for mode in "TH" for m in (15, 17, 100) for n in (111, 112, 113)]
    + [pytest.param("N", 2, m, 130, S, torch.float32, id=f"N-f32-{m}-S{S}")
       for m in (25, 100) for S in (9, 33)]
    + [pytest.param(mode, 2, m, n, S, torch.float32,
                    id=f"{mode}-f32-{m}x{n}-S{S}")
       for mode in "TH" for m, n in ((21, 127), (100, 129)) for S in (9, 33)])


@pytest.mark.parametrize("mode,B,m,n,S,dt", EDGE_CASES)
def test_sbgemm_plain_matches_pallas_interpret_at_kernel_edges(mode, B, m, n,
                                                               S, dt):
    jp, tp = _gemm_planes(B, m, n, S, mode, dt, seed=B * m + n + S)
    want = jops.sbgemm(*jp, mode, block_s=8, out_dtype=jnp.float32,
                       **PALLAS)
    got = _plain(tp, mode, torch.float32)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert g.shape == (B, m if mode == "N" else n, S)
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol,
                                   atol=tol * n / 64)


@pytest.mark.parametrize("mode", ["N", "T", "H"])
@pytest.mark.parametrize("force", [None, "torch", "ref"])
def test_sbgemm_equals_columnwise_sbgemv(mode, force):
    """The batched-RHS path reproduces S independent GEMVs."""
    B, m, n, S = 2, 12, 256, 3
    _, tp = _gemm_planes(B, m, n, S, mode, torch.float32, seed=11)
    table = DispatchTable(force=force)
    Yr, Yi = ops.sbgemm(*tp, mode, dispatch=table)
    for s in range(S):
        yr, yi = ops.sbgemv(tp[0], tp[1], tp[2][:, :, s].contiguous(),
                            tp[3][:, :, s].contiguous(), mode, dispatch=table)
        np.testing.assert_allclose(_np(Yr[:, :, s]), _np(yr), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(Yi[:, :, s]), _np(yi), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["N", "T", "H"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("force", [None, "torch", "ref"])
def test_ops_sbgemm_paths_on_cpu_match_oracle(mode, dt, force):
    jp, tp = _gemm_planes(2, 5, 40, 3, mode, dt, seed=3)
    got = ops.sbgemm(*tp, mode, dispatch=DispatchTable(force=force))
    want = jref.sbgemm_complex_ref(*jp, mode)
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == (2, 5 if mode == "N" else 40, 3)
        np.testing.assert_allclose(_np(g), _np(w), rtol=TOL[dt],
                                   atol=TOL[dt] * 10)


def test_sbgemm_out_dtype_casts_from_the_accumulator():
    _, tp = _gemm_planes(2, 3, 20, 2, "H", torch.bfloat16, seed=4)
    y64 = ops.sbgemm(*tp, "H", out_dtype=torch.float64)
    y32 = ops.sbgemm(*tp, "H", out_dtype=torch.float32)
    assert y64[0].dtype == torch.float64
    # f32 accumulation either way: the wide output is the f32 sum exactly
    assert torch.equal(y64[0], y32[0].to(torch.float64))


# ---------------------------------------------------------------------------
# sbgemm_gram
# ---------------------------------------------------------------------------

GRAM_SHAPES = [(3, 4, 16), (1, 2, 40), (2, 8, 8)]
# the f32 Gram kernel's edges on the card: P around its 100-row tile (one
# item a bin up to 100, two-panel items past it), in both spaces (data P =
# m, parameter P = n), K short and past one 64-wide k-chunk
GRAM_F32_EDGES = [(1, 101, 99), (2, 100, 7), (1, 3, 101)]
# f32 cases keep the shape as their id; bf16 cases (the planes the bf16
# tensor-core kernel takes on the card) add "-bf16"
GRAM_CASES = ([pytest.param(*s, torch.float32, id="-".join(map(str, s)))
               for s in GRAM_SHAPES + GRAM_F32_EDGES]
              + [pytest.param(*s, torch.bfloat16,
                              id="-".join(map(str, s)) + "-bf16")
                 for s in GRAM_SHAPES])


def _gram_planes(B, m, n, dt, seed):
    rng = np.random.default_rng(seed)
    pairs = [_both(rng.standard_normal((B, m, n)), dt) for _ in range(2)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("space", ["parameter", "data"])
@pytest.mark.parametrize("B,m,n,dt", GRAM_CASES)
def test_sbgemm_gram_matches_pallas_interpret(space, B, m, n, dt):
    """f32 at 1e-4, as ``tests/test_gram.py``; bf16 at 2e-2 (one bf16
    rounding of the output), both through ``ops.sbgemm_gram`` and as the
    wrapper's plain version computes it for the kernel on the card (f32
    sums of the bf16 products, no symmetrization)."""
    jp, tp = _gram_planes(B, m, n, dt, seed=B + m + n)
    want = jops.sbgemm_gram(*jp, space=space, **PALLAS)
    got = ops.sbgemm_gram(*tp, space=space)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    P = n if space == "parameter" else m
    for g, w in zip(got, want):
        assert g.shape == (B, P, P) and g.dtype == dt
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)
    raw = tsb.sbgemm_gram_complex(*tp, data=space == "data",
                                  out_dtype=torch.float32)
    for g, w in zip(raw, want):
        assert g.shape == (B, P, P) and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("space", ["parameter", "data"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("force", [None, "torch", "ref"])
def test_sbgemm_gram_is_exactly_hermitian_and_matches_oracle(space, dt,
                                                             force):
    jp, tp = _gram_planes(2, 3, 12, dt, seed=5)
    G_re, G_im = ops.sbgemm_gram(*tp, space=space,
                                 dispatch=DispatchTable(force=force))
    assert G_re.dtype == dt
    assert torch.equal(G_re, G_re.transpose(1, 2))
    assert torch.equal(G_im, -G_im.transpose(1, 2))
    assert not torch.diagonal(G_im, dim1=1, dim2=2).any()
    want = jref.sbgemm_gram_ref(*jp, space)
    for g, w in zip((G_re, G_im), want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=TOL[dt],
                                   atol=TOL[dt] * 10)


@pytest.mark.parametrize("dt,data,P,entry", [
    (torch.bfloat16, True, 1, "sbgemm_gram_complex_wgmma"),
    (torch.bfloat16, True, 100, "sbgemm_gram_complex_wgmma"),   # N_d
    (torch.bfloat16, True, 128, "sbgemm_gram_complex_wgmma"),
    (torch.bfloat16, True, 129, "sbgemm_gram_complex"),    # two tiles a bin
    (torch.bfloat16, False, 100, "sbgemm_gram_complex"),   # parameter space
    (torch.bfloat16, True, 0, "sbgemm_gram_complex"),
    (torch.float32, True, 100, "sbgemm_gram_complex"),
    (torch.float64, True, 100, "sbgemm_gram_complex"),
])
def test_gram_kernel_choice_is_a_pure_function_of_dtype_space_and_P(
        dt, data, P, entry):
    """The Gram wrapper names its C entry from (dtype, space, P) alone: the
    wgmma kernel takes the data space of bf16 planes at P <= 128."""
    assert tsb.gram_kernel_for(dt, data, P) == entry


@pytest.mark.parametrize("B,m,n", [(1, 65, 77), (1, 100, 130), (2, 128, 7)])
def test_bf16_data_gram_at_the_wgmma_edges_matches_pallas_interpret(B, m, n):
    """The data-space bf16 Gram at the wgmma kernel's edges (P across its
    two 64-row warpgroups, n odd, ragged against its 64-wide k-chunks): on
    the CPU the wrapper is its plain version, which matches the reference
    kernel (interpret mode) at the h tolerance and counts no launch."""
    jp, tp = _gram_planes(B, m, n, torch.bfloat16, seed=m + n)
    want = jops.sbgemm_gram(*jp, space="data", **PALLAS)
    _build.reset_launch_counts()
    raw = tsb.sbgemm_gram_complex(*tp, data=True, out_dtype=torch.float32)
    assert not _build.launch_counts
    for g, w in zip(raw, want):
        assert g.shape == (B, m, m) and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-2, atol=2e-2)


def test_gram_plain_reads_data_space_in_stored_layout():
    """The kernel's data flag computes A A^H from A as stored; its plain
    version equals the reference's route through the conjugate-transposed
    planes, bit for bit at f64."""
    _, (Ar, Ai) = _gram_planes(3, 5, 9, torch.float64, seed=6)
    got = tsb.sbgemm_gram_complex(Ar, Ai, data=True)
    want = ref.gram_contract(Ar.transpose(1, 2).contiguous(),
                             (-Ai).transpose(1, 2).contiguous(), "parameter")
    for g, w in zip(got, want):
        assert g.shape == (3, 5, 5)
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-14, atol=1e-14)


# ---------------------------------------------------------------------------
# Wrapper contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    lambda A, X: tsb.sbgemm_n_complex(A, A, X, X),               # X length
    lambda A, X: tsb.sbgemm_th_complex(A, A, X[..., 0], X[..., 0],
                                       conj=True),              # no RHS axis
    lambda A, X: tsb.sbgemm_th_complex(A, A.float(), X, X, conj=True),
    lambda A, X: tsb.sbgemm_th_complex(A, A, X.transpose(0, 1), X,
                                       conj=False),
    lambda A, X: tsb.sbgemm_th_complex(A.half(), A.half(), X.half(),
                                       X.half(), conj=True),
    lambda A, X: tsb.sbgemm_gram_complex(A, A[:, :2]),
    lambda A, X: tsb.sbgemm_gram_complex(A[0], A[0]),
    lambda A, X: tsb.sbgemm_gram_complex(A.transpose(1, 2), A, data=True),
    lambda A, X: ops.sbgemm_gram(A, A, space="bogus"),
    lambda A, X: ops.sbgemm(A, A, X, X, "X"),
])
def test_sbgemm_wrappers_reject_what_the_kernels_do_not_take(bad):
    A = torch.zeros(2, 3, 8, dtype=torch.float64)
    X = torch.zeros(2, 3, 4, dtype=torch.float64)
    with pytest.raises((ValueError, TypeError)):
        bad(A, X)


def test_forced_kernel_on_cpu_raises():
    A = torch.zeros(2, 3, 40)
    X = torch.zeros(2, 40, 2)
    with pytest.raises(UnsupportedOnBackend):
        ops.sbgemm(A, A, X, X, "N", dispatch=DispatchTable(force="kernel"))
    with pytest.raises(UnsupportedOnBackend):
        ops.sbgemm(A, A, X, X, "N", backend="h100")
    with pytest.raises(UnsupportedOnBackend):
        ops.sbgemm_gram(A, A, space="data", backend="h100")
    with pytest.raises(UnsupportedOnBackend):
        ops.sbgemm_gram(A, A, dispatch=DispatchTable(force="kernel"))


def test_launch_counters_stay_zero_on_cpu():
    _build.reset_launch_counts()
    A = torch.randn(2, 3, 40)
    X, Xm = torch.randn(2, 40, 2), torch.randn(2, 3, 2)
    tsb.sbgemm_n_complex(A, A, X, X)
    tsb.sbgemm_th_complex(A, A, Xm, Xm, conj=True)
    tsb.sbgemm_gram_complex(A, A, data=True)
    ops.sbgemm(A, A, X, X, "N")
    ops.sbgemm_gram(A, A)
    assert sum(_build.launch_counts.values()) == 0


def test_sbgemm_source_declares_its_entries():
    """Every C entry the wrappers call is declared in the build table with
    the argument counts its source defines (a tiled entry's level array is
    its one ``const int*``)."""
    src = (_build.CSRC / "sbgemm.cu").read_text()
    for entry, (n_ptrs, n_sizes, n_ints) in _build.ENTRIES["sbgemm"].items():
        head = src[src.index(f"int {entry}("):]
        sig = head[:head.index(")")]
        assert sig.count("void*") + sig.count("int*") == n_ptrs + 1  # + stream
        assert sig.count("int64_t") == n_sizes
        assert sig.count("int ") - 1 == n_ints            # - the return


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("mode", ["N", "T", "H"])
@pytest.mark.parametrize("dt", DTYPES)
def test_strided_views_take_the_contiguous_result(S, mode, dt):
    """The untiled complex products take a chunk of A's rows (N) or
    columns (T/H) as a view of the whole plane, with no copy; the plain
    versions on such views equal the call on a contiguous copy bit for
    bit (the card's kernels are held the same way by chip_smoke.py)."""
    gen = torch.Generator().manual_seed(3)
    B, m, n = 3, 9, 20
    A_re, A_im = (torch.randn((B, m, n), generator=gen).to(dt)
                  for _ in range(2))
    if mode == "N":
        views = [A.narrow(1, 2, 5) for A in (A_re, A_im)]
        xlen = n
    else:
        views = [A.narrow(2, 7, 9) for A in (A_re, A_im)]
        xlen = m
    assert not views[0].is_contiguous()
    shape = (B, xlen, S) if S > 1 else (B, xlen)
    x_re, x_im = (torch.randn(shape, generator=gen).to(dt) for _ in range(2))
    fn = tsb.sbgemm_n_complex if S > 1 else tsb.sbgemv_n_complex
    if mode != "N":
        fn = tsb.sbgemm_th_complex if S > 1 else tsb.sbgemv_th_complex
    kw = {} if mode == "N" else {"conj": mode == "H"}
    got = fn(*views, x_re, x_im, **kw)
    want = fn(*(v.contiguous() for v in views), x_re, x_im, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # through the dispatch as the pipelined gemv calls it
    op = ops.sbgemm if S > 1 else ops.sbgemv
    for g, w in zip(op(*views, x_re, x_im, mode), want):
        assert torch.equal(g, w)
    assert tsb._a_strides(views[0]) == (m * n, n)


def test_strided_entries_check_their_layout():
    A = torch.zeros((2, 4, 6), dtype=torch.float64)
    x = torch.zeros((2, 4), dtype=torch.float64)
    cols = A.transpose(1, 2)                    # unit stride on the rows
    with pytest.raises(ValueError, match="contiguous columns"):
        tsb.sbgemv_th_complex(cols, cols, x[:, :1].expand(2, 6).contiguous(),
                              x[:, :1].expand(2, 6).contiguous(), conj=True)
    with pytest.raises(ValueError, match="differ in strides"):
        tsb.sbgemv_th_complex(A[:, :, :3], A[:, :, :3].contiguous(), x, x,
                              conj=True)
    with pytest.raises(ValueError, match="contiguous planes"):
        tsb.sbgemv_th_complex(A, A, x.T.contiguous().T, x, conj=True)
    # the tiled and real entries take contiguous planes only
    with pytest.raises(ValueError, match="contiguous planes"):
        tsb.sbgemv_th_complex_tiled(A[:, :, :3], A[:, :, :3], x, x,
                                    (("d",),), conj=True)
    # a strided entry's sizes carry A's strides; its FLOPs count the shape
    assert set(tsb.STRIDED_ENTRIES) <= {
        e for entries in _build.ENTRIES.values() for e in entries}
    assert _build.ENTRIES["sbgemv"]["sbgemv_n_complex"] == (6, 5, 3)
    assert _build.ENTRIES["sbgemm"]["sbgemm_th_complex"] == (6, 6, 4)
    assert tsb._flops("sbgemm_n_complex", (A, A, x, x),
                      (2, 4, 6, 3, 24, 6), ()) == 8 * 2 * 4 * 6 * 3
