"""Tile-centric precision in the port, against the JAX package.

The same numpy inputs go through the JAX oracles (``repro.kernels.ref``,
and the JAX operator on its ``xla-ref`` backend) and through the port's
oracles, its dispatch (``ops.sbgemv/sbgemm/sbgemm_gram(tile_map=)``), its
tiled kernels' plain versions (which the wrappers run for CPU tensors) and
its operator.  The CUDA kernels are held against those plain versions, and
bit for bit against the untiled kernels on planes quantized up front, on
the card by ``chip_smoke.py``.  Tolerances:

- quantization: bit for bit (both sides round f64 -> bf16 through f32);
- tiled products against the JAX oracle: f64 1e-12, f32 1e-5 relative
  (the same quantized operand, two summation orders);
- the data-space tiled Gram: against the oracle at f32 scale (rtol 1e-4,
  atol 5e-4, as ``tests/test_tile_precision.py``), never against JAX's
  kernel path, whose own data-space test fails by 2.4e-4 (ROADMAP §3);
- operators with a ``tiles=`` config against JAX: the tolerance of the
  lowest effective level (d 1e-12, s 1e-5, h 2e-2).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FFTMatvec as JaxFFTMatvec
from repro.core import PrecisionConfig as JaxConfig
from repro.kernels import ref as jref
from repro_torch.backend import CPU_TORCH, DispatchTable, UnsupportedOnBackend
from repro_torch.core import FFTMatvec, PrecisionConfig, TileMap, rel_l2
from repro_torch.core import pipeline
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sbgemv as tsb

TOL = {"d": 1e-12, "s": 1e-5, "h": 2e-2}
MAPS = {"2x2": (("d", "s"), ("s", "h")),
        "3x3": (("h", "s", "d"), ("s", "d", "h"), ("d", "h", "s"))}
LEVEL = {torch.float64: "d", torch.float32: "s"}
GATED = dataclasses.replace(CPU_TORCH, name="cpu-torch-nogate",
                            tile_precision=False)
# Values whose f64 -> bf16 rounding differs between one rounding and two
# (through f32): 1 + 2^-8 + 2^-30 is 1.0 through f32, 1.0078125 directly;
# the others are exact ties and near-ties at both steps.  (Subnormals are
# left out: XLA's CPU casts flush them to zero, torch's and CUDA's do not.)
TIES = np.array([1 + 2.0 ** -8 + 2.0 ** -30, 1 + 2.0 ** -8,
                 1 + 3 * 2.0 ** -8, 1 + 2.0 ** -24 + 2.0 ** -50,
                 1 + 2.0 ** -24, -(1 + 2.0 ** -8 + 2.0 ** -30)])


def _np(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.to(torch.float64).numpy()
    return np.array(jnp.asarray(t).astype(jnp.float64))


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 8: np.int64}[a.itemsize])


def _planes(rng, B, m, n, xlen, S, dt):
    src = [rng.standard_normal((B, m, n)), rng.standard_normal((B, m, n))]
    shape = (B, xlen) if S is None else (B, xlen, S)
    src += [rng.standard_normal(shape), rng.standard_normal(shape)]
    npdt = np.float64 if dt == torch.float64 else np.float32
    src = [a.astype(npdt) for a in src]
    return [jnp.asarray(a) for a in src], [torch.as_tensor(a) for a in src]


def _close(got, want, tol):
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= tol, err


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("tmap", sorted(MAPS))
def test_quantized_planes_bitwise_equal_jax(dt, tmap):
    rng = np.random.default_rng(1)
    B, m, n = 7, 3, 23
    npdt = np.float64 if dt == torch.float64 else np.float32
    A = rng.standard_normal((B, m, n))
    A.flat[:TIES.size] = TIES
    A.flat[-TIES.size:] = TIES
    A = A.astype(npdt)
    levels = MAPS[tmap]
    want = np.asarray(jref.quantize_tile_planes(
        jref.expand_tile_levels(levels, B, n), jnp.asarray(A)))
    idx = ref.expand_tile_levels(levels, B, n)
    np.testing.assert_array_equal(idx.numpy(),
                                  jref.expand_tile_levels(levels, B, n))
    elementwise = ref.quantize_tile_planes(idx, torch.as_tensor(A)).numpy()
    cellwise = ref.quantize_tile_cells(levels, torch.as_tensor(A)).numpy()
    np.testing.assert_array_equal(_bits(elementwise), _bits(want))
    np.testing.assert_array_equal(_bits(cellwise), _bits(want))
    assert not np.array_equal(cellwise, A)      # the map bites


def test_tie_values_round_through_f32():
    A = torch.as_tensor(np.tile(TIES[:3], (1, 1, 1)))
    q = ref.quantize_tile_cells((("h",),), A)
    assert q[0, 0, 0].item() == 1.0                  # two roundings
    assert q[0, 0, 1].item() == 1.0                  # tie to even
    assert q[0, 0, 2].item() == 1.015625             # tie to even, upward


def test_tile_bounds_match_the_elementwise_partition():
    for parts, extent in ((3, 1001), (2, 5000), (3, 2), (8, 5)):
        b = ref.tile_bounds(parts, extent)
        cells = [(i * parts) // extent for i in range(extent)]
        for r in range(parts):
            assert cells[b[r]:b[r + 1]] == [r] * (b[r + 1] - b[r])


# ---------------------------------------------------------------------------
# tiled products: oracle, dispatch paths and the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("tmap", sorted(MAPS))
@pytest.mark.parametrize("mode", ["N", "T", "H"])
@pytest.mark.parametrize("S", [None, 1, 5])
def test_tiled_products_match_jax(dt, tmap, mode, S):
    rng = np.random.default_rng(2)
    B, m, n = 5, 6, 37                 # 3x3 cells cut both axes raggedly
    xlen = n if mode == "N" else m
    jp, tp = _planes(rng, B, m, n, xlen, S, dt)
    levels = MAPS[tmap]
    if S is None:      # a GEMV: the JAX oracle on the one-column panel
        jw = jref.sbgemm_tiled_ref(*jp[:2], jp[2][..., None],
                                   jp[3][..., None], levels, mode)
        want = [w[..., 0] for w in jw]
    else:
        want = jref.sbgemm_tiled_ref(*jp, levels, mode)
    tol = TOL[LEVEL[dt]]
    _close(ref.sbgemm_tiled_ref(*tp, levels, mode), want, tol)
    entry = ops.sbgemv if S is None else ops.sbgemm
    tm = TileMap(levels)
    for kw in ({}, {"backend": "torch-ref"},
               {"dispatch": DispatchTable(force="torch")}):
        got = entry(*tp, mode, tile_map=tm, **kw)
        assert got[0].dtype == dt
        _close(got, want, tol)
    kname = f"{'sbgemv' if S is None else 'sbgemm'}_" \
            f"{'n' if mode == 'N' else 'th'}_complex_tiled"
    kw = {} if mode == "N" else {"conj": mode == "H"}
    _close(getattr(tsb, kname)(*tp, levels, **kw), want, tol)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_at_carrier_map_is_the_untiled_product(dt):
    rng = np.random.default_rng(3)
    _, tp = _planes(rng, 4, 5, 33, 33, 3, dt)
    top = TileMap.uniform(LEVEL[dt], (3, 3))
    for path in ("torch", "ref"):
        table = DispatchTable(force=path)
        got = ops.sbgemm(*tp, "N", tile_map=top, dispatch=table)
        want = ops.sbgemm(*tp, "N", dispatch=table)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("space", ["parameter", "data"])
@pytest.mark.parametrize("tmap", sorted(MAPS))
def test_tiled_gram_against_the_oracle(space, tmap):
    rng = np.random.default_rng(4)
    B, m, n = 4, 12, 37
    src = [rng.standard_normal((B, m, n)).astype(np.float32)
           for _ in range(2)]
    levels = MAPS[tmap]
    want = jref.sbgemm_gram_tiled_ref(*(jnp.asarray(a) for a in src), levels,
                                      space=space)
    tp = [torch.as_tensor(a) for a in src]
    for kw in ({}, {"backend": "torch-ref"}):
        got = ops.sbgemm_gram(*tp, space=space, tile_map=TileMap(levels), **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=5e-4)
        assert torch.equal(got[0], got[0].mT)
        assert torch.equal(got[1], -got[1].mT)
    plain = tsb.sbgemm_gram_tiled(*tp, levels, data=(space == "data"))
    for g, w in zip(plain, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=5e-4)


def test_tile_map_gating_and_kernel_path():
    A = torch.ones((2, 3, 8))
    X = torch.ones((2, 8, 2))
    tm = TileMap.uniform("h", (2, 2))
    with pytest.raises(UnsupportedOnBackend, match="tile"):
        ops.sbgemm(A, A, X, X, "N", tile_map=tm, backend=GATED)
    with pytest.raises(UnsupportedOnBackend, match="tile"):
        ops.sbgemv(A, A, X[..., 0], X[..., 0], "N", tile_map=tm,
                   backend=GATED)
    with pytest.raises(UnsupportedOnBackend, match="tile"):
        ops.sbgemm_gram(A, A, tile_map=tm, backend=GATED)
    ops.sbgemm(A, A, X, X, "N", backend=GATED)       # no map: fine
    # the kernel path never takes CPU tensors, map or not
    with pytest.raises(UnsupportedOnBackend, match="card"):
        ops.sbgemm(A, A, X, X, "N", tile_map=tm, backend="h100")
    with pytest.raises(ValueError, match="8 x 8"):
        tsb._level_grid(TileMap.uniform("h", (9, 1)))


# ---------------------------------------------------------------------------
# operators with a tiles= config
# ---------------------------------------------------------------------------

CONFIGS = ["ddddd;tiles=ds|sh", "dssdd;tiles=hs|sh", "dsdds;tiles=hsd|sdh"]


def _lowest(cfg: PrecisionConfig) -> str:
    levels = list(cfg.levels()) + [lvl for row in cfg.gemv_tile_levels()
                                   for lvl in row]
    return min(levels, key="hsd".index)


def _operators(cfg_s, shape=(16, 3, 24), seed=5):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal(shape) / np.sqrt(shape[2])
    jop = JaxFFTMatvec.from_block_column(
        jnp.asarray(F), precision=JaxConfig.from_string(cfg_s),
        backend="xla-ref")
    top = FFTMatvec.from_block_column(
        F, precision=PrecisionConfig.from_string(cfg_s), device="cpu")
    return rng, jop, top


@pytest.mark.parametrize("cfg_s", CONFIGS)
def test_tiled_operator_matches_jax(cfg_s):
    rng, jop, top = _operators(cfg_s)
    cfg = top.precision
    tol = TOL[_lowest(cfg)]
    N_t, N_d, N_m = 16, 3, 24
    m = rng.standard_normal((N_m, N_t))
    d = rng.standard_normal((N_d, N_t))
    M = rng.standard_normal((N_m, N_t, 3))
    D = rng.standard_normal((N_d, N_t, 3))

    def both(name, x, j=None):
        j = j or (lambda v: getattr(jop, name)(v))
        got = getattr(top, name)(torch.as_tensor(x))
        assert rel_l2(got, torch.as_tensor(_np(j(jnp.asarray(x))))) <= tol
        return got

    both("matvec", m)
    both("rmatvec", d)
    both("matmat", M)
    both("rmatmat", D)
    for space, x in (("parameter", M), ("data", D)):
        got = top.gram(space=space).apply(torch.as_tensor(x))
        want = jop.gram(space=space).apply(jnp.asarray(x))
        assert rel_l2(got, torch.as_tensor(_np(want))) <= tol


@pytest.mark.parametrize("cfg_s", CONFIGS)
def test_tiled_operator_is_untiled_on_prequantized_F_hat(cfg_s):
    rng, _, top = _operators(cfg_s)
    cfg = top.precision
    plain = dataclasses.replace(top, precision=cfg.replace(tiles=None))
    Fr, Fi = ref.quantize_tile_cells(cfg.gemv_tile_levels(), top.F_hat_re,
                                     top.F_hat_im)
    quant = dataclasses.replace(plain, F_hat_re=Fr, F_hat_im=Fi)
    m = torch.as_tensor(rng.standard_normal((24, 16)))
    d = torch.as_tensor(rng.standard_normal((3, 16)))
    M = torch.as_tensor(rng.standard_normal((24, 16, 3)))
    for name, x in (("matvec", m), ("rmatvec", d), ("matmat", M)):
        assert torch.equal(getattr(top, name)(x), getattr(quant, name)(x))
        assert not torch.equal(getattr(top, name)(x), getattr(plain, name)(x))
    for space in ("parameter", "data"):
        x = M if space == "parameter" else torch.as_tensor(
            rng.standard_normal((3, 16, 2)))
        assert torch.equal(top.gram(space=space).apply(x),
                           quant.gram(space=space).apply(x))


def test_plans_carry_the_effective_map_on_F_only():
    cfg = PrecisionConfig.from_string("dssdd;tiles=hd|sh")
    gemvs = [s for s in pipeline.matvec_plan(cfg) if s.kind == "gemv"]
    assert [s.tile_map for s in gemvs] == [TileMap.from_string("hs|sh")]
    exact = [s for s in pipeline.gram_plan(cfg) if s.kind == "gemv"]
    assert all(s.tile_map == TileMap.from_string("hs|sh") for s in exact)
    circ = [s for s in pipeline.gram_plan(cfg, mode="circulant")
            if s.kind == "gemv"]
    assert circ[0].operand == "G" and circ[0].tile_map is None
    untiled = [s for s in pipeline.matvec_plan(cfg.replace(tiles=None))
               if s.kind == "gemv"]
    assert untiled[0].tile_map is None
