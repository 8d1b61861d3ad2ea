"""Parity of the port's precision configs with the JAX package.

The module is pure Python on both sides, so every comparison is exact:
the codec, the lattice order and the cost rank agree over all 243
phase-uniform configs, and the ``;tiles=`` codec round-trips the same way.
"""

import jax.numpy as jnp
import pytest
import torch

from repro.core import precision as jprec
from repro_torch.core import precision as tprec

JAX_ALL = list(jprec.all_configs(("h", "s", "d")))
TORCH_ALL = list(tprec.all_configs(("h", "s", "d")))


def test_all_configs_enumerate_identically():
    assert len(TORCH_ALL) == 243
    assert [c.to_string() for c in TORCH_ALL] == \
        [c.to_string() for c in JAX_ALL]


@pytest.mark.parametrize("levels", [("d", "s"), ("s", "h"), ("h", "s", "d")])
def test_cost_rank_and_codec_agree(levels):
    for jc, tc in zip(jprec.all_configs(levels), tprec.all_configs(levels)):
        assert tc.to_string() == jc.to_string()
        assert tprec.PrecisionConfig.from_string(jc.to_string()) == tc
        assert tc.cost_rank() == jc.cost_rank()
        assert tc.highest() == jc.highest()
        assert tc.reorder_level("fft", "gemv") == jc.reorder_level("fft",
                                                                   "gemv")


@pytest.mark.parametrize("chunk", range(3))
def test_config_le_lt_agree_over_all_pairs(chunk):
    # 243 x 243 pairs, split in three so each case stays short
    rows = range(chunk * 81, (chunk + 1) * 81)
    for i in rows:
        ja, ta = JAX_ALL[i], TORCH_ALL[i]
        for jb, tb in zip(JAX_ALL, TORCH_ALL):
            assert tprec.config_le(ta, tb) == jprec.config_le(ja, jb)
            assert tprec.config_lt(ta, tb) == jprec.config_lt(ja, jb)


TILED = ["dssdd;tiles=hs|sh", "sssss;tiles=h", "ddddd;tiles=hhs|sdd",
         "shhss;tiles=ds|ss|hd", "hhhhh;tiles=dd"]


@pytest.mark.parametrize("s", TILED)
def test_tiles_codec_and_order(s):
    jc, tc = jprec.PrecisionConfig.from_string(s), \
        tprec.PrecisionConfig.from_string(s)
    assert tc.to_string() == jc.to_string() == s
    assert tc.gemv_tile_levels() == jc.gemv_tile_levels()
    assert tc.cost_rank() == jc.cost_rank()
    assert tc.tiles.shape == jc.tiles.shape
    assert tc.tiles.min_level() == jc.tiles.min_level()
    assert tc.tiles.is_uniform() == jc.tiles.is_uniform()
    for other in TILED + ["ddddd", "hhhhh", "sssss"]:
        jo, to = jprec.PrecisionConfig.from_string(other), \
            tprec.PrecisionConfig.from_string(other)
        assert tprec.config_le(tc, to) == jprec.config_le(jc, jo)
        assert tprec.tile_le(tc.tiles, tc.tiles)
        if to.tiles is not None:
            assert tprec.tile_le(tc.tiles, to.tiles) == \
                jprec.tile_le(jc.tiles, jo.tiles)


def test_named_configs_and_levels_match():
    for name in ("DOUBLE", "SINGLE", "TPU_FAST", "PAPER_OPT_F",
                 "PAPER_OPT_FSTAR", "PAPER_OPT_F_LARGE", "TPU_OPT_F"):
        assert getattr(tprec, name).to_string() == \
            getattr(jprec, name).to_string()
    assert [c.to_string() for c in tprec.NAMED_CONFIGS] == \
        ["ddddd", "dssdd", "ddssd", "dssds", "sssss", "shhss", "hhhhh"]
    assert tprec.MACHINE_EPS == jprec.MACHINE_EPS
    jmap = {jnp.float64: torch.float64, jnp.float32: torch.float32,
            jnp.bfloat16: torch.bfloat16, jnp.complex128: torch.complex128,
            jnp.complex64: torch.complex64}
    for lvl in "hsd":
        assert tprec.real_dtype(lvl) == jmap[jprec.real_dtype(lvl)]
        assert tprec.fft_compute_dtype(lvl) == \
            jmap[jprec.fft_compute_dtype(lvl)]
        assert tprec.complex_dtype(lvl) == jmap[jprec.complex_dtype(lvl)]
        for other in "hsd":
            assert tprec.min_level(lvl, other) == jprec.min_level(lvl, other)


@pytest.mark.parametrize("bad", ["dddd", "ddddx", "dssdd;tiles=hx",
                                 "dssdd;tiles=hs|s"])
def test_bad_strings_raise_like_the_reference(bad):
    with pytest.raises(ValueError):
        jprec.PrecisionConfig.from_string(bad)
    with pytest.raises(ValueError):
        tprec.PrecisionConfig.from_string(bad)
