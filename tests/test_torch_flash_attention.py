"""The port's flash attention (``repro_torch.kernels.flash_attention``) on
the CPU, against the JAX package.

On a CPU tensor the wrapper runs its plain version, the same blocked
online softmax as the reference kernel written step by step in PyTorch,
so these tests hold the plain version and the GQA wrapper around it
against the JAX Pallas kernel in interpret mode (as
``tests/test_flash_attention.py`` runs it) and against the oracles.  The
CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.  Tolerances: the reference's own, 2e-5 (f32) and 3e-2
(bf16), which cover two summation orders and bf16's rounding of p.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jax_ref
from repro_torch.backend import UnsupportedOnBackend
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

# tests/test_flash_attention.py's CASES: B, Sq, Skv, Hq, Hkv, Dh
CASES = [
    (1, 128, 128, 2, 2, 32),
    (2, 256, 256, 4, 1, 64),      # MQA
    (2, 128, 256, 8, 2, 32),      # GQA, cross lengths (non-causal only)
    (1, 384, 384, 2, 2, 128),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _inputs(seed, B, Sq, Skv, Hq, Hkv, Dh):
    rng = np.random.default_rng(seed)
    mk = lambda s, h: rng.standard_normal((B, s, h, Dh), dtype=np.float32)  # noqa: E731
    return mk(Sq, Hq), mk(Skv, Hkv), mk(Skv, Hkv)


def _both(arrs, tdt, jdt):
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a).astype(jdt) for a in arrs])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_matches_jax_kernel(B, Sq, Skv, Hq, Hkv, Dh, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    causal = Sq == Skv
    (q, k, v), (jq, jk, jv) = _both(_inputs(0, B, Sq, Skv, Hq, Hkv, Dh),
                                    tdt, jdt)
    got = fa.flash_attention(q, k, v, causal=causal, q_block=64,
                             kv_block=128)
    want = jax_flash(jq, jk, jv, causal=causal, q_block=64, kv_block=128,
                     interpret=True)
    assert got.dtype == tdt and tuple(got.shape) == (B, Sq, Hq, Dh)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    # and the port's oracle against the reference's
    np.testing.assert_allclose(_np(fa.flash_attention_ref(q, k, v,
                                                          causal=causal)),
                               _np(jax_ref(jq, jk, jv, causal=causal)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Skv,Dh,causal,q_block,kv_block", [
    (77, 77, 12, True, 32, 16),       # ragged blocks, Dh 12
    (50, 50, 12, True, 64, 64),       # one block each
    (40, 100, 16, False, 16, 48),     # cross lengths
    (100, 40, 8, True, 24, 24),       # more queries than keys
    (1, 5, 8, False, 256, 256),       # one query
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_oracle_at_ragged_shapes(Sq, Skv, Dh, causal, q_block,
                                               kv_block, dtype):
    tdt, _, tol = DTYPES[dtype]
    q, k, v = (torch.from_numpy(a).to(tdt)
               for a in _inputs(1, 1, Sq, Skv, 3, 3, Dh))
    fold = lambda x: x.transpose(1, 2).reshape(3, x.shape[1], Dh)  # noqa: E731
    got = fa.flash_attention_bh_plain(fold(q), fold(k), fold(v),
                                      causal=causal, q_block=q_block,
                                      kv_block=kv_block)
    want = fold(fa.flash_attention_ref(q, k, v, causal=causal))
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_flash_odd_blocks():
    """S = 96 with the default blocks: the wrapper shrinks them to
    divisors, as the reference's does (its test_flash_odd_blocks)."""
    (q, k, v), (jq, jk, jv) = _both(_inputs(2, 1, 96, 96, 2, 2, 32),
                                    torch.float32, jnp.float32)
    got = fa.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(_np(got), _np(jax_flash(jq, jk, jv,
                                                       causal=True,
                                                       interpret=True)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(got), _np(jax_ref(jq, jk, jv,
                                                     causal=True)),
                               rtol=2e-5, atol=2e-5)


def test_bh_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors flash_attention_bh is its plain version and counts
    no launch; the folded call equals the 4-D wrapper's."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 2, 70, 70, 4, 2, 16))
    _build.reset_launch_counts()
    want = fa.flash_attention(q, k, v, causal=True, q_block=32, kv_block=32)
    kr, vr = (x.repeat_interleave(2, dim=2) for x in (k, v))
    fold = lambda x: x.transpose(1, 2).reshape(8, 70, 16)  # noqa: E731
    got = fa.flash_attention_bh(fold(q), fold(kr), fold(vr), causal=True,
                                q_block=35, kv_block=35)
    np.testing.assert_allclose(got.numpy(), fold(want).numpy(), rtol=2e-5,
                               atol=2e-5)
    assert _build.launch_counts["flash_attention_bh"] == 0


def test_wrapper_rejects_what_the_kernel_cannot_take():
    x = torch.zeros((1, 4, 160))
    with pytest.raises(UnsupportedOnBackend, match="head dim"):
        fa.flash_attention_bh(x, x, x)
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, torch.zeros((1, 4, 2, 16)),
                           torch.zeros((1, 4, 2, 16)))
    with pytest.raises(ValueError, match="query heads"):
        fa.flash_attention(torch.zeros((1, 4, 3, 8)), q, q)


@pytest.mark.parametrize("dtype,head_dim,aligned,entry", [
    (torch.bfloat16, 64, True, "flash_attention_bh_wgmma"),
    (torch.bfloat16, 128, True, "flash_attention_bh_wgmma"),
    (torch.bfloat16, 64, False, "flash_attention_bh"),      # unaligned rows
    (torch.bfloat16, 96, True, "flash_attention_bh"),       # other head dims
    (torch.bfloat16, 32, True, "flash_attention_bh"),
    (torch.bfloat16, 12, True, "flash_attention_bh"),
    (torch.float32, 64, True, "flash_attention_bh_f32"),    # f32: FFMA kernel
    (torch.float32, 128, True, "flash_attention_bh_f32"),
    (torch.float32, 12, True, "flash_attention_bh_f32"),
    (torch.float32, 32, True, "flash_attention_bh_f32"),
    (torch.float32, 96, True, "flash_attention_bh_f32"),
    (torch.float32, 64, False, "flash_attention_bh_f32"),   # unaligned rows
    (torch.float32, 12, False, "flash_attention_bh_f32"),
    (torch.float32, 128, False, "flash_attention_bh_f32"),
])
def test_kernel_choice_is_a_pure_function_of_dtype_head_dim_alignment(
        dtype, head_dim, aligned, entry):
    """The wrapper names the C entry from (dtype, Dh, alignment) alone, and
    each entry has its own launch counter."""
    assert fa.kernel_for(dtype, head_dim, aligned) == entry
    assert entry in fa.KERNELS


def test_kernels_lists_every_c_entry_of_the_source():
    """KERNELS names the three C entries of csrc/flash_attention.cu, each
    declared for ctypes in the build table."""
    assert set(fa.KERNELS) == {"flash_attention_bh", "flash_attention_bh_wgmma",
                               "flash_attention_bh_f32"}
    assert set(_build.ENTRIES["flash_attention"]) == set(fa.KERNELS)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_calls_count_no_launch_on_any_entry(dtype):
    """On CPU tensors both wrappers run the plain version and count no
    launch on any of the three entries."""
    tdt = DTYPES[dtype][0]
    q, k, v = (torch.from_numpy(a).to(tdt)
               for a in _inputs(5, 1, 40, 40, 4, 2, 64))
    _build.reset_launch_counts()
    fa.flash_attention(q, k, v, causal=True)
    fold = lambda x: x.transpose(1, 2).reshape(-1, 40, 64)  # noqa: E731
    kr, vr = (x.repeat_interleave(2, dim=2) for x in (k, v))
    fa.flash_attention_bh(fold(q), fold(kr), fold(vr), causal=False)
    assert all(_build.launch_counts[e] == 0 for e in fa.KERNELS)


@pytest.mark.parametrize("Dh", [12, 32, 96])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("aligned", [True, False])
def test_f32_cpu_path_matches_jax_at_other_head_dims(Dh, causal, aligned):
    """f32 at the head dims the f32 kernel takes besides 64 and 128, with
    ragged lengths (two key heads in groups of 2), on contiguous rows and
    (``aligned`` False) on rows of Dh + 1 floats starting one float in, the
    layout of the kernel's 4-byte copies: on the CPU the wrapper is the
    plain version, and it matches the JAX kernel (interpret mode) and
    oracle at the f32 tolerance."""
    tdt, jdt, tol = DTYPES["float32"]
    Sq, Skv = (70, 70) if causal else (50, 90)
    arrs = _inputs(6, 1, Sq, Skv, 4, 2, Dh)
    (q, k, v), (jq, jk, jv) = _both(arrs, tdt, jdt)
    if not aligned:
        q, k, v = (torch.nn.functional.pad(x, (1, 0))[..., 1:]
                   for x in (q, k, v))
        assert all(x.stride(2) == Dh + 1 for x in (q, k, v))
        assert all(x.data_ptr() % 16 for x in (q, k, v))
    got = fa.flash_attention(q, k, v, causal=causal, q_block=35, kv_block=10)
    want = jax_flash(jq, jk, jv, causal=causal, q_block=35, kv_block=10,
                     interpret=True)
    assert got.dtype == tdt and tuple(got.shape) == (1, Sq, 4, Dh)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(jax_ref(jq, jk, jv,
                                                     causal=causal)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_cpu_path_matches_jax_at_the_wgmma_head_dims(Dh, G):
    """The head dims the wgmma kernel takes on the card, with key-head
    groups of 1, 2 and 8: on the CPU the wrapper is still the plain
    version, and it matches the JAX kernel (interpret mode) and oracle at
    the bf16 tolerance."""
    tdt, jdt, tol = DTYPES["bfloat16"]
    (q, k, v), (jq, jk, jv) = _both(_inputs(4, 1, 64, 64, 2 * G, 2, Dh),
                                    tdt, jdt)
    _build.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=True, q_block=32, kv_block=32)
    assert not any(_build.launch_counts[e] for e in fa.KERNELS)
    want = jax_flash(jq, jk, jv, causal=True, q_block=32, kv_block=32,
                     interpret=True)
    assert got.dtype == tdt and tuple(got.shape) == (1, 64, 2 * G, Dh)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(jax_ref(jq, jk, jv,
                                                     causal=True)),
                               rtol=tol, atol=tol)
