"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU, against the
JAX package's ``repro.models.moe.moe_ffn``, on the same numpy inputs.

At f32 (operands and weights) the outputs agree within the reference's
decode bound, 2e-4 (rtol and atol), once the test has asserted that no
token's k-th and (k+1)-th router probabilities lie within 1e-5 (a near
tie could route the token differently under another summation order).
Routing indices and keep masks are equal wherever that gap exceeds 1e-5.
At the default policy (bf16 operands) a small router difference can flip
a near tie, so the output is held, within 3e-2 of the largest |y|, on the
tokens whose chosen and kept experts agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe

GAP = 1e-5


def _inputs(B, S, D, E, Fd, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    router = rng.standard_normal((D, E), dtype=np.float32) * D ** -0.5
    wg, wu = (rng.standard_normal((E, D, Fd), dtype=np.float32) * D ** -0.5
              for _ in range(2))
    wd = rng.standard_normal((E, Fd, D), dtype=np.float32) * Fd ** -0.5
    return x, router, wg, wu, wd


def _jax_routing(x, router, top_k, cf, group):
    """The reference's routing, op for op (``moe_ffn`` and
    ``_dispatch_group``): probs, idx, keep with a leading group axis."""
    B, S, D = x.shape
    E = router.shape[-1]
    T = B * S
    gs = min(group, T)
    while T % gs:
        gs -= 1
    xg = x.reshape(T // gs, gs, D)
    logits = jnp.einsum("gsd,de->gse", xg, router.astype(x.dtype),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate, idx = jax.lax.top_k(probs, top_k)
    gate = gate / jnp.maximum(jnp.sum(gate, -1, keepdims=True), 1e-9)
    C = max(1, int(gs * top_k * cf / E))
    keep = jax.vmap(lambda a, i, g: jmoe._dispatch_group(a, i, g, E, C)[2])(
        xg, idx, gate)
    return np.asarray(probs), np.asarray(idx), np.asarray(keep), C


def _run(args, top_k, cf, group, dtype):
    """(port y, port Routing, reference y, reference routing)."""
    x, router, wg, wu, wd = args
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    kw = dict(top_k=top_k, capacity_factor=cf, group_size=group)
    jx = jnp.asarray(x).astype(jd)
    jw = [jnp.asarray(w).astype(jd) for w in (wg, wu, wd)]
    want, jaux = jax.jit(lambda *a: jmoe.moe_ffn(*a, **kw))(
        jx, jnp.asarray(router), *jw)
    tx = torch.from_numpy(x).to(dtype)
    tw = [torch.from_numpy(w).to(dtype) for w in (wg, wu, wd)]
    routed = []
    route = moe.route
    try:
        moe.route = lambda *a, **k: routed.append(route(*a, **k)) or routed[-1]
        got, aux = moe.moe_ffn(tx, torch.from_numpy(router), *tw, **kw)
    finally:
        moe.route = route
    return (got, aux, routed[0], np.asarray(want.astype(jnp.float32)),
            float(jaux), _jax_routing(jx, jnp.asarray(router), top_k, cf,
                                      group))


def _gaps(probs, top_k):
    """Per token, the k-th minus the (k+1)-th probability (inf at k = E)."""
    s = -np.sort(-probs, axis=-1)
    if top_k == s.shape[-1]:
        return np.full(s.shape[:-1], np.inf)
    return s[..., top_k - 1] - s[..., top_k]


def _agree(r, idx, keep, E):
    """Per token: the chosen and the kept experts equal as sets."""
    def masks(i, k):
        oh = np.eye(E, dtype=bool)[i]                      # (G, gs, k, E)
        return oh.any(2), (oh & k[..., None]).any(2)
    (c1, k1), (c2, k2) = masks(r.idx.numpy(), r.keep.numpy()), \
        masks(idx, keep)
    return (c1 == c2).all(-1) & (k1 == k2).all(-1)


# (B, S, D, E, F, top_k, capacity_factor, moe_group): granite's smoke
# config; a group size that does not divide T (70 = 2 x 35 at group 64);
# granite's routing (40 experts, top 8) at a decode shape, C = 1; a
# prefill of one group with drops at a capacity factor of 1
CASES = {
    "smoke": (2, 20, 48, 8, 32, 4, 1.25, 64),
    "ragged_group": (2, 35, 48, 8, 32, 4, 1.25, 64),
    "decode_C1": (4, 1, 48, 40, 32, 8, 1.25, 4096),
    "drops": (1, 96, 32, 40, 16, 8, 1.0, 4096),
}


@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_matches_jax_f32(case):
    B, S, D, E, Fd, top_k, cf, group = CASES[case]
    got, aux, r, want, jaux, (probs, idx, keep, C) = _run(
        _inputs(B, S, D, E, Fd), top_k, cf, group, torch.float32)
    assert _gaps(probs, top_k).min() > GAP      # no near tie at this seed
    assert r.C == C and got.dtype == torch.float32
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert aux.item() == pytest.approx(jaux, rel=2e-5)


def test_decode_shape_has_capacity_one_and_drops():
    """Granite's decode step: 4 rows, one group of 4, C = max(1, int(4 x 8 x
    1.25 / 40)) = 1, so each expert keeps one (token, slot) pair and the
    rest drop, in the reference's order."""
    B, S, D, E, Fd, top_k, cf, group = CASES["decode_C1"]
    assert moe.pick_group(B * S, group) == 4
    assert moe.capacity(4, top_k, cf, E) == 1
    _, _, r, _, _, (_, _, keep, _) = _run(_inputs(B, S, D, E, Fd), top_k, cf,
                                          group, torch.float32)
    drops = int((~r.keep).sum())
    assert drops == int((~keep).sum()) and drops > 0
    # per expert, the kept pair is the first in token-major order
    flat_i, flat_k = r.idx.reshape(-1).numpy(), r.keep.reshape(-1).numpy()
    for e in np.unique(flat_i):
        at = np.flatnonzero(flat_i == e)
        assert flat_k[at].tolist() == [True] + [False] * (len(at) - 1)


def test_group_size_when_moe_group_does_not_divide_T():
    assert moe.pick_group(70, 64) == 35
    assert moe.pick_group(2048, 4096) == 2048
    assert moe.pick_group(13, 4) == 1
    r = moe.route(torch.zeros((2, 35, 48)), torch.zeros((48, 8)), top_k=4,
                  capacity_factor=1.25)
    assert r.idx.shape == (2, 35, 4) and r.C == int(35 * 4 * 1.25 / 8)


@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_default_policy_on_agreeing_tokens(case):
    B, S, D, E, Fd, top_k, cf, group = CASES[case]
    got, _, r, want, _, (probs, idx, keep, _) = _run(
        _inputs(B, S, D, E, Fd, seed=1), top_k, cf, group, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ok = _agree(r, idx, keep, E).reshape(B, S)
    # a token away from every near tie routes alike in both frameworks
    assert ok.mean() >= 0.5, ok.mean()
    y = got.float().numpy()
    err = np.abs(y[ok] - want[ok]).max() / np.abs(want[ok]).max()
    assert err <= 3e-2, err
