"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's formulas, and its op counter against hand counts and the
reference's own jaxpr.

Tolerances: the roofline terms are the same floating-point formulas, so
they compare with ``==``; FLOP and byte counts are integers and compare
exactly.
"""

import math

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import roofline as jroof
from repro_torch.backend import H100, BackendSpec
from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.kernels import pad_cast as pc
from repro_torch.kernels import sbgemv as sk
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as roof

# the reference's TPU-v5e-class constants, as a port spec: only to hold the
# port's formulas against the reference's (the port's peaks are the H100's)
TPU_CONSTANTS = BackendSpec(name="tpu-v5e-constants",
                            peak_flops=(("bfloat16", 197e12),),
                            hbm_bandwidth=819e9, link_bandwidth=50e9)


def test_h100_peaks_are_the_data_sheets():
    assert H100.peak(torch.bfloat16) == 989e12
    assert H100.peak(torch.float32) == 67e12
    assert H100.peak(torch.float64) == 67e12
    assert H100.peak(torch.complex128) == 67e12
    assert H100.peak() == 989e12            # the native matmul rate
    assert H100.hbm_bandwidth == 3.35e12
    assert roof.TARGET_SPEC is H100 and roof.PEAK_FLOPS == 989e12
    assert roof.HBM_BW == 3.35e12 and roof.LINK_BW == H100.link_bandwidth
    hash(H100)                              # specs key caches


@pytest.mark.parametrize("cost,coll", [
    ({"flops": 197e12, "bytes accessed": 1.0}, ({}, {}, 0)),
    ({"flops": 0.0, "bytes accessed": 0.0},
     ({"all-reduce": 1}, {"all-reduce": 50e9}, int(50e9))),
    ({"flops": 3.7e11, "bytes accessed": 2.2e9}, ({}, {}, 0)),
    ({"flops": 1.1e9, "bytes accessed": 8.8e11},
     ({"all-gather": 2}, {"all-gather": 1e6}, int(1e6))),
])
@pytest.mark.parametrize("floor", [None, 4.4e8])
def test_roofline_terms_equal_the_references(cost, coll, floor):
    ref = jroof.roofline_terms(cost, jroof.CollectiveStats(*coll),
                               bytes_floor=floor)
    got = roof.roofline_terms(cost, roof.CollectiveStats(*coll),
                              bytes_floor=floor, spec=TPU_CONSTANTS)
    assert got == ref


def test_roofline_terms_dominance():
    # the reference's cases (tests/test_roofline.py), at the TPU constants
    coll = roof.CollectiveStats({}, {}, 0)
    t = roof.roofline_terms({"flops": 197e12, "bytes accessed": 1.0}, coll,
                            spec=TPU_CONSTANTS)
    assert t["dominant"] == "compute" and abs(t["compute_s"] - 1.0) < 1e-9
    coll = roof.CollectiveStats({"all-reduce": 1}, {"all-reduce": 50e9},
                                int(50e9))
    t = roof.roofline_terms({"flops": 0.0, "bytes accessed": 0.0}, coll,
                            spec=TPU_CONSTANTS)
    assert t["dominant"] == "collective" and \
        abs(t["collective_s"] - 1.0) < 1e-9


def test_compute_term_sums_each_dtype_over_its_peak():
    coll = roof.CollectiveStats({}, {}, 0)
    t = roof.roofline_terms(
        {"flops": 989e12 + 67e12, "bytes accessed": 0.0,
         "flops_by_dtype": {"bfloat16": 989e12, "float32": 67e12}}, coll)
    assert t["compute_s"] == 2.0 and t["dominant"] == "compute"
    assert t["flops_by_dtype"] == {"bfloat16": 989e12, "float32": 67e12}
    t = roof.roofline_terms({"flops": 0.0, "bytes accessed": 3.35e12},
                            coll)
    assert t["memory_s"] == 1.0 and t["dominant"] == "memory"


def test_model_flops_and_ratios_equal_the_references():
    assert roof.model_flops(1000, 0, 10, "train") == 6 * 1000 * 10
    assert roof.model_flops(1000, 0, 10, "prefill") == 2 * 1000 * 10
    assert roof.model_flops(1000, 250, 10, "train") == 6 * 250 * 10
    for args in ((1000, 0, 10, "train"), (7, 3, 5, "decode")):
        assert roof.model_flops(*args) == jroof.model_flops(*args)
    for mf, f, n in ((1e12, 2e12, 1), (3e9, 0.0, 1), (5e10, 1e10, 256)):
        a, b = roof.useful_ratio(mf, f, n), jroof.useful_ratio(mf, f, n)
        assert a == b or (math.isnan(a) and math.isnan(b))
    for mf, s, n in ((1e15, 2.0, 1), (4e14, 0.0, 1), (3e18, 9.5, 256)):
        a = roof.roofline_fraction(mf, s, n, spec=TPU_CONSTANTS)
        b = jroof.roofline_fraction(mf, s, n)
        assert a == b or (math.isnan(a) and math.isnan(b))
    assert roof.roofline_fraction(989e12, 1.0, 1) == 1.0


# ---------------------------------------------------------------------------
# The op counter
# ---------------------------------------------------------------------------

def test_counter_flops_by_dtype_and_bytes():
    a = torch.ones((8, 16), dtype=torch.bfloat16)
    b = torch.ones((16, 4), dtype=torch.bfloat16)
    with roof.OpCounter() as c:
        y = torch.mm(a, b)                       # 2 * 8 * 16 * 4 at bf16
        z = torch.bmm(y.float()[None], y.float().T[None])   # f32
        w = z[0].T.contiguous()                  # a view, then a copy
    assert dict(c.flops_by_dtype) == {"bfloat16": 2 * 8 * 16 * 4,
                                      "float32": 2 * 8 * 4 * 8}
    mm = c.by_op["aten.mm"]
    assert mm == {"calls": 1, "flops": 1024,
                  "bytes": (8 * 16 + 16 * 4 + 8 * 4) * 2}
    assert "aten.t" not in c.by_op and "aten.transpose" not in c.by_op
    # floor: the two products only (the casts and the copy are elementwise)
    assert c.floor_bytes == mm["bytes"] + c.by_op["aten.bmm"]["bytes"]
    assert c.raw_bytes > c.floor_bytes
    # count_io adds the arguments and outputs no floor op touched: a and
    # b were read by mm, w was written by a copy
    assert c.count_io((a, b), w) == w.numel() * 4
    assert tuple(w.shape) == (8, 8)


def test_counter_takes_the_f32_output_products():
    # the card's bf16 products with f32 sums (layers.matmul_f32 / bmm_f32:
    # aten.mm.dtype and aten.bmm.dtype), counted at the operands' dtype
    with FakeTensorMode():
        a = torch.empty((3, 8, 16), dtype=torch.bfloat16)
        b = torch.empty((3, 16, 4), dtype=torch.bfloat16)
        with roof.OpCounter() as c:
            y = torch.bmm(a, b, out_dtype=torch.float32)
            z = torch.mm(a[0], b[0], out_dtype=torch.float32)
    assert y.dtype == z.dtype == torch.float32
    assert dict(c.flops_by_dtype) == {"bfloat16": 2 * 3 * 8 * 16 * 4
                                      + 2 * 8 * 16 * 4}


@pytest.mark.parametrize("kind,n", [("r2c", 64), ("c2c", 48), ("c2r", 40)])
def test_counter_fft_formula(kind, n):
    x = torch.ones((6, n), dtype=torch.float64)
    with roof.OpCounter() as c:
        if kind == "r2c":
            torch.fft.rfft(x, dim=-1)
        elif kind == "c2c":
            torch.fft.fft(x.to(torch.complex128), dim=-1)
        else:
            torch.fft.irfft(x.to(torch.complex128)[:, : n // 2 + 1], n=n,
                            dim=-1)
    scale = 5.0 if kind == "c2c" else 2.5
    want = int(round(scale * 6 * n * math.log2(n)))
    assert c.flops == want and set(c.flops_by_dtype) == {"float64"}
    assert c.by_op[f"aten._fft_{kind}"]["flops"] == want


def test_kernels_report_their_counts_under_fake_tensors():
    # the paper shape's Phase-3 GEMV, as PERF.md rows 3 and 4 count it:
    # F_hat's two planes and x's read once, y's written once; 8 FLOPs a
    # complex multiply-add.  Fake card tensors: nothing is allocated.
    K, Nd, Nm = 1001, 100, 5000
    with FakeTensorMode():
        A = torch.empty((K, Nd, Nm), dtype=torch.float64, device="cuda")
        xm = torch.empty((K, Nm), dtype=torch.float64, device="cuda")
        xd = torch.empty((K, Nd), dtype=torch.float64, device="cuda")
        v = torch.empty((Nm, 1000), dtype=torch.float64, device="cuda")
        with roof.OpCounter() as c:
            y = sk.sbgemv_n_complex(A, A, xm, xm)
            z = sk.sbgemv_th_complex(A, A, xd, xd, conj=True)
            g = sk.sbgemm_gram_complex(A, A, data=True)
            p = pc.pad_cast(v, 2000, torch.float32)
            u = pc.unpad_cast(p, 1000, torch.float64)
    assert tuple(p.shape) == (Nm, 2000) and p.dtype == torch.float32
    assert tuple(u.shape) == (Nm, 1000) and u.dtype == torch.float64
    assert c.by_op["pad_cast"] == {"calls": 1, "flops": 0,
                                   "bytes": Nm * 1000 * 8 + Nm * 2000 * 4}
    # unpad reads only the kept columns (PERF.md row 2)
    assert c.by_op["unpad_cast"]["bytes"] == Nm * 1000 * 4 + Nm * 1000 * 8
    assert tuple(y[0].shape) == (K, Nd) and y[0].device.type == "cuda"
    assert tuple(z[0].shape) == (K, Nm) and tuple(g[0].shape) == (K, Nd, Nd)
    n = c.by_op["sbgemv_n_complex"]
    t = c.by_op["sbgemv_th_complex"]
    assert n["bytes"] == t["bytes"] == 8 * (2 * K * Nd * Nm + 2 * K * Nm
                                            + 2 * K * Nd)
    assert round(n["bytes"] / 1e9, 4) == 8.0897
    assert n["flops"] == t["flops"] == 8 * K * Nd * Nm
    assert c.by_op["sbgemm_gram_complex"]["flops"] == 4 * K * Nd * (Nd + 1) \
        * Nm
    assert set(c.flops_by_dtype) == {"float64"}
    assert c.floor_bytes == c.raw_bytes     # every kernel materializes


def test_kernel_ops_launch_directly_without_a_mode():
    """A wrapper launches its kernel straight away when no dispatch mode
    is active and its tensor is real (no custom-op dispatch on the hot
    path); under a mode, or on a fake tensor, it calls the op, whose fake
    implementation stands in on fake tensors and reports to the counter."""
    from repro_torch.kernels import _build
    calls = []

    def launch(x, a):
        calls.append("launch")
        return x * a

    op = _build.kernel_op(
        "test_scale_rows", "(Tensor x, float a) -> Tensor", launch,
        lambda x, a: torch.empty_like(x), lambda x, a: x.numel())

    def wrapper(x, a):
        return op(x, a) if _build.traced(x) else launch(x, a)

    x = torch.ones((3, 4))
    assert not _build.traced(x)
    assert torch.equal(wrapper(x, 2.0), 2 * x) and calls == ["launch"]
    with FakeTensorMode():
        fx = torch.empty((3, 4), device="cuda")
        with roof.OpCounter() as c:
            fy = wrapper(fx, 2.0)
    assert calls == ["launch"] and tuple(fy.shape) == (3, 4)
    assert c.by_op["test_scale_rows"] == {"calls": 1, "flops": 12,
                                          "bytes": 2 * 12 * 4}
    # a fake tensor outside its mode still takes the op
    assert _build.traced(fx)


def _dot_general_flops(jaxpr) -> int:
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (_, rc), (_, rb) = eqn.params["dimension_numbers"]
            a, b = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
            free = [d for i, d in enumerate(b) if i not in rc and i not in rb]
            total += 2 * math.prod(a) * math.prod(free)
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                inner = getattr(sub, "jaxpr", None)
                if inner is not None and hasattr(inner, "eqns"):
                    reps = eqn.params.get("length", 1) \
                        if eqn.primitive.name == "scan" else 1
                    total += reps * _dot_general_flops(inner)
                elif hasattr(sub, "eqns"):
                    total += _dot_general_flops(sub)
    return total


@pytest.mark.parametrize("arch", ["qwen1p5_0p5b", "granite_moe_3b"])
def test_counted_step_flops_equal_the_references_dot_generals(arch):
    """A smoke train step (remat none): the port's counted product FLOPs
    equal the dot_general FLOPs of the reference's jaxpr of the same
    step, exactly."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import api as ref_api
    from repro.optim import AdamW as RefAdamW
    from repro.optim import constant_schedule as ref_const
    B, S = 2, 64
    rcfg = ref_smoke(arch).replace(remat="none", scan_layers=False,
                                   analysis_mode=True)
    opt = RefAdamW(schedule=ref_const(1e-4))
    state = jax.eval_shape(
        lambda: ref_api.init_train_state(rcfg, opt, jax.random.PRNGKey(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    jx = jax.make_jaxpr(ref_api.make_train_step(rcfg, opt))(state, batch)
    want = _dot_general_flops(jx.jaxpr)
    v = dryrun.run_step(get_smoke_config(arch).replace(remat="none"),
                        ShapeSpec("smoke", "train", S, B), memory=False)
    assert v["flops"] == want
