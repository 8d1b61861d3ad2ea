"""The port's dry run (``repro_torch.launch.dryrun``) and input shapes
(``repro_torch.configs.shapes``) against the reference, on the CPU.

LM steps run under ``FakeTensorMode`` at smoke widths (nothing is
allocated).  Tolerances: shapes, dtypes and counts are integers and
compare exactly; the 1-/2-layer extrapolation is exact for FLOPs and
bytes (the reference allows 2 %, ``tests/test_roofline.py:93-114``); the
extrapolated peak memory is exact for a train step and within 20 % of a
full-depth run for a prefill (the transient of one layer's attention
overlaps the cache writes differently at one and two layers).
"""

import json
import os

import jax
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.configs import shape_applicable as ref_applicable
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, get_config,
                                 get_smoke_config, input_shard_specs,
                                 input_specs, shape_applicable)
from repro_torch.configs.fftmatvec_paper import SMOKE
from repro_torch.launch import dryrun

SMALL = {"train": ShapeSpec("smoke_train", "train", 64, 2),
         "prefill": ShapeSpec("smoke_prefill", "prefill", 64, 2),
         "decode": ShapeSpec("smoke_decode", "decode", 64, 2)}


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

def test_shapes_match_the_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicability_and_input_specs_match_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, shape in SHAPES.items():
        assert shape_applicable(cfg, shape) == \
            ref_applicable(rcfg, REF_SHAPES[name])
        got = input_specs(cfg, shape)
        want = ref_input_specs(rcfg, REF_SHAPES[name])
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (arch, name, k)
            assert str(v.dtype).replace("torch.", "") == \
                want[k].dtype.name, (arch, name, k)


def test_input_shard_specs_wait_for_multi_gpu():
    cfg = get_config("qwen1p5_0p5b")
    with pytest.raises(NotImplementedError, match="item 13"):
        input_shard_specs(cfg, SHAPES["train_4k"], dp="data",
                          mesh_shape={"data": 16, "model": 16})


# ---------------------------------------------------------------------------
# The per-step cost: 1-/2-layer extrapolation against a full count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [
    ("qwen1p5_0p5b", "train"), ("qwen1p5_0p5b", "prefill"),
    ("qwen1p5_0p5b", "decode"), ("granite_moe_3b", "train"),
    ("zamba2_1p2b", "prefill"), ("whisper_base", "prefill"),
    ("falcon_mamba_7b", "decode")])
def test_extrapolation_matches_a_full_count(arch, kind):
    cfg = get_smoke_config(arch).replace(remat="none", n_layers=4)
    if cfg.family == "encdec":
        cfg = cfg.replace(enc_layers=3)
    shape = SMALL[kind]
    ext = dryrun.analysis_cost(cfg, shape)
    full = dryrun.run_step(
        cfg.replace(**dryrun._analysis_overrides(cfg, shape)), shape,
        memory=False)
    assert ext["flops"] == full["flops"] > 0
    assert ext["flops_by_dtype"] == full["flops_by_dtype"]
    assert ext["bytes"] == full["bytes"]
    assert abs(ext["bytes_floor"] - full["bytes_floor"]) \
        <= 1e-2 * full["bytes_floor"]


def test_extrapolated_peak_against_a_full_depth_run():
    cfg = get_smoke_config("qwen1p5_0p5b").replace(n_layers=4,
                                                   remat="full")
    for kind, tol in (("train", 1e-12), ("prefill", 0.2)):
        shape = SMALL[kind]
        ext = dryrun.memory_cost(cfg, shape, full_depth_ops=0)
        full = dryrun.memory_cost(cfg, shape, full_depth_ops=10 ** 9)
        assert ext["memory_extrapolated"] and \
            not full["memory_extrapolated"]
        assert abs(ext["peak_bytes"] - full["peak_bytes"]) \
            <= tol * full["peak_bytes"], (kind, ext, full)
        assert ext["argument_bytes"] == full["argument_bytes"]
        assert full["peak_bytes"] >= full["argument_bytes"]


def test_train_peak_holds_state_and_gradients():
    """A train step's peak holds at least the weights, the AdamW moments
    (f32) and one gradient per weight."""
    cfg = get_smoke_config("qwen1p5_0p5b")
    n, _ = dryrun.param_counts(cfg, "cpu")
    v = dryrun.run_step(cfg, SMALL["train"], count=False)
    assert v["argument_bytes"] >= 3 * 4 * n       # weights f32 + mu + nu
    assert v["peak_bytes"] >= v["argument_bytes"] + 4 * n


# ---------------------------------------------------------------------------
# Cells and records
# ---------------------------------------------------------------------------

def test_lm_cell_record():
    cfg = get_smoke_config("granite_moe_3b")
    rec = dryrun.lower_lm_cell("granite_moe_3b", "smoke", cfg=cfg,
                               shape=SMALL["train"])
    for k in ("memory", "memory_extrapolated", "fits_80gb", "roofline",
              "model_flops", "useful_flop_ratio", "roofline_fraction",
              "n_params", "n_active_params", "tokens_per_step", "card",
              "collectives", "production_collectives"):
        assert k in rec, k
    assert rec["n_devices"] == 1 and rec["fits_80gb"]
    assert rec["card"] == dryrun.card_info()
    # MoE: the active count keeps top_k of n_experts expert weights
    assert rec["n_params"] > rec["n_active_params"] > 0
    r = rec["roofline"]
    assert r["collective_s"] == 0.0 and r["dominant"] in ("compute",
                                                          "memory")
    assert r["flops_per_device"] == sum(r["flops_by_dtype"].values())
    assert rec["model_flops"] == 6 * rec["n_active_params"] * 2 * 64


def test_quadratic_families_skip_long_context():
    rec = dryrun.lower_lm_cell("qwen1p5_0p5b", "long_500k")
    assert "skipped" in rec


def test_meshes_wait_for_multi_gpu():
    with pytest.raises(NotImplementedError, match="item 13"):
        dryrun.lower_lm_cell("qwen1p5_0p5b", "train_4k", mesh="pod16x16")
    with pytest.raises(NotImplementedError, match="item 13"):
        dryrun.main(["--mesh", "multi"])
    with pytest.raises(NotImplementedError, match="item 13"):
        dryrun.main(["--mesh", "both"])


def test_cli_writes_records(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "SHAPES", {"long_500k": SHAPES["long_500k"],
                                           "smoke_prefill": SMALL["prefill"]})
    rc = dryrun.main(["--arch", "qwen1p5_0p5b,falcon_mamba_7b", "--shape",
                      "long_500k,smoke_prefill", "--out", str(tmp_path)])
    assert rc == 0
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert len(recs) == 4
    assert "skipped" in recs["qwen1p5_0p5b__long_500k__h100x1__baseline"
                             ".json"]
    ssm = recs["falcon_mamba_7b__long_500k__h100x1__baseline.json"]
    assert "roofline" in ssm and ssm["cell"]["mesh"] == "h100x1"
    assert "SKIP" in capsys.readouterr().out


def test_cli_runs_cells_in_parallel(tmp_path, capsys):
    # two cells that skip (quadratic families at long_500k), each in a
    # process of its own; the records and lines come back in cell order
    rc = dryrun.main(["--arch", "qwen1p5_0p5b,minicpm_2b", "--shape",
                      "long_500k", "--jobs", "2", "--out", str(tmp_path)])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "minicpm_2b__long_500k__h100x1__baseline.json",
        "qwen1p5_0p5b__long_500k__h100x1__baseline.json"]
    text = capsys.readouterr().out
    assert text.index("=== qwen1p5_0p5b") < text.index("=== minicpm_2b")
    assert text.count("SKIP") == 2


def _reference_dryrun():
    """The reference's dry-run module, imported without letting its
    XLA_FLAGS line (512 host devices) reach this process's backend."""
    jax.devices()                   # the backend starts with one device
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


@pytest.mark.parametrize("adjoint", [False, True])
def test_fftmatvec_cell_matches_the_reference(adjoint, monkeypatch):
    ref = _reference_dryrun()
    from repro.configs.fftmatvec_paper import SMOKE as REF_SMOKE
    from repro.launch.mesh import make_test_mesh
    monkeypatch.setattr(ref, "PAPER_SINGLE", REF_SMOKE)
    want = ref.lower_fftmatvec_cell(make_test_mesh((1, 1)),
                                    precision="sssss", adjoint=adjoint)
    got = dryrun.lower_fftmatvec_cell(precision="sssss", adjoint=adjoint,
                                      dims=SMOKE, device="cpu")
    K = SMOKE.N_t + 1
    assert got["model_flops"] == want["model_flops"] == \
        8.0 * K * SMOKE.N_d * SMOKE.N_m
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]
    assert got["memory"]["output_bytes"] == want["memory"]["output_bytes"]
    assert got["problem"] == want["problem"]
    # the plain lowering's four real products are the GEMV's 8 K N_d N_m
    assert got["counts"]["by_op"]["aten.bmm"]["flops"] == got["model_flops"]
    assert got["roofline"]["dominant"] == "memory"
    assert got["card"] == "no card" or torch.cuda.is_available()
