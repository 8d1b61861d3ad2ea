"""The port's static plan linter (``repro_torch.analysis``), on the CPU.

The reference's linter cannot be the oracle on this JAX (it traces under
``jax.experimental.enable_x64``, which JAX 0.9 removed), so the port's is
held to seeded plans, as ``tests/test_analysis.py`` holds the
reference's:

* clean: the paper plan families lint with zero findings on the CPU
  backends (``cpu-torch``, ``torch-ref``) at smoke dims and at the paper
  shape (fake planes: nothing is allocated);
* seeded: each deliberately broken lowering fires exactly its rule.
  Seeds patch the executor's dispatch points
  (``pipeline._STAGE_IMPLS``, ``pipeline._ring_hop``), so the
  plans stay valid and the lowering misbehaves;
* mesh plans (the reference's 2 x 4 grid) trace as one rank over torch's
  fake process group: the sweep's mesh plans lint clean, and the
  reference's seeded collective faults fire the rule and severity
  ``tests/test_analysis.py`` asserts for each.

The card's backend (``h100``) traces only where a card is present (a
CPU-only torch cannot fake views of card tensors); ``chip_smoke.py``
lints it on the card.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import analysis
from repro_torch.analysis import cli as analysis_cli
from repro_torch.backend import known_backends
from repro_torch.core import (ExecOpts, FFTMatvec, PrecisionConfig,
                              gram_plan, matvec_plan)
from repro_torch.core import pipeline
from repro_torch.core import precision as prec

N_T, N_D, N_M = 16, 4, 32
DIMS = dict(N_t=N_T, N_d=N_D, N_m=N_M)
OPTS = ExecOpts(backend="torch-ref")
CPU_BACKENDS = ("cpu-torch", "torch-ref")


def fired(findings):
    return {f.rule for f in findings}


def _op(cfg="ddddd", backend="torch-ref", seed=1):
    rng = np.random.default_rng(seed)
    F_col = rng.standard_normal((N_T, N_D, N_M))
    return FFTMatvec.from_block_column(
        F_col, PrecisionConfig.from_string(cfg), backend=backend,
        device="cpu")


def _downgrade_unpad(monkeypatch):
    # the silent-downgrade bug class: a stage that hands f32 downstream of
    # a plan whose last data stage declares f64
    orig = pipeline._STAGE_IMPLS["unpad"]

    def degraded(stage, x, operands, N_t, S, opts):
        return orig(stage, x, operands, N_t, S, opts).to(torch.float32)

    monkeypatch.setitem(pipeline._STAGE_IMPLS, "unpad", degraded)


# ---------------------------------------------------------------------------
# Clean plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("cfg_s", ["ddddd", "dssdd", "sssss", "hhhhh",
                                   "ddddd;tiles=ds|sh"])
def test_clean_plans_cpu_backends(backend, cfg_s):
    cfg = PrecisionConfig.from_string(cfg_s)
    opts = ExecOpts(backend=backend)
    for plan in (matvec_plan(cfg), matvec_plan(cfg, adjoint=True),
                 gram_plan(cfg), gram_plan(cfg, space="data"),
                 gram_plan(cfg, mode="circulant")):
        analysis.assert_plan_clean(plan, opts, **DIMS)


def test_clean_at_the_paper_shape_and_on_blocks():
    # fake planes of (1001, 100, 5000): nothing is allocated
    cfg = PrecisionConfig.from_string("dssdd")
    for backend in CPU_BACKENDS:
        analysis.assert_plan_clean(matvec_plan(cfg, adjoint=True),
                                   ExecOpts(backend=backend), N_t=1000,
                                   N_d=100, N_m=5000)
    analysis.assert_plan_clean(matvec_plan(cfg), OPTS, **DIMS, S=8)


def test_lint_operator_clean_both_directions():
    op = _op("dssdd")
    assert analysis.lint_operator(op) == []
    assert analysis.lint_operator(op.gram(mode="circulant")) == []
    assert analysis.lint_operator(op.gram(space="data")) == []


def test_card_backend_traceable_only_with_a_card():
    assert analysis.traceable("cpu-torch") and analysis.traceable("torch-ref")
    assert analysis.traceable("h100") == torch.cuda.is_available()


def test_the_trace_holds_nodes_with_dtypes():
    ctx = analysis.PlanContext.from_plan(
        matvec_plan(PrecisionConfig.from_string("dssdd")),
        ExecOpts(backend="cpu-torch"), **DIMS)
    names = [analysis.op_name(n) for n, _, _ in ctx.eqns()]
    # the batched FFTs and the plain contraction's products
    assert "_fft_r2c" in names and "_fft_c2r" in names and "bmm" in names
    assert [tuple(v.shape) for v in ctx.out_avals] == [(N_D, N_T)]
    assert ctx.out_avals[0].dtype == torch.float64
    assert ctx.trace_counters["gemv"] == 1 and ctx.trace_counters["pad"] == 1


# ---------------------------------------------------------------------------
# Seeded violations: each fires exactly its rule
# ---------------------------------------------------------------------------

def test_seeded_output_downgrade_fires(monkeypatch):
    _downgrade_unpad(monkeypatch)
    plan = matvec_plan(PrecisionConfig.from_string("ddddd"))
    found = analysis.lint_plan(plan, OPTS, **DIMS)
    assert fired(found) == {"silent-output-downgrade"}
    assert all(f.severity == analysis.ERROR for f in found)
    with pytest.raises(AssertionError, match="silent-output-downgrade"):
        analysis.assert_plan_clean(plan, OPTS, **DIMS)


def test_seeded_output_promotion_warns(monkeypatch):
    orig = pipeline._STAGE_IMPLS["unpad"]

    def promoted(stage, x, operands, N_t, S, opts):
        return orig(stage, x, operands, N_t, S, opts).to(torch.float64)

    monkeypatch.setitem(pipeline._STAGE_IMPLS, "unpad", promoted)
    found = analysis.lint_plan(
        matvec_plan(PrecisionConfig.from_string("dssds")), OPTS, **DIMS)
    assert fired(found) == {"silent-output-downgrade"}
    assert all(f.severity == analysis.WARNING for f in found)


def test_seeded_low_accumulation_fires(monkeypatch):
    # gemv quietly contracts at f32 under a declared-f64 stage, then casts
    # back up: invisible at the output, visible to the pass
    orig = pipeline._STAGE_IMPLS["gemv"]

    def lowered(stage, x, operands, N_t, S, opts):
        out = orig(dataclasses.replace(stage, level="s"), x, operands,
                   N_t, S, opts)
        return tuple(p.to(prec.real_dtype(stage.level)) for p in out)

    monkeypatch.setitem(pipeline._STAGE_IMPLS, "gemv", lowered)
    found = analysis.lint_plan(
        matvec_plan(PrecisionConfig.from_string("ddddd")),
        ExecOpts(backend="cpu-torch"), **DIMS)
    assert fired(found) == {"accum-below-stage"}


def test_seeded_f64_in_a_sub_double_plan_fires(monkeypatch):
    orig = pipeline._STAGE_IMPLS["ifft"]

    def promoted(stage, x, operands, N_t, S, opts):
        y = orig(stage, x, operands, N_t, S, opts)
        return (y.to(torch.float64) * 1.0).to(y.dtype)

    monkeypatch.setitem(pipeline._STAGE_IMPLS, "ifft", promoted)
    found = analysis.lint_plan(
        matvec_plan(PrecisionConfig.from_string("sssss")), OPTS, **DIMS)
    assert fired(found) == {"x64-promotion"}


def test_seeded_reorder_levels_fire():
    cfg = PrecisionConfig.from_string("sssss")
    plan = matvec_plan(cfg)
    low = tuple(dataclasses.replace(s, level="h") if s.kind == "reorder"
                else s for s in plan)
    found = analysis.lint_plan(low, OPTS, **DIMS,
                               names=("reorder-level",))
    assert {f.severity for f in found} == {analysis.ERROR}
    assert sorted(f.stage for f in found) == [2, 4]
    high = tuple(dataclasses.replace(s, level="d") if s.kind == "reorder"
                 else s for s in plan)
    found = analysis.lint_plan(high, OPTS, **DIMS,
                               names=("reorder-level",))
    assert {f.severity for f in found} == {analysis.WARNING}


def test_seeded_tile_above_stage_warns():
    cfg = PrecisionConfig.from_string("sssss")
    plan = tuple(dataclasses.replace(
        s, tile_map=prec.TileMap((("d", "s"), ("s", "h"))))
        if s.kind == "gemv" else s for s in matvec_plan(cfg))
    found = analysis.lint_plan(plan, OPTS, **DIMS)
    assert fired(found) == {"tile-above-stage"}
    assert found[0].stage == 3 and found[0].severity == analysis.WARNING


def test_seeded_zero_fill_assembly_fires(monkeypatch):
    orig = pipeline._STAGE_IMPLS["unpad"]

    def zero_filled(stage, x, operands, N_t, S, opts):
        y = orig(stage, x, operands, N_t, S, opts)
        out = torch.zeros_like(y)
        out[:, :N_t // 2] = y[:, :N_t // 2]
        out[:, N_t // 2:] = y[:, N_t // 2:]
        return out

    monkeypatch.setitem(pipeline._STAGE_IMPLS, "unpad", zero_filled)
    found = analysis.lint_plan(
        matvec_plan(PrecisionConfig.from_string("sssss")), OPTS, **DIMS)
    assert fired(found) == {"no-zero-fill-assembly"}
    assert len(found) == 2


def test_seeded_device_transfer_fires(monkeypatch):
    orig = pipeline._STAGE_IMPLS["fft"]

    def moved(stage, x, operands, N_t, S, opts):
        return orig(stage, x.to("meta").to("cpu"), operands, N_t, S, opts)

    monkeypatch.setitem(pipeline._STAGE_IMPLS, "fft", moved)
    found = analysis.lint_plan(
        matvec_plan(PrecisionConfig.from_string("sssss")), OPTS, **DIMS,
        names=("no-device-transfer",))
    assert fired(found) == {"no-device-transfer"} and len(found) == 2


def test_seeded_convert_round_trip_warns(monkeypatch):
    orig = pipeline._STAGE_IMPLS["unpad"]

    def round_trip(stage, x, operands, N_t, S, opts):
        y = orig(stage, x, operands, N_t, S, opts)
        return y.to(torch.float64).to(y.dtype)

    monkeypatch.setitem(pipeline._STAGE_IMPLS, "unpad", round_trip)
    found = analysis.lint_plan(
        matvec_plan(PrecisionConfig.from_string("sssss")), OPTS, **DIMS,
        families=("invariants",))
    assert fired(found) == {"convert-round-trip"}
    assert all(f.severity == analysis.WARNING for f in found)


def test_narrowing_round_trip_is_the_quantization_idiom(monkeypatch):
    orig = pipeline._STAGE_IMPLS["unpad"]

    def quantized(stage, x, operands, N_t, S, opts):
        y = orig(stage, x, operands, N_t, S, opts)
        return y.to(torch.bfloat16).to(y.dtype)

    monkeypatch.setitem(pipeline._STAGE_IMPLS, "unpad", quantized)
    found = analysis.lint_plan(
        matvec_plan(PrecisionConfig.from_string("sssss")), OPTS, **DIMS,
        families=("invariants",))
    assert found == []


def test_seeded_unhashable_stage_fires():
    plan = matvec_plan(PrecisionConfig.from_string("sssss"))
    bad = tuple(dataclasses.replace(s, tile_map=[["s"]])
                if s.kind == "gemv" else s for s in plan)
    found = analysis.lint_plan(bad, OPTS, **DIMS, families=("recompile",))
    assert fired(found) == {"static-unhashable"}
    assert any("tile_map" in f.detail for f in found)


def test_seeded_unstable_hash_fires():
    @dataclasses.dataclass(frozen=True)
    class Drifting:
        _tick = itertools.count()

        def __hash__(self):
            return next(self._tick)

    opts = dataclasses.replace(OPTS, dispatch=Drifting())
    ctx = analysis.PlanContext.from_plan(
        matvec_plan(PrecisionConfig.from_string("sssss")), opts, **DIMS)
    from repro_torch.analysis.recompile import check_hash_stable
    assert fired(check_hash_stable(ctx)) == {"hash-unstable"}


def test_seeded_nondeterministic_resolve_fires(monkeypatch):
    from repro_torch.analysis.recompile import check_resolve_deterministic
    ticks = itertools.count()
    orig = ExecOpts.resolve

    def drifting(self, device):
        r = orig(self, device)
        return dataclasses.replace(
            r, spec=dataclasses.replace(r.spec,
                                        device_kind=str(next(ticks))))

    monkeypatch.setattr(ExecOpts, "resolve", drifting)
    ctx = analysis.PlanContext.from_plan(
        matvec_plan(PrecisionConfig.from_string("sssss")), OPTS, **DIMS)
    assert fired(check_resolve_deterministic(ctx)) == {
        "resolve-deterministic"}


# ---------------------------------------------------------------------------
# Mesh plans: one rank of the grid over a fake process group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("cfg_s", ["ddddd", "dssdd", "sssss"])
def test_clean_mesh_plans(backend, cfg_s):
    plans = analysis_cli.plan_matrix(PrecisionConfig.from_string(cfg_s))
    for name in ("matvec-hier", "matvec-ring", "rmatvec-ring", "gram-mesh"):
        analysis.assert_plan_clean(plans[name][0], ExecOpts(backend=backend),
                                   **DIMS)
    # the fake process group lives only for the lint
    assert not dist.is_initialized()


def test_a_mesh_trace_holds_its_collectives_and_local_planes():
    plan = analysis_cli.plan_matrix(PrecisionConfig.from_string("ddddd"))[
        "gram-mesh"][0]
    ctx = analysis.PlanContext.from_plan(plan, OPTS, **DIMS)
    assert [tuple(v.shape) for v in ctx.out_avals] == [(N_M // 4, N_T)]
    names = [analysis.op_name(n) for n, _, _ in ctx.eqns()]
    # the mid reduction of two Fourier planes, the final of one carrier
    assert names.count("c10d.allreduce_") == 3
    assert (ctx.N_d_local, ctx.N_m_local) == (N_D // 2, N_M // 4)
    assert ctx.trace_counters["psum"] == 2
    ring = analysis.PlanContext.from_plan(
        matvec_plan(PrecisionConfig.from_string("sssss"), psum_axis="col",
                    collective="ring", psum_groups=(4,)), OPTS, **DIMS)
    names = [analysis.op_name(n) for n, _, _ in ring.eqns()]
    assert names.count("c10d.send") == names.count("c10d.recv_") == 3


def test_seeded_unrestored_comm_fires(monkeypatch):
    # a reduced-precision collective that keeps the comm dtype instead of
    # restoring the carrier
    def leaky(stage, x, operands, N_t, S, opts):
        comm_dt = prec.real_dtype(stage.level)
        planes = x if isinstance(x, tuple) else (x,)
        out = []
        for p in planes:
            q = p.to(comm_dt).contiguous()
            dist.all_reduce(q, group=pipeline._group(opts, stage.axes))
            out.append(q)
        return tuple(out) if isinstance(x, tuple) else out[0]

    monkeypatch.setitem(pipeline._STAGE_IMPLS, "psum", leaky)
    plan = matvec_plan(PrecisionConfig.from_string("ddddd"),
                       psum_axis="col", psum_groups=(4,), comm_level="s")
    opts = dataclasses.replace(OPTS, overlap=None)
    found = analysis.lint_plan(plan, opts, **DIMS)
    # the root cause and its symptom: the collective is the matvec's last
    # stage, so the comm dtype reaches the output
    assert fired(found) == {"comm-restores-carrier",
                            "silent-output-downgrade"}
    assert all(f.severity == analysis.ERROR for f in found)
    only = analysis.lint_plan(plan, opts, **DIMS,
                              names=("comm-restores-carrier",))
    assert len(only) == 1 and only[0].stage is not None


def test_seeded_invalid_ring_fires(monkeypatch):
    # a pair-swap "ring": every rank once, but two disjoint 2-cycles
    _pair_swap(monkeypatch)
    plan = matvec_plan(PrecisionConfig.from_string("sssss"),
                       psum_axis="col", collective="ring", psum_groups=(4,))
    found = analysis.lint_plan(plan, OPTS, **DIMS)
    assert fired(found) == {"ring-permutation"}
    assert all(f.severity == analysis.ERROR for f in found)
    assert any("disjoint cycles" in f.message for f in found)


def _pair_swap(monkeypatch):
    hop = pipeline._ring_hop

    def swapped(t, group, dst, src):
        me = dist.get_rank(group)
        return hop(t, group, me ^ 1, me ^ 1)

    monkeypatch.setattr(pipeline, "_ring_hop", swapped)


@pytest.mark.parametrize("seeded", [False, True])
def test_ring_on_one_ranks_groups(monkeypatch, seeded):
    # over a process's own groups a trace holds this rank's hops alone:
    # they must take the ring's step, which the pair swap leaves
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.core.fftmatvec import axis_groups
    if seeded:
        _pair_swap(monkeypatch)
    plan = matvec_plan(PrecisionConfig.from_string("sssss"),
                       psum_axis="col", collective="ring", psum_groups=(4,))
    dist.init_process_group("fake", store=FakeStore(), rank=2, world_size=4)
    try:
        groups = axis_groups(init_device_mesh("cpu", (4,),
                                              mesh_dim_names=("col",)),
                             {"col"})
        found = analysis.lint_plan(plan, OPTS, **DIMS, groups=groups,
                                   names=("ring-permutation",))
    finally:
        dist.destroy_process_group()
    if not seeded:
        assert found == []
        return
    assert fired(found) == {"ring-permutation"}
    assert all(f.severity == analysis.ERROR for f in found)
    assert any("ring's step" in f.message and "(2, 3)" in f.detail
               for f in found)


def test_seeded_fallback_collective_fires():
    # a ring without static groups cannot build its schedule: the static
    # rule flags the request, the executor's fallback counter confirms it
    plan = matvec_plan(PrecisionConfig.from_string("sssss"),
                       psum_axis="col", collective="ring")
    found = analysis.lint_plan(plan, OPTS, **DIMS)
    assert fired(found) == {"collective-stage-valid", "collective-fallback"}
    assert all(f.severity == analysis.WARNING for f in found)


def test_seeded_invalid_collective_stages_fire():
    base = matvec_plan(PrecisionConfig.from_string("sssss"),
                       psum_axis="col", psum_groups=(4,))
    for bad, what in (
            (dict(axis=("col", "col"), groups=(2, 2)), "duplicate"),
            (dict(groups=(0,)), "non-positive")):
        plan = tuple(dataclasses.replace(s, **bad) if s.kind == "gemv_psum"
                     else s for s in base)
        found = analysis.lint_plan(plan, OPTS, **DIMS,
                                   names=("collective-stage-valid",))
        assert fired(found) == {"collective-stage-valid"}
        assert any(what in f.message and f.severity == analysis.ERROR
                   for f in found)
    stray = tuple(dataclasses.replace(s, comm="h") if s.kind == "pad"
                  else s for s in base)
    found = analysis.lint_plan(stray, OPTS, **DIMS,
                               names=("collective-stage-valid",))
    assert [f.severity for f in found] == [analysis.WARNING]


def test_seeded_unhashable_mesh_stage_fires():
    plan = matvec_plan(PrecisionConfig.from_string("sssss"),
                       psum_axis="col", psum_groups=(4,))
    bad = tuple(dataclasses.replace(s, groups=[4])
                if s.kind == "gemv_psum" else s for s in plan)
    found = analysis.lint_plan(bad, OPTS, **DIMS, families=("recompile",))
    assert fired(found) == {"static-unhashable"}
    assert any("groups" in f.detail for f in found)


# ---------------------------------------------------------------------------
# Recompile hazards: the executed cross-check
# ---------------------------------------------------------------------------

def test_trace_stability_on_an_operator():
    op = _op("sssss")
    x = torch.ones((N_M, N_T), dtype=torch.float32)
    assert analysis.trace_stability(op.matvec, x, calls=3) == []


def test_trace_stability_detects_unstable_static_key():
    class UnstableKey:
        _tick = itertools.count()

        def __eq__(self, other):
            return isinstance(other, UnstableKey)

        def __hash__(self):
            return next(self._tick)

    def f(x, mode):
        return x * 2.0

    found = analysis.trace_stability(f, torch.ones((4,)), UnstableKey(),
                                     calls=3, static_argnums=(1,))
    assert fired(found) == {"retrace-on-identical-call"}


# ---------------------------------------------------------------------------
# Engine plumbing: lint_callable, registry, CLI
# ---------------------------------------------------------------------------

def test_lint_callable_allow_and_forbid():
    def f(a):
        return torch.cat([a, a]).reshape(2, -1)

    a = torch.ones((1, 3))
    assert analysis.lint_callable(f, (a,), allowed={"cat", "view"}) == []
    found = analysis.lint_callable(f, (a,), forbidden={"cat"},
                                   name="no-concat")
    assert [g.rule for g in found] == ["no-concat"]


def test_rule_registry_and_catalog():
    cat = analysis.rule_catalog()
    assert {r.family for r in cat} == set(analysis.FAMILIES)
    names = [r.name for r in cat]
    assert len(names) == len(set(names))
    assert set(names) == {
        "silent-output-downgrade", "x64-promotion", "accum-below-stage",
        "reorder-level", "tile-above-stage", "no-zero-fill-assembly",
        "no-device-transfer", "convert-round-trip", "static-unhashable",
        "hash-unstable", "resolve-deterministic", "collective-stage-valid",
        "collective-fallback", "ring-permutation", "comm-restores-carrier"}
    order = [(analysis.FAMILIES.index(r.family), r.name) for r in cat]
    assert order == sorted(order)
    with pytest.raises(ValueError, match="duplicate"):
        analysis.rule(names[0], cat[0].family, "dup")(lambda ctx: [])
    with pytest.raises(ValueError, match="unknown rule family"):
        analysis.rule("x", "nonsense", "d")
    with pytest.raises(KeyError):
        analysis.all_rules(names=("no-such-rule",))


def test_rule_family_and_name_filters(monkeypatch):
    _downgrade_unpad(monkeypatch)
    plan = matvec_plan(PrecisionConfig.from_string("ddddd"))
    assert analysis.lint_plan(plan, OPTS, **DIMS,
                              families=("recompile",)) == []
    assert analysis.lint_plan(plan, OPTS, **DIMS,
                              names=("reorder-level",)) == []
    only = analysis.lint_plan(plan, OPTS, **DIMS,
                              names=("silent-output-downgrade",))
    assert fired(only) == {"silent-output-downgrade"}


def test_a_rule_that_raises_is_a_trace_failure(monkeypatch):
    def broken(stage, x, operands, N_t, S, opts):
        raise RuntimeError("no lowering")

    monkeypatch.setitem(pipeline._STAGE_IMPLS, "fft", broken)
    found = analysis.lint_plan(
        matvec_plan(PrecisionConfig.from_string("sssss")), OPTS, **DIMS,
        names=("silent-output-downgrade",))
    assert fired(found) == {"trace-failure"}


def test_cli_rules_listing(capsys):
    assert analysis_cli.main(["--rules"]) == 0
    text = capsys.readouterr().out
    assert "silent-output-downgrade" in text
    assert "[invariants]" in text


def test_cli_json_smoke(capsys):
    rc = analysis_cli.main(
        ["--smoke", "--backend", "torch-ref", "--config", "sssss",
         "--plan", "matvec", "--plan", "gram", "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert report["errors"] == 0 and report["warnings"] == 0
    assert {row["plan"] for row in report["rows"]} == {"matvec", "gram"}


def test_cli_default_sweep_covers_the_traceable_backends(capsys):
    rc = analysis_cli.main(["--smoke", "--json", "--plan", "matvec"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    traced = {row["backend"] for row in report["rows"]}
    assert traced | set(report["skipped_backends"]) == set(known_backends())
    assert set(CPU_BACKENDS) <= traced
    assert {row["config"] for row in report["rows"]} == set(
        analysis_cli.DEFAULT_CONFIGS)


def test_cli_exits_nonzero_on_seeded_error(monkeypatch, capsys):
    _downgrade_unpad(monkeypatch)
    rc = analysis_cli.main(
        ["--smoke", "--backend", "torch-ref", "--config", "ddddd",
         "--plan", "matvec"])
    assert rc == 1
    assert "silent-output-downgrade" in capsys.readouterr().out
