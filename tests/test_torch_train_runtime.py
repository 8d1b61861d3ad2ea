"""The port's training runtime on the CPU: the data pipeline, the
checkpointer, the fault-tolerant trainer and the launcher.  The twins of
``tests/test_runtime.py``'s training tests, plus what carries state
between the packages: each package restores the other's checkpoint bit
for bit (the same files: ``step_<N>/arrays.npz`` + ``manifest.json``,
the reference's leaves in its flatten order, bf16 as uint16), and the
pipeline keeps the reference's contract (its bits are not
``jax.random``'s).  Exact resume is held at the reference's own bound,
``rtol=1e-5, atol=1e-6``.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_smoke_config as jax_smoke
from repro.models import api as japi
from repro.models.policy import PrecisionPolicy as JaxPolicy
from repro.optim import AdamW as JaxAdamW
from repro.optim import Compressor as JaxCompressor
from repro.optim import constant_schedule as jax_constant
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.data import PipelineState, SyntheticPipeline
from repro_torch.examples import train_lm
from repro_torch.launch import train as cli
from repro_torch.models import api
from repro_torch.models.policy import PrecisionPolicy
from repro_torch.optim import AdamW, constant_schedule
from repro_torch.runtime import PreemptionRequested, Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke models' ops are tiny: one intra-op thread a process keeps
    a worker from contending with the others for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_pipeline_deterministic_restart():
    cfg = get_smoke_config("qwen1p5_0p5b")
    pipe = SyntheticPipeline(cfg, batch=4, seq=16, seed=7, device="cpu")
    s = pipe.init_state()
    batches = []
    for _ in range(3):
        s, b = pipe.next(s)
        batches.append(b)
    assert s == PipelineState(7, 3)
    # restart from step 1 reproduces batches 2 and 3 exactly, from a new
    # pipeline object and a state read back from its dict
    again = SyntheticPipeline(cfg, batch=4, seq=16, seed=7, device="cpu")
    s2 = PipelineState.from_dict(json.loads(json.dumps(
        PipelineState(7, 1).to_dict())))
    for i in (1, 2):
        s2, b = again.next(s2)
        assert torch.equal(b["tokens"], batches[i]["tokens"])
        assert torch.equal(b["labels"], batches[i]["labels"])
    assert not torch.equal(batches[0]["tokens"], batches[1]["tokens"])
    other = SyntheticPipeline(cfg, batch=4, seq=16, seed=8, device="cpu")
    assert not torch.equal(other.generate(0)["tokens"],
                           batches[0]["tokens"])


def test_pipeline_has_learnable_structure():
    cfg = get_smoke_config("qwen1p5_0p5b")
    pipe = SyntheticPipeline(cfg, batch=8, seq=64, device="cpu")
    _, b = pipe.next(pipe.init_state())
    toks, labels = b["tokens"].numpy(), b["labels"].numpy()
    assert toks.shape == labels.shape == (8, 64)
    assert b["tokens"].dtype == torch.long
    assert toks.min() >= 0 and toks.max() < cfg.vocab
    # labels are next tokens
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])
    # Markov structure: successor is (t+1) mod V more often than chance
    assert (labels == (toks + 1) % cfg.vocab).mean() > 0.2
    # Zipf-ish marginal: token ids below V/8 (u^3 < 1/8, u < 1/2) take
    # about half of the draws that are not copies
    assert (toks < cfg.vocab // 8).mean() > 0.3


@pytest.mark.parametrize("arch", ["phi3_vision_4p2b", "whisper_base"])
def test_pipeline_family_inputs(arch):
    """The VLM's patch embeddings and the encoder-decoder's frames, in the
    reference's shapes and dtype (its batch for the same config)."""
    cfg = get_smoke_config(arch)
    from repro.data import SyntheticPipeline as JaxPipeline
    _, want = JaxPipeline(jax_smoke(arch), 2, 24).next(
        JaxPipeline(jax_smoke(arch), 2, 24).init_state())
    got = SyntheticPipeline(cfg, 2, 24, device="cpu").generate(0)
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        if k not in ("tokens", "labels"):
            assert got[k].dtype == cfg.policy.c()
            assert abs(float(got[k].float().std()) - 1) < 0.1


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(5, dtype=torch.float32),
            "b": {"c": torch.ones((2, 3), dtype=torch.bfloat16) * 1.5,
                  "d": np.zeros((), np.int32)}}
    ck.save(3, tree, extra={"pipeline": {"seed": 0, "step": 3}})
    restored, step, extra = ck.restore(tree)
    assert step == 3 and extra["pipeline"]["step"] == 3
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert restored["b"]["d"].dtype == np.int32
    with open(os.path.join(ck.step_dir(3), "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["dtypes"] == ["float32", "bfloat16", "int32"]
    assert manifest["shapes"] == [[5], [2, 3], []]
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"a": tree["a"]})


def test_checkpoint_ignores_corrupt_and_gcs(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    tree = {"x": torch.ones(4)}
    for s in (1, 2, 3):
        ck.save(s, tree)
    assert ck.available_steps() == [2, 3]           # keep_last GC
    # corrupt the newest manifest -> restore falls back
    with open(os.path.join(ck.step_dir(3), "manifest.json"), "w") as f:
        f.write("{not json")
    assert ck.available_steps() == [2]
    _, step, _ = ck.restore(tree)
    assert step == 2
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(tree)


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=True)
    tree = {"x": torch.arange(10)}
    ck.save(1, tree)
    ck.save(2, tree)                  # waits for the first write
    ck.wait()
    assert ck.latest_step() == 2 and ck._pending is None
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


# ---------------------------------------------------------------------------
# checkpoints carried between the packages
# ---------------------------------------------------------------------------

BF16 = {"param_dtype": "bfloat16"}


def _cross_states(with_efb):
    """The reference's train state one int8-compressed step in (bf16
    params, bf16 moments, error-feedback buffers: every dtype a
    checkpoint stores) and the port's fresh state of the same config."""
    jc = jax_smoke("qwen1p5_0p5b").replace(policy=JaxPolicy(**BF16))
    tc = get_smoke_config("qwen1p5_0p5b").replace(
        policy=PrecisionPolicy(**BF16))
    jopt = JaxAdamW(schedule=jax_constant(1e-3), state_dtype="bfloat16")
    topt = AdamW(schedule=constant_schedule(1e-3), state_dtype="bfloat16")
    jstate = japi.init_train_state(jc, jopt, jax.random.PRNGKey(5),
                                   with_efb=with_efb)
    toks = jax.random.randint(jax.random.PRNGKey(6), (2, 17), 0, jc.vocab)
    step = japi.make_train_step(jc, jopt, grad_compressor=JaxCompressor(
        "int8") if with_efb else None)
    jstate, _ = jax.jit(step)(jstate, {"tokens": toks[:, :-1],
                                       "labels": toks[:, 1:]})
    tstate = api.init_train_state(tc, topt, seed=1, device="cpu",
                                  with_efb=with_efb)
    return tc, jstate, tstate


def _bits(x):
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16).view(np.int16) if x.dtype.name == "bfloat16" \
        else x


@pytest.mark.parametrize("with_efb", [False, True], ids=["plain", "efb"])
def test_each_package_restores_the_others_checkpoint(tmp_path, with_efb):
    tc, jstate, tstate = _cross_states(with_efb)
    want = jax.tree.map(np.asarray, jstate)
    # the reference writes, the port restores into its own state
    JaxCheckpointer(str(tmp_path / "jax")).save(
        1, jstate, extra={"pipeline": {"seed": 0, "step": 1}})
    tree, step, extra = Checkpointer(str(tmp_path / "jax")).restore(
        train_state_to_numpy(tc, tstate))
    assert step == 1 and extra["pipeline"]["step"] == 1
    ported = train_state_from_numpy(tc, tree, device="cpu")
    got = train_state_to_numpy(tc, ported)
    assert jax.tree_util.tree_structure(jax.tree.map(
        lambda x: 0, got, is_leaf=torch.is_tensor)) == \
        jax.tree_util.tree_structure(jax.tree.map(lambda x: 0, want))
    for a, b in zip(jax.tree_util.tree_leaves(got, is_leaf=torch.is_tensor),
                    jax.tree_util.tree_leaves(want)):
        assert str(a.dtype).split(".")[-1] == b.dtype.name
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the port writes, the reference restores into its fresh state
    Checkpointer(str(tmp_path / "torch")).save(
        1, got, extra={"pipeline": {"seed": 0, "step": 1}})
    jfresh = jax.tree.map(jnp.zeros_like, jstate)
    back, step, _ = JaxCheckpointer(str(tmp_path / "torch")).restore(jfresh)
    assert step == 1
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the files hold the same leaves: names, dtypes, shapes
    for d in ("jax", "torch"):
        with open(tmp_path / d / "step_0000000001" / "manifest.json") as f:
            m = json.load(f)
        assert m["dtypes"] == [b.dtype.name for b in
                               jax.tree_util.tree_leaves(want)]


# ---------------------------------------------------------------------------
# trainer: runs, crash/restart, preemption, stragglers
# ---------------------------------------------------------------------------

def _mk_trainer(tmp_path, arch="qwen1p5_0p5b", steps=12, fault_hook=None,
                grad_compress="none", log_every=50):
    cfg = get_smoke_config(arch)
    pipe = SyntheticPipeline(cfg, batch=4, seq=32, device="cpu")
    tcfg = TrainerConfig(total_steps=steps, checkpoint_every=5,
                         log_every=log_every, lr=3e-3, warmup=2,
                         grad_compress=grad_compress)
    ck = Checkpointer(str(tmp_path), keep_last=2)
    return Trainer(cfg, tcfg, pipe, ck, fault_hook=fault_hook)


def test_trainer_runs_and_learns(tmp_path):
    tr = _mk_trainer(tmp_path, steps=30, log_every=5)
    state, status = tr.run()
    assert status == "done" and int(state["step"]) == 30
    assert len(tr.step_times) == 30
    losses = [m["loss"] for m in tr.metrics_log]
    assert [m["step"] for m in tr.metrics_log] == [5, 10, 15, 20, 25, 30]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert tr.ckpt.available_steps() == [25, 30]


class _CrashOnce:
    def __init__(self, at):
        self.at = at
        self.done = False

    def __call__(self, step):
        if step == self.at and not self.done:
            self.done = True
            raise RuntimeError("injected node failure")


def _params(state):
    return [p.detach().numpy() for p in state["params"].parameters()]


def test_trainer_crash_restart_exact_resume(tmp_path):
    crash = _CrashOnce(at=8)
    tr = _mk_trainer(tmp_path, steps=12, fault_hook=crash)
    with pytest.raises(RuntimeError):
        tr.run()
    # "new process": a fresh trainer against the same checkpoint dir
    tr2 = _mk_trainer(tmp_path, steps=12)
    state, status = tr2.run()
    assert status == "done" and int(state["step"]) == 12
    # the resumed run started from the last checkpoint (step 5)
    assert len(tr2.step_times) == 7
    # an uninterrupted run gives the same final params
    state3, _ = _mk_trainer(tmp_path / "fresh", steps=12).run()
    for a, b in zip(_params(state), _params(state3)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_trainer_preemption_checkpoints(tmp_path):
    tr = _mk_trainer(tmp_path, steps=50)

    def preempt(step):
        if step == 6:
            tr._preempted = True

    tr.fault_hook = preempt
    state, status = tr.run()
    assert status == "preempted" and int(state["step"]) == 6
    assert tr.ckpt.latest_step() == 6
    assert issubclass(PreemptionRequested, Exception)


def test_trainer_straggler_detection(tmp_path):
    tr = _mk_trainer(tmp_path, steps=10)

    def slow(step):
        if step == 7:     # slower than any step so far, whatever the load
            time.sleep(0.5 + 4 * max(tr.step_times))

    tr.fault_hook = slow
    tr.run()
    assert 7 in tr.stragglers and 0 not in tr.stragglers


def test_grad_compression_int8_error_feedback(tmp_path):
    """int8-compressed training stays close to uncompressed training, and
    carries nonzero error-feedback buffers."""
    s_ref, _ = _mk_trainer(tmp_path / "a", steps=10).run()
    s_c, _ = _mk_trainer(tmp_path / "b", steps=10, grad_compress="int8").run()
    ref = np.concatenate([a.ravel() for a in _params(s_ref)])
    com = np.concatenate([a.ravel() for a in _params(s_c)])
    assert np.linalg.norm(ref - com) / np.linalg.norm(ref) < 0.05
    assert any(bool(e.abs().max() > 0) for e in s_c["efb"].values())


def test_trainer_one_device_only(tmp_path):
    tr = _mk_trainer(tmp_path)
    with pytest.raises(NotImplementedError, match="item 13"):
        tr.remesh(None, None)
    cfg = get_smoke_config("qwen1p5_0p5b")
    with pytest.raises(NotImplementedError, match="item 13"):
        Trainer(cfg, TrainerConfig(), SyntheticPipeline(
            cfg, 2, 8, device="cpu"), tr.ckpt, mesh=object())


# ---------------------------------------------------------------------------
# launcher and example
# ---------------------------------------------------------------------------

def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    state, status = cli.main(["--arch", "qwen1p5_0p5b", "--smoke",
                              "--device", "cpu", "--steps", "4", "--batch",
                              "2", "--seq", "16", "--ckpt", str(tmp_path),
                              "--ckpt-every", "2", "--grad-compress",
                              "int8"])
    assert status == "done" and int(state["step"]) == 4
    assert "finished: done at step 4" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).available_steps() == [2, 4]
    # a second launch resumes at the end and takes no step
    state, status = cli.main(["--arch", "qwen1p5_0p5b", "--smoke",
                              "--device", "cpu", "--steps", "4", "--ckpt",
                              str(tmp_path), "--grad-compress", "int8"])
    assert int(state["step"]) == 4
    assert "resumed from checkpoint step 4" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 13"):
        cli.main(["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu",
                  "--production-mesh"])


def test_train_lm_example_on_cpu(tmp_path, capsys):
    tr = train_lm.main(["--steps", "40", "--batch", "4", "--seq", "32",
                        "--ckpt", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "params=" in out and "LEARNING" in out
    assert len(tr.metrics_log) == 2
