"""Fault-tolerant training loop.

Twin of ``src/repro/runtime/trainer.py``:
  - checkpoint/restart: periodic atomic checkpoints holding the train
    state (in the reference's tree, ``convert.train_state_to_numpy``) and
    the data pipeline's state; ``run`` resumes from the latest valid step
    after any crash or preemption;
  - preemption: SIGTERM (and an injectable fault hook) triggers a final
    checkpoint and a clean exit;
  - straggler detection: an EWMA of the step's wall time, seeded from the
    second step (the first carries the warm-up); steps slower than
    ``straggler_factor`` times the EWMA are logged and counted.

The step runs eagerly on the pipeline's device.  Each step waits for the
device (``torch.cuda.synchronize``), as the reference blocks on its loss,
so the wall time is the step's; the metrics are read to the host only on
``log_every`` steps.  Elastic re-meshing needs more than one device:
:meth:`Trainer.remesh` raises (ROADMAP item 13c).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import torch

from .. import convert
from ..checkpoint.checkpointer import Checkpointer
from ..data.pipeline import PipelineState, SyntheticPipeline
from ..models import api
from ..optim import AdamW, Compressor, cosine_schedule, wsd_schedule

_MESH = ("{} needs more than one device: meshes and sharded state are "
         "ROADMAP item 13c (multi-device)")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1
    lr: float = 3e-4
    warmup: int = 10
    grad_compress: str = "none"      # none | bf16 | int8


class PreemptionRequested(Exception):
    pass


def _block(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, model_cfg, tcfg: TrainerConfig,
                 pipeline: SyntheticPipeline, checkpointer: Checkpointer, *,
                 mesh=None, state_shardings=None,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 handle_sigterm: bool = False):
        if mesh is not None or state_shardings is not None:
            raise NotImplementedError(_MESH.format("Trainer(mesh=...)"))
        self.cfg = model_cfg
        self.tcfg = tcfg
        self.pipe = pipeline
        self.device = pipeline.device
        self.ckpt = checkpointer
        self.fault_hook = fault_hook
        self._preempted = False
        if handle_sigterm:
            signal.signal(signal.SIGTERM, self._on_sigterm)

        sched = (wsd_schedule(tcfg.lr, tcfg.warmup,
                              int(tcfg.total_steps * 0.8),
                              int(tcfg.total_steps * 0.2))
                 if model_cfg.lr_schedule == "wsd" else
                 cosine_schedule(tcfg.lr, tcfg.warmup, tcfg.total_steps))
        self.optimizer = AdamW(schedule=sched)
        comp = (Compressor(tcfg.grad_compress)
                if tcfg.grad_compress != "none" else None)
        self.step_fn = api.make_train_step(self.cfg, self.optimizer,
                                           grad_compressor=comp)
        self.with_efb = tcfg.grad_compress == "int8"

        # telemetry
        self.step_times: list[float] = []
        self.stragglers: list[int] = []
        self.metrics_log: list[dict] = []

    # -- preemption ------------------------------------------------------------
    def _on_sigterm(self, *_):
        self._preempted = True

    # -- state ------------------------------------------------------------------
    def fresh_state(self, seed: int = 0):
        state = api.init_train_state(self.cfg, self.optimizer, seed=seed,
                                     device=self.device,
                                     with_efb=self.with_efb)
        return state, self.pipe.init_state()

    def restore_or_init(self, seed: int = 0):
        state, pstate = self.fresh_state(seed)
        if self.ckpt.latest_step() is None:
            print("[trainer] fresh start")
            return state, pstate
        tree, step, extra = self.ckpt.restore(
            convert.train_state_to_numpy(self.cfg, state))
        del state
        state = convert.train_state_from_numpy(self.cfg, tree, self.device)
        pstate = PipelineState.from_dict(
            extra.get("pipeline", pstate.to_dict()))
        print(f"[trainer] resumed from checkpoint step {step}")
        return state, pstate

    def _save(self, state, pstate: PipelineState):
        self.ckpt.save(int(state["step"]),
                       convert.train_state_to_numpy(self.cfg, state),
                       extra={"pipeline": pstate.to_dict()})

    # -- loop --------------------------------------------------------------------
    def run(self, seed: int = 0):
        state, pstate = self.restore_or_init(seed)
        ewma = None
        try:
            while int(state["step"]) < self.tcfg.total_steps:
                step = int(state["step"])
                t0 = time.perf_counter()
                if self.fault_hook is not None:
                    self.fault_hook(step)           # fault/slowdown injection
                if self._preempted:
                    raise PreemptionRequested()
                pstate, batch = self.pipe.next(pstate)
                state, metrics = self.step_fn(state, batch)
                _block(self.device)
                dt = time.perf_counter() - t0
                # straggler detection (EWMA of step time), seeded from the
                # second step: the first carries the warm-up
                if ewma is not None and dt > self.tcfg.straggler_factor * ewma:
                    self.stragglers.append(step)
                    print(f"[trainer] straggler step {step}: "
                          f"{dt * 1e3:.1f}ms vs ewma {ewma * 1e3:.1f}ms")
                if self.step_times:
                    ewma = dt if ewma is None else \
                        ((1 - self.tcfg.ewma_alpha) * ewma
                         + self.tcfg.ewma_alpha * dt)
                self.step_times.append(dt)

                if (step + 1) % self.tcfg.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step + 1
                    m["ms"] = dt * 1e3
                    self.metrics_log.append(m)
                    print(f"[trainer] step {step + 1} "
                          f"loss {m['loss']:.4f} ({dt * 1e3:.1f} ms)")
                if (step + 1) % self.tcfg.checkpoint_every == 0:
                    self._save(state, pstate)
        except PreemptionRequested:
            print("[trainer] preemption: checkpoint + exit")
            self._save(state, pstate)
            self.ckpt.wait()
            return state, "preempted"
        self._save(state, pstate)
        self.ckpt.wait()
        return state, "done"

    # -- elasticity ---------------------------------------------------------------
    def remesh(self, make_mesh_fn, make_shardings_fn):
        raise NotImplementedError(_MESH.format("Trainer.remesh"))
