"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1p5_0p5b \\
      --smoke --device cpu --steps 50 --batch 8 --seq 128

trains the smoke config on the CPU; without ``--device`` it runs on the
card (without ``--smoke``, at the config's full widths).  One process, one
device: the reference's production mesh (``--production-mesh``,
``--multi-pod``) needs several and raises (ROADMAP item 13b).  The default
checkpoint directory is ``repro_torch_ckpt`` under the temporary
directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.backend import default_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticPipeline
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--production-mesh", action="store_true",
                    help="shard over the production mesh (not on one card)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.production_mesh or args.multi_pod:
        raise NotImplementedError(
            "--production-mesh/--multi-pod shard over many devices: ROADMAP "
            "item 13b (multi-device)")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    pipe = SyntheticPipeline(cfg, args.batch, args.seq, seed=args.seed,
                             device=default_device(args.device))
    tcfg = TrainerConfig(total_steps=args.steps, lr=args.lr,
                         checkpoint_every=args.ckpt_every,
                         grad_compress=args.grad_compress)
    ckpt = Checkpointer(args.ckpt, keep_last=3)
    trainer = Trainer(cfg, tcfg, pipe, ckpt, handle_sigterm=True)
    state, status = trainer.run(seed=args.seed)
    print(f"[train] finished: {status} at step {int(state['step'])}")
    if trainer.metrics_log:
        first, last = trainer.metrics_log[0], trainer.metrics_log[-1]
        print(f"[train] loss {first['loss']:.4f} -> {last['loss']:.4f}")
    return state, status


if __name__ == "__main__":
    main()
