"""End-to-end LM training demo: data pipeline -> train step -> fault-
tolerant trainer with checkpointing -> loss curve; the twin of
``examples/train_lm.py``.

The default scale is CPU-friendly (a reduced qwen-family config, a few
hundred steps); ``--hundred-m`` switches to a ~100M-parameter config.

    python -m repro_torch.examples.train_lm --steps 200 --device cpu
    python -m repro_torch.examples.train_lm --arch minicpm_2b --steps 50

Runs on the card unless ``--device`` names another device.  The default
checkpoint directory is ``repro_torch_train_lm`` under the temporary
directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.backend import default_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticPipeline
from repro_torch.models import api
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1p5_0p5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--hundred-m", action="store_true",
                    help="~100M-param config (slow on CPU)")
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if args.hundred_m:
        cfg = cfg.replace(n_layers=12, d_model=768, n_heads=12, n_kv=12,
                          d_ff=2048, vocab=32768, attn_q_chunk=512,
                          attn_kv_chunk=512)
    dev = default_device(args.device)
    with torch.device("meta"):
        n_params = sum(p.numel() for p in api.family_module(cfg).Model(
            cfg).parameters())
    print(f"[train_lm] arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"steps={args.steps} batch={args.batch}x{args.seq}")

    pipe = SyntheticPipeline(cfg, args.batch, args.seq, device=dev)
    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=50,
                         log_every=20, lr=3e-3, warmup=20,
                         grad_compress=args.grad_compress)
    trainer = Trainer(cfg, tcfg, pipe, Checkpointer(args.ckpt, keep_last=2))
    state, status = trainer.run()
    losses = [m["loss"] for m in trainer.metrics_log]
    if len(losses) >= 2:
        print(f"[train_lm] {status}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"over {int(state['step'])} steps "
              f"({'LEARNING' if losses[-1] < losses[0] else 'check config'})")
    return trainer


if __name__ == "__main__":
    main()
