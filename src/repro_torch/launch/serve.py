"""Serving launcher: bring up a ServeEngine on a model (the smoke config
unless ``--full``) and run a synthetic batched-request workload.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1p5_0p5b \
      --device cpu                 # smoke widths on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1p5_0p5b \
      --full                       # full widths on the card

Every architecture of ``configs`` serves, each family through its decode
state; the VLM gets stub patch embeddings, the encoder-decoder stub
frames.

Runs on the card unless ``--device`` names another device.  The line
``[serve] ... tok/s`` times the whole serve call on the host clock,
synchronised with the device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.backend import default_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import api
from repro_torch.runtime import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="full config (default is smoke)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    dev = default_device(args.device)
    rng = np.random.default_rng(args.seed)
    params = api.init_params(cfg, seed=args.seed, device=dev)

    extras = None
    if cfg.family == "vlm":
        extras = {"patch_embeds": rng.standard_normal(
            (cfg.n_patches, cfg.d_model), dtype=np.float32)}
    if cfg.family == "encdec":
        extras = {"frames": rng.standard_normal(
            (cfg.enc_positions, cfg.d_model), dtype=np.float32)}

    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.max_new, extras=extras)
            for i in range(args.requests)]

    engine = ServeEngine(cfg, params, max_seq=args.max_seq,
                         temperature=args.temperature, seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.tokens) for r in results)
    print(f"[serve] {len(results)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s) on {dev}")
    for r in results[:4]:
        print(f"  uid={r.uid} tokens={r.tokens.tolist()}")
    return results


if __name__ == "__main__":
    main()
