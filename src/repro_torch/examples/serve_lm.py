"""Batched serving demo: bucketed batches with a prefill/decode split on a
smoke-scale model; the twin of ``examples/serve_lm.py``.  Every family
serves: the KV-cache transformers (dense, MoE, VLM), the SSM-state
decoders (falcon-mamba, the zamba2 hybrid) and the encoder-decoder with
its cross-attention cache.

    python -m repro_torch.examples.serve_lm --arch qwen1p5_0p5b
    python -m repro_torch.examples.serve_lm --arch falcon_mamba_7b \
        --device cpu

Runs on the card unless ``--device`` names another device.  The time it
prints is the serve call on the host clock, synchronised with the device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.backend import default_device
from repro_torch.configs import get_smoke_config
from repro_torch.models import api
from repro_torch.runtime import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1p5_0p5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    dev = default_device(args.device)
    params = api.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)

    extras = None
    if cfg.family == "vlm":
        extras = {"patch_embeds": rng.standard_normal(
            (cfg.n_patches, cfg.d_model), dtype=np.float32)}
    if cfg.family == "encdec":
        extras = {"frames": rng.standard_normal(
            (cfg.enc_positions, cfg.d_model), dtype=np.float32)}

    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, 8 + 4 * (i % 3),
                                        dtype=np.int32),
                    max_new_tokens=args.max_new, extras=extras)
            for i in range(args.requests)]
    engine = ServeEngine(cfg, params, max_seq=96,
                         temperature=args.temperature)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tok = sum(len(r.tokens) for r in results)
    print(f"[serve_lm] {cfg.name}: {len(results)} requests, {tok} tokens, "
          f"{dt:.2f}s ({tok / dt:.1f} tok/s) on {dev}")
    for r in results:
        print(f"  uid={r.uid}: {r.tokens.tolist()}")
    return results


if __name__ == "__main__":
    main()
