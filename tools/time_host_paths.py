"""Time the host-bound paths of one checkout on one CUDA card.

    python3 tools/time_host_paths.py [CHECKOUT] [LABEL]

For the checkout CHECKOUT (default: the one this script sits in; its
kernels build into CHECKOUT/build), with this script's own
``chip_smoke.py`` as the harness:

* an S = 1 ``matvec`` and ``rmatvec`` at N_t = 1000, N_d = 100, N_m =
  5000 for a ddddd, a dssdd and an hhhhh operator (random F_hat planes
  from a seed): ``host_us``, the wall time of one ``matvec`` as the host
  issues it (every launch and the Python around it), the median of 15
  rounds of 40 calls issued back to back after a synchronize, each
  round's mean; ``F_ms`` and ``Fstar_ms``, the median of 20 CUDA-event
  timed calls after 3 warm-ups (``core.time_callable``);
* the LM serve of ``chip_smoke.serve_plan`` (qwen1.5-0.5b at full width,
  flash attention, 8 requests in two batches, 32 new tokens each): one
  warm-up ``ServeEngine.serve``, then one timed (``chip_smoke.
  _serve_once``): tokens/s on the host clock, each prefill's ms and the
  decode steps' median ms on CUDA events.

Both paths are host-bound, so compare two checkouts in one call, parent
and change alternating.  Prints a line per row and writes
``chiprun_out/host_paths_LABEL.json`` under the working directory.
Checks nothing.
"""
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

HERE = pathlib.Path(__file__).resolve().parents[1]
root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else HERE).resolve()
label = sys.argv[2] if len(sys.argv) > 2 else "tree"
if not torch.cuda.is_available():
    sys.exit("time_host_paths: no CUDA device; nothing was run")
sys.path.insert(0, str(root / "src"))
sys.path.insert(1, str(HERE))
import chip_smoke  # noqa: E402
from repro_torch.core import (FFTMatvec, PrecisionConfig,  # noqa: E402
                              time_callable)
from repro_torch.core import precision as prec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import api  # noqa: E402

ROUNDS, CALLS = 15, 40
dev = torch.device("cuda", 0)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip().splitlines()[0]
print(f"{label}: {root}; {smi}", flush=True)
_build.build(("pad_cast", "sbgemv", "flash_attention"))
N_t, N_d, N_m = 1000, 100, 5000
gen = torch.Generator(device=dev).manual_seed(0)
rows = []
for cfg_s in ("ddddd", "dssdd", "hhhhh"):
    cfg = PrecisionConfig.from_string(cfg_s)
    dt = prec.real_dtype(cfg.gemv)
    planes = [torch.randn((N_t + 1, N_d, N_m), generator=gen, device=dev,
                          dtype=torch.float32).to(dt) for _ in range(2)]
    op = FFTMatvec(planes[0], planes[1], N_t, cfg)
    x = torch.randn((N_m, N_t), generator=gen, device=dev,
                    dtype=torch.float32).to(op.io_dtype)
    y = torch.randn((N_d, N_t), generator=gen, device=dev,
                    dtype=torch.float32).to(op.io_dtype)
    _build.reset_launch_counts()
    op.matvec(x)
    torch.cuda.synchronize(dev)
    launches = dict(_build.launch_counts)
    means = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(CALLS):
            op.matvec(x)
        means.append((time.perf_counter() - t0) / CALLS * 1e6)
    torch.cuda.synchronize(dev)
    row = {"config": cfg_s, "host_us": statistics.median(means),
           "host_us_rounds": means,
           "F_ms": time_callable(op.matvec, x, 20, warmup=3),
           "Fstar_ms": time_callable(op.rmatvec, y, 20, warmup=3),
           "launches": launches}
    rows.append(row)
    print(f"{label} {cfg_s}: host {row['host_us']:.1f} us a matvec (rounds "
          f"{[round(m, 1) for m in means]}), F {row['F_ms']:.4f} ms, F* "
          f"{row['Fstar_ms']:.4f} ms, launches {launches}", flush=True)
    del op, planes, x, y
    torch.cuda.empty_cache()

cfg, reqs, bucket, max_seq, _ = chip_smoke.serve_plan(True)
model = api.init_params(cfg, torch.Generator(device=dev).manual_seed(29),
                        device=dev)
chip_smoke._serve_once(dev, cfg, model, reqs, bucket, max_seq)   # warm-up
_, run = chip_smoke._serve_once(dev, cfg, model, reqs, bucket, max_seq)
steps = run["decode_ms_per_step"]
serve = {"tokens_per_s": run["tokens_per_s"], "wall_s": run["wall_s"],
         "prefill_ms": run["prefill_ms"],
         "decode_ms_median": steps[len(steps) // 2],
         "decode_steps": run["decode_steps"]}
print(f"{label} serve: {serve['tokens_per_s']:.1f} tok/s, prefill ms "
      f"{[round(t, 3) for t in serve['prefill_ms']]}, decode ms/step median "
      f"{serve['decode_ms_median']:.3f}", flush=True)
out = pathlib.Path("chiprun_out")
out.mkdir(exist_ok=True)
(out / f"host_paths_{label}.json").write_text(json.dumps(
    {"label": label, "checkout": str(root), "nvidia_smi": smi,
     "rows": rows, "serve": serve}, indent=1))
