"""Time the tiled complex builds of bf16 planes through their C entries.

    python3 tools/time_tiled_bf16.py [CHECKOUT] [LABEL]

On one CUDA card, at the paper shape (B = 1001 bins, m = 100, n = 5000),
for the checkout CHECKOUT (default: the one this script sits in; its
kernels build into CHECKOUT/build): the tiled N and T/H products (mode H)
at S = 1, 8 and 32 and the tiled Gram in data space (1001, 100, 5000) and
parameter space (1001, 100, 1000), each on the 2 x 2 and the ragged 3 x 3
map of ``chip_smoke.py``, beside the untiled build and one ``torch.bmm``
of the stacked real planes (the same function at a bf16 carrier, where
every cell's rounding is the identity).  Each is timed queued (200 calls
behind a device-side spin, 20 for a call of 2 ms or more; the median)
twice.  Then ``hhhhh;tiles=ds|sh`` (its effective map all h) and uniform
``hhhhh`` through matvec, rmatvec, matmat and rmatmat (S = 8) at the paper
shape (N_t = 1000, N_d = 100, N_m = 5000), median of 20 events a call.
Prints a line a build and writes ``chiprun_out/tiled_bf16_LABEL.json``
under the working directory.  Checks nothing: it times a parent checkout
whose builds a newer ``chip_smoke.py`` would refuse.
"""
import ctypes
import json
import pathlib
import subprocess
import sys
import time

import torch

root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                    else pathlib.Path(__file__).resolve().parents[1]).resolve()
label = sys.argv[2] if len(sys.argv) > 2 else "tree"
if not torch.cuda.is_available():
    sys.exit("time_tiled_bf16: no CUDA device; nothing was run")
sys.path.insert(0, str(root / "src"))
from repro_torch.core import (FFTMatvec, PrecisionConfig,  # noqa: E402
                              random_block_column, time_callable)
from repro_torch.core.precision import DOUBLE  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import sbgemv as sk  # noqa: E402

assert pathlib.Path(_build.__file__).resolve().is_relative_to(root), _build.__file__
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True, text=True,
                     check=True).stdout.strip()
print(label, root, smi, flush=True)
t0 = time.perf_counter()
_build.build(names=("sbgemv", "sbgemm"))
print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

B, m, n = 1001, 100, 5000
MAPS = {"2x2": (("d", "s"), ("s", "h")),
        "3x3": (("h", "s", "d"), ("s", "d", "h"), ("d", "h", "s"))}
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(12)
bf = torch.bfloat16


def entry(source, name, tensors, shape, ints, levels=None):
    fn = getattr(_build.library(source), name)
    sizes = shape
    if name in getattr(sk, "STRIDED_ENTRIES", ()):   # A's strides follow
        sizes = (*sizes, *sk._a_strides(tensors[0]))
    sizes = (*sizes, *ints)
    ptrs, grid = [t.data_ptr() for t in tensors], None
    if levels is not None:
        R, C, grid = sk._level_grid(levels)
        ptrs.append(ctypes.addressof(grid))
        sizes = (*sizes, R, C)
    code = _build.DTYPE_CODES[bf]
    args = (*ptrs, *sizes, code, code, 0, _build.stream_of(tensors[0]))

    def call(_, grid=grid):
        _build.check(fn(*args), name)
    return call


def queued(fn):
    one = time_callable(fn, None, repeats=3, warmup=1)
    reps = 200 if one < 2.0 else 20
    return time_callable(fn, None, repeats=reps, mode="queued")


def bmm_call(Ar, Ai, X, mode):
    if mode == "N":
        As = torch.cat([Ar, Ai], dim=1)
        return lambda _: torch.bmm(As, X)
    As = torch.cat([Ar, Ai], dim=2)
    return lambda _: torch.bmm(As.mT, X)


out = {"nvidia_smi": smi, "label": label, "root": str(root), "rows": {}}
Ar, Ai = (torch.randn((B, m, n), generator=gen, device=dev).to(bf)
          for _ in range(2))
for S in (1, 8, 32):
    for mode in "NH":
        xlen, ylen = (n, m) if mode == "N" else (m, n)
        shape = (B, xlen, S) if S > 1 else (B, xlen)
        Xr, Xi = (torch.randn(shape, generator=gen, device=dev).to(bf)
                  for _ in range(2))
        Y = [torch.empty(shape[:1] + (ylen,) + shape[2:], device=dev, dtype=bf)
             for _ in range(2)]
        kind = "sbgemm" if S > 1 else "sbgemv"
        kname = f"{kind}_{'n' if mode == 'N' else 'th'}_complex"
        shape = (B, m, n) + ((S,) if S > 1 else ())
        ints = (1,) if mode == "H" else ()
        X = torch.cat([Xr.reshape(B, xlen, -1), Xi.reshape(B, xlen, -1)], dim=-1)
        lib = bmm_call(Ar, Ai, X, mode)
        unt = entry(kind, kname, (Ar, Ai, Xr, Xi, *Y), shape, ints)
        row = {"untiled": queued(unt), "bmm": queued(lib)}
        for tname, lv in MAPS.items():
            t = entry(kind, kname + "_tiled", (Ar, Ai, Xr, Xi, *Y), shape, ints,
                      lv)
            row[tname] = queued(t)
            row[tname + "_again"] = queued(t)
        row["bmm_again"] = queued(lib)
        row["untiled_again"] = queued(unt)
        key = f"{kname}_tiled {mode} S={S}"
        out["rows"][key] = row
        print(key, json.dumps(row), flush=True)
        del Xr, Xi, Y, X, lib
for space, nn in (("data", n), ("parameter", 1000)):
    data = space == "data"
    Ar2, Ai2 = Ar[:, :, :nn].contiguous(), Ai[:, :, :nn].contiguous()
    P = m if data else nn
    G = [torch.empty((B, P, P), device=dev, dtype=bf) for _ in range(2)]
    unt = entry("sbgemm", sk.gram_kernel_for(bf, data, P), (Ar2, Ai2, *G),
                (B, m, nn), (int(data),))
    if data:
        As = torch.cat([Ar2, Ai2], dim=1)
        lib = lambda _: torch.bmm(As, As.mT)
    else:
        As = torch.cat([Ar2, Ai2], dim=2)
        lib = lambda _: torch.bmm(As.mT, As)
    row = {"untiled": queued(unt), "bmm": queued(lib)}
    for tname, lv in MAPS.items():
        t = entry("sbgemm", "sbgemm_gram_tiled", (Ar2, Ai2, *G), (B, m, nn),
                  (int(data),), lv)
        row[tname] = queued(t)
        row[tname + "_again"] = queued(t)
    row["bmm_again"] = queued(lib)
    row["untiled_again"] = queued(unt)
    key = f"sbgemm_gram_tiled {space} {(B, m, nn)}"
    out["rows"][key] = row
    print(key, json.dumps(row), flush=True)
    del Ar2, Ai2, G, As, lib
    torch.cuda.empty_cache()
# the operator: hhhhh;tiles=ds|sh (its effective map all h) beside uniform
# hhhhh, median of events (the wrappers' host time included)
del Ar, Ai
torch.cuda.empty_cache()
N_t, N_d, N_m, S = 1000, 100, 5000, 8
F_col = random_block_column(gen, N_t, N_d, N_m)
op_d = FFTMatvec.from_block_column(F_col, precision=DOUBLE, device=dev)
del F_col
f64 = dict(generator=gen, device=dev, dtype=torch.float64)
calls = {"matvec": torch.randn((N_m, N_t), **f64),
         "rmatvec": torch.randn((N_d, N_t), **f64),
         "matmat": torch.randn((N_m, N_t, S), **f64),
         "rmatmat": torch.randn((N_d, N_t, S), **f64)}
for cfg_s in ("hhhhh;tiles=ds|sh", "hhhhh"):
    op = op_d.with_precision(PrecisionConfig.from_string(cfg_s))
    row = {k: time_callable(getattr(op, k), x) for k, x in calls.items()}
    out["rows"][cfg_s] = row
    print(cfg_s, json.dumps(row), flush=True)
    del op
dst = pathlib.Path("chiprun_out")
dst.mkdir(exist_ok=True)
(dst / f"tiled_bf16_{label}.json").write_text(json.dumps(out, indent=1))
print("done", label, flush=True)
