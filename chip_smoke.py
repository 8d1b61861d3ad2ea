#!/usr/bin/env python3
"""Drive the PyTorch port of FFTMatvec on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit.  It:

1. prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions, and builds the hand-written kernels from ``src/``;
2. holds each kernel against its plain PyTorch version on the card, at
   ragged small shapes and at the paper shapes, for every dtype it takes:
   pad/unpad bitwise, sbgemv at rel <= 1e-12 (f64), 1e-5 (f32), 2e-2 (bf16),
   and checks that automatic dispatch on the card launches the sbgemv
   kernels at tall as well as short-wide shapes;
3. drives the main path, ``FFTMatvec.from_block_column`` -> ``matvec`` /
   ``rmatvec`` at the paper's shape N_t=1000, N_d=100, N_m=5000, for the
   seven named precision configs, with the launch counters reset just
   before and read just after; checks the ddddd adjoint identity
   (<= 1e-12), each config against the same operator under the
   ``torch-ref`` oracles, that the error against ddddd grows d -> s -> h,
   and ddddd against the dense oracle at a small shape (<= 1e-13);
4. times each kernel, its plain version and one PyTorch call for the same
   function (CUDA events, median of 20 after warm-up), the end-to-end
   matvec/rmatvec per config and the per-phase split for ddddd and dssdd.

It prints a JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.  Any failed check exits nonzero before
that line.  Full results go to ``chiprun_out/chip_smoke.json``.  Without a
CUDA device, or without the rest of the repository, it exits nonzero and
prints no result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}   # FP64 / FP32 vector
TOL = {"d": 1e-12, "s": 1e-5, "h": 2e-2}
LEVEL_OF = {torch.float64: "d", torch.float32: "s", torch.bfloat16: "h"}
DTYPES = (torch.float64, torch.float32, torch.bfloat16)
REPEATS = 20
SEED = 0


def name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bits(t: torch.Tensor) -> torch.Tensor:
    """Integer view of a float tensor, for bitwise comparison."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def max_abs(a, b) -> float:
    return (a.to(torch.float64) - b.to(torch.float64)).abs().max().item()


def bound_ms(bytes_moved: float, flops: float, flop_dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[flop_dtype] if flops else 0.0
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")


# ---------------------------------------------------------------------------
# 2 + 4a. Kernels against their plain versions; kernel, plain, library times
# ---------------------------------------------------------------------------

def check_pad_kernels(dev, R, T, P, timed, results, time_fn):
    from repro_torch.kernels import pad_cast as pk
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = torch.randn((R, P), generator=gen, device=dev, dtype=torch.float64)
    for din in DTYPES:
        wide = base.to(din)
        for dout in DTYPES:
            # pad reads a row-strided view: (R, T) columns of an (R, P) tensor
            x = wide[:, :T]
            got = pk.pad_cast(x, P, dout)
            want = pk.pad_cast_plain(x, P, dout)
            if not torch.equal(bits(got), bits(want)):
                fail(f"pad_cast {name(din)}->{name(dout)} at {(R, T, P)} "
                     f"differs from its plain version")
            got_u = pk.unpad_cast(wide, T, dout)
            want_u = pk.unpad_cast_plain(wide, T, dout)
            if not torch.equal(bits(got_u), bits(want_u)):
                fail(f"unpad_cast {name(din)}->{name(dout)} at {(R, P, T)} "
                     f"differs from its plain version")
            if not timed or din != dout:
                continue
            xc = x.contiguous()
            s = din.itemsize
            for kname, kfn, pfn, lfn, nbytes in (
                ("pad_cast", lambda a: pk.pad_cast(a, P, dout),
                 lambda a: pk.pad_cast_plain(a, P, dout),
                 lambda a: torch.nn.functional.pad(a.to(dout), (0, P - T)),
                 R * T * s + R * P * s),
                ("unpad_cast", lambda a: pk.unpad_cast(a, T, dout),
                 lambda a: pk.unpad_cast_plain(a, T, dout),
                 lambda a: a[:, :T].to(dout).contiguous(),
                 R * T * 2 * s),
            ):
                arg = xc if kname == "pad_cast" else wide
                b_ms, b_by = bound_ms(nbytes, 0, "float32")
                results[kname][name(din)] = {
                    "shape": [R, T, P], "max_abs_err": 0.0,
                    "ms": time_fn(kfn, arg), "plain_ms": time_fn(pfn, arg),
                    "library_ms": time_fn(lfn, arg), "bytes": nbytes,
                    "bound_ms": b_ms, "bound_by": b_by}
    print(f"pad_cast/unpad_cast at {(R, T, P)}: bitwise equal to the plain "
          f"versions for all 9 dtype pairs", flush=True)


def _library(Ar, Ai, x_re, x_im, mode):
    """One torch.bmm for the same function, its operands built outside the
    timed call.  f32/f64: complex tensors built from the planes.  bf16
    (torch has no complex bf16 matmul): the real planes stacked, A as
    (B, 2m, n) for mode N or (B, m, 2n) for T/H and x as (B, ., 2), so one
    bmm reads the same bytes and gives all four real products; the final
    re/im combine is left out."""
    if Ar.dtype == torch.bfloat16:
        X = torch.stack([x_re, x_im], dim=-1)
        if mode == "N":
            As = torch.cat([Ar, Ai], dim=1)
            return lambda _: torch.bmm(As, X)
        As = torch.cat([Ar, Ai], dim=2)
        return lambda _: torch.bmm(As.mT, X)
    Ac = torch.complex(Ar, Ai)
    xc = torch.complex(x_re, x_im).unsqueeze(-1)
    if mode == "N":
        return lambda _: torch.bmm(Ac, xc)
    if mode == "H":
        return lambda _: torch.bmm(Ac.mH, xc)
    return lambda _: torch.bmm(Ac.mT, xc)


def check_sbgemv_kernels(dev, B, m, n, timed, results, time_fn):
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    A64 = [torch.randn((B, m, n), generator=gen, device=dev,
                       dtype=torch.float64) for _ in range(2)]
    xn64 = [torch.randn((B, n), generator=gen, device=dev,
                        dtype=torch.float64) for _ in range(2)]
    xm64 = [torch.randn((B, m), generator=gen, device=dev,
                        dtype=torch.float64) for _ in range(2)]
    for dt in DTYPES:
        Ar, Ai = (a.to(dt) for a in A64)
        for mode in "NTH":
            if mode == "N":
                xr, xi = (x.to(dt) for x in xn64)
                kname = "sbgemv_n_complex"
                kfn = lambda _: sk.sbgemv_n_complex(Ar, Ai, xr, xi)
                pfn = lambda _: sk.sbgemv_n_complex_plain(Ar, Ai, xr, xi, dt)
                x_elems, y_elems = B * n, B * m
            else:
                xr, xi = (x.to(dt) for x in xm64)
                conj = mode == "H"
                kname = "sbgemv_th_complex"
                kfn = lambda _: sk.sbgemv_th_complex(Ar, Ai, xr, xi, conj=conj)
                pfn = lambda _: sk.sbgemv_th_complex_plain(Ar, Ai, xr, xi,
                                                           conj, dt)
                x_elems, y_elems = B * m, B * n
            got, want = kfn(None), pfn(None)
            err = 0.0
            for g, w in zip(got, want):
                denom = w.to(torch.float64).norm().item() or 1.0
                rel = (g.to(torch.float64) - w.to(torch.float64)).norm().item() / denom
                if not rel <= TOL[LEVEL_OF[dt]]:
                    fail(f"{kname} mode {mode} {name(dt)} at {(B, m, n)}: "
                         f"rel err {rel:.3e} > {TOL[LEVEL_OF[dt]]:g}")
                err = max(err, max_abs(g, w))
            print(f"{kname} mode {mode} {name(dt)} at {(B, m, n)}: "
                  f"max abs err vs plain {err:.3e}", flush=True)
            if not timed or mode == "T":
                continue
            s = dt.itemsize
            nbytes = 2 * B * m * n * s + 2 * x_elems * s + 2 * y_elems * s
            flops = 8 * B * m * n
            acc = "float64" if dt == torch.float64 else "float32"
            b_ms, b_by = bound_ms(nbytes, flops, acc)
            lib = _library(Ar, Ai, xr, xi, mode)
            results[kname][name(dt)] = {
                "shape": [B, m, n], "mode": mode, "max_abs_err": err,
                "ms": time_fn(kfn, None), "plain_ms": time_fn(pfn, None),
                "library_ms": time_fn(lib, None),
                "bytes": nbytes, "flops": flops,
                "bound_ms": b_ms, "bound_by": b_by}
            del lib
        del Ar, Ai


def check_dispatch_on_card(dev):
    """Automatic dispatch on the card takes the kernel at every shape:
    short-wide blocks and tall ones (m * 4 > n), every mode and dtype."""
    from repro_torch.kernels import _build, ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for B, m, n in ((3, 3, 77), (2, 300, 50)):
        for dt in DTYPES:
            A = [torch.randn((B, m, n), generator=gen, device=dev).to(dt)
                 for _ in range(2)]
            for mode in "NTH":
                x = [torch.randn((B, n if mode == "N" else m), generator=gen,
                                 device=dev).to(dt) for _ in range(2)]
                kname = ("sbgemv_n_complex" if mode == "N"
                         else "sbgemv_th_complex")
                before = _build.launch_counts[kname]
                ops.sbgemv(*A, *x, mode)
                if _build.launch_counts[kname] != before + 1:
                    fail(f"ops.sbgemv mode {mode} {name(dt)} at {(B, m, n)} "
                         f"did not launch {kname}")
    print("ops.sbgemv on the card launched its kernel at (3, 3, 77) and "
          "(2, 300, 50) for every mode and dtype", flush=True)


# ---------------------------------------------------------------------------
# 3 + 4b. The main path
# ---------------------------------------------------------------------------

def drive_main_path(dev, N_t, N_d, N_m, timed, time_fn, report):
    from repro_torch.core import (FFTMatvec, NAMED_CONFIGS, dense_matvec,
                                  dense_rmatvec, phase_callables,
                                  random_block_column, rel_l2)
    from repro_torch.core.precision import DOUBLE
    from repro_torch.kernels import _build

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    t0 = time.perf_counter()
    F_col = random_block_column(gen, N_t, N_d, N_m)
    op_d = FFTMatvec.from_block_column(F_col, precision=DOUBLE, device=dev)
    del F_col
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report["setup_s"] = time.perf_counter() - t0
    m = torch.randn((N_m, N_t), generator=gen, device=dev, dtype=torch.float64)
    d = torch.randn((N_d, N_t), generator=gen, device=dev, dtype=torch.float64)

    # -- the counted run: every named config through the kernel path -------
    ops = {cfg.to_string(): op_d.with_precision(cfg) for cfg in NAMED_CONFIGS}
    _build.reset_launch_counts()
    outs = {c: (op.matvec(m), op.rmatvec(d)) for c, op in ops.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    counts = dict(_build.launch_counts)
    n_cfg = len(NAMED_CONFIGS)
    expected = {"pad_cast": 2 * n_cfg, "unpad_cast": 2 * n_cfg,
                "sbgemv_n_complex": n_cfg, "sbgemv_th_complex": n_cfg}
    report["launches"] = counts
    report["launches_expected"] = expected
    print(f"main path launches {counts} (expected {expected})", flush=True)
    check_launches(counts, expected)

    # -- adjoint identity at ddddd -------------------------------------------
    y_d, x_d = outs["ddddd"]
    lhs = torch.dot(y_d.flatten(), d.flatten()).item()
    rhs = torch.dot(m.flatten(), x_d.flatten()).item()
    adj = abs(lhs - rhs) / (y_d.norm().item() * d.norm().item())
    report["adjoint_identity"] = adj
    print(f"ddddd adjoint identity {adj:.3e} (<= 1e-12)", flush=True)
    if not adj <= 1e-12:
        fail(f"adjoint identity {adj:.3e} > 1e-12")

    # -- each config against the oracles; error growth d -> s -> h ----------
    ref_d = None
    rows = {}
    for c in ops:
        op_ref = ops[c].with_backend("torch-ref")
        y_ref, x_ref = op_ref.matvec(m), op_ref.rmatvec(d)
        if c == "ddddd":
            ref_d = (y_ref, x_ref)
        y, x = outs[c]
        lvl = ops[c].precision.lowest()
        e_f, e_a = rel_l2(y, y_ref), rel_l2(x, x_ref)
        for e, what in ((e_f, "matvec"), (e_a, "rmatvec")):
            if not e <= TOL[lvl]:
                fail(f"{c} {what}: kernel path vs torch-ref rel {e:.3e} > "
                     f"{TOL[lvl]:g}")
        rows[c] = {"lowest": lvl, "vs_ref_matvec": e_f, "vs_ref_rmatvec": e_a,
                   "vs_ddddd_matvec": rel_l2(y, ref_d[0]),
                   "vs_ddddd_rmatvec": rel_l2(x, ref_d[1]),
                   "finite": bool(torch.isfinite(y).all() and
                                  torch.isfinite(x).all()),
                   "shapes": [list(y.shape), list(x.shape)]}
        if not rows[c]["finite"] or tuple(y.shape) != (N_d, N_t) \
                or tuple(x.shape) != (N_m, N_t):
            fail(f"{c}: non-finite output or wrong shape")
        print(f"{c}: vs torch-ref {e_f:.3e} / {e_a:.3e}; vs ddddd "
              f"{rows[c]['vs_ddddd_matvec']:.3e} / "
              f"{rows[c]['vs_ddddd_rmatvec']:.3e}", flush=True)
        del op_ref
    for key in ("vs_ddddd_matvec", "vs_ddddd_rmatvec"):
        by = {lvl: [r[key] for r in rows.values() if r["lowest"] == lvl]
              for lvl in "dsh"}
        if not (max(by["d"]) < min(by["s"]) and max(by["s"]) < min(by["h"])):
            fail(f"{key} does not grow d -> s -> h: {by}")
    report["configs"] = rows

    # -- ddddd against the dense oracle at a small shape ---------------------
    g2 = torch.Generator(device=dev).manual_seed(SEED + 3)
    Fs = random_block_column(g2, 32, 4, 40, dtype=torch.float64)
    ms = torch.randn((40, 32), generator=g2, device=dev, dtype=torch.float64)
    ds = torch.randn((4, 32), generator=g2, device=dev, dtype=torch.float64)
    small = FFTMatvec.from_block_column(Fs, precision=DOUBLE, device=dev)
    e_fwd = rel_l2(small.matvec(ms), dense_matvec(Fs, ms))
    e_adj = rel_l2(small.rmatvec(ds), dense_rmatvec(Fs, ds))
    report["dense_small"] = {"shape": [32, 4, 40], "matvec": e_fwd,
                             "rmatvec": e_adj}
    print(f"ddddd vs dense at (32, 4, 40): {e_fwd:.3e} / {e_adj:.3e}",
          flush=True)
    if not (e_fwd <= 1e-13 and e_adj <= 1e-13):
        fail(f"ddddd vs dense oracle {e_fwd:.3e} / {e_adj:.3e} > 1e-13")

    if not timed:
        return
    # -- end-to-end and per-phase times --------------------------------------
    e2e = {}
    for c, op in ops.items():
        e2e[c] = {"matvec_ms": time_fn(op.matvec, m),
                  "rmatvec_ms": time_fn(op.rmatvec, d)}
        print(f"{c}: matvec {e2e[c]['matvec_ms']:.3f} ms, rmatvec "
              f"{e2e[c]['rmatvec_ms']:.3f} ms", flush=True)
    report["end_to_end"] = e2e
    phases = {}
    for c in ("ddddd", "dssdd"):
        for adjoint, x0 in ((False, m), (True, d)):
            x, split = x0, {}
            for ph, fn in phase_callables(ops[c], adjoint=adjoint).items():
                split[ph] = time_fn(fn, x)
                x = fn(x)
            key = f"{c} {'rmatvec' if adjoint else 'matvec'}"
            phases[key] = split
            print(f"{key} phases (ms): " + ", ".join(
                f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    report["phases"] = phases


def check_launches(counts, expected) -> None:
    for k, n in expected.items():
        if counts.get(k, 0) != n:
            fail(f"kernel {k} launched {counts.get(k, 0)} times on the main "
                 f"path, expected {n}")


# ---------------------------------------------------------------------------

REPLACES = {
    "pad_cast": ("src/repro_torch/kernels/csrc/pad_cast.cu",
                 "src/repro/kernels/pad_cast.py:27"),
    "unpad_cast": ("src/repro_torch/kernels/csrc/pad_cast.cu",
                   "src/repro/kernels/pad_cast.py:49"),
    "sbgemv_n_complex": ("src/repro_torch/kernels/csrc/sbgemv.cu",
                         "src/repro/kernels/sbgemv.py:120"),
    "sbgemv_th_complex": ("src/repro_torch/kernels/csrc/sbgemv.cu",
                          "src/repro/kernels/sbgemv.py:67"),
}


def kernel_line(results, launches):
    """The per-kernel JSON: top-level numbers at f64 (the paper's ddddd
    planes), every dtype under ``by_dtype``."""
    out = []
    for k, (src, rep) in REPLACES.items():
        top = results[k]["float64"]
        out.append({"name": k, "route": "cuda", "source": src,
                    "replaces": rep, "launches": launches.get(k, 0),
                    "max_abs_err": top["max_abs_err"],
                    "ms": top["ms"], "plain_ms": top["plain_ms"],
                    "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                    "library_ms": top["library_ms"], "dtype": "float64",
                    "by_dtype": results[k]})
    return {"kernels": out}


def run(dev, N_t, N_d, N_m, timed, time_fn):
    results = {k: {} for k in REPLACES}
    report = {}
    check_pad_kernels(dev, 5, 77, 154, False, results, time_fn)
    check_sbgemv_kernels(dev, 3, 3, 77, False, results, time_fn)
    check_sbgemv_kernels(dev, 2, 300, 50, False, results, time_fn)
    if dev.type == "cuda":
        check_dispatch_on_card(dev)
    check_pad_kernels(dev, N_m, N_t, 2 * N_t, timed, results, time_fn)
    check_sbgemv_kernels(dev, N_t + 1, N_d, N_m, timed, results, time_fn)
    drive_main_path(dev, N_t, N_d, N_m, timed, time_fn, report)
    return results, report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import PAPER_SINGLE
    from repro_torch.core import time_callable
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # "s" is IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.1f} s", flush=True)
    for src, log in logs.items():
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line
                  and " 0 bytes spill stores, 0 bytes spill loads" not in line]
        print(f"  {src}: {len(regs)} kernels, at most {max(regs, default=0)} "
              f"registers a thread, spills: {spills or 'none'}")

    def time_fn(fn, arg):
        return time_callable(fn, arg, repeats=REPEATS, warmup=3)

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = PAPER_SINGLE
    results, report = run(dev, cfg.N_t, cfg.N_d, cfg.N_m, True, time_fn)
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    line = kernel_line(results, report["launches"])

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_s": build_s,
         "hbm_bytes_per_s": HBM_BYTES_PER_S, "peak_flops": PEAK_FLOPS,
         "repeats": REPEATS, "kernels": line["kernels"], **report},
        indent=1))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
