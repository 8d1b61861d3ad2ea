#!/usr/bin/env python3
"""Drive the PyTorch port of FFTMatvec on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit.  It:

1. prints the card (``nvidia-smi`` name and power limit) and the torch and
   CUDA versions, and builds the hand-written kernels from ``src/`` (one
   ``nvcc`` per source, all started together);
2. holds each of the seven kernels against its plain PyTorch version on
   the card, at ragged small shapes and at the paper shapes, for every
   dtype it takes: pad/unpad bitwise; sbgemv, sbgemm (S = 8 and 32) and
   the Gram blocks at rel <= 1e-12 (f64), 1e-5 (f32), 2e-2 (bf16); and
   checks that automatic dispatch on the card launches the kernels of
   ``ops.sbgemv``, ``ops.sbgemm`` and ``ops.sbgemm_gram`` at tall as well
   as short-wide shapes;
3. drives the main paths at the paper's shape N_t=1000, N_d=100,
   N_m=5000, each with the launch counters reset just before and read
   just after:
   a. ``matvec`` / ``rmatvec`` for the seven named precision configs:
      the ddddd adjoint identity (<= 1e-12), each config against the
      ``torch-ref`` oracles, error growth d -> s -> h, and ddddd against
      the dense oracle at a small shape (<= 1e-13);
   b. ``matmat`` / ``rmatmat`` on S = 8 columns for the seven configs:
      each column against ``matvec`` of that column within its level's
      tolerance, and the block adjoint identity at ddddd (<= 1e-12);
   c. the exact Gram (S = 8, data and parameter space) against the
      composed ``rmatmat(matmat(.))`` (<= 1e-12), with the mask stage's
      pad/unpad launches counted, and the Hessian action at S = 1;
   d. the data-space circulant G_hat, kernel against ``torch-ref``;
   e. 30 fixed iterations of LSQR and CGNR on S = 8 observation blocks
      at ddddd, kernel path against ``torch-ref``;
   f. the inverse-problem example (``repro_torch.examples.
      inverse_problem``) at its own shape, inside the reference example's
      acceptance bands;
4. times each kernel, its plain version and one PyTorch call for the same
   function (CUDA events, median of 20 after warm-up), the end-to-end
   matvec/rmatvec per config and the per-phase split for ddddd and dssdd,
   matmat/rmatmat per right-hand side against matvec, the solvers per
   iteration, the Hessian action and the G_hat setup;
5. tile-centric precision and the autotuner:
   a. the five tiled kernels (SBGEMV N and T/H for S = 1, SBGEMM N and
      T/H for S > 1, the Gram), f64 and f32 carriers, an aligned 2 x 2 and
      a ragged 3 x 3 map, at ragged small shapes and at the paper shape
      (S = 1, 8, 32; the Gram in data space there, in parameter space at
      (1001, 100, 1000)): each bit for bit against its untiled kernel on
      planes quantized up front, and against its plain version at the
      carrier's tolerance; tiled and untiled kernel times side by side;
   b. two ``tiles=`` configs through matvec, rmatvec, matmat/rmatmat
      (S = 8), the exact Gram in both spaces and the tiled data-space G_hat,
      against ``torch-ref``, with launch counts that show the tiled kernels
      and no untiled gemv, each timed beside its uniform base;
   c. ``autotune`` at the paper shape (CUDA-event timing): the (d, s)
      ladder at 1e-7 beside the exhaustive 32-config sweep (the choice
      within tolerance, fewer configs timed, its time within 5 % of the
      sweep's optimum), the (s, h) ladder at 1e-2, ``tiles=(2, 2)`` on a
      column with a cold model-axis tail (a tiled config timed within
      tolerance, the tiled kernels launched), and a second call answered
      from the TuningCache with nothing timed.

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

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit: the
# fastest rate the card has for each input type.  f64: the FP64 tensor
# cores (67 TFLOP/s; the FP64 vector units give 34).  f32: the FP32 vector
# units ("s" is IEEE f32; TF32 would round the inputs).  bf16: the tensor
# cores with f32 accumulation.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12}
TOL = {"d": 1e-12, "s": 1e-5, "h": 2e-2}
LEVEL_OF = {torch.float64: "d", torch.float32: "s", torch.bfloat16: "h"}
DTYPES = (torch.float64, torch.float32, torch.bfloat16)
REPEATS = 20
SEED = 0
S_BLOCK = 8          # the main path's block of right-hand sides
S_WIDE = 32          # a wider block, for the per-column trend
SOLVER_ITERS = 30
# tile maps for the tiled kernels: an aligned 2 x 2 grid, and a 3 x 3 one
# whose cells cut 1001 bins and 5000 columns raggedly
TILE_MAPS = {"2x2": (("d", "s"), ("s", "h")),
             "3x3": (("h", "s", "d"), ("s", "d", "h"), ("d", "h", "s"))}
# tiles= configs on the main path: f64 carrier with f32 and bf16 cells, and
# f32 carrier with bf16 cells
TILED_CONFIGS = ("ddddd;tiles=ds|sh", "dssdd;tiles=hs|sh")


def name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bits(t: torch.Tensor) -> torch.Tensor:
    """Integer view of a float tensor, for bitwise comparison."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def same_bits(got, want) -> bool:
    """Whether every plane of ``got`` equals ``want``'s bit for bit (no
    plane outlives the call)."""
    return all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


def max_abs(a, b) -> float:
    return (a.to(torch.float64) - b.to(torch.float64)).abs().max().item()


def rel(got, want) -> float:
    """||got - want|| / ||want|| in f64 (a zero reference divides by 1)."""
    w = want.to(torch.float64)
    return (got.to(torch.float64) - w).norm().item() / (w.norm().item() or 1.0)


def check_planes(what: str, got, want, dt) -> float:
    """Hold each output plane of a kernel against its plain version at the
    level's tolerance; returns the largest absolute difference."""
    tol = TOL[LEVEL_OF[dt]]
    err = 0.0
    for g, w in zip(got, want):
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            fail(f"{what}: kernel gives {tuple(g.shape)} {g.dtype}, plain "
                 f"{tuple(w.shape)} {w.dtype}")
        r = rel(g, w)
        if not r <= tol:
            fail(f"{what}: rel err {r:.3e} > {tol:g}")
        err = max(err, max_abs(g, w))
    return err


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    timed call; x is (B, len) or (B, len, S).  f32/f64: complex tensors
    built from the planes.  bf16 (torch has no complex bf16 matmul): the
    real planes stacked, A as (B, 2m, n) for mode N or (B, m, 2n) for T/H
    and x as (B, ., 2S), so one bmm reads the same bytes and gives all four
    real products; the final re/im combine is left out."""
    if x_re.ndim == 2:
        x_re, x_im = x_re[..., None], x_im[..., None]
    if Ar.dtype == torch.bfloat16:
        X = torch.cat([x_re, x_im], dim=-1)
        if mode == "N":
            As = torch.cat([Ar, Ai], dim=1)
            return lambda _: torch.bmm(As, X)
        As = torch.cat([Ar, Ai], dim=2)
        return lambda _: torch.bmm(As.mT, X)
    Ac = torch.complex(Ar, Ai)
    xc = torch.complex(x_re, x_im)
    if mode == "N":
        return lambda _: torch.bmm(Ac, xc)
    if mode == "H":
        return lambda _: torch.bmm(Ac.mH, xc)
    return lambda _: torch.bmm(Ac.mT, xc)


def _library_gram(Ar, Ai, data: bool):
    """One torch.bmm for the Gram blocks: A A^H (data) or A^H A on complex
    tensors at f32/f64; at bf16 the stacked real planes against
    themselves, which gives all four real products (combine left out)."""
    if Ar.dtype == torch.bfloat16:
        if data:
            As = torch.cat([Ar, Ai], dim=1)              # (B, 2m, n)
            return lambda _: torch.bmm(As, As.mT)
        As = torch.cat([Ar, Ai], dim=2)                  # (B, m, 2n)
        return lambda _: torch.bmm(As.mT, As)
    Ac = torch.complex(Ar, Ai)
    if data:
        return lambda _: torch.bmm(Ac, Ac.mH)
    return lambda _: torch.bmm(Ac.mH, Ac)


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
            what = f"{kname} mode {mode} {name(dt)} at {(B, m, n)}"
            err = check_planes(what, kfn(None), pfn(None), dt)
            print(f"{what}: max abs err vs plain {err:.3e}", flush=True)
            if not timed or mode == "T":
                continue
            s = dt.itemsize
            nbytes = 2 * B * m * n * s + 2 * x_elems * s + 2 * y_elems * s
            flops = 8 * B * m * n
            b_ms, b_by = bound_ms(nbytes, flops, name(dt))
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


def check_sbgemm_kernels(dev, B, m, n, S_list, timed, results, time_fn):
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    A64 = [torch.randn((B, m, n), generator=gen, device=dev,
                       dtype=torch.float64) for _ in range(2)]
    for dt in DTYPES:
        Ar, Ai = (a.to(dt) for a in A64)
        for S in S_list:
            for mode in "NTH":
                xlen, ylen = (n, m) if mode == "N" else (m, n)
                Xr, Xi = (torch.randn((B, xlen, S), generator=gen, device=dev,
                                      dtype=torch.float64).to(dt)
                          for _ in range(2))
                conj = mode == "H"
                if mode == "N":
                    kname = "sbgemm_n_complex"
                    kfn = lambda _: sk.sbgemm_n_complex(Ar, Ai, Xr, Xi)
                    pfn = lambda _: sk.sbgemm_n_complex_plain(Ar, Ai, Xr, Xi,
                                                              dt)
                else:
                    kname = "sbgemm_th_complex"
                    kfn = lambda _: sk.sbgemm_th_complex(Ar, Ai, Xr, Xi,
                                                         conj=conj)
                    pfn = lambda _: sk.sbgemm_th_complex_plain(
                        Ar, Ai, Xr, Xi, conj, dt)
                what = f"{kname} mode {mode} {name(dt)} at {(B, m, n, S)}"
                err = check_planes(what, kfn(None), pfn(None), dt)
                print(f"{what}: max abs err vs plain {err:.3e}", flush=True)
                if not timed or mode == "T":
                    continue
                nbytes = 2 * dt.itemsize * (B * m * n + B * xlen * S
                                            + B * ylen * S)
                flops = 8 * B * m * n * S
                b_ms, b_by = bound_ms(nbytes, flops, name(dt))
                lib = _library(Ar, Ai, Xr, Xi, mode)
                results[kname][f"{name(dt)} S={S}"] = {
                    "shape": [B, m, n, S], "mode": mode, "max_abs_err": err,
                    "ms": time_fn(kfn, None), "plain_ms": time_fn(pfn, None),
                    "library_ms": time_fn(lib, None),
                    "bytes": nbytes, "flops": flops,
                    "bound_ms": b_ms, "bound_by": b_by}
                del lib
        del Ar, Ai


def check_gram_kernel(dev, B, m, n, spaces, timed, results, time_fn):
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    A64 = [torch.randn((B, m, n), generator=gen, device=dev,
                       dtype=torch.float64) for _ in range(2)]
    for dt in DTYPES:
        Ar, Ai = (a.to(dt) for a in A64)
        for space in spaces:
            data = space == "data"
            kfn = lambda _: sk.sbgemm_gram_complex(Ar, Ai, data=data)
            pfn = lambda _: sk.sbgemm_gram_complex_plain(Ar, Ai, data, dt)
            what = (f"sbgemm_gram_complex {space} {name(dt)} at "
                    f"{(B, m, n)}")
            err = check_planes(what, kfn(None), pfn(None), dt)
            print(f"{what}: max abs err vs plain {err:.3e}", flush=True)
            if not timed:
                continue
            P, K = (m, n) if data else (n, m)
            nbytes = 2 * dt.itemsize * (B * m * n + B * P * P)
            # G is Hermitian: the P (P + 1) / 2 entries on and above the
            # diagonal are the work, 8 K real flops each
            flops = 4 * B * P * (P + 1) * K
            b_ms, b_by = bound_ms(nbytes, flops, name(dt))
            lib = _library_gram(Ar, Ai, data)
            results["sbgemm_gram_complex"][f"{name(dt)} {space}"] = {
                "shape": [B, m, n], "space": space, "max_abs_err": err,
                "ms": time_fn(kfn, None), "plain_ms": time_fn(pfn, None),
                "library_ms": time_fn(lib, None),
                "bytes": nbytes, "flops": flops,
                "bound_ms": b_ms, "bound_by": b_by}
            del lib
        del Ar, Ai


def check_tiled_kernels(dev, B, m, n, S_list, modes, timed, results, time_fn):
    """The tiled SBGEMV (S = 1) and SBGEMM (S > 1) kernels, f64 and f32
    carriers, on each map of TILE_MAPS: bit for bit against the untiled
    kernel on planes quantized up front, and against the plain version at
    the carrier's tolerance.  Timed: tiled and untiled kernel (the untiled
    one on the same, unquantized planes: the same bytes), the plain
    version on the first map."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    A64 = [torch.randn((B, m, n), generator=gen, device=dev,
                       dtype=torch.float64) for _ in range(2)]
    for dt in (torch.float64, torch.float32):
        Ar, Ai = (a.to(dt) for a in A64)
        for S in S_list:
            for mode in modes:
                xlen, ylen = (n, m) if mode == "N" else (m, n)
                shape = (B, xlen, S) if S > 1 else (B, xlen)
                Xr, Xi = (torch.randn(shape, generator=gen, device=dev,
                                      dtype=torch.float64).to(dt)
                          for _ in range(2))
                kind = "sbgemm" if S > 1 else "sbgemv"
                kname = f"{kind}_{'n' if mode == 'N' else 'th'}_complex"
                untiled, tiled = getattr(sk, kname), getattr(sk, kname + "_tiled")
                plain = getattr(sk, kname + "_tiled_plain")
                kw = {} if mode == "N" else {"conj": mode == "H"}
                pkw = () if mode == "N" else (mode == "H",)
                u_ms = None
                for tname, levels in TILE_MAPS.items():
                    Aq = kref.quantize_tile_cells(levels, Ar, Ai)
                    got = tiled(Ar, Ai, Xr, Xi, levels, **kw)
                    want_bits = untiled(*Aq, Xr, Xi, **kw)
                    del Aq
                    what = (f"{kname}_tiled mode {mode} {name(dt)} map {tname} "
                            f"at {(B, m, n, S)}")
                    if not same_bits(got, want_bits):
                        fail(f"{what}: differs from the untiled kernel on "
                             f"planes quantized up front")
                    err = check_planes(what, got, plain(Ar, Ai, Xr, Xi, levels,
                                                        *pkw, dt), dt)
                    del got, want_bits
                    print(f"{what}: bitwise equal to the untiled kernel on "
                          f"quantized planes; max abs err vs plain {err:.3e}",
                          flush=True)
                    if not timed:
                        continue
                    if u_ms is None:
                        u_ms = time_fn(lambda _: untiled(Ar, Ai, Xr, Xi, **kw),
                                       None)
                        p_ms = time_fn(lambda _: plain(Ar, Ai, Xr, Xi, levels,
                                                       *pkw, dt), None)
                    nbytes = 2 * dt.itemsize * (B * m * n + B * xlen * S
                                                + B * ylen * S)
                    b_ms, b_by = bound_ms(nbytes, 8 * B * m * n * S, name(dt))
                    key = (f"{name(dt)} {tname}" if S == 1
                           else f"{name(dt)} S={S} {tname}")
                    results[kname + "_tiled"][key] = {
                        "shape": [B, m, n, S], "mode": mode, "map": tname,
                        "max_abs_err": err,
                        "ms": time_fn(lambda _: tiled(Ar, Ai, Xr, Xi, levels,
                                                      **kw), None),
                        "untiled_ms": u_ms, "plain_ms": p_ms,
                        "library_ms": None, "bytes": nbytes,
                        "flops": 8 * B * m * n * S, "bound_ms": b_ms,
                        "bound_by": b_by}
                del Xr, Xi
        del Ar, Ai


def check_tile_rounding(dev):
    """The tiled kernels round every kind of finite value as the plain
    version does: random f32 and f64 bit patterns (subnormals, ties,
    values that round to infinity or to zero) through
    ``sbgemv_th_complex_tiled`` at m = 1 with x = 1, so y = A^T x is A as
    the kernel rounded it, against ``ref.quantize_tile_cells``, value for
    value (the sign of a zero aside: the kernel's sum 0 + (-0) is +0)."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    n = 1 << 22
    for dt, idt in ((torch.float32, torch.int32), (torch.float64, torch.int64)):
        info = torch.iinfo(idt)
        raw = torch.randint(info.min, info.max, (1, 1, n), generator=gen,
                            device=dev, dtype=torch.int64).to(idt)
        A = raw.view(dt)
        A = torch.where(torch.isfinite(A), A, torch.zeros_like(A))
        one = torch.ones((1, 1), device=dev, dtype=dt)
        for levels in ((("h",),), (("s",),)):
            y, _ = sk.sbgemv_th_complex_tiled(A, torch.zeros_like(A), one,
                                              torch.zeros_like(one), levels,
                                              conj=False)
            if not torch.equal(y, kref.quantize_tile_cells(levels, A)[:, 0]):
                fail(f"tiled rounding of {name(dt)} bit patterns to level "
                     f"{levels[0][0]!r} differs from the plain version")
    print(f"tiled rounding of {n} random f32 and f64 bit patterns to h and s: "
          f"equal to the plain version", flush=True)


def check_tiled_gram(dev, B, m, n, spaces, timed, results, time_fn):
    """The tiled Gram kernel, f64 and f32 carriers, each map of TILE_MAPS:
    bit for bit against the untiled Gram kernel on planes quantized up
    front, and against the plain version (quantize, then the plain Gram,
    taken 128 bins at a time so the plain products fit beside the
    kernel's output) at the carrier's tolerance."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    A64 = [torch.randn((B, m, n), generator=gen, device=dev,
                       dtype=torch.float64) for _ in range(2)]
    for dt in (torch.float64, torch.float32):
        Ar, Ai = (a.to(dt) for a in A64)
        for space in spaces:
            data = space == "data"
            u_ms = None
            for tname, levels in TILE_MAPS.items():
                Aq = kref.quantize_tile_cells(levels, Ar, Ai)
                got = sk.sbgemm_gram_tiled(Ar, Ai, levels, data=data)
                want = sk.sbgemm_gram_complex(*Aq, data=data)
                what = (f"sbgemm_gram_tiled {space} {name(dt)} map {tname} at "
                        f"{(B, m, n)}")
                if not same_bits(got, want):
                    fail(f"{what}: differs from the untiled kernel on "
                         f"planes quantized up front")
                del want
                err = 0.0
                for b0 in range(0, B, 128):
                    sl = slice(b0, min(B, b0 + 128))
                    err = max(err, check_planes(
                        what, [g[sl] for g in got],
                        sk.sbgemm_gram_complex_plain(Aq[0][sl], Aq[1][sl],
                                                     data, dt), dt))
                del got, Aq
                print(f"{what}: bitwise equal to the untiled kernel on "
                      f"quantized planes; max abs err vs plain {err:.3e}",
                      flush=True)
                if not timed:
                    continue
                free(dev)
                if u_ms is None:
                    u_ms = time_fn(lambda _: sk.sbgemm_gram_complex(
                        Ar, Ai, data=data), None)
                    p_ms = time_fn(lambda _: sk.sbgemm_gram_tiled_plain(
                        Ar, Ai, levels, data, dt), None)
                P, K = (m, n) if data else (n, m)
                nbytes = 2 * dt.itemsize * (B * m * n + B * P * P)
                flops = 4 * B * P * (P + 1) * K
                b_ms, b_by = bound_ms(nbytes, flops, name(dt))
                results["sbgemm_gram_tiled"][f"{name(dt)} {space} {tname}"] = {
                    "shape": [B, m, n], "space": space, "map": tname,
                    "max_abs_err": err,
                    "ms": time_fn(lambda _: sk.sbgemm_gram_tiled(
                        Ar, Ai, levels, data=data), None),
                    "untiled_ms": u_ms, "plain_ms": p_ms, "library_ms": None,
                    "bytes": nbytes, "flops": flops, "bound_ms": b_ms,
                    "bound_by": b_by}
                free(dev)
        del Ar, Ai


def check_block_dispatch_on_card(dev):
    """Automatic dispatch on the card takes the SBGEMM and Gram kernels at
    every shape: short-wide and tall blocks, one column and more than a
    pass of 32, every mode, space and dtype."""
    from repro_torch.kernels import _build, ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for B, m, n, S in ((3, 3, 77, 5), (2, 300, 50, 33), (2, 4, 9, 1)):
        for dt in DTYPES:
            A = [torch.randn((B, m, n), generator=gen, device=dev).to(dt)
                 for _ in range(2)]
            for mode in "NTH":
                X = [torch.randn((B, n if mode == "N" else m, S),
                                 generator=gen, device=dev).to(dt)
                     for _ in range(2)]
                kname = ("sbgemm_n_complex" if mode == "N"
                         else "sbgemm_th_complex")
                before = _build.launch_counts[kname]
                ops.sbgemm(*A, *X, mode)
                if _build.launch_counts[kname] != before + 1:
                    fail(f"ops.sbgemm mode {mode} {name(dt)} at "
                         f"{(B, m, n, S)} did not launch {kname}")
            for space in ("parameter", "data"):
                before = _build.launch_counts["sbgemm_gram_complex"]
                ops.sbgemm_gram(*A, space=space)
                if _build.launch_counts["sbgemm_gram_complex"] != before + 1:
                    fail(f"ops.sbgemm_gram {space} {name(dt)} at {(B, m, n)}"
                         f" did not launch sbgemm_gram_complex")
    print("ops.sbgemm and ops.sbgemm_gram on the card launched their kernels "
          "at (3, 3, 77, 5), (2, 300, 50, 33) and (2, 4, 9, 1) for every "
          "mode, space and dtype", flush=True)


# ---------------------------------------------------------------------------
# 3 + 4b. The main paths
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


def drive_block_path(dev, N_t, N_d, N_m, timed, time_fn, report):
    """matmat / rmatmat on S_BLOCK columns for the seven named configs;
    returns the ddddd operator for the phases after it."""
    from repro_torch.core import (FFTMatvec, NAMED_CONFIGS,
                                  random_block_column, rel_l2)
    from repro_torch.core.precision import DOUBLE
    from repro_torch.kernels import _build

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    F_col = random_block_column(gen, N_t, N_d, N_m)
    op_d = FFTMatvec.from_block_column(F_col, precision=DOUBLE, device=dev)
    del F_col
    S = S_BLOCK
    M = torch.randn((N_m, N_t, S), generator=gen, device=dev,
                    dtype=torch.float64)
    D = torch.randn((N_d, N_t, S), generator=gen, device=dev,
                    dtype=torch.float64)
    ops = {cfg.to_string(): op_d.with_precision(cfg) for cfg in NAMED_CONFIGS}
    _build.reset_launch_counts()
    outs = {c: (op.matmat(M), op.rmatmat(D)) for c, op in ops.items()}
    sync(dev)
    counts = dict(_build.launch_counts)
    n_cfg = len(ops)
    expected = {"pad_cast": 2 * n_cfg, "unpad_cast": 2 * n_cfg,
                "sbgemm_n_complex": n_cfg, "sbgemm_th_complex": n_cfg,
                "sbgemv_n_complex": 0, "sbgemv_th_complex": 0}
    block = {"S": S, "launches": counts, "launches_expected": expected}
    report["block"] = block
    print(f"matmat/rmatmat S={S} launches {counts} (expected {expected})",
          flush=True)
    check_launches(counts, expected)

    rows = {}
    for c, op in ops.items():
        Y, X = outs[c]
        lvl = op.precision.lowest()
        if tuple(Y.shape) != (N_d, N_t, S) or tuple(X.shape) != (N_m, N_t, S) \
                or not (torch.isfinite(Y).all() and torch.isfinite(X).all()):
            fail(f"{c} matmat/rmatmat: non-finite output or wrong shape")
        e_f = max(rel_l2(Y[..., s], op.matvec(M[..., s])) for s in range(S))
        e_a = max(rel_l2(X[..., s], op.rmatvec(D[..., s])) for s in range(S))
        rows[c] = {"lowest": lvl, "columns_vs_matvec": e_f,
                   "columns_vs_rmatvec": e_a}
        print(f"{c}: matmat columns vs matvec {e_f:.3e}, rmatmat columns vs "
              f"rmatvec {e_a:.3e} (<= {TOL[lvl]:g})", flush=True)
        if not (e_f <= TOL[lvl] and e_a <= TOL[lvl]):
            fail(f"{c}: block columns differ from matvec/rmatvec "
                 f"{e_f:.3e} / {e_a:.3e} > {TOL[lvl]:g}")
    Y, X = outs["ddddd"]
    lhs, rhs = torch.sum(Y * D).item(), torch.sum(M * X).item()
    adj = abs(lhs - rhs) / (Y.norm().item() * D.norm().item())
    block["adjoint_identity"] = adj
    block["configs"] = rows
    print(f"ddddd block adjoint identity {adj:.3e} (<= 1e-12)", flush=True)
    if not adj <= 1e-12:
        fail(f"block adjoint identity {adj:.3e} > 1e-12")
    del outs, Y, X

    if timed:
        times = {}
        for c, op in ops.items():
            t = {"matmat_ms": time_fn(op.matmat, M),
                 "rmatmat_ms": time_fn(op.rmatmat, D),
                 "matvec_ms": time_fn(op.matvec, M[..., 0].contiguous()),
                 "rmatvec_ms": time_fn(op.rmatvec, D[..., 0].contiguous())}
            t["matmat_per_rhs_ms"] = t["matmat_ms"] / S
            t["rmatmat_per_rhs_ms"] = t["rmatmat_ms"] / S
            times[c] = t
            print(f"{c}: matmat S={S} {t['matmat_ms']:.3f} ms "
                  f"({t['matmat_per_rhs_ms']:.3f} a column; matvec "
                  f"{t['matvec_ms']:.3f}), rmatmat {t['rmatmat_ms']:.3f} ms "
                  f"({t['rmatmat_per_rhs_ms']:.3f}; rmatvec "
                  f"{t['rmatvec_ms']:.3f})", flush=True)
        block["times"] = times
        Mw = torch.randn((N_m, N_t, S_WIDE), generator=gen, device=dev,
                         dtype=torch.float64)
        Dw = torch.randn((N_d, N_t, S_WIDE), generator=gen, device=dev,
                         dtype=torch.float64)
        wide = {}
        for c in ("ddddd", "dssdd"):
            t = {"matmat_ms": time_fn(ops[c].matmat, Mw),
                 "rmatmat_ms": time_fn(ops[c].rmatmat, Dw)}
            t["matmat_per_rhs_ms"] = t["matmat_ms"] / S_WIDE
            t["rmatmat_per_rhs_ms"] = t["rmatmat_ms"] / S_WIDE
            wide[c] = t
            print(f"{c}: matmat S={S_WIDE} {t['matmat_ms']:.3f} ms, rmatmat "
                  f"{t['rmatmat_ms']:.3f} ms", flush=True)
        block["times_S32"] = wide
        # the same entry points with Phase 3 on the plain PyTorch
        # contraction, for the end-to-end cost of the kernels
        plain = {}
        for c in ("ddddd", "dssdd"):
            op_p = plain_path(ops[c])
            for Sx, Mx, Dx in ((S, M, D), (S_WIDE, Mw, Dw)):
                t = {"matmat_ms": time_fn(op_p.matmat, Mx),
                     "rmatmat_ms": time_fn(op_p.rmatmat, Dx)}
                plain[f"{c} S={Sx}"] = t
                print(f"{c} plain path: matmat S={Sx} {t['matmat_ms']:.3f} "
                      f"ms, rmatmat {t['rmatmat_ms']:.3f} ms", flush=True)
        block["times_plain_path"] = plain
    return op_d


def drive_gram_path(dev, op_d, timed, time_fn, report):
    """The exact fused Gram on S_BLOCK columns in both spaces against the
    composed products, and the data-space Hessian action at S = 1."""
    from repro_torch.core import GaussianInverseProblem, rel_l2
    from repro_torch.kernels import _build

    N_t, N_d, N_m = op_d.N_t, op_d.N_d, op_d.N_m
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    out = {}
    report["gram_exact"] = out
    for space, rows in (("data", N_d), ("parameter", N_m)):
        V = torch.randn((rows, N_t, S_BLOCK), generator=gen, device=dev,
                        dtype=torch.float64)
        g = op_d.gram(space=space)
        _build.reset_launch_counts()
        got = g.apply(V)
        sync(dev)
        counts = dict(_build.launch_counts)
        # pad + the mask stage's unpad and pad + unpad, and one product of
        # each direction
        expected = {"pad_cast": 2, "unpad_cast": 2, "sbgemm_n_complex": 1,
                    "sbgemm_th_complex": 1}
        check_launches(counts, expected)
        composed = (op_d.rmatmat(op_d.matmat(V)) if space == "parameter"
                    else op_d.matmat(op_d.rmatmat(V)))
        e = rel_l2(got, composed)
        out[space] = {"S": S_BLOCK, "vs_composed": e, "launches": counts}
        print(f"exact Gram {space} S={S_BLOCK}: vs composed {e:.3e} "
              f"(<= 1e-12), launches {counts}", flush=True)
        if not e <= 1e-12:
            fail(f"exact Gram {space} vs composed {e:.3e} > 1e-12")
        if timed:
            out[space]["apply_ms"] = time_fn(g.apply, V)
            out[space]["composed_ms"] = time_fn(
                (lambda v: op_d.rmatmat(op_d.matmat(v))) if space ==
                "parameter" else (lambda v: op_d.matmat(op_d.rmatmat(v))), V)
            print(f"  apply {out[space]['apply_ms']:.3f} ms, composed "
                  f"{out[space]['composed_ms']:.3f} ms", flush=True)
        del V, got, composed

    prob = GaussianInverseProblem(op_d, noise_var=1e-4)
    v = torch.randn((N_d * N_t,), generator=gen, device=dev,
                    dtype=torch.float64)
    _build.reset_launch_counts()
    h = prob.hessian_action(v)
    sync(dev)
    counts = dict(_build.launch_counts)
    check_launches(counts, {"pad_cast": 2, "unpad_cast": 2,
                            "sbgemv_n_complex": 1, "sbgemv_th_complex": 1,
                            "sbgemm_n_complex": 0, "sbgemm_th_complex": 0})
    v2 = v.reshape(N_d, N_t)
    want = (op_d.matvec(op_d.rmatvec(v2)) + 1e-4 * v2).reshape(-1)
    e = rel_l2(h, want)
    hess = {"vs_composed": e, "launches": counts}
    report["hessian_action"] = hess
    print(f"Hessian action S=1: vs composed {e:.3e} (<= 1e-12), launches "
          f"{counts}", flush=True)
    if not e <= 1e-12:
        fail(f"Hessian action vs composed {e:.3e} > 1e-12")
    if timed:
        hess["ms"] = time_fn(prob.hessian_action, v)
        print(f"  Hessian action {hess['ms']:.3f} ms", flush=True)


def drive_circulant(dev, op_d, timed, time_fn, report):
    """The data-space circulant Gram: G_hat through the Gram kernel against
    the ``torch-ref`` oracle, and its action."""
    from repro_torch.core import GramOperator, rel_l2
    from repro_torch.kernels import _build

    _build.reset_launch_counts()
    circ = GramOperator.from_matvec(op_d, space="data", mode="circulant")
    sync(dev)
    counts = dict(_build.launch_counts)
    check_launches(counts, {"sbgemm_gram_complex": 1})
    ref = GramOperator.from_matvec(op_d.with_backend("torch-ref"),
                                   space="data", mode="circulant")
    G_re, G_im = circ.G_hat_re, circ.G_hat_im
    if not (torch.equal(G_re, G_re.mT) and torch.equal(G_im, -G_im.mT)):
        fail("circulant G_hat is not exactly Hermitian")
    e_re, e_im = rel(G_re, ref.G_hat_re), rel(G_im, ref.G_hat_im)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    v = torch.randn((op_d.N_d, op_d.N_t), generator=gen, device=dev,
                    dtype=torch.float64)
    e_apply = rel_l2(circ.apply(v), ref.apply(v))
    out = {"shape": list(G_re.shape), "G_hat_re_vs_ref": e_re,
           "G_hat_im_vs_ref": e_im, "apply_vs_ref": e_apply,
           "launches": counts}
    report["circulant"] = out
    print(f"circulant data-space G_hat {tuple(G_re.shape)}: vs torch-ref "
          f"{e_re:.3e} / {e_im:.3e}, action {e_apply:.3e} (<= 1e-12), "
          f"launches {counts}", flush=True)
    if not max(e_re, e_im, e_apply) <= 1e-12:
        fail(f"circulant Gram vs torch-ref {e_re:.3e} / {e_im:.3e} / "
             f"{e_apply:.3e} > 1e-12")
    if timed:
        out["setup_ms"] = time_fn(
            lambda _: GramOperator.from_matvec(op_d, space="data",
                                               mode="circulant"), None)
        out["setup_plain_path_ms"] = time_fn(
            lambda _: GramOperator.from_matvec(plain_path(op_d), space="data",
                                               mode="circulant"), None)
        out["apply_ms"] = time_fn(circ.apply, v)
        print(f"  G_hat setup {out['setup_ms']:.3f} ms (plain path "
              f"{out['setup_plain_path_ms']:.3f}), action "
              f"{out['apply_ms']:.3f} ms", flush=True)


def drive_solvers(dev, op_d, timed, time_fn, report):
    """SOLVER_ITERS fixed iterations (tol = 0) of LSQR and CGNR on
    S_BLOCK observation blocks at ddddd, kernel path against torch-ref.

    Checks: LSQR's residual estimate |phibar| is a product of rotation
    factors <= 1, so its history never rises (4 ulps allowed for the
    rounding of a rotation's sqrt).  CG's residual norm is not monotone
    in general; on this well-conditioned operator it falls until the f64
    roundoff floor, so CGNR's history is held to never rising above 1e-13
    and to reach 1e-10.  The iterates of the two paths agree to 1e-10: the
    damped normal operator here has a condition number of a few, so the
    ~1e-16 difference two summation orders make per iteration stays far
    below that."""
    import numpy as np

    from repro_torch import solvers
    from repro_torch.core import rel_l2
    from repro_torch.kernels import _build

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    D = torch.randn((op_d.N_d, op_d.N_t, S_BLOCK), generator=gen, device=dev,
                    dtype=torch.float64)
    ref_op = op_d.with_backend("torch-ref")
    out = {}
    report["solvers"] = out
    for sname, fn, damp in (("lsqr", solvers.lsqr, 0.1),
                            ("cgnr", solvers.cg_normal_equations, 0.01)):
        def solve(op):
            return fn(op, D, damp=damp, tol=0.0, maxiter=SOLVER_ITERS)
        _build.reset_launch_counts()
        res = solve(op_d)
        sync(dev)
        counts = dict(_build.launch_counts)
        # one F* for the start, then one F and one F* an iteration
        n_it = SOLVER_ITERS
        check_launches(counts, {"sbgemm_n_complex": n_it,
                                "sbgemm_th_complex": n_it + 1,
                                "pad_cast": 2 * n_it + 1,
                                "unpad_cast": 2 * n_it + 1})
        h = res.residual_history
        if res.n_iters != n_it or h.shape != (n_it, S_BLOCK):
            fail(f"{sname}: {res.n_iters} iterations, history {h.shape}")
        if sname == "lsqr":
            rises = int((h[1:] > h[:-1] * (1 + 4 * 2.0 ** -52)).sum())
        else:
            rises = int(((h[1:] > h[:-1]) & (h[1:] > 1e-13)).sum())
            if not h[-1].max() <= 1e-10:
                fail(f"cgnr: final residual {h[-1].max():.3e} > 1e-10")
        ref_res = solve(ref_op)
        e_x = rel_l2(res.x, ref_res.x)
        out[sname] = {"iters": n_it, "damp": damp, "launches": counts,
                      "final_relres_max": float(h[-1].max()),
                      "history_col0": [float(x) for x in h[:, 0]],
                      "rises": rises, "x_vs_ref": e_x,
                      "history_vs_ref_max_abs": float(
                          np.abs(h - ref_res.residual_history).max())}
        print(f"{sname} {n_it} iterations S={S_BLOCK}: final relres "
              f"{h[-1].max():.3e}, rises {rises}, x vs torch-ref {e_x:.3e} "
              f"(<= 1e-10), launches {counts}", flush=True)
        if rises:
            fail(f"{sname}: the residual history rose {rises} times")
        if not e_x <= 1e-10:
            fail(f"{sname}: kernel path vs torch-ref {e_x:.3e} > 1e-10")
        if timed:
            # whole solves: the median of 3 after one warm-up
            ms = time_fn(solve, op_d, repeats=3, warmup=1)
            ms_p = time_fn(solve, plain_path(op_d), repeats=3, warmup=1)
            out[sname]["ms_per_iter"] = ms / n_it
            out[sname]["ms_per_iter_plain_path"] = ms_p / n_it
            print(f"  {sname}: {ms / n_it:.3f} ms an iteration (plain path "
                  f"{ms_p / n_it:.3f})", flush=True)


def drive_example(dev, report):
    """The inverse-problem example at its own shape, on the card."""
    from repro_torch.examples import inverse_problem as example
    from repro_torch.kernels import _build

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = example.run(dev, verbose=False)
    sync(dev)
    out["seconds"] = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    out["launches"] = counts
    report["example"] = out
    print(f"inverse-problem example {tuple(out['shape'])}: misfits CG "
          f"{out['cg_misfit']:.3e}, mixed {out['mixed_misfit']:.3e}, batch "
          f"max {out['batch_misfit_max']:.3e}; mixed vs f64 MAP "
          f"{out['mixed_vs_f64_map']:.3e}; LSQR/CGNR iters "
          f"{out['lsqr_iters']}/{out['cgnr_iters']}; EIG {out['eig']:.2f} "
          f"vs {out['eig_2_sensors']:.2f} nats with 2 sensors; "
          f"{out['seconds']:.1f} s; launches {counts}", flush=True)
    bad = example.check(out)
    if bad:
        fail("inverse-problem example: " + "; ".join(bad))
    check_launched(counts, [k for k in REPLACES if not k.endswith("_tiled")])


def drive_tiled_configs(dev, N_t, N_d, N_m, timed, time_fn, report):
    """TILED_CONFIGS through matvec, rmatvec, matmat / rmatmat (S_BLOCK),
    the exact Gram in both spaces and the data-space G_hat through
    ``ops.sbgemm_gram(tile_map=)``, each against ``torch-ref`` at the
    lowest effective level's tolerance; the launches show the tiled
    kernels and no untiled gemv.  Timed: each config beside its uniform
    base (the same config without the map)."""
    from repro_torch.core import (FFTMatvec, PrecisionConfig,
                                  random_block_column, rel_l2)
    from repro_torch.core.precision import DOUBLE
    from repro_torch.kernels import _build, ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    F_col = random_block_column(gen, N_t, N_d, N_m)
    op_d = FFTMatvec.from_block_column(F_col, precision=DOUBLE, device=dev)
    del F_col
    f64 = dict(generator=gen, device=dev, dtype=torch.float64)
    m, d = torch.randn((N_m, N_t), **f64), torch.randn((N_d, N_t), **f64)
    M = torch.randn((N_m, N_t, S_BLOCK), **f64)
    D = torch.randn((N_d, N_t, S_BLOCK), **f64)
    calls = {"matvec": (lambda o: o.matvec, m), "rmatvec": (lambda o: o.rmatvec, d),
             "matmat": (lambda o: o.matmat, M),
             "rmatmat": (lambda o: o.rmatmat, D),
             "gram_parameter": (lambda o: o.gram(space="parameter").apply, M),
             "gram_data": (lambda o: o.gram(space="data").apply, D)}
    out = {}
    report["tiled_configs"] = out
    total = {}
    for cfg_s in TILED_CONFIGS:
        cfg = PrecisionConfig.from_string(cfg_s)
        op = op_d.with_precision(cfg)
        eff = cfg.gemv_tile_levels()
        lowest = min(list(cfg.levels()) + [lvl for row in eff for lvl in row],
                     key="hsd".index)
        _build.reset_launch_counts()
        got = {k: fn(op)(x) for k, (fn, x) in calls.items()}
        G = ops.sbgemm_gram(op.F_hat_re, op.F_hat_im, space="data",
                            tile_map=eff)
        sync(dev)
        counts = dict(_build.launch_counts)
        # S = 1: one SBGEMV a direction; S = 8 and the two exact Grams:
        # one SBGEMM a direction each; six pads and unpads plus the masks
        expected = {"sbgemv_n_complex_tiled": 1, "sbgemv_th_complex_tiled": 1,
                    "sbgemm_n_complex_tiled": 3, "sbgemm_th_complex_tiled": 3,
                    "sbgemm_gram_tiled": 1, "sbgemv_n_complex": 0,
                    "sbgemv_th_complex": 0, "sbgemm_n_complex": 0,
                    "sbgemm_th_complex": 0, "sbgemm_gram_complex": 0,
                    "pad_cast": 8, "unpad_cast": 8}
        print(f"{cfg_s} launches {counts}", flush=True)
        check_launches(counts, expected)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        ref_op = op.with_backend("torch-ref")
        row = {"lowest": lowest, "launches": counts}
        for k, (fn, x) in calls.items():
            e = rel_l2(got[k], fn(ref_op)(x))
            row[f"{k}_vs_ref"] = e
            if not (e <= TOL[lowest] and torch.isfinite(got[k]).all()):
                fail(f"{cfg_s} {k}: vs torch-ref {e:.3e} > {TOL[lowest]:g} "
                     f"or not finite")
        G_ref = ops.sbgemm_gram(op.F_hat_re, op.F_hat_im, space="data",
                                tile_map=eff, backend="torch-ref")
        e = max(rel(g, w) for g, w in zip(G, G_ref))
        row["G_hat_data_vs_ref"] = e
        if not e <= TOL[lowest]:
            fail(f"{cfg_s} tiled data-space G_hat vs torch-ref {e:.3e}")
        del got, G, G_ref, ref_op
        print(f"{cfg_s}: vs torch-ref " + ", ".join(
            f"{k} {row[f'{k}_vs_ref']:.3e}" for k in calls)
            + f", G_hat {e:.3e} (<= {TOL[lowest]:g})", flush=True)
        if timed:
            base = op_d.with_precision(cfg.replace(tiles=None))
            for k in ("matvec", "rmatvec", "matmat", "rmatmat"):
                fn, x = calls[k]
                row[f"{k}_ms"] = time_fn(fn(op), x)
                row[f"{k}_uniform_ms"] = time_fn(fn(base), x)
            print(f"  {cfg_s} vs {base.precision.to_string()} (ms): " + ", ".join(
                f"{k} {row[f'{k}_ms']:.4f} / {row[f'{k}_uniform_ms']:.4f}"
                for k in ("matvec", "rmatvec", "matmat", "rmatmat")), flush=True)
            del base
        out[cfg_s] = row
        del op
    out["launches_total"] = total


def drive_autotune(dev, N_t, N_d, N_m, report):
    """``autotune`` at the paper shape with CUDA-event timing: the (d, s)
    ladder at 1e-7 beside the exhaustive 32-config sweep, the (s, h)
    ladder at 1e-2, ``tiles=(2, 2)`` on a column whose model-axis tail
    carries ~no energy, and a second call answered by the TuningCache."""
    from repro_torch.core import (FFTMatvec, all_configs, measure_configs,
                                  optimal_config, random_block_column)
    from repro_torch.core.precision import DOUBLE, SINGLE
    from repro_torch.kernels import _build
    from repro_torch.tune import (TimingHarness, TuningCache, autotune,
                                  default_input)

    out = {}
    report["autotune"] = out
    # the whole run's peak so far, before the phase's own peak is taken
    report["peak_memory_gb_before_autotune"] = \
        torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    F_col = random_block_column(gen, N_t, N_d, N_m)
    op_d = FFTMatvec.from_block_column(F_col, precision=DOUBLE, device=dev)
    v = default_input(op_d, "matvec")
    cache_path = ROOT / "chiprun_out" / "tune_cache.json"
    cache_path.unlink(missing_ok=True)
    cache = TuningCache(cache_path)

    def tune(name, op, x, tol, ladder, **kw):
        t0 = time.perf_counter()
        res = autotune(op, tol=tol, v=x, ladder=ladder,
                       harness=TimingHarness(repeats=REPEATS, warmup=3), **kw)
        wall = time.perf_counter() - t0
        r = {"tol": tol, "ladder": "".join(ladder), "choice": res.config.to_string(),
             "rel_error": res.record.rel_error, "ms": res.record.time_s * 1e3,
             "speedup_vs_top": res.record.speedup, "n_timed": res.n_timed,
             "n_lattice": res.n_lattice, "from_cache": res.from_cache,
             "wall_s": wall, "records": {rec.prec: [rec.rel_error, rec.time_s * 1e3]
                                         for rec in res.records},
             "front": [rec.prec for rec in res.front]}
        out[name] = r
        print(f"autotune {name}: {res.summary()}; {wall:.1f} s wall", flush=True)
        if not res.record.rel_error <= tol:
            fail(f"autotune {name}: selected error {res.record.rel_error:.3e} "
                 f"> {tol:g}")
        return res, r

    # (d, s) at 1e-7, then the exhaustive sweep on the same input
    res, r = tune("ds_1e-7", op_d, v, 1e-7, ("d", "s"), cache=cache)
    if not (res.n_timed < res.n_lattice and not res.from_cache):
        fail(f"autotune ds_1e-7 timed {res.n_timed} of {res.n_lattice}")
    t0 = time.perf_counter()
    recs = measure_configs(lambda c: op_d.with_precision(c), v,
                           list(all_configs(("d", "s"))),
                           harness=TimingHarness(repeats=REPEATS, warmup=3))
    best = optimal_config(recs, 1e-7)
    sweep = {rec.prec: rec for rec in recs}
    r["exhaustive"] = {"choice": best.prec, "ms": best.time_s * 1e3,
                       "wall_s": time.perf_counter() - t0,
                       "records": {k: [x.rel_error, x.time_s * 1e3]
                                   for k, x in sweep.items()}}
    t_sel = sweep[res.config.to_string()].time_s
    r["choice_vs_sweep_optimum"] = t_sel / best.time_s
    print(f"  exhaustive sweep: {best.prec} {best.time_s * 1e3:.4f} ms, the "
          f"tuner's choice {t_sel * 1e3:.4f} ms in the sweep "
          f"({t_sel / best.time_s:.4f}x, <= 1.05); "
          f"{r['exhaustive']['wall_s']:.1f} s wall", flush=True)
    if not t_sel <= 1.05 * best.time_s:
        fail(f"autotune's choice {res.config.to_string()} takes "
             f"{t_sel / best.time_s:.3f}x the sweep's optimum {best.prec}")
    ddddd_ms = sweep["ddddd"].time_s * 1e3
    r["speedup_vs_ddddd"] = ddddd_ms / r["ms"]
    print(f"  the choice {r['speedup_vs_ddddd']:.3f}x over ddddd", flush=True)
    del recs, sweep, res

    # the same call again, answered from the cache
    again, r2 = tune("ds_1e-7_cached", op_d, v, 1e-7, ("d", "s"), cache=cache)
    if not (again.from_cache and again.n_timed == 0
            and again.config.to_string() == r["choice"]):
        fail("the second autotune call was not answered by the cache")
    del again

    # (s, h) at 1e-2 on the f32 operator
    op_s = op_d.with_precision(SINGLE)
    res, r = tune("sh_1e-2", op_s, default_input(op_s, "matvec"), 1e-2,
                  ("s", "h"))
    r["speedup_vs_ddddd"] = ddddd_ms / r["ms"]
    print(f"  {r['speedup_vs_ddddd']:.3f}x over ddddd ({ddddd_ms:.4f} ms in "
          f"the sweep)", flush=True)
    if not res.n_timed < res.n_lattice:
        fail(f"autotune sh_1e-2 timed {res.n_timed} of {res.n_lattice}")
    del res, op_s

    # tiles=(2, 2) on a column whose model-axis tail carries ~no energy
    cold = torch.where(torch.arange(N_m, device=dev) < (N_m + 1) // 2, 1.0, 1e-6)
    op_c = FFTMatvec.from_block_column(F_col * cold, precision=DOUBLE,
                                       device=dev)
    del F_col
    _build.reset_launch_counts()
    res, r = tune("ds_1e-5_tiles", op_c, v, 1e-5, ("d", "s"), tiles=(2, 2))
    sync(dev)
    counts = dict(_build.launch_counts)
    r["launches"] = counts
    tiled = [rec for rec in res.records if rec.config.tiles is not None]
    r["tiled_timed"] = [rec.prec for rec in tiled]
    r["tiled_on_front"] = [rec.prec for rec in res.front
                           if rec.config.tiles is not None]
    print(f"  tiled configs timed {r['tiled_timed']} (on the front: "
          f"{r['tiled_on_front']}), launches {counts}", flush=True)
    if not any(rec.rel_error <= 1e-5 for rec in tiled):
        fail("autotune(tiles=(2, 2)) timed no tiled config within tolerance")
    check_launched(counts, ["sbgemv_n_complex_tiled"])
    r["speedup_vs_ddddd"] = ddddd_ms / r["ms"]
    print(f"  {r['speedup_vs_ddddd']:.3f}x over ddddd", flush=True)
    del res, op_c, op_d
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"autotune phase peak device memory {out['peak_memory_gb']:.2f} GB",
          flush=True)


def plain_path(op):
    """``op`` with every contraction on the plain PyTorch code (the
    "torch" dispatch path); pad/unpad still launch their kernels."""
    from repro_torch.backend import DispatchTable
    return op.with_backend(op.opts.backend,
                           dispatch=DispatchTable(force="torch"))


def check_launches(counts, expected) -> None:
    for k, n in expected.items():
        if counts.get(k, 0) != n:
            fail(f"kernel {k} launched {counts.get(k, 0)} times on the main "
                 f"path, expected {n}")


def check_launched(counts, names) -> None:
    missing = [k for k in names if not counts.get(k, 0)]
    if missing:
        fail(f"kernels {missing} were not launched on this path")


# ---------------------------------------------------------------------------

# kernel: (source, the TPU kernel it replaces, the results entry reported
# at top level: f64 planes at the main path's shape)
REPLACES = {
    "pad_cast": ("src/repro_torch/kernels/csrc/pad_cast.cu",
                 "src/repro/kernels/pad_cast.py:27", "float64"),
    "unpad_cast": ("src/repro_torch/kernels/csrc/pad_cast.cu",
                   "src/repro/kernels/pad_cast.py:49", "float64"),
    "sbgemv_n_complex": ("src/repro_torch/kernels/csrc/sbgemv.cu",
                         "src/repro/kernels/sbgemv.py:120", "float64"),
    "sbgemv_th_complex": ("src/repro_torch/kernels/csrc/sbgemv.cu",
                          "src/repro/kernels/sbgemv.py:67", "float64"),
    "sbgemm_n_complex": ("src/repro_torch/kernels/csrc/sbgemm.cu",
                         "src/repro/kernels/sbgemv.py:296",
                         f"float64 S={S_BLOCK}"),
    "sbgemm_th_complex": ("src/repro_torch/kernels/csrc/sbgemm.cu",
                          "src/repro/kernels/sbgemv.py:243",
                          f"float64 S={S_BLOCK}"),
    "sbgemm_gram_complex": ("src/repro_torch/kernels/csrc/sbgemm.cu",
                            "src/repro/kernels/sbgemv.py:342",
                            "float64 data"),
    # the tiled TPU kernels: S = 1 and S > 1 builds of the products
    "sbgemv_n_complex_tiled": ("src/repro_torch/kernels/csrc/sbgemv.cu",
                               "src/repro/kernels/sbgemv.py:521",
                               "float64 2x2"),
    "sbgemv_th_complex_tiled": ("src/repro_torch/kernels/csrc/sbgemv.cu",
                                "src/repro/kernels/sbgemv.py:473",
                                "float64 2x2"),
    "sbgemm_n_complex_tiled": ("src/repro_torch/kernels/csrc/sbgemm.cu",
                               "src/repro/kernels/sbgemv.py:521",
                               f"float64 S={S_BLOCK} 2x2"),
    "sbgemm_th_complex_tiled": ("src/repro_torch/kernels/csrc/sbgemm.cu",
                                "src/repro/kernels/sbgemv.py:473",
                                f"float64 S={S_BLOCK} 2x2"),
    "sbgemm_gram_tiled": ("src/repro_torch/kernels/csrc/sbgemm.cu",
                          "src/repro/kernels/sbgemv.py:559",
                          "float64 data 2x2"),
}


def kernel_line(results, launches):
    """The per-kernel JSON: top-level numbers at f64 (the paper's ddddd
    planes) at the main path's shape, every dtype and shape under
    ``by_dtype``."""
    out = []
    for k, (src, rep, key) in REPLACES.items():
        top = results[k][key]
        out.append({"name": k, "route": "cuda", "source": src,
                    "replaces": rep, "launches": launches.get(k, 0),
                    "max_abs_err": top["max_abs_err"],
                    "ms": top["ms"], "plain_ms": top["plain_ms"],
                    "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                    "library_ms": top["library_ms"], "at": key,
                    "by_dtype": results[k]})
    return {"kernels": out}


def free(dev) -> None:
    """Hand the caching allocator's free blocks back between phases."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(dev, N_t, N_d, N_m, timed, time_fn):
    results = {k: {} for k in REPLACES}
    report = {}
    # slice 1: pad/unpad and the SBGEMV kernels, matvec / rmatvec
    check_pad_kernels(dev, 5, 77, 154, False, results, time_fn)
    check_sbgemv_kernels(dev, 3, 3, 77, False, results, time_fn)
    check_sbgemv_kernels(dev, 2, 300, 50, False, results, time_fn)
    if dev.type == "cuda":
        check_dispatch_on_card(dev)
    check_pad_kernels(dev, N_m, N_t, 2 * N_t, timed, results, time_fn)
    check_sbgemv_kernels(dev, N_t + 1, N_d, N_m, timed, results, time_fn)
    drive_main_path(dev, N_t, N_d, N_m, timed, time_fn, report)
    free(dev)
    # slice 2: the SBGEMM and Gram kernels, blocks, Gram, solvers, example
    check_sbgemm_kernels(dev, 3, 7, 130, (5,), False, results, time_fn)
    check_sbgemm_kernels(dev, 2, 300, 50, (1, 33), False, results, time_fn)
    for shape in ((3, 7, 130), (2, 300, 50)):
        check_gram_kernel(dev, *shape, ("parameter", "data"), False, results,
                          time_fn)
    if dev.type == "cuda":
        check_block_dispatch_on_card(dev)
    check_sbgemm_kernels(dev, N_t + 1, N_d, N_m, (S_BLOCK, S_WIDE), timed,
                         results, time_fn)
    free(dev)
    # parameter-space G_hat at the paper shape is (1001, 5000, 5000) a
    # plane: only the data space is held there
    check_gram_kernel(dev, N_t + 1, N_d, N_m, ("data",), timed, results,
                      time_fn)
    free(dev)
    op_d = drive_block_path(dev, N_t, N_d, N_m, timed, time_fn, report)
    free(dev)
    drive_gram_path(dev, op_d, timed, time_fn, report)
    drive_circulant(dev, op_d, timed, time_fn, report)
    drive_solvers(dev, op_d, timed, time_fn, report)
    del op_d
    free(dev)
    drive_example(dev, report)
    free(dev)
    # slice 3: the tiled kernels, tiles= configs, autotune
    check_tiled_kernels(dev, 3, 7, 130, (1, 5, 33), "NTH", False, results,
                        time_fn)
    check_tiled_kernels(dev, 2, 300, 50, (1, 9), "NTH", False, results,
                        time_fn)
    for shape in ((3, 7, 130), (2, 300, 50), (3, 70, 9)):
        check_tiled_gram(dev, *shape, ("parameter", "data"), False, results,
                         time_fn)
    check_tile_rounding(dev)
    check_tiled_kernels(dev, N_t + 1, N_d, N_m, (1, S_BLOCK, S_WIDE), "NH",
                        timed, results, time_fn)
    free(dev)
    check_tiled_gram(dev, N_t + 1, N_d, N_m, ("data",), timed, results,
                     time_fn)
    # parameter-space G at (1001, 5000, 5000) does not fit: N_m cut to 1000
    check_tiled_gram(dev, N_t + 1, N_d, min(N_m, 1000), ("parameter",), timed,
                     results, time_fn)
    free(dev)
    drive_tiled_configs(dev, N_t, N_d, N_m, timed, time_fn, report)
    free(dev)
    if dev.type == "cuda":
        drive_autotune(dev, N_t, N_d, N_m, report)
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

    def time_fn(fn, arg, repeats=REPEATS, warmup=3):
        return time_callable(fn, arg, repeats=repeats, warmup=warmup)

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = PAPER_SINGLE
    results, report = run(dev, cfg.N_t, cfg.N_d, cfg.N_m, True, time_fn)
    report["peak_memory_gb"] = max(
        report.get("peak_memory_gb_before_autotune", 0.0),
        torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"peak device memory {report['peak_memory_gb']:.2f} GB", flush=True)
    # each kernel's launches on the main path that uses it
    launches = {**report["launches"],
                **{k: report["block"]["launches"][k]
                   for k in ("sbgemm_n_complex", "sbgemm_th_complex")},
                "sbgemm_gram_complex":
                    report["circulant"]["launches"]["sbgemm_gram_complex"],
                **{k: v for k, v in
                   report["tiled_configs"]["launches_total"].items()
                   if k.endswith("_tiled")}}
    line = kernel_line(results, launches)

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
