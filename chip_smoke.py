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
      T/H for S > 1, the Gram), f64, f32 and bf16 carriers, an aligned 2 x
      2 and a ragged 3 x 3 map, at ragged small shapes and at the paper
      shape (S = 1, 8, 32; the Gram in data space there, in parameter
      space at (1001, 100, 1000)): each bit for bit against its untiled
      kernel on planes quantized up front, and against its plain version
      at the carrier's tolerance; tiled and untiled kernel times side by
      side, at bf16 beside one ``torch.bmm`` and queued through the C
      entries;
   b. three ``tiles=`` configs through matvec, rmatvec, matmat/rmatmat
      (S = 8), the exact Gram in both spaces and the tiled data-space G_hat,
      against ``torch-ref``, with launch counts that show the tiled kernels
      and no untiled gemv, each timed beside its uniform base;
   c. ``autotune`` at the paper shape (CUDA-event timing): the (d, s)
      ladder at 1e-7 beside the exhaustive 32-config sweep (the choice
      within tolerance, fewer configs timed, its time within 5 % of the
      sweep's optimum), the (s, h) ladder at 1e-2, ``tiles=(2, 2)`` on a
      column with a cold model-axis tail (a tiled config timed within
      tolerance, the tiled kernels launched), and a second call answered
      from the TuningCache with nothing timed;
6. the real-A products:
   a. the six real kernels (SBGEMV N and T; SBGEMM N and T and their
      tiled builds), f64, f32 and bf16 planes, at ragged small shapes and
      at the paper shape (S = 1, 8, 32): each against its plain version at
      its level's tolerance, each tiled build bit for bit against its
      untiled build on planes quantized up front (the 2 x 2 and the ragged
      3 x 3 map); at the paper shape each timed beside its bound, its
      plain version and ``torch.bmm``;
   b. ``ops.sbgemv_real`` / ``ops.sbgemm_real`` on the card launch their
      kernel, and with ``tile_map=`` their tiled build, at a short-wide
      and a tall shape, matching the plain path;
   c. the twin of the paper's Fig. 1 sweep (``repro_torch.examples.
      fig1_sbgemv``, batch 100): the hand kernels against the stock
      passes and the library call, with launch counts;
7. the LM serving path:
   a. the flash-attention kernels against their plain version, bf16 and
      f32 (max abs <= 3e-2 / 2e-5), at ragged shapes, at the serve
      phase's longer prefill batch and at a 2048-token prefill, the last
      two timed beside the bound, the plain version and one
      ``scaled_dot_product_attention`` call;
   b. qwen1.5-0.5b at full width with ``attn_impl="flash"`` through
      ``ServeEngine.serve``: 8 seeded requests in two batches of 4, 32
      new tokens each; exactly 24 flash launches a prefill batch and none
      in decode; prefill ms, decode ms a step, tokens/s, the kernel's
      share of prefill, a profiled decode step's device time, peak memory,
      and the same traffic on the chunked path; prefill and teacher-forced
      decode logits against the chunked path within 1e-1 of max |logit|
      at the default policy and 1e-4 at ``FULL_F32``; the head's
      default-policy logits against an f64 product of the same bf16
      operands within HEAD_TOL of max |logit|;
8. the staged f64 kernels (the GEMM, for N and T/H, and the Gram): the
   registers and spill bytes ``ptxas`` gives each of their
   instantiations, and ragged shapes that cross their item, warp-tile and
   staged-chunk edges (m and n around the 128-row items, odd n, P around
   64, 112 and 128, S = 1, 8, 9, 32, 33) for N, T/H, the Gram in both
   spaces, the tiled and the real builds: each against its plain version,
   each tiled build bit for bit against its untiled one on quantized
   planes.  ddddd ``matmat``/``rmatmat`` at S = 32 and the G_hat setup are
   printed as ratios to the plain path (reported, not gated);
9. the bf16 tensor-core kernels (the N and T/H products and the Gram of
   bf16 planes): their ``ptxas`` registers and spill bytes, and ragged
   shapes across their edges (N: m = 15, 16, 17, 100, 129 with odd n, n %
   8 != 0 and n shorter than one k-chunk; T/H in modes T and H: m = 1 ..
   129 across the 112-wide k-chunk, n = 40 .. 133 around the 112-row
   items; both at S = 1 .. 40, bf16, f32 and f64 outputs; the Gram at P =
   31 .. 300 in both spaces, bf16 and f32 outputs), each against its
   plain version at the h tolerance.  ``hhhhh`` and ``shhss``
   ``matmat``/``rmatmat`` at S = 32 and the ``hhhhh`` circulant G_hat
   setup (against ``torch-ref`` at the h tolerance) are timed beside the
   plain path, and the bf16 Gram's library call once more with its re/im
   combine (reported, not gated);
10. the staged f32 kernels (FFMA on the vector units: N, T/H and the
   Gram): their ``ptxas`` registers and spill bytes, and ragged shapes (N:
   m = 15 .. 129 around its 100-row items, n = 40 .. 5000 with odd n and n
   % 4 != 0; T/H in modes T and H: m = 1 .. 129 across its 16- and 20-wide
   k-chunks, n = 40 .. 133 around its 128-row items; both at S = 1 .. 40;
   the Gram at P = 1 .. 300 around its 100-row tiles, in both spaces, K =
   1 .. 264): the f32 output against its plain version at the s
   tolerance, the bf16 and f64 outputs bit for bit the f32 output cast.
   The bf16 and the f32 Gram (data space), N and T/H (mode H) are also
   built without their products and without their copies and timed at the
   paper shape, so the side that bounds each is measured (reported, not
   gated); the ``dssdd`` circulant G_hat setup runs through the f32 Gram
   (one launch, against ``torch-ref`` at the s tolerance), timed beside the
   plain path.
11. the wgmma kernels (Hopper's warpgroup products, ``csrc/wgmma.cuh``):
   the bf16 flash attention at Dh 64 and 128 (``flash_attention_bh_wgmma``)
   and the data-space Gram of bf16 planes at P <= 128
   (``sbgemm_gram_complex_wgmma``): their ``ptxas`` registers and spill
   bytes, and ragged shapes against their plain versions (flash: Sq and
   Skv around the 64-row blocks, the 64-key tiles and 128, causal and not
   with Sq != Skv, the 4-D entry with key-head groups of 1, 2 and 8, within
   FLASH_TOL; the Gram: P = 31 .. 128 with odd n, n % 8 != 0 and n over
   several k-chunks, bf16 and f32 outputs, within the h tolerance and
   exactly Hermitian off the diagonal), each call shown by its launch
   count to have run the wgmma kernel.  The serve prefill (24 launches a
   batch) and the ``hhhhh`` G_hat setup (one launch) run them; the
   parameter-space bf16 Gram keeps the general kernel.  Both are built
   without their products and without their copies for the bound probe.
12. the f32 flash kernel (``flash_attention_bh_f32``, IEEE FFMA on the
   FP32 units, every f32 call): its ``ptxas`` registers and spill bytes;
   ragged shapes against the plain version within FLASH_TOL (Sq and Skv
   around the 64-row blocks and tiles, causal and not, Dh = 12 .. 128,
   16-byte-aligned rows and rows of Dh + 1 floats, the 4-D entry with
   key-head groups of 1, 2 and 8), each call one launch of its entry, and
   each flash entry refusing the other's dtype; timed through its C entry
   at the serve shape and at 2048 tokens beside SDPA (queued) and built
   without its products and without its copies for the bound probe; the
   ``FULL_F32`` check launches it n_layers times and the general kernel
   never, and its prefill of the longer batch is timed on the flash and
   the chunked path.  pad_cast and unpad_cast are timed queued through
   their C entries beside their one-call PyTorch versions.
13. the vector cast kernel and the N SBGEMV on 16-byte vectors: pad_cast
   at a shape whose rows hold whole vectors at every dtype pair and from a
   view one column in (the element path), bit for bit; the N SBGEMV at
   (3, 5, 264) and (2, 7, 1000), also on planes that start one element
   in, and its tiled build at (3, 5, 264); the N SBGEMVs timed queued
   through their C entries beside ``torch.bmm``; the N kernel built
   without its products, timed beside it at the paper shape; the real N
   kernel at an odd n (its element path at every dtype).
14. the real SBGEMMs of bf16 and f32 planes on the staged kernels: about
   6200 calls at ragged shapes across their layouts' edges against the
   plain versions, each one launch of its kernel; the tiled real builds
   bit for bit against the untiled ones at three more edge shapes; both
   real SBGEMMs timed queued through their C entries beside ``torch.bmm``
   at S = 8 and 32; the four real builds in the bound probe.
15. the bf16 carrier of the tiled complex products: the tiled N and T/H
   SBGEMMs and the Gram of bf16 planes run their untiled tensor-core
   builds (every cell's rounding is the identity there; the data-space
   Gram at P <= 128 on wgmma), held bit for bit against them at every
   shape of 5a; ``hhhhh;tiles=ds|sh`` runs in 5b beside uniform ``hhhhh``.
16. the solve server (``runtime.SolveEngine``) at the paper shape, on the
   f64 operator of 3e (``max_batch`` 64): S = 1, 4, 16 and 64 consistent
   requests (tolerances 1e-6, 3e-6, 9e-6, CGNR damp 0.01, at most 30
   iterations) served coalesced and one at a time through the fig6
   twin's sweep, requests/s of both; every request converged on both
   paths, per uid the coalesced x within 1e-3 of the naive x, one batch
   of S per coalesced serve, no operator or applier built after the
   warm-up, a repeat serve at S = 64 launching the SBGEMMs once per
   iteration, one exact Gram at S = 64 under the served config against
   the plain path, and a second engine answered from the TuningCache.
17. every other LM family at full width through ``ServeEngine.serve``
   (``drive_families``; granite-moe-3b, falcon-mamba-7b, zamba2-1.2b,
   whisper-base, one model at a time, 4 greedy requests of 8 new tokens;
   prompts of 449-512 tokens, whisper's of 17-32 over 1500 stub frames):
   exactly the prefill's attention calls on the wgmma flash kernel (32,
   0, 6 and 18 a batch), none in decode; flash against chunked logits
   within LOGIT_TOL (granite's chunked path on the flash path's routing,
   the (token, layer) pairs whose own choice differs counted); the MoE FFN
   at one full-width layer against a dense oracle at a prefill and a
   decode shape (dropped pairs equal); Mamba-1's selective scan and its
   LTI FFT convolution against f64 loops, the LTI-FFT block against the
   direct convolution's; Mamba-2's SSD against its f64 recurrence;
   falcon's prefill + decode against its forward (gated at ``FULL_F32``);
   tokens/s, prefill ms, decode ms a step and its idle share (a profiled
   decode step), peak memory, seconds.  The
   wgmma flash checks (11) also take granite's GQA groups of 3 and
   whisper's non-causal 1500-key calls.
18. the dispatch crossover and training (``drive_dispatch_calibration``,
   ``drive_train``): ``calibrate_dispatch`` on the card into a temp-dir
   TuningCache (the kernel and plain ms of the complex "H" SBGEMV at B =
   8, m = 16 at every ratio, the ratio found, a second call answered from
   the cache, the calibrated table's routing by launch counts, the
   default table launching the kernel at the paper shape); qwen1.5-0.5b
   at full width and depth trained by ``runtime.Trainer`` for 6 steps
   (AdamW, cosine schedule, ``remat="full"``, chunked attention, batches
   of 2 x 4096 from ``SyntheticPipeline``): step ms, tokens/s, peak
   memory, loss and grad norm a step, the final checkpoint's seconds and
   GB, a profiled step's device time, no hand-written kernel launched;
   checks: 4 AdamW steps lower one batch's loss, the head product's
   backward against f64, and on a 2-layer model at ``FULL_F32`` the loss
   and grad norm against a plain f64 model (1e-4), a crash resumed to the
   uninterrupted run's parameters (rtol 1e-5, atol 1e-6), an int8-
   compressed step with nonzero error feedback, a grad-enabled flash call
   raising.
19. the roofline and the dry run (``drive_roofline``): F and F* at the
   paper shape for ddddd, sssss and hhhhh run once under
   ``launch.roofline.OpCounter`` (FLOPs by dtype, raw and floor bytes,
   the bound and its side, the ms measured in the phase, the share bound
   over measured, which fails above 1.05; the GEMV's counted bytes equal
   to PERF.md rows 3-4); qwen1.5-0.5b's train step at drive_train's 2 x
   4096 counted under fake tensors, drive_serve's longer prefill batch
   counted on the card on the flash path that phase times, ``train_mfu``
   and ``prefill_mfu`` from those phases' median times, the fake-mode
   peak of the train step within TRAIN_PEAK_BAND of the measured one.
   The autotuner (5c) pre-flights every timed config through the plan
   linter (``lint=True``).
20. the plan linter (``drive_lint``): ``python -m repro_torch.analysis``
   at the paper shape over every registered backend exits 0; the h100
   matvec trace holds the three kernels' nodes; the seeded downgrading
   ``unpad`` makes the CLI exit nonzero.
21. the dry run (``drive_dryrun``), after every timed phase: ``python -m
   repro_torch.launch.dryrun`` over every arch at train_4k, decode_32k
   and long_500k on the single-card mesh (host work on fake tensors):
   every cell ok or skipped.  The prefill_32k cells run once through the
   chip tool instead (PERF.md, PR 28).

It prints a JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.  Any failed check exits nonzero before
that line.  Full results go to ``chiprun_out/chip_smoke.json``.  Without a
CUDA device, or without the rest of the repository, it exits nonzero and
prints no result.
"""

from __future__ import annotations

import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent

TOL = {"d": 1e-12, "s": 1e-5, "h": 2e-2}
LEVEL_OF = {torch.float64: "d", torch.float32: "s", torch.bfloat16: "h"}
DTYPES = (torch.float64, torch.float32, torch.bfloat16)
REPEATS = 20
FLASH_REPEATS = 200     # queued timings of calls of tens of us (flash, casts)
SEED = 0
S_BLOCK = 8          # the main path's block of right-hand sides
S_WIDE = 32          # a wider block, for the per-column trend
SOLVER_ITERS = 30
# tile maps for the tiled kernels: an aligned 2 x 2 grid, and a 3 x 3 one
# whose cells cut 1001 bins and 5000 columns raggedly
TILE_MAPS = {"2x2": (("d", "s"), ("s", "h")),
             "3x3": (("h", "s", "d"), ("s", "d", "h"), ("d", "h", "s"))}
# tiles= configs on the main path: f64 carrier with f32 and bf16 cells, f32
# carrier with bf16 cells, and a bf16 carrier (its effective map all h)
TILED_CONFIGS = ("ddddd;tiles=ds|sh", "dssdd;tiles=hs|sh", "hhhhh;tiles=ds|sh")


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


def check_planes(what: str, got, want, dt, tol=None) -> float:
    """Hold each output plane of a kernel against its plain version at the
    level's tolerance (or ``tol``); returns the largest absolute
    difference."""
    tol = TOL[LEVEL_OF[dt]] if tol is None else tol
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
    """The least time for the work on the H100: its bytes over the HBM
    rate or its FLOPs over the peak for ``flop_dtype``, whichever is
    larger (the data sheet's peaks, ``backend.H100``)."""
    from repro_torch.backend import H100
    t_bytes = bytes_moved / H100.hbm_bandwidth
    t_ops = flops / H100.peak(flop_dtype) if flops else 0.0
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                      else "operations")


# ---------------------------------------------------------------------------
# 2 + 4a. Kernels against their plain versions; kernel, plain, library times
# ---------------------------------------------------------------------------

def check_pad_kernels(dev, R, T, P, timed, results, time_fn):
    """pad_cast / unpad_cast bit for bit their plain versions for all 9
    dtype pairs, the pad reading a row-strided view and a view one column
    in, the unpad its rows and a view of them one column in (the views one
    column in take the kernel's element path).  Timed (same-dtype pairs):
    each kernel through its C entry and its one-call PyTorch version, both
    queued (FLASH_REPEATS calls behind a device-side spin, so the host's
    launch time stays out of a call of tens of us), each twice (``ms``,
    ``ms_again``; ``library_ms``, ``library_ms_again``); the wrapper
    (``wrapper_ms``) and the plain version by the median of events."""
    from repro_torch.kernels import pad_cast as pk
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = torch.randn((R, P), generator=gen, device=dev, dtype=torch.float64)
    for din in DTYPES:
        wide = base.to(din)
        for dout in DTYPES:
            # pad reads a row-strided view: (R, T) columns of an (R, P)
            # tensor, from its first column and one column in
            x = wide[:, :T]
            for src, what in ((x, ""), (wide[:, 1:1 + T], " one column in")):
                got = pk.pad_cast(src, P, dout)
                want = pk.pad_cast_plain(src, P, dout)
                if not torch.equal(bits(got), bits(want)):
                    fail(f"pad_cast {name(din)}->{name(dout)} at {(R, T, P)}"
                         f"{what} differs from its plain version")
            # unpad from rows whose starts allow vectors and from a view one
            # column in (the element path)
            for src, what in ((wide, ""), (wide[:, 1:], " one column in")):
                got_u = pk.unpad_cast(src, T, dout)
                want_u = pk.unpad_cast_plain(src, T, dout)
                if not torch.equal(bits(got_u), bits(want_u)):
                    fail(f"unpad_cast {name(din)}->{name(dout)} at "
                         f"{(R, P, T)}{what} differs from its plain version")
            if not timed or din != dout:
                continue
            xc = x.contiguous()
            s = din.itemsize
            yp = torch.empty((R, P), device=dev, dtype=dout)
            yu = torch.empty((R, T), device=dev, dtype=dout)
            entries = {"pad_cast": ((xc, yp), (R, T, P, T)),
                       "unpad_cast": ((wide, yu), (R, T, P))}
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
                launch = (entry_call("pad_cast", kname, *entries[kname],
                                     din, dout) if dev.type == "cuda"
                          else lambda _, kfn=kfn, arg=arg: kfn(arg))

                def queued(fn, arg=arg):
                    return time_fn(fn, arg, repeats=FLASH_REPEATS,
                                   mode="queued")
                row = results[kname][name(din)] = {
                    "shape": [R, T, P], "max_abs_err": 0.0,
                    "ms": queued(launch), "library_ms": queued(lfn)}
                row["library_ms_again"] = queued(lfn)
                row["ms_again"] = queued(launch)
                row.update({"wrapper_ms": time_fn(kfn, arg),
                            "plain_ms": time_fn(pfn, arg), "bytes": nbytes,
                            "bound_ms": b_ms, "bound_by": b_by})
                print(f"{kname} {name(din)} at {(R, T, P)}: {row['ms']:.4f} / "
                      f"{row['ms_again']:.4f} ms, one PyTorch call "
                      f"{row['library_ms']:.4f} / {row['library_ms_again']:.4f}"
                      f" (queued); bound {b_ms:.4f}; through the wrapper "
                      f"{row['wrapper_ms']:.4f}", flush=True)
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


def _library_gram(Ar, Ai, data: bool, combine: bool = False):
    """One torch.bmm for the Gram blocks: A A^H (data) or A^H A on complex
    tensors at f32/f64; at bf16 the stacked real planes against
    themselves, which gives all four real products (with ``combine``, then
    the two adds that make G's planes from them)."""
    if Ar.dtype == torch.bfloat16:
        P = Ar.shape[1] if data else Ar.shape[2]
        if data:
            As = torch.cat([Ar, Ai], dim=1)              # (B, 2m, n)
            prod = lambda: torch.bmm(As, As.mT)
        else:
            As = torch.cat([Ar, Ai], dim=2)              # (B, m, 2n)
            prod = lambda: torch.bmm(As.mT, As)
        if not combine:
            return lambda _: prod()

        def combined(_):
            # [[rr, ri], [ir, ii]]: Gr = rr + ii; Gi = ir - ri (data),
            # ri - ir (parameter)
            G = prod()
            rr, ii = G[:, :P, :P], G[:, P:, P:]
            ri, ir = G[:, :P, P:], G[:, P:, :P]
            return rr + ii, (ir - ri) if data else (ri - ir)
        return combined
    Ac = torch.complex(Ar, Ai)
    if data:
        return lambda _: torch.bmm(Ac, Ac.mH)
    return lambda _: torch.bmm(Ac.mH, Ac)


def entry_call(source, entry, tensors, sizes, dt_in, dt_out, defines=(),
               levels=None):
    """A C entry of ``csrc/<source>.cu`` (built with the ``-D`` macros
    ``defines``) on ``tensors`` (inputs, then outputs) with no Python
    around it: no launch is counted.  ``levels``: a tiled entry's map,
    passed as the wrappers pass it (a host array after the outputs, its R
    and C after ``sizes``).  The entries that take A's strides get those
    of ``tensors[0]`` after ``sizes``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import sbgemv as sk
    fn = getattr(_build.library(source, defines), entry)
    t0 = tensors[0]
    if entry in sk.STRIDED_ENTRIES:
        sizes = (*sizes, *sk._a_strides(t0))
    ptrs, grid = [t.data_ptr() for t in tensors], None
    if levels is not None:
        R, C, grid = sk._level_grid(levels)
        ptrs.append(ctypes.addressof(grid))
        sizes = (*sizes, R, C)
    args = (*ptrs, *sizes,
            _build.DTYPE_CODES[dt_in], _build.DTYPE_CODES[dt_out],
            t0.device.index, _build.stream_of(t0))

    def call(_, grid=grid):            # holds the host array the calls read
        _build.check(fn(*args), entry)
    return call


def queued_pair(time_fn, kernel_call, library_call) -> dict:
    """A kernel's call and one PyTorch call for the same function, each
    timed queued (FLASH_REPEATS calls behind a device-side spin, so the
    host's time stays out) twice, in the order kernel, library, library,
    kernel."""
    def queued(fn):
        return time_fn(fn, None, repeats=FLASH_REPEATS, mode="queued")
    row = {"queued_ms": queued(kernel_call),
           "library_queued_ms": queued(library_call)}
    row["library_queued_ms_again"] = queued(library_call)
    row["queued_ms_again"] = queued(kernel_call)
    return row


def check_sbgemv_kernels(dev, B, m, n, timed, results, time_fn, offset=0):
    """The complex SBGEMVs (modes N, T, H) against their plain versions at
    each dtype; with ``offset``, on planes that start that many elements
    into a larger buffer (contiguous views whose starts no 16-byte vector
    fits: the N kernel's element path).  Timed (modes N and H): kernel,
    plain version and one PyTorch call by the median of events; mode N also
    through its C entry beside the PyTorch call, both queued."""
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    A64 = [torch.randn((B, m, n), generator=gen, device=dev,
                       dtype=torch.float64) for _ in range(2)]
    xn64 = [torch.randn((B, n), generator=gen, device=dev,
                        dtype=torch.float64) for _ in range(2)]
    xm64 = [torch.randn((B, m), generator=gen, device=dev,
                        dtype=torch.float64) for _ in range(2)]

    def at(t):
        if not offset:
            return t
        buf = torch.empty(t.numel() + offset, device=dev, dtype=t.dtype)
        return buf[offset:].view(t.shape).copy_(t)
    where = f" {offset} element(s) in" if offset else ""
    for dt in DTYPES:
        Ar, Ai = (at(a.to(dt)) for a in A64)
        for mode in "NTH":
            if mode == "N":
                xr, xi = (at(x.to(dt)) for x in xn64)
                kname = "sbgemv_n_complex"
                kfn = lambda _: sk.sbgemv_n_complex(Ar, Ai, xr, xi)
                pfn = lambda _: sk.sbgemv_n_complex_plain(Ar, Ai, xr, xi, dt)
                x_elems, y_elems = B * n, B * m
            else:
                xr, xi = (at(x.to(dt)) for x in xm64)
                conj = mode == "H"
                kname = "sbgemv_th_complex"
                kfn = lambda _: sk.sbgemv_th_complex(Ar, Ai, xr, xi, conj=conj)
                pfn = lambda _: sk.sbgemv_th_complex_plain(Ar, Ai, xr, xi,
                                                           conj, dt)
                x_elems, y_elems = B * m, B * n
            what = f"{kname} mode {mode} {name(dt)} at {(B, m, n)}{where}"
            err = check_planes(what, kfn(None), pfn(None), dt)
            print(f"{what}: max abs err vs plain {err:.3e}", flush=True)
            if not timed or mode == "T":
                continue
            s = dt.itemsize
            nbytes = 2 * B * m * n * s + 2 * x_elems * s + 2 * y_elems * s
            flops = 8 * B * m * n
            b_ms, b_by = bound_ms(nbytes, flops, name(dt))
            lib = _library(Ar, Ai, xr, xi, mode)
            row = results[kname][name(dt)] = {
                "shape": [B, m, n], "mode": mode, "max_abs_err": err,
                "ms": time_fn(kfn, None), "plain_ms": time_fn(pfn, None),
                "library_ms": time_fn(lib, None),
                "bytes": nbytes, "flops": flops,
                "bound_ms": b_ms, "bound_by": b_by}
            if mode == "N":
                ys = [torch.empty((B, m), device=dev, dtype=dt)
                      for _ in range(2)]
                call = (entry_call("sbgemv", kname, (Ar, Ai, xr, xi, *ys),
                                   (B, m, n), dt, dt)
                        if dev.type == "cuda" else kfn)
                row.update(queued_pair(time_fn, call, lib))
                print(f"{kname} {name(dt)} at {(B, m, n)}: "
                      f"{row['queued_ms']:.4f} / {row['queued_ms_again']:.4f}"
                      f" ms queued, one PyTorch call "
                      f"{row['library_queued_ms']:.4f} / "
                      f"{row['library_queued_ms_again']:.4f}; bound "
                      f"{b_ms:.4f}", flush=True)
                del ys
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
    from repro_torch.kernels import _build
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
            P, K = (m, n) if data else (n, m)
            # the entry that must take it: the wgmma Gram for bf16 planes
            # in data space at P <= 128, the general one for the rest
            entry = ("sbgemm_gram_complex_wgmma" if dt == torch.bfloat16
                     and data and P <= 128 else "sbgemm_gram_complex")
            before = _build.launch_counts[entry]
            err = check_planes(what, kfn(None), pfn(None), dt)
            if dev.type == "cuda" and \
                    _build.launch_counts[entry] != before + 1:
                fail(f"{what}: did not launch {entry}")
            print(f"{what}: max abs err vs plain {err:.3e}", flush=True)
            if not timed:
                continue
            nbytes = 2 * dt.itemsize * (B * m * n + B * P * P)
            # G is Hermitian: the P (P + 1) / 2 entries on and above the
            # diagonal are the work, 8 K real flops each
            flops = 4 * B * P * (P + 1) * K
            b_ms, b_by = bound_ms(nbytes, flops, name(dt))
            lib = _library_gram(Ar, Ai, data)
            row = results[entry][f"{name(dt)} {space}"] = {
                "shape": [B, m, n], "space": space, "max_abs_err": err,
                "ms": time_fn(kfn, None), "plain_ms": time_fn(pfn, None),
                "library_ms": time_fn(lib, None),
                "bytes": nbytes, "flops": flops,
                "bound_ms": b_ms, "bound_by": b_by}
            if dt == torch.bfloat16:
                # the stacked bmm leaves out the re/im combine; with it, the
                # library does the kernel's whole function
                lib = _library_gram(Ar, Ai, data, combine=True)
                e = max(rel(g, w) for g, w in zip(lib(None), pfn(None)))
                if not e <= TOL["h"]:
                    fail(f"{what}: library with combine differs, rel {e:.3e}")
                row["library_combine_ms"] = time_fn(lib, None)
                print(f"  bf16 Gram {row['ms']:.4f} ms, bmm "
                      f"{row['library_ms']:.4f}, bmm + combine "
                      f"{row['library_combine_ms']:.4f}", flush=True)
            del lib
        del Ar, Ai


def check_bf16_tensor_core_kernels(dev):
    """The bf16 tensor-core kernels (untiled complex N, T/H and Gram of bf16
    planes) at ragged shapes across their edges.  N: m around the 16-row
    warp tiles and the 112-row item, n odd (element copies), n % 8 != 0, n
    shorter than one k-chunk and n over several chunks with a ragged last
    one (16-byte copies), S across the 8/16/32 passes.  T/H (modes T and
    H): k = m from 1 to past one 112-wide k-chunk, n around the 112-row
    items (odd n: element copies), the same S.  The Gram at P around its
    16-row tiles, its 112-row tile and its 64-row off-diagonal halves, in
    both spaces.  bf16, f32 and f64 outputs (the Gram bf16 and f32), each
    against its plain version at the h tolerance."""
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    dt = torch.bfloat16
    outs = (dt, torch.float32, torch.float64)
    S_list = (1, 8, 9, 16, 17, 32, 33, 40)

    def planes(*shape):
        return [torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float64).to(dt) for _ in range(2)]

    n_n = n_t = n_g = 0
    for m in (15, 16, 17, 100, 129):
        for n in (133, 130, 40, 264):
            A = planes(2, m, n)
            for S in S_list:
                X = planes(2, n, S)
                for od in outs:
                    check_planes(f"sbgemm_n_complex bf16 -> {name(od)} at "
                                 f"{(2, m, n, S)}",
                                 sk.sbgemm_n_complex(*A, *X, out_dtype=od),
                                 sk.sbgemm_n_complex_plain(*A, *X, od), dt)
                    n_n += 1
    for m in (1, 7, 15, 16, 17, 100, 113, 129):
        for n in (40, 111, 112, 113, 130, 133):
            A = planes(2, m, n)
            for S in S_list:
                X = planes(2, m, S)
                for conj in (False, True):
                    for od in outs:
                        check_planes(
                            f"sbgemm_th_complex mode {'H' if conj else 'T'} "
                            f"bf16 -> {name(od)} at {(2, m, n, S)}",
                            sk.sbgemm_th_complex(*A, *X, conj=conj,
                                                 out_dtype=od),
                            sk.sbgemm_th_complex_plain(*A, *X, conj, od), dt)
                        n_t += 1
    for P in (31, 64, 100, 112, 113, 128, 129, 300):
        for space in ("data", "parameter"):
            data = space == "data"
            for K in (7, 77, 264):
                m, n = (P, K) if data else (K, P)
                A = planes(2, m, n)
                for od in (dt, torch.float32):
                    check_planes(f"sbgemm_gram_complex {space} bf16 -> "
                                 f"{name(od)} at {(2, m, n)}",
                                 sk.sbgemm_gram_complex(*A, data=data,
                                                        out_dtype=od),
                                 sk.sbgemm_gram_complex_plain(*A, data, od),
                                 dt)
                    n_g += 1
    sync(dev)
    print(f"bf16 tensor-core kernels: {n_n} N, {n_t} T/H and {n_g} Gram "
          f"calls at ragged shapes within {TOL['h']:g} of their plain "
          f"versions", flush=True)


def _check_f32_outputs(what, kernel, plain) -> int:
    """One staged f32 kernel call against its plain version: the f32 output
    at the s tolerance; the bf16 and f64 outputs bit for bit the f32 output
    cast (the sums do not depend on the output dtype), and against the
    plain version within one rounding of their dtype.  ``kernel`` and
    ``plain`` take the output dtype; returns the calls made."""
    dt = torch.float32
    got = kernel(dt)
    check_planes(what, got, plain(dt), dt)
    for od in (torch.bfloat16, torch.float64):
        cast = kernel(od)
        if not same_bits(cast, [g.to(od) for g in got]):
            fail(f"{what} -> {name(od)} differs from the f32 output cast")
        check_planes(f"{what} -> {name(od)}", cast, plain(od), dt,
                     max(TOL["s"], 2.0 ** -8 if od == torch.bfloat16
                         else 0.0))
    return 3


def check_f32_kernels(dev):
    """The staged f32 kernels at ragged shapes across their edges, each
    output checked by ``_check_f32_outputs``.  N: m around its 20-row warp
    bands and 100-row items, n shorter than one 32-wide k-chunk, odd and n
    % 4 != 0 (element copies) and the paper's 5000, S across the 8/16/32
    passes and past 32.  T/H, modes T and H: k = m from 1 past one 16- or
    20-wide k-chunk and past 100, n around the 32-row warp bands and the
    128-row items, odd and n % 4 != 0, the same S.  The Gram, both spaces:
    P around the 25-quad tile (99 .. 103, and its multiples past 100, which
    take the two-panel items), P % 4 != 0 (element stores), K from 1 past
    one 64-wide k-chunk."""
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    dt = torch.float32
    S_list = (1, 8, 9, 16, 17, 32, 33, 40)

    def planes(*shape):
        return [torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float64).to(dt) for _ in range(2)]

    n_n = n_t = n_g = 0
    for m in (15, 16, 17, 25, 100, 129):
        for n in (40, 130, 133, 264, 5000):
            A = planes(2, m, n)
            for S in S_list:
                X = planes(2, n, S)
                n_n += _check_f32_outputs(
                    f"sbgemm_n_complex f32 at {(2, m, n, S)}",
                    lambda od: sk.sbgemm_n_complex(*A, *X, out_dtype=od),
                    lambda od: sk.sbgemm_n_complex_plain(*A, *X, od))
    for m in (1, 7, 16, 17, 20, 21, 100, 129):
        for n in (40, 127, 128, 129, 130, 133):
            A = planes(2, m, n)
            for S in S_list:
                X = planes(2, m, S)
                for conj in (False, True):
                    n_t += _check_f32_outputs(
                        f"sbgemm_th_complex mode {'H' if conj else 'T'} f32 "
                        f"at {(2, m, n, S)}",
                        lambda od: sk.sbgemm_th_complex(*A, *X, conj=conj,
                                                        out_dtype=od),
                        lambda od: sk.sbgemm_th_complex_plain(*A, *X, conj,
                                                              od))
    for P in (1, 4, 31, 99, 100, 101, 103, 200, 201, 300):
        for space in ("data", "parameter"):
            data = space == "data"
            for K in (1, 7, 64, 65, 264):
                A = planes(2, *((P, K) if data else (K, P)))
                n_g += _check_f32_outputs(
                    f"sbgemm_gram_complex {space} f32 at {tuple(A[0].shape)}",
                    lambda od: sk.sbgemm_gram_complex(*A, data=data,
                                                      out_dtype=od),
                    lambda od: sk.sbgemm_gram_complex_plain(*A, data, od))
    sync(dev)
    print(f"f32 staged kernels: {n_n} N, {n_t} T/H and {n_g} Gram calls at "
          f"ragged shapes within {TOL['s']:g} of their plain versions (bf16 "
          f"/ f64 outputs: the f32 output cast, bit for bit)", flush=True)


def check_wgmma_kernels(dev):
    """The wgmma kernels at ragged shapes, each call's launch counted.
    Flash (bf16, Dh 64 and 128): Sq and Skv around the 64-row blocks, the
    64-key tiles and 128, causal and not, Sq != Skv both ways, and
    whisper's non-causal 1500 x 1500 and 30 x 1500 calls, on folded heads;
    the 4-D entry with 2 key heads in groups of 1, 2, 3 (granite's) and 8
    against the plain version of the repeated heads; within FLASH_TOL.  The Gram
    (data space, bf16 planes): P = 31 .. 128 around the two 64-row
    warpgroups, n odd (element copies), n % 8 != 0, one k-chunk and
    several with a ragged last one (16-byte copies), bf16 and f32 outputs
    within the h tolerance, and on the card exactly Hermitian off the
    diagonal (Gr symmetric, Gi antisymmetric bit for bit)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    dt = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dt)

    def counted(entry, fn):
        _build.reset_launch_counts()
        out = fn()
        check_launches(dict(_build.launch_counts), {entry: 1})
        return out

    n_f = n_g = 0
    worst = 0.0
    lengths = ((1, 1), (63, 63), (64, 64), (65, 65), (127, 127), (128, 128),
               (129, 129), (200, 77), (77, 200), (64, 130), (130, 64),
               (1, 300), (300, 1))
    for Dh in (64, 128):
        for Sq, Skv in lengths:
            for causal in (True, False):
                q, k, v = randn(3, Sq, Dh), randn(3, Skv, Dh), randn(3, Skv, Dh)
                got = counted("flash_attention_bh_wgmma",
                              lambda: fa.flash_attention_bh(q, k, v,
                                                            causal=causal))
                want = fa.flash_attention_bh_plain(q, k, v, causal=causal)
                err = max_abs(got, want)
                if got.dtype != dt or not err <= FLASH_TOL[dt]:
                    fail(f"flash_attention_bh_wgmma at {(3, Sq, Skv, Dh)} "
                         f"causal={causal}: {got.dtype}, max abs err "
                         f"{err:.3e} > {FLASH_TOL[dt]:g}")
                worst, n_f = max(worst, err), n_f + 1
        # whisper's encoder (1500 x 1500) and cross-attention (a prompt over
        # 1500 frames), both non-causal, on folded heads
        for Sq, Skv in ((1500, 1500), (30, 1500)):
            q, k, v = randn(3, Sq, Dh), randn(3, Skv, Dh), randn(3, Skv, Dh)
            got = counted("flash_attention_bh_wgmma",
                          lambda: fa.flash_attention_bh(q, k, v, causal=False))
            err = max_abs(got, fa.flash_attention_bh_plain(q, k, v,
                                                           causal=False))
            if not err <= FLASH_TOL[dt]:
                fail(f"flash_attention_bh_wgmma at {(3, Sq, Skv, Dh)} "
                     f"non-causal: max abs err {err:.3e} > {FLASH_TOL[dt]:g}")
            worst, n_f = max(worst, err), n_f + 1
        # granite's GQA is 24 query heads over 8 key heads: groups of 3
        for G in (1, 2, 3, 8):
            B, S, Hkv = 2, 150, 2
            q, k, v = randn(B, S, Hkv * G, Dh), randn(B, S, Hkv, Dh), \
                randn(B, S, Hkv, Dh)
            got = counted("flash_attention_bh_wgmma",
                          lambda: fa.flash_attention(q, k, v, causal=True))
            fold = lambda x: x.transpose(1, 2).reshape(-1, S, Dh)  # noqa: E731
            kr, vr = (x.repeat_interleave(G, dim=2) for x in (k, v))
            want = fa.flash_attention_bh_plain(fold(q), fold(kr), fold(vr),
                                               causal=True)
            err = max_abs(fold(got), want)
            if not err <= FLASH_TOL[dt]:
                fail(f"flash_attention_bh_wgmma GQA group {G} Dh {Dh}: max "
                     f"abs err {err:.3e} > {FLASH_TOL[dt]:g}")
            worst, n_f = max(worst, err), n_f + 1
    for P in (31, 63, 64, 65, 100, 127, 128):
        for K in (1, 7, 77, 130, 264, 5000):
            A = [randn(3, P, K) for _ in range(2)]
            for od in (dt, torch.float32):
                what = f"sbgemm_gram_complex_wgmma bf16 -> {name(od)} at {(3, P, K)}"
                got = counted("sbgemm_gram_complex_wgmma",
                              lambda: sk.sbgemm_gram_complex(*A, data=True,
                                                             out_dtype=od))
                check_planes(what, got, sk.sbgemm_gram_complex_plain(*A, True,
                                                                     od), dt)
                off = ~torch.eye(P, dtype=torch.bool, device=dev)
                if dev.type == "cuda" and not (
                        torch.equal(got[0], got[0].mT) and torch.equal(
                            got[1][:, off], -got[1].mT[:, off])):
                    fail(f"{what}: not exactly Hermitian off the diagonal")
                n_g += 1
    if dev.type == "cuda":
        # one kernel a shape: the general entry refuses bf16 data-space
        # calls at P <= 128 and takes P = 129
        lib, code = _build.library("sbgemm"), _build.DTYPE_CODES[dt]
        for P in (1, 100, 128, 129):
            A = [randn(1, P, 77) for _ in range(2)]
            G = [torch.empty((1, P, P), device=dev, dtype=dt)
                 for _ in range(2)]
            rc = lib.sbgemm_gram_complex(*(t.data_ptr() for t in (*A, *G)),
                                         1, P, 77, 1, code, code, dev.index,
                                         _build.stream_of(A[0]))
            if (rc != 0) != (P <= 128):
                fail(f"sbgemm_gram_complex bf16 data space at P = {P} "
                     f"returned {rc}: it must refuse P <= 128 and take more")
    sync(dev)
    print(f"wgmma kernels: {n_f} flash calls within {FLASH_TOL[dt]:g} (worst "
          f"{worst:.3e}) and {n_g} Gram calls within {TOL['h']:g} of their "
          f"plain versions, each one launch of its wgmma kernel", flush=True)


# measurement builds of csrc/sbgemm.cu and csrc/sbgemm_real.cu: the bf16
# tensor-core kernels and the staged f32 kernels with one side compiled out
# (csrc/sbgemm_bf16.cuh, csrc/sbgemm_f32.cuh)
BOUND_PROBES = {"no_products_ms": ("SBGEMM_BF16_NO_MMA", "SBGEMM_F32_NO_FMA"),
                "no_copy_ms": ("SBGEMM_BF16_NO_COPY", "SBGEMM_F32_NO_COPY")}


def bound_side(time_fn, call_whole, calls_one_sided) -> dict:
    """The whole build timed before and after its one-sided builds (the
    run's spread: the two readings' difference, at least 2 % of the
    first), and the side that bounds it: neither when no one-sided build
    beats the whole by more than the spread (something else binds), else
    the side left in the slower one-sided build."""
    row = {"ms": time_fn(call_whole, None)}
    for label, call in calls_one_sided.items():
        row[label] = time_fn(call, None)
    row["ms_again"] = time_fn(call_whole, None)
    spread = max(abs(row["ms_again"] - row["ms"]), 0.02 * row["ms"])
    whole = min(row["ms"], row["ms_again"])
    if min(row["no_products_ms"], row["no_copy_ms"]) >= whole - spread:
        row["bound_side"] = "neither"
    else:
        row["bound_side"] = ("products" if row["no_copy_ms"]
                             > row["no_products_ms"] else "copies")
    return row


def probe_bounds(dev, B, m, n, time_fn):
    """The bf16 tensor-core kernels and the staged f32 kernels (each: the
    data-space Gram, N and mode H at S = 8 and 32; the real N and T at S =
    8 and 32, from the ``sbgemm_real`` library) at the paper shape, each
    built as the wrappers load it, without its products (the copy
    pipeline alone, with the bf16 fragment loads) and without its copies
    (the products alone, on whatever shared memory holds): ``bound_side``
    names the side that bounds the kernel, or neither.  A real build's
    whole is timed once and the reading dropped first (the card's first
    reading after other work runs slow).  Called through the C entries,
    so no launch is counted.  Reported, not gated."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)

    def planes(dt, *shape, fill=True):
        return [torch.randn(shape, generator=gen, device=dev).to(dt) if fill
                else torch.empty(shape, device=dev, dtype=dt)
                for _ in range(2)]

    out = {}
    for dt in (torch.bfloat16, torch.float32):
        A = planes(dt, B, m, n)
        # the data-space Gram: bf16 planes at P = m <= 128 take the wgmma
        # entry alone
        gram = ("sbgemm_gram_complex_wgmma" if dt == torch.bfloat16
                else "sbgemm_gram_complex")
        cases = {f"{gram} data": (
            "sbgemm", gram, (*A, *planes(dt, B, m, m, fill=False)),
            (B, m, n), (1,))}
        for S in (S_BLOCK, S_WIDE):
            cases[f"sbgemm_n_complex S={S}"] = (
                "sbgemm", "sbgemm_n_complex",
                (*A, *planes(dt, B, n, S), *planes(dt, B, m, S, fill=False)),
                (B, m, n, S), ())
            cases[f"sbgemm_th_complex H S={S}"] = (
                "sbgemm", "sbgemm_th_complex",
                (*A, *planes(dt, B, m, S), *planes(dt, B, n, S, fill=False)),
                (B, m, n, S), (1,))
            # the real builds: one plane of A, X and Y
            for op, (xlen, ylen) in (("n", (n, m)), ("th", (m, n))):
                cases[f"sbgemm_{op}_real S={S}"] = (
                    "sbgemm_real", f"sbgemm_{op}_real",
                    (A[0], planes(dt, B, xlen, S)[0],
                     planes(dt, B, ylen, S, fill=False)[0]), (B, m, n, S), ())
        code = _build.DTYPE_CODES[dt]
        for what, (source, entry, tensors, sizes, ints) in cases.items():
            ptrs = [t.data_ptr() for t in tensors]
            if entry in sk.STRIDED_ENTRIES:      # A's strides follow
                sizes = (*sizes, *sk._a_strides(tensors[0]))

            def call_of(defines, source=source, entry=entry, ptrs=ptrs,
                        sizes=sizes, ints=ints):
                fn = getattr(_build.library(source, defines), entry)

                def call(_):
                    _build.check(fn(*ptrs, *sizes, *ints, code, code,
                                    dev.index, _build.stream_of(A[0])), entry)
                return call
            if source == "sbgemm_real":
                time_fn(call_of(()), None)
            row = out[f"{what} {name(dt)}"] = bound_side(
                time_fn, call_of(()),
                {label: call_of(d) for label, d in BOUND_PROBES.items()})
            print(f"{what} {name(dt)}: {row['ms']:.4f} / {row['ms_again']:.4f}"
                  f" ms; without products {row['no_products_ms']:.4f}, "
                  f"without copies {row['no_copy_ms']:.4f}: bound by "
                  f"{row['bound_side']}", flush=True)
        del A, cases
        free(dev)
    return out


# the measurement build of csrc/sbgemv.cu's N kernel without its products
# (every loaded word folded into the sums by XOR instead)
SBGEMV_PROBES = {"no_products_ms": ("SBGEMV_N_NO_PRODUCTS",)}


def probe_sbgemv_bounds(dev, B, m, n, time_fn):
    """The N SBGEMV (``sbgemv_n_complex``) at the paper shape at each
    dtype, built as the wrapper loads it and without its products.  The
    whole build is timed once and the reading dropped (the card's first
    reading after other work runs slow), then timed before and after the
    build without products (the run's spread: the two readings'
    difference, at least 2 % of the first).  Bound by its loads when the
    build without products is no faster than the whole by more than the
    spread, else by the instructions around them.  Called through the C
    entry: no launch is counted.  Reported, not gated."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 33)
    out = {}
    for dt in DTYPES:
        tensors = [torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((B, m, n), (B, m, n), (B, n), (B, n))]
        tensors += [torch.empty((B, m), device=dev, dtype=dt)
                    for _ in range(2)]

        def call_of(defines, tensors=tensors, dt=dt):
            return entry_call("sbgemv", "sbgemv_n_complex", tensors,
                              (B, m, n), dt, dt, defines)
        time_fn(call_of(()), None)
        row = {"ms": time_fn(call_of(()), None)}
        for label, defines in SBGEMV_PROBES.items():
            row[label] = time_fn(call_of(defines), None)
        row["ms_again"] = time_fn(call_of(()), None)
        spread = max(abs(row["ms_again"] - row["ms"]), 0.02 * row["ms"])
        whole = min(row["ms"], row["ms_again"])
        row["bound_side"] = ("loads" if row["no_products_ms"]
                             >= whole - spread else "instructions")
        out[f"sbgemv_n_complex {name(dt)}"] = row
        print(f"sbgemv_n_complex {name(dt)} at {(B, m, n)}: {row['ms']:.4f}"
              f" / {row['ms_again']:.4f} ms; without products "
              f"{row['no_products_ms']:.4f}: bound by {row['bound_side']}",
              flush=True)
        del tensors
        free(dev)
    return out


# measurement builds of csrc/flash_attention.cu: the wgmma and the f32
# kernels without their products (wgmma.cuh; the f32 kernel's FFMA loops)
# and without their K/V and Q copies
FLASH_PROBES = {"no_products_ms": ("WGMMA_NO_MMA", "FLASH_F32_NO_FMA"),
                "no_copy_ms": ("FLASH_NO_COPY",)}


def probe_flash_bounds(dev, shapes, time_fn):
    """The bf16 wgmma flash kernel and the f32 flash kernel at each causal
    (BH, S, S, Dh) of ``shapes``, built as the wrapper loads them, without
    their products and without their copies; ``bound_side`` names the
    side that bounds each, or neither.  Called through the C entries: no
    launch is counted.  Reported, not gated."""
    from repro_torch.kernels import _build
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    out = {}
    for dt, entry in ((torch.bfloat16, "flash_attention_bh_wgmma"),
                      (torch.float32, "flash_attention_bh_f32")):
        for BH, S, _, Dh, causal in shapes:
            q, k, v = (torch.randn((BH, S, Dh), generator=gen, device=dev)
                       .to(dt) for _ in range(3))
            o = torch.empty_like(q)
            st = (S * Dh, 0, Dh)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    BH, 1, 1, S, S, Dh, *st, *st, *st, *st, int(causal),
                    _build.DTYPE_CODES[dt], dev.index, _build.stream_of(q))

            def call_of(defines, args=args, entry=entry):
                fn = getattr(_build.library("flash_attention", defines), entry)

                def call(_):
                    _build.check(fn(*args), entry)
                return call
            row = out[f"{entry} {(BH, S, S, Dh)}"] = bound_side(
                time_fn, call_of(()),
                {label: call_of(d) for label, d in FLASH_PROBES.items()})
            print(f"{entry} {(BH, S, S, Dh)}: {row['ms']:.4f} / "
                  f"{row['ms_again']:.4f} ms; without products "
                  f"{row['no_products_ms']:.4f}, without copies "
                  f"{row['no_copy_ms']:.4f}: bound by {row['bound_side']}",
                  flush=True)
            del q, k, v, o
    return out


def queued_tiled(time_fn, call, untiled, what, b_ms) -> dict:
    """A tiled build's C entry timed queued twice, beside ``untiled``, the
    ``queued_pair`` of its untiled build's C entry and the ``bmm``, and
    the first tiled reading over the first untiled one."""
    row = {"queued_ms": time_fn(call, None, repeats=FLASH_REPEATS,
                                mode="queued")}
    row["queued_ms_again"] = time_fn(call, None, repeats=FLASH_REPEATS,
                                     mode="queued")
    row.update({"untiled_queued_ms": untiled["queued_ms"],
                "untiled_queued_ms_again": untiled["queued_ms_again"],
                "library_queued_ms": untiled["library_queued_ms"],
                "library_queued_ms_again": untiled["library_queued_ms_again"]})
    row["tiled_over_untiled"] = row["queued_ms"] / row["untiled_queued_ms"]
    print(f"  {what}: {row['queued_ms']:.4f} / {row['queued_ms_again']:.4f} "
          f"ms, untiled {row['untiled_queued_ms']:.4f} / "
          f"{row['untiled_queued_ms_again']:.4f} "
          f"({row['tiled_over_untiled']:.4f}x), torch.bmm "
          f"{row['library_queued_ms']:.4f} / "
          f"{row['library_queued_ms_again']:.4f} (queued through the C "
          f"entries); bound {b_ms:.4f}", flush=True)
    return row


def check_tiled_kernels(dev, B, m, n, S_list, modes, timed, results, time_fn):
    """The tiled SBGEMV (S = 1) and SBGEMM (S > 1) kernels, f64, f32 and
    bf16 carriers, in every mode of ``modes``, on each map of TILE_MAPS:
    bit for bit against the untiled kernel on planes quantized up front,
    and against the plain version at the carrier's tolerance.  Timed:
    tiled and untiled kernel (the untiled one on the same, unquantized
    planes: the same bytes), the plain version on the first map; at bf16,
    where one ``torch.bmm`` computes the same function, also that call
    (median of events), and on the card the tiled and the untiled C
    entries and the ``bmm``, each queued twice, with the tiled build's
    queued time over the untiled build's."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    A64 = [torch.randn((B, m, n), generator=gen, device=dev,
                       dtype=torch.float64) for _ in range(2)]
    for dt in DTYPES:
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
                bf16_card = timed and dt == torch.bfloat16 and dev.type == "cuda"
                if bf16_card:      # the C entries' operands and sizes
                    Y = [torch.empty(shape[:1] + (ylen,) + shape[2:],
                                     device=dev, dtype=dt) for _ in range(2)]
                    sizes = ((B, m, n) + ((S,) if S > 1 else ())
                             + ((int(mode == "H"),) if mode != "N" else ()))

                    def c_entry(entry, levels=None):
                        return entry_call(kind, entry, (Ar, Ai, Xr, Xi, *Y),
                                          sizes, dt, dt, levels=levels)
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
                        lib = (_library(Ar, Ai, Xr, Xi, mode)
                               if dt == torch.bfloat16 else None)
                        lib_ms = time_fn(lib, None) if lib else None
                        if bf16_card:
                            uq = queued_pair(time_fn, c_entry(kname), lib)
                    nbytes = 2 * dt.itemsize * (B * m * n + B * xlen * S
                                                + B * ylen * S)
                    b_ms, b_by = bound_ms(nbytes, 8 * B * m * n * S, name(dt))
                    key = (f"{name(dt)} {tname}" if S == 1
                           else f"{name(dt)} S={S} {tname}")
                    row = results[kname + "_tiled"][key] = {
                        "shape": [B, m, n, S], "mode": mode, "map": tname,
                        "max_abs_err": err,
                        "ms": time_fn(lambda _: tiled(Ar, Ai, Xr, Xi, levels,
                                                      **kw), None),
                        "untiled_ms": u_ms, "plain_ms": p_ms,
                        "library_ms": lib_ms, "bytes": nbytes,
                        "flops": 8 * B * m * n * S, "bound_ms": b_ms,
                        "bound_by": b_by}
                    if bf16_card:
                        row.update(queued_tiled(
                            time_fn, c_entry(kname + "_tiled", levels), uq,
                            what, b_ms))
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
    """The tiled Gram kernel, f64, f32 and bf16 carriers, each map of
    TILE_MAPS: bit for bit against the untiled Gram kernel on planes
    quantized up front (at bf16 the data space at P <= 128 is the wgmma
    Gram's, the rest the general bf16 Gram's), and against the plain
    version (quantize, then the plain Gram, taken 128 bins at a time so
    the plain products fit beside the kernel's output) at the carrier's
    tolerance.  Timed as ``check_tiled_kernels``: at bf16 also one
    ``torch.bmm`` of the stacked planes, and on the card the tiled and the
    untiled C entries and the ``bmm``, each queued twice."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    A64 = [torch.randn((B, m, n), generator=gen, device=dev,
                       dtype=torch.float64) for _ in range(2)]
    for dt in DTYPES:
        Ar, Ai = (a.to(dt) for a in A64)
        for space in spaces:
            data = space == "data"
            P, K = (m, n) if data else (n, m)
            bf16_card = timed and dt == torch.bfloat16 and dev.type == "cuda"
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
                if bf16_card and u_ms is None:   # the C entries' outputs
                    G = [torch.empty((B, P, P), device=dev, dtype=dt)
                         for _ in range(2)]

                    def c_entry(entry, levels=None):
                        return entry_call("sbgemm", entry, (Ar, Ai, *G),
                                          (B, m, n, int(data)), dt, dt,
                                          levels=levels)
                if u_ms is None:
                    u_ms = time_fn(lambda _: sk.sbgemm_gram_complex(
                        Ar, Ai, data=data), None)
                    p_ms = time_fn(lambda _: sk.sbgemm_gram_tiled_plain(
                        Ar, Ai, levels, data, dt), None)
                    lib = (_library_gram(Ar, Ai, data)
                           if dt == torch.bfloat16 else None)
                    lib_ms = time_fn(lib, None) if lib else None
                    if bf16_card:
                        uq = queued_pair(time_fn, c_entry(
                            sk.gram_kernel_for(dt, data, P)), lib)
                nbytes = 2 * dt.itemsize * (B * m * n + B * P * P)
                flops = 4 * B * P * (P + 1) * K
                b_ms, b_by = bound_ms(nbytes, flops, name(dt))
                row = results["sbgemm_gram_tiled"][
                    f"{name(dt)} {space} {tname}"] = {
                    "shape": [B, m, n], "space": space, "map": tname,
                    "max_abs_err": err,
                    "ms": time_fn(lambda _: sk.sbgemm_gram_tiled(
                        Ar, Ai, levels, data=data), None),
                    "untiled_ms": u_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                    "bytes": nbytes, "flops": flops, "bound_ms": b_ms,
                    "bound_by": b_by}
                if bf16_card:
                    row.update(queued_tiled(
                        time_fn, c_entry("sbgemm_gram_tiled", levels), uq,
                        what, b_ms))
                free(dev)
        del Ar, Ai


def check_block_dispatch_on_card(dev):
    """Automatic dispatch on the card takes the SBGEMM and Gram kernels at
    every shape: short-wide and tall blocks, one column and more than a
    pass of 32, every mode, space and dtype."""
    from repro_torch.kernels import _build, ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    # the last flag: bf16 data space goes to the wgmma Gram (P = m <= 128)
    for B, m, n, S, wgmma in ((3, 3, 77, 5, True), (2, 300, 50, 33, False),
                              (2, 4, 9, 1, True)):
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
                kname = ("sbgemm_gram_complex_wgmma" if wgmma and space ==
                         "data" and dt == torch.bfloat16
                         else "sbgemm_gram_complex")
                before = _build.launch_counts[kname]
                ops.sbgemm_gram(*A, space=space)
                if _build.launch_counts[kname] != before + 1:
                    fail(f"ops.sbgemm_gram {space} {name(dt)} at {(B, m, n)}"
                         f" did not launch {kname}")
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
        for c in ("ddddd", "dssdd", "hhhhh", "shhss"):
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
        for c in ("ddddd", "dssdd", "hhhhh", "shhss"):
            op_p = plain_path(ops[c])
            for Sx, Mx, Dx in ((S, M, D), (S_WIDE, Mw, Dw)):
                t = {"matmat_ms": time_fn(op_p.matmat, Mx),
                     "rmatmat_ms": time_fn(op_p.rmatmat, Dx)}
                plain[f"{c} S={Sx}"] = t
                print(f"{c} plain path: matmat S={Sx} {t['matmat_ms']:.3f} "
                      f"ms, rmatmat {t['rmatmat_ms']:.3f} ms", flush=True)
        block["times_plain_path"] = plain
        # the kernel path's time over the plain path's (reported, not gated)
        ratios = {}
        for c in ("ddddd", "dssdd", "hhhhh", "shhss"):
            for Sx, kt in ((S, times[c]), (S_WIDE, wide[c])):
                pt = plain[f"{c} S={Sx}"]
                ratios[f"{c} S={Sx}"] = {
                    op: kt[f"{op}_ms"] / pt[f"{op}_ms"]
                    for op in ("matmat", "rmatmat")}
        block["ratio_to_plain_path"] = ratios
        for c in ("ddddd", "hhhhh", "shhss"):
            r = ratios[f"{c} S={S_WIDE}"]
            print(f"{c} S={S_WIDE}: matmat {r['matmat']:.3f}x, rmatmat "
                  f"{r['rmatmat']:.3f}x the plain path", flush=True)
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
        out["setup_ratio_to_plain_path"] = (out["setup_ms"]
                                            / out["setup_plain_path_ms"])
        print(f"  G_hat setup {out['setup_ms']:.3f} ms (plain path "
              f"{out['setup_plain_path_ms']:.3f}: "
              f"{out['setup_ratio_to_plain_path']:.3f}x), action "
              f"{out['apply_ms']:.3f} ms", flush=True)

    # hhhhh: G_hat from bf16 F_hat through the wgmma Gram (P = N_d <= 128);
    # dssdd: from f32 F_hat through the staged f32 Gram
    from repro_torch.core.precision import PrecisionConfig
    for cfg, level, kernel in (("hhhhh", "h", "sbgemm_gram_complex_wgmma"),
                               ("dssdd", "s", "sbgemm_gram_complex")):
        op_c = op_d.with_precision(PrecisionConfig.from_string(cfg))
        _build.reset_launch_counts()
        circ_c = GramOperator.from_matvec(op_c, space="data",
                                          mode="circulant")
        sync(dev)
        counts_c = dict(_build.launch_counts)
        check_launches(counts_c, {kernel: 1})
        check_launches(counts_c, {k: 0 for k in ("sbgemm_gram_complex",
                                                 "sbgemm_gram_complex_wgmma")
                                  if k != kernel})
        if not (torch.equal(circ_c.G_hat_re, circ_c.G_hat_re.mT)
                and torch.equal(circ_c.G_hat_im, -circ_c.G_hat_im.mT)):
            fail(f"{cfg} circulant G_hat is not exactly Hermitian")
        ref_c = GramOperator.from_matvec(op_c.with_backend("torch-ref"),
                                         space="data", mode="circulant")
        e_c = max(rel(circ_c.G_hat_re, ref_c.G_hat_re),
                  rel(circ_c.G_hat_im, ref_c.G_hat_im))
        row = out[cfg] = {"G_hat_vs_ref": e_c, "launches": counts_c}
        print(f"circulant G_hat {cfg}: vs torch-ref {e_c:.3e} (<= "
              f"{TOL[level]:g})", flush=True)
        if not e_c <= TOL[level]:
            fail(f"{cfg} circulant G_hat vs torch-ref {e_c:.3e} > "
                 f"{TOL[level]:g}")
        del circ_c, ref_c
        if timed:
            row["setup_ms"] = time_fn(
                lambda _: GramOperator.from_matvec(op_c, space="data",
                                                   mode="circulant"), None)
            row["setup_plain_path_ms"] = time_fn(
                lambda _: GramOperator.from_matvec(plain_path(op_c),
                                                   space="data",
                                                   mode="circulant"), None)
            row["setup_ratio_to_plain_path"] = (row["setup_ms"]
                                                / row["setup_plain_path_ms"])
            print(f"  {cfg} G_hat setup {row['setup_ms']:.3f} ms (plain path "
                  f"{row['setup_plain_path_ms']:.3f}: "
                  f"{row['setup_ratio_to_plain_path']:.3f}x)", flush=True)
        del op_c


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
    # the example's kernels: not the tiled, real or flash ones, nor the
    # wgmma Gram (its planes are f64 and f32)
    check_launched(counts, [k for k in REPLACES
                            if not k.endswith("_tiled") and "_real" not in k
                            and not k.startswith("flash_attention")
                            and k != "sbgemm_gram_complex_wgmma"])


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
                       harness=TimingHarness(repeats=REPEATS, warmup=3),
                       lint=True, **kw)
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


# ---------------------------------------------------------------------------
# 6. The real-A products
# ---------------------------------------------------------------------------

def _real_names(mode: str, S: int):
    """The untiled kernel a real product of ``S`` columns runs (S = 1:
    the SBGEMV) and its tiled SBGEMM build."""
    d = "n" if mode == "N" else "th"
    return (f"sbgemv_{d}_real" if S == 1 else f"sbgemm_{d}_real",
            f"sbgemm_{d}_real_tiled")


def check_real_kernels(dev, B, m, n, S_list, timed, results, time_fn):
    """The six real kernels, f64, f32 and bf16 planes: each against its
    plain version at its level's tolerance; each tiled build (S = 1 as one
    column of the SBGEMM) bit for bit against the untiled SBGEMM on planes
    quantized up front, on each map of TILE_MAPS, and against its plain
    version.  Timed: kernel, plain version and one ``torch.bmm`` on the
    same planes (the transposed view for T); the N SBGEMV and both real
    SBGEMMs also through their C entries beside the ``bmm``, both queued;
    the tiled builds beside the untiled SBGEMM on the same, unquantized
    planes (f64 and f32 carriers; no single PyTorch call quantizes per
    cell, so no library time)."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    A64 = torch.randn((B, m, n), generator=gen, device=dev, dtype=torch.float64)
    for dt in DTYPES:
        A = A64.to(dt)
        for S in S_list:
            for mode in "NT":
                xlen, ylen = (n, m) if mode == "N" else (m, n)
                X = torch.randn((B, xlen) if S == 1 else (B, xlen, S),
                                generator=gen, device=dev,
                                dtype=torch.float64).to(dt)
                Xc = X[..., None] if S == 1 else X        # the SBGEMM's X
                kname, tname_k = _real_names(mode, S)
                kern, plain = getattr(sk, kname), getattr(sk, kname + "_plain")
                gemm = getattr(sk, tname_k.removesuffix("_tiled"))
                tiled = getattr(sk, tname_k)
                tplain = getattr(sk, tname_k + "_plain")
                what = f"{kname} mode {mode} {name(dt)} at {(B, m, n, S)}"
                err = check_planes(what, [kern(A, X)], [plain(A, X, dt)], dt)
                print(f"{what}: max abs err vs plain {err:.3e}", flush=True)
                t_errs = {}
                for tname, levels in TILE_MAPS.items():
                    got = tiled(A, Xc, levels)
                    want = gemm(kref.quantize_tile_cells(levels, A), Xc)
                    twhat = (f"{tname_k} mode {mode} {name(dt)} map {tname} "
                             f"at {(B, m, n, S)}")
                    if not same_bits([got], [want]):
                        fail(f"{twhat}: differs from the untiled kernel on "
                             f"planes quantized up front")
                    del want
                    t_errs[tname] = check_planes(
                        twhat, [got], [tplain(A, Xc, levels, dt)], dt)
                    del got
                print(f"{tname_k} mode {mode} {name(dt)} at {(B, m, n, S)}: "
                      f"bitwise equal to {tname_k.removesuffix('_tiled')} on "
                      f"quantized planes for maps {list(TILE_MAPS)}; max abs "
                      f"err vs plain {max(t_errs.values()):.3e}", flush=True)
                if not timed:
                    continue
                nbytes = dt.itemsize * (B * m * n + B * xlen * S
                                        + B * ylen * S)
                flops = 2 * B * m * n * S
                b_ms, b_by = bound_ms(nbytes, flops, name(dt))
                Am = A if mode == "N" else A.mT
                lib = lambda _: torch.bmm(Am, Xc)
                row = results[kname][name(dt) if S == 1
                                     else f"{name(dt)} S={S}"] = {
                    "shape": [B, m, n, S], "mode": mode, "max_abs_err": err,
                    "ms": time_fn(lambda _: kern(A, X), None),
                    "plain_ms": time_fn(lambda _: plain(A, X, dt), None),
                    "library_ms": time_fn(lib, None),
                    "bytes": nbytes, "flops": flops, "bound_ms": b_ms,
                    "bound_by": b_by}
                if kname != "sbgemv_th_real":
                    # through the C entry, queued, beside the queued bmm
                    y = torch.empty((B, ylen) if S == 1 else (B, ylen, S),
                                    device=dev, dtype=dt)
                    source, sizes = (("sbgemv", (B, m, n)) if S == 1
                                     else ("sbgemm_real", (B, m, n, S)))
                    call = (entry_call(source, kname, (A, X, y), sizes, dt,
                                       dt)
                            if dev.type == "cuda" else lambda _: kern(A, X))
                    row.update(queued_pair(time_fn, call, lib))
                    print(f"{kname} {name(dt)} at {(B, m, n, S)}: "
                          f"{row['queued_ms']:.4f} / "
                          f"{row['queued_ms_again']:.4f} ms queued, one "
                          f"PyTorch call {row['library_queued_ms']:.4f} / "
                          f"{row['library_queued_ms_again']:.4f}; bound "
                          f"{b_ms:.4f}", flush=True)
                    del y
                if dt == torch.bfloat16:
                    continue
                u_ms = time_fn(lambda _: gemm(A, Xc), None)
                for tname, levels in TILE_MAPS.items():
                    results[tname_k][f"{name(dt)} S={S} {tname}"] = {
                        "shape": [B, m, n, S], "mode": mode, "map": tname,
                        "max_abs_err": t_errs[tname],
                        "ms": time_fn(lambda _: tiled(A, Xc, levels), None),
                        "untiled_ms": u_ms,
                        "plain_ms": time_fn(lambda _: tplain(A, Xc, levels,
                                                             dt), None),
                        "library_ms": None,     # no one call quantizes
                        "bytes": nbytes, "flops": flops, "bound_ms": b_ms,
                        "bound_by": b_by}
                del X, Xc
        del A
    del A64


def check_real_gemm_kernels(dev):
    """The real SBGEMMs of bf16 and f32 planes (``zgemm_bf16_kernel``,
    ``zgemm_f32_kernel`` and ``zgemm_th_f32_kernel`` with ``REAL``) at
    ragged shapes across their layouts' edges, modes N and T, each call
    one launch of its kernel.  bf16 N: m around the 16-row warp tiles and
    the 112-row item, n odd (element copies), n % 8 != 0, n shorter than
    one 256-wide k-chunk (192 at S > 16) and past two.  bf16 T: k = m from
    1 past one 112-wide k-chunk, n around the 112 rows of the warps' first
    row tiles and the 224-row item.  f32 N: m around the 40-row warp bands,
    the 3-row tile of a band of at most 24 rows and the 100-row item, n
    shorter than one 64-wide k-chunk (32 at S > 16), odd, n % 4 != 0 and
    the paper's 5000.  f32 T: k = m past one 20- or 16-wide k-chunk, n
    around the 64-row warp bands and the 256-row item.  S across the
    8/16/32 passes and past 32.  bf16: the bf16, f32 and f64 outputs within
    the h tolerance of the plain version; f32: ``_check_f32_outputs``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    S_list = (1, 8, 9, 16, 17, 32, 33, 40)
    shapes = {
        (torch.bfloat16, "N"): ((1, 15, 16, 17, 100, 112, 113, 129),
                                (40, 130, 133, 264, 520)),
        (torch.bfloat16, "T"): ((1, 7, 16, 100, 112, 113, 129),
                                (40, 111, 112, 113, 127, 128, 129, 223, 224,
                                 225, 257)),
        (torch.float32, "N"): ((1, 15, 24, 25, 39, 40, 41, 64, 65, 80, 99,
                                100, 101, 129), (40, 65, 130, 133, 5000)),
        (torch.float32, "T"): ((1, 7, 16, 17, 20, 21, 100, 129),
                               (40, 63, 64, 65, 129, 133, 255, 256, 257)),
    }
    counted = {}
    for (dt, mode), (ms, ns) in shapes.items():
        kname = "sbgemm_n_real" if mode == "N" else "sbgemm_th_real"
        kern, plain = getattr(sk, kname), getattr(sk, kname + "_plain")
        for m in ms:
            for n in ns:
                A = torch.randn((2, m, n), generator=gen, device=dev,
                                dtype=torch.float64).to(dt)
                for S in S_list:
                    X = torch.randn((2, n if mode == "N" else m, S),
                                    generator=gen, device=dev,
                                    dtype=torch.float64).to(dt)
                    what = f"{kname} {name(dt)} at {(2, m, n, S)}"
                    before = _build.launch_counts[kname]
                    if dt == torch.float32:
                        calls = _check_f32_outputs(
                            what, lambda od: [kern(A, X, out_dtype=od)],
                            lambda od: [plain(A, X, od)])
                    else:
                        calls = 0
                        for od in (dt, torch.float32, torch.float64):
                            check_planes(f"{what} -> {name(od)}",
                                         [kern(A, X, out_dtype=od)],
                                         [plain(A, X, od)], dt)
                            calls += 1
                    if (dev.type == "cuda" and _build.launch_counts[kname]
                            != before + calls):
                        fail(f"{what}: {calls} calls did not launch {kname} "
                             f"{calls} times")
                    key = f"{kname} {name(dt)}"
                    counted[key] = counted.get(key, 0) + calls
    sync(dev)
    print(f"real SBGEMM kernels at ragged shapes: {counted} calls, each "
          f"within {TOL['h']:g} (bf16) / {TOL['s']:g} (f32) of its plain "
          f"version (f32's bf16 / f64 outputs: its f32 output cast, bit for "
          f"bit)", flush=True)


def check_real_dispatch_on_card(dev):
    """``ops.sbgemv_real`` / ``ops.sbgemm_real`` on the card launch their
    kernel at a short-wide and a tall shape, every mode and dtype, and with
    ``tile_map=`` the tiled build (``sbgemv_real`` as its one column);
    each output matches the plain path.  Returns the phase's launches,
    the counters set to 0 just before."""
    from repro_torch.backend import DispatchTable
    from repro_torch.kernels import _build, ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    plain = DispatchTable(force="torch")
    _build.reset_launch_counts()
    for B, m, n, S in ((3, 3, 77, 5), (2, 300, 50, 33)):
        for dt in DTYPES:
            A = torch.randn((B, m, n), generator=gen, device=dev).to(dt)
            for mode in "NT":
                xlen = n if mode == "N" else m
                x = torch.randn((B, xlen), generator=gen, device=dev).to(dt)
                X = torch.randn((B, xlen, S), generator=gen, device=dev).to(dt)
                for fn, arg, S_, tile_map in (
                        (ops.sbgemv_real, x, 1, None),
                        (ops.sbgemm_real, X, S, None),
                        (ops.sbgemv_real, x, 1, TILE_MAPS["3x3"]),
                        (ops.sbgemm_real, X, S, TILE_MAPS["2x2"])):
                    kname = _real_names(mode, S_)[tile_map is not None]
                    what = (f"ops.{fn.__name__} mode {mode} {name(dt)} at "
                            f"{(B, m, n, S_)}{' tiled' if tile_map else ''}")
                    before = _build.launch_counts[kname]
                    got = fn(A, arg, mode, tile_map=tile_map)
                    if _build.launch_counts[kname] != before + 1:
                        fail(f"{what} did not launch {kname}")
                    check_planes(what, [got], [fn(A, arg, mode,
                                                  tile_map=tile_map,
                                                  dispatch=plain)], dt)
    sync(dev)
    counts = dict(_build.launch_counts)
    print(f"ops.sbgemv_real / ops.sbgemm_real on the card launched their "
          f"kernels (tiled with tile_map=) at (3, 3, 77) and (2, 300, 50) "
          f"for every mode and dtype: {counts}", flush=True)
    return counts


def drive_fig1(dev, report):
    """The twin of the paper's Fig. 1 sweep at batch 100: each case's one
    checked call launches exactly its kernel once (``run_case`` counts the
    launches of that call alone, not its warm-up and timed calls), within
    its level's tolerance of its plain version.  Returns the phase's
    launches: the sum over those checked calls."""
    from repro_torch.examples import fig1_sbgemv as fig1
    rows = fig1.run(dev)
    sync(dev)
    counts = {}
    for r in rows:
        case = f"fig1 {r['dtype']} {r['m']}:{r['n']}"
        kname = "sbgemv_th_real" if r["dtype"][0] == "r" else \
            "sbgemv_th_complex"
        if r["launches"] != {kname: 1}:
            fail(f"{case}: its checked call launched {r['launches']}, "
                 f"expected {{{kname!r}: 1}}")
        counts[kname] = counts.get(kname, 0) + 1
        tol = TOL["d" if r["dtype"].endswith("64") else "s"]
        if not r["rel_err"] <= tol:
            fail(f"{case}: kernel vs plain rel {r['rel_err']:.3e} > {tol:g}")
    report["fig1"] = {"rows": rows, "launches": counts}
    print(f"fig1 sweep: each case's checked call launched its kernel once; "
          f"launches {counts}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# 7. Slice 5: the flash-attention kernel and the LM serving path
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen1p5_0p5b"
SERVE_NEW = 32                    # new tokens a request
FLASH_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
# max |logit difference| / max |logit|, flash path against chunked
LOGIT_TOL = {"default": 1e-1, "full_f32": 1e-4}
# the head at the default policy keeps its f32 sums: against the f64 product
# of the same bf16 operands, f32 summation error over d_model terms
HEAD_TOL = 1e-5
# (BH, Sq, Skv, Dh, causal): ragged lengths, Dh 12/16/64/128, cross lengths
FLASH_RAGGED = ((3, 77, 77, 64, True), (2, 40, 100, 16, False),
                (3, 50, 50, 12, True), (2, 130, 130, 128, True))
FLASH_LONG = 2048                 # a long prefill, (64, 2048, 2048, 64)


def serve_plan(full: bool):
    """The serve phase's config and traffic: qwen1.5-0.5b at full width
    with ``attn_impl="flash"``, 8 greedy requests made from SEED, four with
    prompts of 449-512 tokens and four of 897-1024, so the 128-token
    buckets give two batches of 4; max_seq 2048, SERVE_NEW new tokens each.
    ``full=False`` (the CPU rehearsal): the smoke config, prompts of 9-16
    and 17-32 tokens in buckets of 16, max_seq 64, 4 new tokens."""
    import numpy as np
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.runtime import Request
    cfg = (get_config if full else get_smoke_config)(SERVE_ARCH)
    cfg = cfg.replace(attn_impl="flash")
    (lo, hi), bucket, max_seq, new = (
        (((449, 512), (897, 1024)), 128, 2048, SERVE_NEW) if full else
        (((9, 16), (17, 32)), 16, 64, 4))
    rng = np.random.default_rng(SEED)
    lens = [int(n) for n in (*rng.integers(lo[0], lo[1] + 1, 4),
                             *rng.integers(hi[0], hi[1] + 1, 4))]
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(n),
                                               dtype=np.int32),
                    max_new_tokens=new) for i, n in enumerate(lens)]
    batch_lens = [max(lens[:4]), max(lens[4:])]
    return cfg, reqs, bucket, max_seq, batch_lens


def check_flash_kernel(dev, shapes, timed_keys, results, time_fn):
    """The flash kernels against their plain version on the card, bf16 and
    f32 at each (BH, Sq, Skv, Dh, causal) of ``shapes``: the dtype and
    shape, and the largest absolute difference within FLASH_TOL (the
    reference's test tolerances).  The shapes named in ``timed_keys`` are
    timed: the kernel the wrapper picks, its plain version and one
    ``scaled_dot_product_attention`` on (1, BH, S, Dh) views of the same
    tensors, beside the bound (each of q, k, v, o moved once; 4 Dh flops a
    key-query pair).  The kernel is timed through its C entry (``ms``, and
    again last as ``ms_again``: the run's spread) and through the wrapper
    (``wrapper_ms``, with the wrapper's host time).  Where the wgmma kernel
    takes bf16, the general bf16 kernel (the one for other head dims and
    unaligned rows) is timed through its own C entry beside it on the same
    inputs, into an output of its own checked against the same plain
    output; its row is ``results["flash_attention_bh"]``.  The C entries
    and SDPA are timed queued (FLASH_REPEATS calls, the median), so the
    host's launch time stays out of their device time."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    for shape in shapes:
        BH, Sq, Skv, Dh, causal = shape
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn((BH, s, Dh), generator=gen, device=dev,
                                   dtype=torch.float32).to(dt)
                       for s in (Sq, Skv, Skv))
            got = fa.flash_attention_bh(q, k, v, causal=causal)
            want = fa.flash_attention_bh_plain(q, k, v, causal=causal)
            what = f"flash_attention_bh {name(dt)} at {shape}"
            if got.dtype != dt or tuple(got.shape) != (BH, Sq, Dh):
                fail(f"{what}: gives {tuple(got.shape)} {got.dtype}")
            err = max_abs(got, want)
            if not err <= FLASH_TOL[dt]:
                fail(f"{what}: max abs err vs plain {err:.3e} > "
                     f"{FLASH_TOL[dt]:g}")
            print(f"{what}: max abs err vs plain {err:.3e}", flush=True)
            del got
            key = timed_keys.get(shape)
            if key is None:
                continue
            nbytes = dt.itemsize * (2 * BH * Sq * Dh + 2 * BH * Skv * Dh)
            flops = 4 * BH * Dh * fa.attn_pairs(Sq, Skv, causal)
            b_ms, b_by = bound_ms(nbytes, flops, name(dt))
            q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            entry = fa.kernel_for(dt, Dh, True)     # contiguous, aligned
            # the kernel through its C entry (a launch, no Python around
            # it: the wrapper's host time, which hides the device's at
            # small shapes, is wrapper_ms)
            wrapper = lambda _: fa.flash_attention_bh(  # noqa: E731
                q, k, v, causal=causal)
            o = torch.empty_like(q)
            st = (Sq * Dh, 0, Dh)

            def entry_call(kname, o=o):
                if dev.type != "cuda":
                    return wrapper                  # the CPU rehearsal
                fn = getattr(_build.library("flash_attention"), kname)
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), BH, 1, 1, Sq, Skv, Dh, *st, Skv * Dh, 0,
                        Dh, Skv * Dh, 0, Dh, *st, int(causal),
                        _build.DTYPE_CODES[dt], dev.index, _build.stream_of(q))

                def call(_):
                    _build.check(fn(*args), kname)
                return call

            def queued(fn):
                return time_fn(fn, None, repeats=FLASH_REPEATS, mode="queued")
            launch = entry_call(entry)
            # the general kernel writes its own output, checked below
            o_general = (torch.empty_like(q) if dev.type == "cuda"
                         and entry == "flash_attention_bh_wgmma" else None)
            general = (entry_call("flash_attention_bh", o=o_general)
                       if o_general is not None else None)
            row = results[entry][f"{name(dt)} {key}"] = {
                "shape": list(shape), "max_abs_err": err,
                "ms": queued(launch)}
            if general is not None:
                row["general_ms"] = queued(general)
            row["library_ms"] = queued(lambda _: sdpa(q4, k4, v4,
                                                      is_causal=causal))
            if dev.type == "cuda":
                row["library_kernels"] = profiled_kernels(
                    lambda: sdpa(q4, k4, v4, is_causal=causal))
            if general is not None:
                row["general_ms_again"] = queued(general)
            row["ms_again"] = queued(launch)
            row.update({
                "wrapper_ms": time_fn(wrapper, None),
                "plain_ms": time_fn(lambda _: fa.flash_attention_bh_plain(
                    q, k, v, causal=causal), None),
                "bytes": nbytes, "flops": flops, "bound_ms": b_ms,
                "bound_by": b_by})
            if general is not None:
                # the general kernel's own row: its output here against the
                # same plain output, its queued readings, the same bound
                sync(dev)
                g_err = max_abs(o_general, want)
                if not g_err <= FLASH_TOL[dt]:
                    fail(f"flash_attention_bh (general) {name(dt)} at {shape}:"
                         f" max abs err vs plain {g_err:.3e} > "
                         f"{FLASH_TOL[dt]:g}")
                results["flash_attention_bh"][f"{name(dt)} {key}"] = {
                    **{k_: row[k_] for k_ in ("shape", "library_ms",
                                              "plain_ms", "bytes", "flops",
                                              "bound_ms", "bound_by")},
                    "max_abs_err": g_err, "ms": row["general_ms"],
                    "ms_again": row["general_ms_again"]}
            print(f"SDPA {name(dt)} {key} ran {row.get('library_kernels')}",
                  flush=True)
            print(f"{entry} {name(dt)} {key}: {row['ms']:.4f} / "
                  f"{row['ms_again']:.4f} ms" + (
                      f", general kernel {row['general_ms']:.4f} / "
                      f"{row['general_ms_again']:.4f}" if general else "")
                  + f", SDPA {row['library_ms']:.4f} (queued); bound "
                  f"{b_ms:.4f} ({b_by}); through the wrapper "
                  f"{row['wrapper_ms']:.4f}", flush=True)
            del q4, k4, v4, o, o_general, launch, general
        del q, k, v, want


def profiled_events(fn):
    """(device event names, host event names) of one call of ``fn``,
    from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return (sorted({e.key for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA}),
            sorted({e.key for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU}))


def profiled_kernels(fn) -> list:
    """The names of the CUDA kernels one call of ``fn`` runs, from
    ``torch.profiler`` (empty where it shows no device activity)."""
    return profiled_events(fn)[0]


# The ragged checks of the flash entries other than wgmma: (entry, dtype,
# head dims, row layouts).  Layout None: rows 16-byte aligned (the 16-byte
# copies); an int n: rows of Dh + n elements starting one element in (the
# 4-byte copies).  The bf16 head dims take every instantiation of the
# general kernel (KD = ceil(Dh / 16) 1-8; 12 and 16 are FLASH_RAGGED's).
FLASH_ENTRY_CASES = (
    ("flash_attention_bh_f32", torch.float32, (12, 16, 32, 64, 96, 128),
     (None, 1)),
    ("flash_attention_bh", torch.bfloat16, (32, 48, 80, 96, 112), (None,)),
    ("flash_attention_bh", torch.bfloat16, (64, 128), (8,)),
)


def check_flash_entries(dev):
    """The f32 flash kernel (``flash_attention_bh_f32``) and the general
    bf16 kernel (``flash_attention_bh``) at ragged shapes, each call's
    launch counted as one of its entry: Sq and Skv around the 64-row
    blocks, the 64-key tiles and 128, causal and not, Sq != Skv both ways,
    at the head dims and row layouts of FLASH_ENTRY_CASES; f32 also through
    the 4-D entry with 2 key heads in groups of 1, 2 and 8; within
    FLASH_TOL of the plain version.  On the card, each entry refuses the
    other's dtype."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(SEED + 37)

    def randn(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dt)

    def counted(entry, fn):
        _build.reset_launch_counts()
        out = fn()
        check_launches(dict(_build.launch_counts),
                       {k: int(k == entry) for k in fa.KERNELS})
        return out

    n, worst = {}, {}
    lengths = ((1, 1), (63, 63), (64, 64), (65, 65), (127, 127), (128, 128),
               (129, 129), (200, 77), (77, 200), (64, 130), (130, 64),
               (1, 300), (300, 1))
    for entry, dt, dims, layouts in FLASH_ENTRY_CASES:
        for Dh in dims:
            for Sq, Skv in lengths:
                for causal in (True, False):
                    for pad in layouts:
                        if pad is None:
                            q, k, v = (randn(3, s, Dh, dt=dt)
                                       for s in (Sq, Skv, Skv))
                        else:
                            q, k, v = (randn(3, s, Dh + pad, dt=dt)[
                                ..., 1:Dh + 1] for s in (Sq, Skv, Skv))
                        got = counted(entry, lambda: fa.flash_attention_bh(
                            q, k, v, causal=causal))
                        want = fa.flash_attention_bh_plain(q, k, v,
                                                           causal=causal)
                        err = max_abs(got, want)
                        if got.dtype != dt or not err <= FLASH_TOL[dt]:
                            fail(f"{entry} {name(dt)} at {(3, Sq, Skv, Dh)} "
                                 f"causal={causal} row pad={pad}: "
                                 f"{got.dtype}, max abs err {err:.3e} > "
                                 f"{FLASH_TOL[dt]:g}")
                        worst[entry] = max(worst.get(entry, 0.0), err)
                        n[entry] = n.get(entry, 0) + 1
    dt, entry = torch.float32, "flash_attention_bh_f32"
    for Dh in (64, 96):
        for G in (1, 2, 8):
            B, S, Hkv = 2, 150, 2
            q, k, v = randn(B, S, Hkv * G, Dh), randn(B, S, Hkv, Dh), \
                randn(B, S, Hkv, Dh)
            got = counted(entry, lambda: fa.flash_attention(q, k, v,
                                                            causal=True))
            fold = lambda x: x.transpose(1, 2).reshape(-1, S, Dh)  # noqa: E731
            kr, vr = (x.repeat_interleave(G, dim=2) for x in (k, v))
            want = fa.flash_attention_bh_plain(fold(q), fold(kr), fold(vr),
                                               causal=True)
            err = max_abs(fold(got), want)
            if not err <= FLASH_TOL[dt]:
                fail(f"{entry} GQA group {G} Dh {Dh}: max abs err {err:.3e} "
                     f"> {FLASH_TOL[dt]:g}")
            worst[entry], n[entry] = max(worst[entry], err), n[entry] + 1
    if dev.type == "cuda":
        lib = _build.library("flash_attention")
        for entry, other in (("flash_attention_bh", torch.float32),
                             ("flash_attention_bh_f32", torch.bfloat16)):
            x = torch.zeros((1, 64, 64), device=dev, dtype=other)
            st = (64 * 64, 0, 64)
            rc = getattr(lib, entry)(*(x.data_ptr() for _ in range(4)), 1, 1,
                                     1, 64, 64, 64, *st, *st, *st, *st, 1,
                                     _build.DTYPE_CODES[other], dev.index,
                                     _build.stream_of(x))
            if rc == 0:
                fail(f"{entry} took {name(other)}: each flash entry takes one "
                     f"dtype")
    sync(dev)
    for entry, dt_ in (("flash_attention_bh_f32", torch.float32),
                       ("flash_attention_bh", torch.bfloat16)):
        print(f"{entry}: {n[entry]} ragged calls within {FLASH_TOL[dt_]:g} of "
              f"the plain version (worst {worst[entry]:.3e}), each one launch "
              f"of its entry", flush=True)


class _PhaseClock:
    """Times each call of a wrapped engine phase (CUDA events on the card,
    so no call waits on the device; the host clock on the CPU) and counts
    the flash launches inside it."""

    def __init__(self, dev, fn):
        self.dev, self.fn, self.marks, self.launches = dev, fn, [], 0

    def _mark(self):
        if self.dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def __call__(self, *args):
        from repro_torch.kernels import _build
        from repro_torch.kernels.flash_attention import KERNELS
        n0 = sum(_build.launch_counts[k] for k in KERNELS)
        t0 = self._mark()
        out = self.fn(*args)
        self.marks.append((t0, self._mark()))
        self.launches += sum(_build.launch_counts[k] for k in KERNELS) - n0
        return out

    def ms(self) -> list:
        sync(self.dev)
        return [a.elapsed_time(b) if self.dev.type == "cuda" else 1e3 * (b - a)
                for a, b in self.marks]


def _serve_once(dev, cfg, model, reqs, bucket, max_seq):
    """One ``ServeEngine.serve`` call, its prefill and decode calls timed
    and their flash launches counted apart; wall time on the host clock
    from a synchronised start to a synchronised end."""
    from repro_torch.runtime import ServeEngine
    eng = ServeEngine(cfg, model, max_seq=max_seq)
    pre = eng._prefill = _PhaseClock(dev, eng._prefill)
    dec = eng._decode = _PhaseClock(dev, eng._decode)
    sync(dev)
    t0 = time.perf_counter()
    results = eng.serve(reqs, bucket=bucket)
    sync(dev)
    wall = time.perf_counter() - t0
    tokens = sum(len(r.tokens) for r in results)
    return results, {
        "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "prefill_ms": pre.ms(), "decode_ms_per_step": sorted(dec.ms()),
        "decode_steps": len(dec.marks), "prefill_launches": pre.launches,
        "decode_launches": dec.launches}


def _left_padded(reqs):
    import numpy as np
    S = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), S), np.int64)
    for i, r in enumerate(reqs):
        toks[i, S - len(r.prompt):] = r.prompt
    return toks


def _batch_of(reqs, dev) -> dict:
    """The requests as one model batch, as ``ServeEngine.run_batch`` builds
    it: left-padded tokens and each extras key stacked."""
    import numpy as np
    batch = {"tokens": torch.as_tensor(_left_padded(reqs), device=dev)}
    for k in sorted(reqs[0].extras or ()):
        batch[k] = torch.as_tensor(np.stack([r.extras[k] for r in reqs]),
                                   device=dev)
    return batch


def _logit_gap(a, b, rows=None) -> float:
    """max |a - b| / max |b| (f32 logits), over the (B, S) rows of ``rows``
    where given."""
    if rows is not None:
        a, b = a[rows], b[rows]
    return (a - b).abs().max().item() / b.abs().max().item()


class _Router:
    """While entered, stands in for ``moe.route``: records each call's own
    ``Routing``.  With ``force`` set to another run's calls, each call
    takes the next one's experts, slots and keep (its gates renormalised
    from its own probabilities), so both runs route alike; its own
    decisions are still what it records."""

    def __init__(self):
        self.calls, self.force = [], None

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._route = moe, moe.route

        def route(xg, router_w, **kw):
            r = self._route(xg, router_w, **kw)
            self.calls.append(r)
            if self.force is None:
                return r
            f = self.force.pop(0)
            gate = r.probs.gather(-1, f.idx)
            return f._replace(probs=r.probs, gate=gate / gate.sum(
                -1, keepdim=True).clamp_min(1e-9))
        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def _route_agreement(a, b, B, n):
    """Rows (B, n) whose token chose and kept the same experts in every
    call of ``a`` and ``b`` (one a layer), and the count of (token, layer)
    pairs that differ."""
    ok, differ = None, 0
    for ra, rb in zip(a, b, strict=True):
        E = ra.probs.shape[-1]
        masks = [(oh.any(-2), (oh & r.keep[..., None]).any(-2))
                 for r in (ra, rb)
                 for oh in [torch.nn.functional.one_hot(r.idx, E).bool()]]
        (c1, k1), (c2, k2) = masks
        same = ((c1 == c2).all(-1) & (k1 == k2).all(-1)).reshape(-1)
        differ += int((~same).sum())
        ok = same if ok is None else ok & same
    return ok.reshape(B, n), differ


def compare_paths(dev, cfg, model, reqs, max_seq, steps, tol, what):
    """Prefill logits of the flash path against the chunked path on one
    batch (the requests' extras included), then ``steps`` teacher-forced
    decode steps feeding both the flash path's greedy tokens: each step's
    logits within ``tol`` of max |logit|.  With experts, a router near tie
    can route a token differently under the two paths, and a different
    expert moves the token's hidden state far more than the attention
    paths' rounding does; so the chunked path runs on the flash path's
    routing (``_Router.force``), and the (token, layer) pairs where its own
    choice differs are counted, with the rows whose choices agree in
    every layer.  An unforced chunked prefill counts the same for routing
    left free.  Returns the gaps, the share of greedy tokens that agree
    and (with experts) the routing counts."""
    from repro_torch.models import api
    cfg_c = cfg.replace(attn_impl="chunked")
    batch = _batch_of(reqs, dev)
    B, S = batch["tokens"].shape
    gaps, agree, n = [], 0, 0
    differ, held, free_run = [], [], None
    router = _Router().__enter__() if cfg.n_experts else None

    def chunked(call):
        """The chunked path's call, forced onto the flash call's routing
        just taken; counts the pairs where its own routing differs."""
        if router is None:
            return call()
        flash = router.take()
        router.force = list(flash)
        out = call()
        router.force = None
        ok, d = _route_agreement(flash, router.take(), *out[0].shape[:2])
        differ.append(d)
        held.append(int(ok.sum()))
        return out
    try:
        with torch.inference_mode():
            if router is not None:                 # routing left free
                api.prefill_step(cfg, model, batch, max_seq)
                flash = router.take()
                api.prefill_step(cfg_c, model, batch, max_seq)
                ok, d = _route_agreement(flash, router.take(), B, S)
                free_run = {"routed_differently": d, "rows_agreeing":
                            int(ok.sum()), "rows": B * S}
            lf, sf = api.prefill_step(cfg, model, batch, max_seq)
            lc, sc = chunked(lambda: api.prefill_step(cfg_c, model, batch,
                                                      max_seq))
            gaps.append(_logit_gap(lf, lc))
            lf, lc = lf[:, -1:], lc[:, -1:]
            for i in range(steps):
                tf, tc = lf[:, -1].argmax(-1), lc[:, -1].argmax(-1)
                agree += int((tf == tc).sum())
                n += tf.numel()
                if i == steps - 1:
                    break
                lf, sf = api.decode_step(cfg, model, sf, tf[:, None])
                lc, sc = chunked(lambda: api.decode_step(cfg_c, model, sc,
                                                         tf[:, None]))
                gaps.append(_logit_gap(lf, lc))
    finally:
        if router is not None:
            router.__exit__()
    del sf, sc, lf, lc
    worst = max(gaps)
    routed = "" if router is None else (
        f"; chunked on the flash routing, its own choice differs in (token, "
        f"layer) pairs: prefill {differ[0]} of {B * S * cfg.n_layers}, "
        f"decode {sum(differ[1:])} of {B * (steps - 1) * cfg.n_layers}; rows "
        f"whose choice agrees in every layer: prefill {held[0]} of {B * S}, "
        f"decode {sum(held[1:])} of {B * (steps - 1)}; routing left free, a "
        f"prefill: {free_run['routed_differently']} pairs differ, "
        f"{free_run['rows_agreeing']} rows agree")
    print(f"{what}: flash vs chunked logits, prefill {gaps[0]:.3e}, worst "
          f"of {steps - 1} teacher-forced decode steps "
          f"{max(gaps[1:], default=0.0):.3e} (<= {tol:g}); greedy tokens "
          f"agree {agree}/{n}{routed}", flush=True)
    if not worst <= tol:
        fail(f"{what}: flash vs chunked logits differ by {worst:.3e} of max "
             f"|logit| > {tol:g}")
    out = {"prefill_gap": gaps[0], "decode_gaps": gaps[1:],
           "greedy_agree": agree / n}
    if router is not None:
        out.update({"routed_differently": differ, "rows_agreeing": held,
                    "rows": [B * S] + [B] * (steps - 1),
                    "pairs": [B * S * cfg.n_layers]
                    + [B * cfg.n_layers] * (steps - 1),
                    "free_prefill": free_run})
    return out


def profile_decode(dev, cfg, model, reqs, max_seq, steps: int = 4):
    """Device time and kernel launches a decode step, from
    ``torch.profiler`` over ``steps`` steps after a prefill of ``reqs``
    (the kernels' own device time, summed); None where the profiler shows
    no device time (the CPU)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api
    with torch.inference_mode():
        logits, state = api.prefill_step(cfg, model, _batch_of(reqs, dev),
                                         max_seq)
        tok = logits[:, -1].argmax(-1)[:, None]
        del logits
        sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                logits, state = api.decode_step(cfg, model, state, tok)
                tok = logits[:, -1].argmax(-1)[:, None]
            sync(dev)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    if not busy_us:
        return None
    return {"device_ms_per_step": busy_us / 1e3 / steps,
            "kernels_per_step": sum(e.count for e in kern) / steps}


def check_head(dev, cfg, model, gen) -> float:
    """The LM head at the default policy keeps the f32 sums of its bf16
    product, as the reference does: ``unembed`` on a random bf16 hidden
    state against the f64 product of the same bf16 operands, within
    HEAD_TOL of max |logit|."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer
    h = torch.randn((4, 8, cfg.d_model), generator=gen,
                    device=dev).to(cfg.policy.c())
    with torch.inference_mode():
        got = transformer.unembed(cfg, model, h)
        x = L.rms_norm(h, model.ln_f, cfg.norm_eps)
        head = model.embed.T if cfg.tie_embeddings else model.lm_head
        want = x.double() @ head.to(x.dtype).double()
    err = (got.double() - want).abs().max().item() / want.abs().max().item()
    print(f"LM head, default policy ({cfg.policy.c()} compute, "
          f"{got.dtype} logits): vs the f64 product of the same operands "
          f"{err:.3e} of max |logit| (<= {HEAD_TOL:g})", flush=True)
    if got.dtype != torch.float32 or not err <= HEAD_TOL:
        fail(f"LM head logits {got.dtype} off the f64 product by {err:.3e} "
             f"> {HEAD_TOL:g}")
    return err


def drive_serve(dev, full, time_fn, report):
    """The slice's main path: qwen1.5-0.5b at full width through
    ``ServeEngine.serve`` (``serve_plan``), weights from a seeded generator
    on the device.  A warm-up call first; then the counted call, with the
    counters set to 0 just before it: exactly n_layers flash launches a
    prefill batch, none in decode.  The same traffic on the chunked path
    for its times.  Correctness against the chunked path (the reference's
    plain attention): prefill and teacher-forced decode logits within
    LOGIT_TOL at the default policy and at FULL_F32."""
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.models.policy import FULL_F32
    cfg, reqs, bucket, max_seq, batch_lens = serve_plan(full)
    out = {"config": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "max_seq": max_seq, "bucket": bucket,
           "prompt_lens": [len(r.prompt) for r in reqs],
           "batch_lens": batch_lens}
    report["serve"] = out
    if dev.type == "cuda":
        report["peak_memory_gb_before_serve"] = \
            torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    model = api.init_params(cfg, gen, device=dev)
    out["head_vs_f64"] = check_head(dev, cfg, model, gen)
    t_start = time.perf_counter()
    _serve_once(dev, cfg, model, reqs, bucket, max_seq)        # warm-up
    _build.reset_launch_counts()
    res_f, run_f = _serve_once(dev, cfg, model, reqs, bucket, max_seq)
    counts = dict(_build.launch_counts)
    out["launches"] = counts
    out["flash"] = run_f
    n_batches = len(run_f["prefill_ms"])
    print(f"serve {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}) "
          f"flash: {len(reqs)} requests in {n_batches} batches "
          f"{batch_lens}, {run_f['tokens']} tokens in {run_f['wall_s']:.3f} "
          f"s ({run_f['tokens_per_s']:.1f} tok/s); prefill ms "
          f"{[round(t, 3) for t in run_f['prefill_ms']]}; decode ms/step "
          f"median {run_f['decode_ms_per_step'][len(run_f['decode_ms_per_step']) // 2]:.3f}; "
          f"launches {counts} (prefill {run_f['prefill_launches']}, decode "
          f"{run_f['decode_launches']})", flush=True)
    # bf16 heads of Dh 64 on aligned rows: every launch is the wgmma kernel
    check_launches(counts, {"flash_attention_bh_wgmma":
                            cfg.n_layers * n_batches,
                            "flash_attention_bh": 0,
                            "flash_attention_bh_f32": 0})
    check_launches({"flash": run_f["prefill_launches"]},
                   {"flash": cfg.n_layers * n_batches})
    check_launches({"flash": run_f["decode_launches"]}, {"flash": 0})
    if len(res_f) != len(reqs) or any(
            len(r.tokens) != q.max_new_tokens or r.tokens.min() < 0
            or r.tokens.max() >= cfg.vocab for r, q in zip(res_f, reqs)):
        fail("serve: results of the wrong length or outside the vocabulary")

    # how far the host holds decode back: device time a step (profiler)
    # against the step's time on the device's clock in the counted call
    prof = profile_decode(dev, cfg, model, reqs[:4], max_seq)
    if prof is not None:
        steps = run_f["decode_ms_per_step"]
        prof["idle_share"] = 1 - prof["device_ms_per_step"] / \
            steps[len(steps) // 2]
        print(f"decode step: {prof['kernels_per_step']:.0f} kernels, "
              f"{prof['device_ms_per_step']:.3f} ms of device time; idle "
              f"share {prof['idle_share']:.3f}", flush=True)
    out["decode_profile"] = prof

    cfg_c = cfg.replace(attn_impl="chunked")
    _serve_once(dev, cfg_c, model, reqs, bucket, max_seq)      # warm-up
    res_c, run_c = _serve_once(dev, cfg_c, model, reqs, bucket, max_seq)
    out["chunked"] = run_c
    same = sum(int((a.tokens == b.tokens).sum()) for a, b in zip(res_f, res_c))
    out["served_tokens_agree"] = same / run_f["tokens"]
    print(f"serve chunked: {run_c['tokens_per_s']:.1f} tok/s; prefill ms "
          f"{[round(t, 3) for t in run_c['prefill_ms']]}; decode ms/step "
          f"median {run_c['decode_ms_per_step'][len(run_c['decode_ms_per_step']) // 2]:.3f}; "
          f"served tokens equal to the flash path's: {same}/{run_f['tokens']}",
          flush=True)
    if dev.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        # the kernel's share of prefill: its time at each batch's shape
        # (B x heads folded), once a layer, over the batch's prefill time
        from repro_torch.kernels import flash_attention as fa
        shares = []
        for S, pre_ms in zip(batch_lens, run_f["prefill_ms"]):
            q = torch.randn((4 * cfg.n_heads, S, cfg.head_dim()), device=dev,
                            dtype=torch.bfloat16)
            k_ms = time_fn(lambda _: fa.flash_attention_bh(q, q, q), None)
            shares.append({"S": S, "kernel_ms": k_ms,
                           "share": cfg.n_layers * k_ms / pre_ms})
            del q
        out["kernel_share_of_prefill"] = shares
        print(f"serve peak device memory {out['peak_memory_gb']:.2f} GB; "
              f"kernel share of prefill "
              f"{[round(s['share'], 4) for s in shares]}", flush=True)
        out["flash_prefill_count"] = count_flash_prefill(
            dev, cfg, model, reqs[4:], max_seq)

    # correctness on the longer batch (serve_plan's last four), both policies
    big, steps = reqs[4:], reqs[0].max_new_tokens
    out["check_default"] = compare_paths(dev, cfg, model, big, max_seq, steps,
                                         LOGIT_TOL["default"], "default policy")
    # FULL_F32 runs the f32 flash: the f32 kernel, once a layer
    cfg32 = cfg.replace(policy=FULL_F32)
    _build.reset_launch_counts()
    out["check_full_f32"] = compare_paths(
        dev, cfg32, model, big, max_seq, steps, LOGIT_TOL["full_f32"],
        "FULL_F32")
    out["full_f32_launches"] = dict(_build.launch_counts)
    check_launches(out["full_f32_launches"],
                   {"flash_attention_bh_f32": cfg.n_layers,
                    "flash_attention_bh": 0, "flash_attention_bh_wgmma": 0})
    if dev.type == "cuda":
        out["full_f32_prefill_ms"] = time_full_f32_prefill(
            dev, cfg, model, big, max_seq, time_fn)
    out["seconds"] = time.perf_counter() - t_start
    del model


def count_flash_prefill(dev, cfg, model, reqs, max_seq) -> dict:
    """The work of the serve's second prefill batch (``reqs``, left-padded
    as ``ServeEngine.run_batch`` pads them) on the path the serve phase
    times, the flash kernel's: one untimed ``api.prefill_step`` under
    ``launch.roofline.OpCounter`` (the kernel reports its own FLOPs and
    bytes), the parameters, tokens and outputs counted once."""
    from repro_torch.launch.roofline import OpCounter
    from repro_torch.models import api
    batch = {"tokens": torch.as_tensor(_left_padded(reqs), device=dev)}
    with torch.inference_mode(), OpCounter() as c:
        outs = api.prefill_step(cfg, model, batch, max_seq)
    c.count_io((model, batch), outs)
    del outs
    flash = {k: v for k, v in c.by_op.items() if k.startswith("flash")}
    print(f"flash prefill {list(batch['tokens'].shape)} counted: FLOPs "
          f"{dict(c.flops_by_dtype)}, floor {c.floor_bytes / 1e9:.4f} GB; "
          f"flash {flash}", flush=True)
    if not flash:
        fail("the counted prefill reported no flash kernel")
    return {"tokens": list(batch["tokens"].shape),
            "flops": c.flops, "flops_by_dtype": dict(c.flops_by_dtype),
            "raw_bytes": c.raw_bytes, "floor_bytes": c.floor_bytes,
            "flash": flash}


def time_full_f32_prefill(dev, cfg, model, reqs, max_seq, time_fn) -> dict:
    """The ``FULL_F32`` prefill of ``reqs`` (left-padded into one batch) on
    the flash and on the chunked path, CUDA events, the median of 5, with
    the flash path's kernel launches of one call: the f32 flash kernel's
    share of it is n_layers x its time at that shape."""
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.models.policy import FULL_F32
    cfg32 = cfg.replace(policy=FULL_F32)
    toks = torch.as_tensor(_left_padded(reqs), device=dev)

    def prefill(c):
        def call(_):
            with torch.inference_mode():
                api.prefill_step(c, model, {"tokens": toks}, max_seq)
        return call
    out = {"tokens": list(toks.shape),
           "flash": time_fn(prefill(cfg32), None, repeats=5),
           "chunked": time_fn(prefill(cfg32.replace(attn_impl="chunked")),
                              None, repeats=5)}
    _build.reset_launch_counts()
    prefill(cfg32)(None)
    out["flash_launches"] = {k: v for k, v in _build.launch_counts.items()
                             if v}
    print(f"FULL_F32 prefill of {out['tokens']} tokens: flash "
          f"{out['flash']:.3f} ms ({out['flash_launches']}), chunked "
          f"{out['chunked']:.3f} ms (median of 5)", flush=True)
    return out


# ---------------------------------------------------------------------------
# 8. The solve server at the paper shape
# ---------------------------------------------------------------------------

SOLVE_SIZES = (1, 4, 16, 64)     # fig6's sweep: requests a serve
SOLVE_DAMP = 0.01                # drive_solvers' CGNR damp
SOLVE_REPEATS = 3                # timed serves of each path, after one warm-up
SOLVE_NAIVE_REPEATS = {64: 1}    # 64 solo solves: timed once
SOLVE_X_TOL = 1e-3               # coalesced vs naive x (tests/test_solve_serve.py)


def drive_solve_serve(dev, N_t, N_d, N_m, time_fn, report):
    """``runtime.SolveEngine`` at the paper shape, on drive_solvers'
    operator (f64, ``max_batch = 64``): S consistent requests (D = F
    M_true, M_true from a seeded generator on the card; fig6's tolerance
    decade, CGNR damp SOLVE_DAMP, at most SOLVER_ITERS iterations, within
    which CGNR reaches 1e-10 on this operator) for S in SOLVE_SIZES,
    served coalesced and naive through ``examples.fig6_serve.sweep``
    (requests/s from CUDA events around whole serves).

    Checks: outcomes in uid order; every request converged with relres <
    tol on both paths; per uid the coalesced x within SOLVE_X_TOL of the
    naive x; each coalesced serve one batch of S (naive: batches of 1);
    the timed sweep and a repeat serve build no operator and no applier;
    that repeat serve at S = 64 launches the SBGEMM N once and the T/H
    once more than its iterations (every contraction on a kernel); one
    exact Gram apply at S = 64 under the served config against the plain
    path at the config's lowest level's tolerance; a second engine on the
    same TuningCache file answers from it with the first engine's config
    and solutions."""
    from repro_torch.core import (FFTMatvec, PrecisionConfig,
                                  random_block_column, rel_l2)
    from repro_torch.core.precision import DOUBLE
    from repro_torch.core.timing import TimingHarness
    from repro_torch.examples import fig6_serve
    from repro_torch.examples.mixed_precision_pareto import host_timer
    from repro_torch.kernels import _build
    from repro_torch.runtime import SolveEngine
    from repro_torch.tune import TuningCache

    t_start = time.perf_counter()
    out = {"sizes": list(SOLVE_SIZES), "damp": SOLVE_DAMP,
           "max_iters": SOLVER_ITERS, "tols": list(fig6_serve.TOLS)}
    report["solve_serve"] = out
    if dev.type == "cuda":
        report["peak_memory_gb_before_solve_serve"] = \
            torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    F_col = random_block_column(gen, N_t, N_d, N_m)
    op = FFTMatvec.from_block_column(F_col, precision=DOUBLE, device=dev)
    del F_col
    cache_path = ROOT / "chiprun_out" / "solve_serve_cache.json"
    cache_path.parent.mkdir(exist_ok=True)
    cache_path.unlink(missing_ok=True)
    # CUDA-event timing on the card; the host clock in a CPU rehearsal
    harness = (None if dev.type == "cuda"
               else TimingHarness(timer=host_timer))

    def engine():
        return SolveEngine(op, cache=TuningCache(cache_path),
                           harness=harness, max_batch=max(SOLVE_SIZES))

    t0 = time.perf_counter()
    eng = engine()
    out["engine_setup_s"] = time.perf_counter() - t0
    checks = out["checks"] = {}

    def check(S, reqs, coalesced, naive):
        uids = list(range(S))
        if [o.uid for o in coalesced] != uids or \
                [o.uid for o in naive] != uids:
            fail(f"solve serve S={S}: outcomes not in uid order")
        for path, outs in (("coalesced", coalesced), ("naive", naive)):
            for o, r in zip(outs, reqs):
                if not (o.converged and o.relres < r.tol):
                    fail(f"solve serve S={S} {path}: request {o.uid} relres "
                         f"{o.relres:.3e} (tol {r.tol:g}) after {o.n_iters} "
                         f"of {r.max_iters} iterations")
        e_x = max(rel_l2(a.x, b.x) for a, b in zip(coalesced, naive))
        checks[str(S)] = {
            "x_coalesced_vs_naive_max": e_x,
            "iters_coalesced": [o.n_iters for o in coalesced],
            "iters_naive": [o.n_iters for o in naive],
            "relres_over_tol_max": max(o.relres / r.tol
                                       for o, r in zip(coalesced, reqs))}
        print(f"  S={S}: every request converged on both paths, coalesced "
              f"vs naive x {e_x:.3e} (< {SOLVE_X_TOL:g}), iterations "
              f"{min(checks[str(S)]['iters_coalesced'])}-"
              f"{max(checks[str(S)]['iters_coalesced'])}", flush=True)
        if not e_x < SOLVE_X_TOL:
            fail(f"solve serve S={S}: coalesced vs naive x {e_x:.3e}")

    res = fig6_serve.sweep(eng, op, SOLVE_SIZES, max_iters=SOLVER_ITERS,
                           repeats=SOLVE_REPEATS, time_fn=time_fn,
                           damp=SOLVE_DAMP, naive_repeats=SOLVE_NAIVE_REPEATS,
                           check=check)
    out.update(res)
    served = {row["config"] for row in res["sweep"].values()}
    if len(served) != 1:
        fail(f"solve serve: one bucket served under {sorted(served)}")
    cfg = PrecisionConfig.from_string(served.pop())
    out["config"] = cfg.to_string()
    out["stats"] = dict(eng.stats, coalesced=sorted(set(eng.stats["coalesced"])))
    for S, row in res["sweep"].items():
        if row["coalesced_batches"] != [int(S)] or row["naive_batches"] != [1]:
            fail(f"solve serve S={S}: stats['coalesced'] held "
                 f"{row['coalesced_batches']} coalesced, "
                 f"{row['naive_batches']} naive")
    if eng.stats["cold_tunes"] != 1 or eng.stats["warm_hits"] != 0:
        fail(f"solve serve: {eng.stats['cold_tunes']} cold tunes and "
             f"{eng.stats['warm_hits']} warm hits for one bucket")
    jit = res["jit"]
    if (jit["n_appliers"], jit["n_traces"]) != (2, 1) or any(
            jit[k] for k in ("appliers_grown_during_timed",
                             "traces_during_timed", "traces_on_repeat_serve",
                             "appliers_on_repeat_serve")):
        fail(f"solve serve: operators or appliers built while re-serving "
             f"the bucket: {jit}")
    rep = res["repeat_serve"]
    it = rep["iters_max"]
    check_launched(rep["launches"], ["sbgemm_n_complex", "sbgemm_th_complex"])
    check_launches(rep["launches"], {
        "sbgemm_n_complex": it, "sbgemm_th_complex": it + 1,
        "pad_cast": 2 * it + 1, "unpad_cast": 2 * it + 1,
        "sbgemv_n_complex": 0, "sbgemv_th_complex": 0})
    print(f"solve serve: config {cfg.to_string()} (gemv planes "
          f"{name(cfg.phase_dtype('gemv'))}), jit {jit}; the "
          f"repeat serve at S={rep['S']}: {it} iterations, launches "
          f"{rep['launches']}", flush=True)

    # one exact Gram apply at S = 64 under the served config, kernel path
    # against the plain path
    op_t = op.with_precision(cfg)
    X = torch.randn((N_m, N_t, max(SOLVE_SIZES)), generator=gen, device=dev,
                    dtype=torch.float64).to(op_t.io_dtype)
    _build.reset_launch_counts()
    G = op_t.gram(space="parameter").apply(X)
    sync(dev)
    counts = dict(_build.launch_counts)
    check_launches(counts, {"sbgemm_n_complex": 1, "sbgemm_th_complex": 1})
    G_p = plain_path(op_t).gram(space="parameter").apply(X)
    lvl = cfg.lowest()
    e_g = rel_l2(G, G_p)
    out["gram_S64"] = {"rel_vs_plain": e_g, "tol": TOL[lvl],
                       "launches": counts}
    print(f"solve serve: exact Gram at S={X.shape[-1]} under "
          f"{cfg.to_string()} vs the plain path {e_g:.3e} (<= {TOL[lvl]:g}), "
          f"launches {counts}", flush=True)
    if not (torch.isfinite(G).all() and e_g <= TOL[lvl]):
        fail(f"solve serve: Gram at S={X.shape[-1]} vs plain path {e_g:.3e}")
    del G, G_p
    # where a coalesced iteration's time goes: the Gram apply alone at S =
    # 16 and 64 (median of 5 events), and on the plain path at S = 64
    gram = op_t.gram(space="parameter").apply
    out["gram_ms"] = {str(S): time_fn(gram, X[..., :S].contiguous(),
                                      repeats=5, warmup=1)
                      for S in SOLVE_SIZES[2:]}
    out["gram_S64"]["plain_ms"] = time_fn(
        plain_path(op_t).gram(space="parameter").apply, X, repeats=5,
        warmup=1)
    print(f"solve serve: Gram apply {out['gram_ms']} ms (plain path at "
          f"S={X.shape[-1]} {out['gram_S64']['plain_ms']:.3f})", flush=True)
    del X, op_t, gram

    # a second engine on the same cache file: the warm path
    reqs = fig6_serve.make_requests(op, 4, SOLVER_ITERS, damp=SOLVE_DAMP)
    first = eng.serve(reqs)
    eng2 = engine()
    second = eng2.serve(reqs)
    e_w = max(rel_l2(a.x, b.x) for a, b in zip(first, second))
    out["warm_engine"] = {"stats": eng2.stats, "x_vs_first_max": e_w,
                          "config": second[0].config}
    print(f"solve serve: second engine {eng2.stats['warm_hits']} warm hits, "
          f"{eng2.stats['cold_tunes']} cold tunes, config "
          f"{second[0].config}, x vs the first engine {e_w:.3e}", flush=True)
    if eng2.stats["warm_hits"] != 1 or eng2.stats["cold_tunes"] != 0 or \
            {o.config for o in second} != {cfg.to_string()} or \
            not e_w < 1e-10:
        fail("solve serve: the second engine was not answered by the cache")
    del first, second, eng2, eng, op
    if dev.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["seconds"] = time.perf_counter() - t_start
    for S, row in res["sweep"].items():
        row["ms_per_iter_coalesced"] = 1e3 * row["t_coalesced_s"] / \
            row["iters_max"]
        print(f"  S={S}: coalesced {row['rps_coalesced']:.3f} requests/s "
              f"({row['ms_per_iter_coalesced']:.3f} ms a serve's iteration), "
              f"naive {row['rps_naive']:.3f} ({row['ratio']:.3f}x)",
              flush=True)
    print(f"solve serve phase: {out['seconds']:.1f} s, peak device memory "
          f"{out.get('peak_memory_gb', 0.0):.2f} GB", flush=True)


# ---------------------------------------------------------------------------
# 8b. Slice 19: the operator on a 2-D process grid (torch.distributed)
# ---------------------------------------------------------------------------

# (B, m, n, row chunk of N, column chunk of T/H): ragged views, one column
# chunk starting off the 16-byte vectors, and a paper-shape chunk
STRIDED_SHAPES = ((3, 77, 133, (5, 45), (3, 70)), (2, 9, 264, (1, 8), (8, 136)),
                  (2, 100, 2500, (25, 50), (625, 1250)))
MESH_KINDS = ("psum", "hierarchical", "reduce_scatter", "ring")
MESH_LEVELS = ("ddddd", "sssss", "hhhhh")      # the one-rank NCCL part
GLOO_LEVELS = ("ddddd", "hhhhh")
GLOO_GRIDS = {4: ((2, 2), (1, 4)), 2: ((1, 2), (2, 1))}
GLOO_S = 4                 # the gloo part's block of right-hand sides
MESH_JOIN_S = 300          # seconds a spawn of ranks may take


def check_strided_kernels(dev) -> dict:
    """The four strided C entries (the untiled complex SBGEMV and SBGEMM,
    N and T/H) on views of a larger plane, a chunk of its rows (N) or
    columns (T/H) as the pipelined gemv_psum hands them over, each launch
    bit for bit against the same launch on a contiguous copy, at every
    dtype, S = 1, 8 and 33; each wrapper call one launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import sbgemv as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    n_calls = 0
    for B, m, n, rows, cols in STRIDED_SHAPES:
        for dt in DTYPES:
            A = [torch.randn((B, m, n), generator=gen, device=dev).to(dt)
                 for _ in range(2)]
            for mode in "NTH":
                ax, (lo, hi) = (1, rows) if mode == "N" else (2, cols)
                views = [a.narrow(ax, lo, hi - lo) for a in A]
                copies = [v.contiguous() for v in views]
                xlen = n if mode == "N" else m
                for S in (1, 8, 33):
                    shape = (B, xlen, S) if S > 1 else (B, xlen)
                    X = [torch.randn(shape, generator=gen, device=dev).to(dt)
                         for _ in range(2)]
                    if mode == "N":
                        fn = sk.sbgemm_n_complex if S > 1 \
                            else sk.sbgemv_n_complex
                        kw = {}
                    else:
                        fn = sk.sbgemm_th_complex if S > 1 \
                            else sk.sbgemv_th_complex
                        kw = {"conj": mode == "H"}
                    _build.reset_launch_counts()
                    got = fn(*views, *X, **kw)
                    want = fn(*copies, *X, **kw)
                    sync(dev)
                    counts = dict(_build.launch_counts)
                    if dev.type == "cuda" and counts != {fn.__name__: 2}:
                        fail(f"strided {fn.__name__}: launches {counts}")
                    if not same_bits(got, want):
                        fail(f"strided {fn.__name__} {name(dt)} mode {mode} "
                             f"S={S} at {(B, m, n)}: the view's launch "
                             f"differs from the contiguous copy's")
                    n_calls += 1
            del A
    print(f"strided entries: {n_calls} launches on views bit for bit "
          f"against contiguous copies", flush=True)
    return {"calls": n_calls}


def _rehearsal_tol(dev, level: str, overlap) -> float:
    """How far a chunked schedule may stray from the unchunked one: not at
    all on the card, where each row's sum is the kernel's whatever the
    chunk; in a CPU rehearsal the plain contraction may block a chunk's
    sums by its row count, so the level's tolerance there."""
    if dev.type == "cuda" or overlap in (None, 1):
        return 0.0
    return TOL[min(level, key="hsd".index)]


def _mesh_data(dev, N_t, N_d, N_m, seed, S=GLOO_S):
    """The block column and inputs (blocks of S columns) every rank and
    the single-device reference share: drawn on the card from one seed."""
    from repro_torch.core import random_block_column
    gen = torch.Generator(device=dev).manual_seed(seed)
    F_col = random_block_column(gen, N_t, N_d, N_m)
    x = {k: torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)
         for k, shape in (("m", (N_m, N_t)), ("d", (N_d, N_t)),
                          ("M", (N_m, N_t, S)), ("D", (N_d, N_t, S)))}
    return F_col, x


# entry point: (input, its space, the output's space)
MESH_CALLS = {"matvec": ("m", "m", "d"), "rmatvec": ("d", "d", "m"),
              "matmat": ("M", "m", "d"), "rmatmat": ("D", "d", "m"),
              "gram_p": ("m", "m", "m"), "gram_d": ("d", "d", "d")}


def _mesh_call(op, call: str, v):
    if call == "gram_p":
        return op.gram("parameter").apply(v)
    if call == "gram_d":
        return op.gram("data").apply(v)
    return getattr(op, call)(v)


def _mesh_rank(rank, world, store, tmp, N_t, N_d, N_m, dev_type):
    """One rank of the gloo part (spawned): every grid of GLOO_GRIDS[world]
    at GLOO_LEVELS, every collective kind and overlap K in (1, 4) on
    matvec/rmatvec, the blocks and the exact Gram at both K, assembled on
    every rank and held by rank 0 against the single-device outputs the
    parent saved; with 2 ranks also calibrate_overlap and the weak-scaled
    grid.  Each rank writes its launch, collective and host-staging
    counts."""
    import datetime

    import torch.distributed as dist

    from repro_torch.backend import H100, calibrate_overlap
    from repro_torch.core import (FFTMatvec, PrecisionConfig, record_stages,
                                  time_callable)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_test_mesh
    tmp = pathlib.Path(tmp)
    dev = torch.device(dev_type, 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_JOIN_S))
    refs = torch.load(tmp / "refs.pt", weights_only=False)
    out = {"checks": {}, "times": {}}
    _build.reset_launch_counts()

    def gathered(op, call, x):
        key, space_in, space_out = MESH_CALLS[call]
        y = _mesh_call(op, call, op.local_block(x[key], space_in))
        return op.gather_block(y, space_out)

    def check(what, got, want, tol):
        e = rel(got, want.to(got.device))
        if rank == 0:
            out["checks"][what] = e
        if not (torch.isfinite(got).all() and e <= tol):
            raise AssertionError(f"{what}: rel {e:.3e} > {tol:g}")

    try:
        with record_stages() as census:
            F_col, x = _mesh_data(dev, N_t, N_d, N_m, SEED + 29)
            for grid in GLOO_GRIDS[world]:
                mesh = make_test_mesh(grid, ("row", "col"), device_type=dev.type)
                g = f"{grid[0]}x{grid[1]}"
                for level in GLOO_LEVELS:
                    tol = TOL[min(level, key="hsd".index)]
                    # gloo's sum order follows the buffer's size, so a
                    # chunked flat reduction regroups each row's sum: f64
                    # within 1e-15 of the serial one, a bf16 carrier within
                    # its level (the ring's fixed order keeps its bits)
                    chunk_tol = 1e-15 if level == "ddddd" else tol
                    # every rank runs its Phase 0 at once on the shared
                    # card: each starts from an empty cache
                    free(dev)
                    base = FFTMatvec.from_block_column(
                        F_col, precision=PrecisionConfig.from_string(level),
                        device=dev, mesh=mesh)
                    want = refs[level]
                    for kind in MESH_KINDS:
                        ser = {}
                        for K in (1, 4):
                            op = base.with_comm(None, kind).with_overlap(K)
                            for call in ("matvec", "rmatvec"):
                                y = gathered(op, call, x)
                                check(f"{g} {level} {kind} K={K} {call}", y,
                                      want[call], tol)
                                if K == 1:
                                    ser[call] = y
                                elif kind == "ring" and not torch.equal(
                                        bits(y), bits(ser[call])) and \
                                        rel(y, ser[call]) > _rehearsal_tol(
                                            dev, level, K):
                                    raise AssertionError(
                                        f"{g} {level} ring {call}: K=4 not "
                                        f"bit for bit the serial ring")
                                elif kind != "ring" and rel(y, ser[call]) > \
                                        max(chunk_tol, _rehearsal_tol(
                                            dev, level, K)):
                                    raise AssertionError(
                                        f"{g} {level} {kind} {call}: K=4 vs "
                                        f"serial {rel(y, ser[call]):.3e}")
                    for K in (1, 4):
                        op = base.with_overlap(K)
                        for call in ("matmat", "rmatmat", "gram_p", "gram_d"):
                            check(f"{g} {level} K={K} {call}",
                                  gathered(op, call, x), want[call], tol)
                    if level == "ddddd":
                        # comm_level="h" on a d carrier: back at f64
                        y = base.with_comm("h").matvec(
                            base.local_block(x["m"], "m"))
                        if y.dtype != torch.float64:
                            raise AssertionError(f"{g}: comm h gave {y.dtype}")
                        check(f"{g} comm=h on a d carrier, matvec",
                              base.gather_block(y, "d"), want["matvec"], 2e-2)
                        m_loc = base.local_block(x["m"], "m")
                        for K in (1, 4):
                            if dev.type == "cuda":
                                out["times"][f"{g} ddddd matvec K={K}"] = \
                                    time_callable(base.with_overlap(K).matvec,
                                                  m_loc, 5, warmup=2)
                    del base
            del F_col, x
            if world == 2:
                # calibrate_overlap's real measurement, in a cache of its own
                # that no other phase reads
                from repro_torch.tune import TuningCache
                if dev.type == "cuda":
                    eff = calibrate_overlap(H100, cache=TuningCache(
                        tmp / f"overlap{rank}.json"))
                    out["overlap_efficiency"] = eff
                # the weak-scaled grid: N_m a rank, fftmatvec_grid's default.
                # Both ranks build at once, and a rank's Phase 0 here peaks
                # at about four times the 8 GB it keeps
                # (weak_build_peak_gb).  So the global column waits on the
                # host, in f64 (Phase 0's precision: the card's draw
                # exactly), and the card holds only each rank's shard; and
                # each rank starts from an empty cache, as the blocks
                # either rank cached from the grids above would leave the
                # other too little of the card
                mesh = make_test_mesh((1, world), ("row", "col"),
                                      device_type=dev.type)
                free(dev)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                F_col, x = _mesh_data(dev, N_t, N_d, N_m * world, SEED + 39)
                F_col = F_col.cpu().double()
                free(dev)
                op = FFTMatvec.from_block_column(F_col, device=dev, mesh=mesh)
                del F_col
                if dev.type == "cuda":
                    out["weak_build_peak_gb"] = \
                        torch.cuda.max_memory_allocated(dev) / 1e9
                    out["weak_device_free_gb"] = \
                        torch.cuda.mem_get_info(dev)[0] / 1e9
                free(dev)
                out["weak_fhat_gb_a_rank"] = 2 * op.F_hat_re.numel() * \
                    op.F_hat_re.element_size() / 1e9
                for call in ("matvec", "rmatvec"):
                    check(f"weak 1x{world} ddddd {call}",
                          gathered(op, call, x), refs["weak"][call], 1e-12)
                if dev.type == "cuda":
                    for call, key, space in (("matvec", "m", "m"),
                                             ("rmatvec", "d", "d")):
                        out["times"][f"weak 1x{world} ddddd {call}"] = \
                            time_callable(getattr(op, call),
                                          op.local_block(x[key], space), 5,
                                          warmup=2)
                del op, x
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["launches"] = dict(_build.launch_counts)
        out["collectives"] = {k: v for k, v in census.items()
                              if k.startswith("collective:")}
        (tmp / f"rank{world}_{rank}.json").write_text(json.dumps(out))
    except BaseException:
        # the parent prints every rank's, not only the first one to exit
        import traceback
        (tmp / f"rank{world}_{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _mesh_nccl(dev, N_t, N_d, N_m, time_fn, out) -> None:
    """One NCCL rank in this process (gloo in a CPU rehearsal): a (1, 1)
    DeviceMesh at the paper shape, every level of MESH_LEVELS, collective
    kind and overlap (None, 4) through matvec, rmatvec, matmat/rmatmat
    (S = 8) and the exact Gram in both spaces, each bit for bit the
    single-device operator's; times beside the single-device operator."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import FFTMatvec, PrecisionConfig, record_stages
    from repro_torch.kernels import _build
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh(dev.type, (1, 1),
                                    mesh_dim_names=("row", "col"))
            F_col, x = _mesh_data(dev, N_t, N_d, N_m, SEED + 19, S=S_BLOCK)
            rows = out["nccl"] = {}
            for level in MESH_LEVELS:
                cfg = PrecisionConfig.from_string(level)
                single = FFTMatvec.from_block_column(F_col, precision=cfg,
                                                     device=dev)
                meshed = FFTMatvec.from_block_column(F_col, precision=cfg,
                                                     device=dev, mesh=mesh)
                want = {c: _mesh_call(single, c, x[MESH_CALLS[c][0]])
                        for c in MESH_CALLS}
                for kind in MESH_KINDS:
                    for ov in (None, 4):
                        op = meshed.with_comm(None, kind).with_overlap(ov)
                        _build.reset_launch_counts()
                        with record_stages() as c:
                            got = {k: _mesh_call(op, k, x[MESH_CALLS[k][0]])
                                   for k in MESH_CALLS}
                        sync(dev)
                        launches = dict(_build.launch_counts)
                        for k in MESH_CALLS:
                            if torch.equal(bits(got[k]), bits(want[k])) or (
                                    rel(got[k], want[k])
                                    <= _rehearsal_tol(dev, level, ov)):
                                continue
                            fail(f"NCCL 1 rank {level} {kind} overlap {ov} "
                                 f"{k}: not bit for bit the single-device "
                                 f"operator (rel {rel(got[k], want[k]):.3e})")
                        if dev.type == "cuda":
                            check_launched(launches, [
                                "sbgemv_n_complex", "sbgemv_th_complex",
                                "sbgemm_n_complex", "sbgemm_th_complex",
                                "pad_cast", "unpad_cast"])
                        if c.get("collective:host_staged"):
                            fail("a collective was staged through host "
                                 f"memory under {backend}")
                        rows[f"{level} {kind} {ov}"] = {
                            "launches": launches,
                            "collectives": {k: v for k, v in c.items()
                                            if k.startswith("collective:")}}
                del single, meshed, want
                free(dev)
            print(f"mesh NCCL, 1 rank: {len(rows)} (level, kind, overlap) "
                  f"cases, every entry point bit for bit the single-device "
                  f"operator", flush=True)
            op = FFTMatvec.from_block_column(F_col, device=dev, mesh=mesh)
            single = FFTMatvec.from_block_column(F_col, device=dev)
            del F_col
            if dev.type == "cuda":
                times = out["nccl_ms"] = {}
                for what, fn, arg in (
                        ("single matvec", single.matvec, x["m"]),
                        ("mesh psum matvec", op.matvec, x["m"]),
                        ("mesh psum matvec K=4", op.with_overlap(4).matvec,
                         x["m"]),
                        ("single rmatvec", single.rmatvec, x["d"]),
                        ("mesh psum rmatvec", op.rmatvec, x["d"]),
                        ("mesh ring rmatvec K=4", op.with_comm(
                            None, "ring").with_overlap(4).rmatvec, x["d"])):
                    times[what] = time_fn(fn, arg)
                print(f"mesh times (NCCL, 1 rank; {out['smi']}; ddddd, ms): "
                      + json.dumps({k: round(v, 4) for k, v in times.items()}),
                      flush=True)
            del op, single, x
        finally:
            dist.destroy_process_group()
    free(dev)


def _mesh_profile(rank, store, tmp, N_t, N_d, N_m):
    """The profiler's view of three meshed calls on one NCCL rank, in a
    fresh process (spawned): each call once, then each profiled; the
    device and host event names go to ``profile.json``.  In the script's
    own process, after the phases before this one, the profiler lost the
    records of some kernels of a call (the SBGEMV among them)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import FFTMatvec
    tmp = pathlib.Path(tmp)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("row", "col"))
        F_col, x = _mesh_data(dev, N_t, N_d, N_m, SEED + 19, S=S_BLOCK)
        op = FFTMatvec.from_block_column(F_col, device=dev, mesh=mesh)
        del F_col
        calls = {"psum matvec": lambda: op.matvec(x["m"]),
                 "reduce_scatter matmat K=4":
                     lambda: op.with_comm(None, "reduce_scatter")
                     .with_overlap(4).matmat(x["M"]),
                 "psum rmatvec K=4": lambda: op.with_overlap(4).rmatvec(x["d"])}
        for fn in calls.values():
            fn()
        sync(dev)
        seen = {what: profiled_events(fn) for what, fn in calls.items()}
        (tmp / "profile.json").write_text(json.dumps(seen))
    except BaseException:
        import traceback
        (tmp / f"profile_{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _spawn_ranks(fn, args, nprocs: int, tmp: pathlib.Path, tag: str) -> None:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes (CUDA is live in
    this one, so never forked), joined within MESH_JOIN_S; a rank that
    fails fails the run, after every rank's ``<tag>_<rank>.err`` is
    printed, and none is left running."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + MESH_JOIN_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                fail(f"{nprocs} spawned {tag} ranks did not finish in "
                     f"{MESH_JOIN_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException):
        for err in sorted(tmp.glob(f"{tag}_*.err")):
            print(f"{err.name}:\n{err.read_text()}", flush=True)
        raise
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def check_mesh_profile(tmp: pathlib.Path, out: dict) -> None:
    """Gate :func:`_mesh_profile`'s records: every profiled call shows its
    NCCL calls and an SBGEMV/SBGEMM kernel.  On one rank NCCL short-cuts a
    sum (ncclLaunchOneRank): in place it runs nothing on the device, out
    of place a copy, so what is on record is the host side of each NCCL
    call and, as its device work, that copy."""
    seen = json.loads((tmp / "profile.json").read_text())
    for what, (device, host) in seen.items():
        calls = sorted(k for k in host if "nccl" in k.lower())
        nccl_dev = [k for k in device
                    if "nccl" in k.lower() or "memcpy" in k.lower()]
        gemv = sorted({re.search(r"(\w+_kernel)", k).group(1)
                       for k in device if "sbgemv" in k or "zgemm" in k})
        out.setdefault("profiler", {})[what] = {
            "nccl_calls": calls, "nccl_device_work": nccl_dev,
            "gemv_kernels": gemv, "device_events": device}
        print(f"mesh NCCL, 1 rank, profiler {what} (a fresh process): NCCL "
              f"calls {calls}, their device work {nccl_dev or 'none'}, "
              f"SBGEMV/SBGEMM kernels {gemv}; {len(device)} device event "
              f"names", flush=True)
        if not gemv:
            print(f"  the profiler's device events: "
                  f"{[k[:60] for k in device]}", flush=True)
            fail(f"the profiler saw no SBGEMV/SBGEMM kernel in the meshed "
                 f"{what}")
        if not calls:
            fail(f"the profiler saw no NCCL call in the meshed {what}")


def drive_mesh(dev, N_t, N_d, N_m, time_fn, report) -> None:
    """The operator on a 2-D process grid, checked on the one card (NCCL
    refuses two ranks on one GPU, so this checks correctness, not fabric
    speed):

    1. one NCCL rank in this process (:func:`_mesh_nccl`), and the
       profiler's view of three meshed calls on one NCCL rank in a fresh
       process (:func:`_mesh_profile`, :func:`check_mesh_profile`);
    2. 4 ranks ((2, 2) and (1, 4)), then 2 ranks ((1, 2), (2, 1)),
       sharing the card over gloo, spawned, each running the hand-written
       kernels on its shard (:func:`_mesh_rank`), the assembled outputs
       held against the single-device operator at the level's tolerance;
       calibrate_overlap in the 2-rank group; the weak-scaled (1, 2) grid
       at N_m a rank.

    Times are printed labelled "NCCL, 1 rank" or "gloo on one card", with
    the card's name and power limit: they are not fabric numbers."""
    import tempfile

    from repro_torch.core import DOUBLE, FFTMatvec, PrecisionConfig
    t_start = time.perf_counter()
    out = report["mesh"] = {}
    out["smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip() \
        if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out["strided"] = check_strided_kernels(dev)
    free(dev)
    _mesh_nccl(dev, N_t, N_d, N_m, time_fn, out)

    # the single-device outputs the gloo ranks are held against
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        refs = {}
        F_col, x = _mesh_data(dev, N_t, N_d, N_m, SEED + 29)
        for level in GLOO_LEVELS:
            op = FFTMatvec.from_block_column(
                F_col, precision=PrecisionConfig.from_string(level),
                device=dev)
            refs[level] = {c: _mesh_call(op, c, x[MESH_CALLS[c][0]]).cpu()
                           for c in MESH_CALLS}
            del op
        del F_col, x
        F_col, x = _mesh_data(dev, N_t, N_d, 2 * N_m, SEED + 39)
        op = FFTMatvec.from_block_column(F_col, precision=DOUBLE, device=dev)
        del F_col
        refs["weak"] = {c: _mesh_call(op, c, x[MESH_CALLS[c][0]]).cpu()
                        for c in ("matvec", "rmatvec")}
        del op, x
        torch.save(refs, tmp / "refs.pt")
        del refs
        free(dev)
        if dev.type == "cuda":
            _spawn_ranks(_mesh_profile, (str(tmp / "store_profile"),
                                         str(tmp), N_t, N_d, N_m),
                         1, tmp, "profile")
            check_mesh_profile(tmp, out)
        ranks = out["gloo"] = {}
        if dev.type == "cuda":
            out["parent_allocated_gb"] = torch.cuda.memory_allocated(dev) / 1e9
            out["card_free_gb"] = torch.cuda.mem_get_info(dev)[0] / 1e9
            print(f"mesh: this process holds "
                  f"{out['parent_allocated_gb']:.2f} GB of the card while "
                  f"the gloo ranks run; {out['card_free_gb']:.2f} GB free",
                  flush=True)
        for world in (4, 2):
            t0 = time.perf_counter()
            _spawn_ranks(_mesh_rank, (world, str(tmp / f"store{world}"),
                                      str(tmp), N_t, N_d, N_m, dev.type),
                         world, tmp, f"rank{world}")
            per = [json.loads((tmp / f"rank{world}_{r}.json").read_text())
                   for r in range(world)]
            ranks[world] = {"seconds": time.perf_counter() - t0,
                            "ranks": per}
            for r, info in enumerate(per):
                weak = (f"; weak-scaled build peak "
                        f"{info['weak_build_peak_gb']:.2f} GB, card free "
                        f"after it {info['weak_device_free_gb']:.2f} GB"
                        if "weak_build_peak_gb" in info else "")
                print(f"mesh gloo {world} ranks, rank {r}: launches "
                      f"{info['launches']}, collectives "
                      f"{info['collectives']}{weak}", flush=True)
                staged = info["collectives"].get("collective:host_staged", 0)
                if dev.type == "cuda" and not staged:
                    fail(f"gloo rank {r} staged no collective through host "
                         f"memory")
                if dev.type == "cuda":
                    check_launched(info["launches"], [
                        "sbgemv_n_complex", "sbgemv_th_complex",
                        "sbgemm_n_complex", "sbgemm_th_complex",
                        "pad_cast", "unpad_cast"])
            checks = per[0]["checks"]
            worst = {lvl: max(e for k, e in checks.items() if lvl in k)
                     for lvl in (*GLOO_LEVELS, "weak")
                     if any(lvl in k for k in checks)}
            print(f"mesh gloo {world} ranks: {len(checks)} assembled outputs "
                  f"within the level's tolerance of the single-device "
                  f"operator, worst rel {worst}; "
                  f"{ranks[world]['seconds']:.1f} s", flush=True)
            if per[0]["times"]:
                print(f"mesh times (gloo on one card, {world} ranks sharing "
                      f"it; {out['smi']}; ms): "
                      + json.dumps({k: round(v, 4) for k, v in
                                    per[0]["times"].items()}), flush=True)
        eff = ranks[2]["ranks"][0].get("overlap_efficiency")
        if eff is not None:
            print(f"mesh calibrate_overlap efficiency {eff:.4f} (gloo staged "
                  f"through host memory on one card, 2 ranks; not an NVLink "
                  f"figure)", flush=True)
    if dev.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["seconds"] = time.perf_counter() - t_start
    print(f"mesh phase: {out['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# 9. Slice 16: the MoE, SSM, hybrid and encoder-decoder families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("granite_moe_3b", "falcon_mamba_7b", "zamba2_1p2b",
                "whisper_base")
FAMILY_NEW = 8                    # new tokens a request
# moe_ffn against its dense oracle, of max |y|: the h tolerance (bf16
# operands; the oracle rounds where the port does, summed in another order)
MOE_TOL = 2e-2
# an f32 recurrence (the chunked scans, the FFT convolution) against its
# f64 loop or direct convolution on the same inputs, of max |y|
SSM_TOL = 1e-4
LAYER_T = 256                     # positions of the one-layer SSM checks


def family_plan(arch: str, full: bool):
    """A family phase's config and traffic: full width, ``attn_impl=
    "flash"`` where the family has attention, 4 greedy requests made from
    SEED with FAMILY_NEW new tokens: prompts of 449-512 tokens (one bucket
    of 128) and max_seq 1024; whisper prompts of 17-32 tokens with stub
    frames (enc_positions, d_model), max_seq 64.  ``full=False`` (the CPU
    rehearsal): the smoke config, prompts of 9-16 tokens in a bucket of
    16, max_seq 64, 4 new tokens."""
    import numpy as np
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.runtime import Request
    cfg = (get_config if full else get_smoke_config)(arch)
    if cfg.n_heads:
        cfg = cfg.replace(attn_impl="flash")
    encdec = cfg.family == "encdec"
    (lo, hi), bucket, max_seq, new = (
        (((17, 32) if encdec else (449, 512)), 128, 64 if encdec else 1024,
         FAMILY_NEW) if full else ((9, 16), 16, 64, 4))
    rng = np.random.default_rng(SEED)
    reqs = []
    for i, n in enumerate(rng.integers(lo, hi + 1, 4)):
        prompt = rng.integers(0, cfg.vocab, int(n), dtype=np.int32)
        extras = ({"frames": rng.standard_normal(
            (cfg.enc_positions, cfg.d_model), dtype=np.float32)}
            if encdec else None)
        reqs.append(Request(uid=i, prompt=prompt, max_new_tokens=new,
                            extras=extras))
    return cfg, reqs, bucket, max_seq


def flash_calls_per_prefill(cfg) -> int:
    """The attention calls one prefill batch makes through
    ``layers.attention`` with more than one query, each a flash call: the
    transformer's one a layer; the hybrid's one a shared-block invocation
    (``hybrid.group_slices``); the encoder-decoder's one an encoder layer
    and two a decoder layer (causal self-attention, and cross-attention
    over the encoder output: ``encdec._mha`` without a cache); the SSM LM
    none.  A decode step reads its caches through chunked attention."""
    from repro_torch.models import hybrid
    if cfg.family == "hybrid":
        return hybrid.group_slices(cfg)[1]
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.n_layers
    return 0 if cfg.family == "ssm" else cfg.n_layers


def _rel(a, b) -> float:
    return (a - b).abs().max().item() / b.abs().max().item()


def check_moe_layer(dev, cfg, lp, gen, shapes) -> dict:
    """``moe_ffn`` at one full-width layer, for each (B, S) of ``shapes``,
    against a dense oracle: every expert on every token (f32 sums of the
    compute-dtype operands, h and each expert's output rounded to it as
    the port rounds them), weighted by gate * keep, with keep recomputed
    apart from the port's cumsum by ranking each expert's (token, slot)
    pairs in token-major order (a stable sort).  The dropped pair counts
    must be equal and y within MOE_TOL of max |y|."""
    from repro_torch.models import moe
    F_ = torch.nn.functional
    out = {}
    E, k, D = cfg.n_experts, cfg.top_k, cfg.d_model
    for B, S in shapes:
        x = torch.randn((B, S, D), generator=gen, device=dev).to(
            cfg.policy.c())
        with torch.inference_mode():
            y, _ = moe.moe_ffn(x, lp.router, lp.wg, lp.wu, lp.wd, top_k=k,
                               capacity_factor=cfg.capacity_factor,
                               group_size=cfg.moe_group)
            T = B * S
            gs = moe.pick_group(T, cfg.moe_group)
            r = moe.route(x.reshape(T // gs, gs, D), lp.router, top_k=k,
                          capacity_factor=cfg.capacity_factor)
            flat = r.idx.reshape(T // gs, gs * k)
            srt, order = torch.sort(flat, dim=1, stable=True)
            first = torch.searchsorted(srt, srt)
            rank = torch.empty_like(flat).scatter_(
                1, order, torch.arange(gs * k, device=dev).expand_as(flat)
                - first)
            keep = (rank < r.C).reshape(r.idx.shape)
            drops, port_drops = int((~keep).sum()), int((~r.keep).sum())
            w = torch.zeros((T, E), device=dev).scatter_add_(
                1, r.idx.reshape(T, k), (r.gate * keep).reshape(T, k).float())
            xf, want = x.reshape(T, D).float(), torch.zeros((T, D),
                                                             device=dev)
            c = x.dtype
            for e in range(E):
                wg, wu, wd = (p[e].to(c).float() for p in (lp.wg, lp.wu,
                                                           lp.wd))
                h = (F_.silu(xf @ wg) * (xf @ wu)).to(c).float()
                want += w[:, e:e + 1] * (h @ wd).to(c).float()
            err = _rel(y.reshape(T, D).float(), want)
        what = f"moe_ffn {cfg.name} layer 0 at {(B, S, D)} (C = {r.C})"
        print(f"{what}: vs the dense oracle {err:.3e} of max |y| (<= "
              f"{MOE_TOL:g}); dropped (token, slot) pairs {port_drops} of "
              f"{T * k}, oracle {drops}", flush=True)
        if port_drops != drops or not err <= MOE_TOL:
            fail(f"{what}: {port_drops} dropped pairs against the oracle's "
                 f"{drops}, y off it by {err:.3e} > {MOE_TOL:g}")
        out[f"{B}x{S}"] = {"capacity": r.C, "group": gs, "dropped": drops,
                           "pairs": T * k, "max_rel_err": err}
    return out


def check_mamba1_layer(dev, cfg, lp, gen, T) -> dict:
    """One full-width Mamba-1 layer on T positions of a random hidden
    state: the chunked selective scan (``_ssm_selective``, two chunks at
    T = 256) against the sequential recurrence in f64 on the same f32
    inputs, y and the last state; the LTI kernel's causal convolution by
    FFT (``lti_conv_fft``) against the direct convolution in f64 with the
    f64 impulse response; the LTI-FFT block against the block with that
    direct convolution.  The recurrences within SSM_TOL, the block within
    the h tolerance, of their max |value|."""
    from repro_torch.models import mamba
    F_ = torch.nn.functional
    h = torch.randn((1, T, cfg.d_model), generator=gen, device=dev).to(
        cfg.policy.c())
    with torch.inference_mode():
        xi, z, _ = mamba.conv_inputs(cfg, lp, h)
        dt, Bc, Cc = mamba.selective_inputs(cfg, lp, xi, h.dtype)
        y, s_last = mamba._ssm_selective(xi, dt, Bc, Cc, lp.A_log, lp.D_skip,
                                         cfg.ssm_chunk)
        A = -torch.exp(lp.A_log.double())
        s = torch.zeros_like(A)[None]
        ys = []
        for t in range(T):
            s = torch.exp(dt[:, t, :, None].double() * A) * s + \
                (dt[:, t] * xi[:, t]).double()[..., None] * \
                Bc[:, t, None, :].double()
            ys.append((s * Cc[:, t, None, :].double()).sum(-1))
        y_ref = torch.stack(ys, 1) + lp.D_skip.double() * xi.double()
        scan = {"y": _rel(y.double(), y_ref), "state": _rel(s_last.double(),
                                                            s)}
        dtl = F_.softplus(lp.dt_bias.double())
        decay = torch.exp(dtl[:, None] * -torch.exp(lp.A_log.double()))
        steps = torch.arange(T, device=dev, dtype=torch.float64)
        kern = (dtl[:, None] / cfg.ssm_state * decay[None]
                ** steps[:, None, None]).sum(-1)                # (T, Di)
        direct = F_.conv1d(F_.pad(xi.double().transpose(1, 2), (T - 1, 0)),
                           kern.T.flip(-1)[:, None, :],
                           groups=kern.shape[1]).transpose(1, 2)
        fft = mamba.lti_conv_fft(mamba.lti_kernel(cfg, lp, T), xi)
        conv = _rel(fft.double(), direct)
        block = mamba.mamba1_block_lti_fft(cfg, lp, h)
        block_direct = mamba._out(lp, h, direct.float() + lp.D_skip * xi, z)
        blk = _rel((block - h).float(), (block_direct - h).float())
    what = f"mamba1 {cfg.name} layer 0 at (1, {T}, {cfg.d_model})"
    print(f"{what}: selective scan vs the f64 recurrence y {scan['y']:.3e}, "
          f"last state {scan['state']:.3e}; LTI FFT convolution vs the f64 "
          f"direct one {conv:.3e} (<= {SSM_TOL:g}); LTI-FFT block vs the "
          f"block on the direct convolution {blk:.3e} (<= {TOL['h']:g})",
          flush=True)
    if not max(scan.values()) <= SSM_TOL or not conv <= SSM_TOL \
            or not blk <= TOL["h"]:
        fail(f"{what}: scan {scan}, LTI convolution {conv:.3e}, block "
             f"{blk:.3e}")
    return {"scan": scan, "lti_conv": conv, "lti_block": blk,
            "chunk": mamba._pick_chunk(T, cfg.ssm_chunk)}


def check_ssd_layer(dev, cfg, lp, gen, T) -> dict:
    """The Mamba-2 SSD chunked form (``_ssd_chunked``) at one full-width
    layer's heads (its A_log and dt_bias), on random f32 inputs over T
    positions, against the naive per-step recurrence in f64, as
    ``tests/test_models_smoke.py`` does on the CPU: y and the last state
    within SSM_TOL of their max |value|."""
    from repro_torch.models import mamba
    Di = cfg.ssm_expand * cfg.d_model
    Ph, N = cfg.ssm_head_dim, cfg.ssm_state
    H = Di // Ph
    rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                     device=dev)
    x, Bc, Cc = rnd(1, T, H, Ph), rnd(1, T, N), rnd(1, T, N)
    dt = torch.nn.functional.softplus(rnd(1, T, H) + lp.dt_bias)
    with torch.inference_mode():
        y, S_last = mamba._ssd_chunked(x, dt, Bc, Cc, lp.A_log,
                                       cfg.ssm_chunk)
        a = dt.double() * -torch.exp(lp.A_log.double())
        s = torch.zeros((1, H, Ph, N), dtype=torch.float64, device=dev)
        ys = []
        for t in range(T):
            s = s * torch.exp(a[:, t])[..., None, None] + torch.einsum(
                "bhp,bn->bhpn", (x[:, t] * dt[:, t][..., None]).double(),
                Bc[:, t].double())
            ys.append(torch.einsum("bhpn,bn->bhp", s, Cc[:, t].double()))
        errs = {"y": _rel(y.double(), torch.stack(ys, 1)),
                "state": _rel(S_last.double(), s)}
    what = f"SSD {cfg.name} at (1, {T}, {H}, {Ph}), N {N}"
    print(f"{what}: vs the f64 recurrence y {errs['y']:.3e}, last state "
          f"{errs['state']:.3e} (<= {SSM_TOL:g})", flush=True)
    if not max(errs.values()) <= SSM_TOL:
        fail(f"{what}: {errs}")
    return errs


def check_decode_vs_forward(dev, cfg, model, reqs, cont, tol, what) -> dict:
    """Prefill of the left-padded prompts, then one decode step a token of
    ``cont`` (B, n): each step's logits against the teacher-forced
    ``forward`` of prompt + ``cont`` at that position, within ``tol`` of
    max |logit| (``tol`` None: reported, not gated)."""
    from repro_torch.models import api
    toks = torch.as_tensor(_left_padded(reqs), device=dev)
    S = toks.shape[1]
    full = torch.cat([toks, cont], dim=1)
    with torch.inference_mode():
        want, _ = api.forward(cfg, model, {"tokens": full})
        logits, state = api.prefill_step(cfg, model, {"tokens": toks}, 0)
        gaps = [_logit_gap(logits[:, -1], want[:, S - 1])]
        for i in range(cont.shape[1] - 1):
            logits, state = api.decode_step(cfg, model, state,
                                            cont[:, i:i + 1])
            gaps.append(_logit_gap(logits[:, 0], want[:, S + i]))
    print(f"{what}: prefill + {len(gaps) - 1} decode steps vs the teacher-"
          f"forced forward, worst {max(gaps):.3e} of max |logit| ("
          + (f"<= {tol:g})" if tol is not None else "reported, not gated)"),
          flush=True)
    if tol is not None and not max(gaps) <= tol:
        fail(f"{what}: decode off the forward by {max(gaps):.3e} > {tol:g}")
    return {"gaps": gaps, "tol": tol}


def drive_families(dev, full, time_fn, report):
    """The slice's main paths: granite-moe-3b, falcon-mamba-7b, zamba2-1.2b
    and whisper-base at full width through ``ServeEngine.serve``
    (``family_plan``), weights from a seeded generator on the device, one
    model at a time.  For each: the layer checks of its family (the MoE
    FFN, Mamba-1 with the LTI-FFT path, Mamba-2's SSD); a warm-up serve,
    then the counted serve with the counters set to 0 just before it:
    ``flash_calls_per_prefill`` wgmma flash launches a prefill batch and
    none in decode; flash against chunked (prefill and teacher-forced
    decode logits within LOGIT_TOL; granite's chunked path on the flash
    path's routing, the pairs routed differently counted); falcon's
    prefill + decode against its forward, gated at ``FULL_F32`` and
    reported at the default policy.  Tokens/s, prefill ms, the median
    decode ms a step, peak memory and the phase's seconds."""
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.models.policy import FULL_F32
    out = report["families"] = {}
    if dev.type == "cuda":
        report["peak_memory_gb_before_families"] = \
            torch.cuda.max_memory_allocated(dev) / 1e9
    for arch in FAMILY_ARCHS:
        free(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cfg, reqs, bucket, max_seq = family_plan(arch, full)
        gen = torch.Generator(device=dev).manual_seed(SEED + 41)
        model = api.init_params(cfg, gen, device=dev)
        fam = out[cfg.name] = {
            "family": cfg.family, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "attn_impl": cfg.attn_impl,
            "max_seq": max_seq, "bucket": bucket,
            "prompt_lens": [len(r.prompt) for r in reqs]}
        if cfg.family == "moe":
            fam["moe_layer"] = check_moe_layer(
                dev, cfg, model.layers[0], gen,
                ((4, 512), (4, 1)) if full else ((4, 16), (4, 1)))
        if cfg.family == "ssm":
            fam["mamba1_layer"] = check_mamba1_layer(
                dev, cfg, model.layers[0], gen, LAYER_T if full else 16)
        if cfg.family == "hybrid":
            fam["ssd_layer"] = check_ssd_layer(
                dev, cfg, model.layers[0], gen, LAYER_T if full else 16)
        _serve_once(dev, cfg, model, reqs, bucket, max_seq)      # warm-up
        _build.reset_launch_counts()
        res, run = _serve_once(dev, cfg, model, reqs, bucket, max_seq)
        counts = {k: v for k, v in _build.launch_counts.items() if v}
        fam.update({"launches": counts, "serve": run})
        n_batches = len(run["prefill_ms"])
        expect = flash_calls_per_prefill(cfg) * n_batches
        steps = sorted(run["decode_ms_per_step"])
        print(f"serve {cfg.name} ({cfg.family}, {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, {cfg.attn_impl}): {len(reqs)} "
              f"requests in {n_batches} batch(es) of prompts "
              f"{fam['prompt_lens']}, {run['tokens']} tokens in "
              f"{run['wall_s']:.3f} s ({run['tokens_per_s']:.1f} tok/s); "
              f"prefill ms {[round(t, 3) for t in run['prefill_ms']]}; "
              f"decode ms/step median {steps[len(steps) // 2]:.3f}; "
              f"launches {counts} (prefill {run['prefill_launches']}, decode "
              f"{run['decode_launches']}, expected {expect} and 0)",
              flush=True)
        check_launches(counts, {"flash_attention_bh_wgmma": expect,
                                "flash_attention_bh": 0,
                                "flash_attention_bh_f32": 0})
        check_launches({"flash": run["prefill_launches"]}, {"flash": expect})
        check_launches({"flash": run["decode_launches"]}, {"flash": 0})
        if len(res) != len(reqs) or any(
                len(r.tokens) != q.max_new_tokens or r.tokens.min() < 0
                or r.tokens.max() >= cfg.vocab for r, q in zip(res, reqs)):
            fail(f"serve {cfg.name}: results of the wrong length or outside "
                 f"the vocabulary")
        # how far the host holds decode back, as drive_serve measures it
        prof = profile_decode(dev, cfg, model, reqs, max_seq)
        if prof is not None:
            prof["idle_share"] = 1 - prof["device_ms_per_step"] / \
                steps[len(steps) // 2]
            print(f"{cfg.name} decode step: {prof['kernels_per_step']:.0f} "
                  f"kernels, {prof['device_ms_per_step']:.3f} ms of device "
                  f"time; idle share {prof['idle_share']:.3f}", flush=True)
        fam["decode_profile"] = prof
        new = reqs[0].max_new_tokens
        if cfg.n_heads:
            fam["check_default"] = compare_paths(
                dev, cfg, model, reqs, max_seq, new, LOGIT_TOL["default"],
                f"{cfg.name} default policy")
        if cfg.family == "ssm":
            import numpy as np
            cont = torch.as_tensor(np.stack([r.tokens for r in res]),
                                   device=dev, dtype=torch.long)
            # gated at FULL_F32, as the reference's own decode-against-
            # forward check (tests/test_models_smoke.py) runs in f32; at
            # the default policy the prefill, decode and forward GEMMs of
            # other row counts round bf16 differently, and 64 layers carry
            # it: reported
            fam["decode_vs_forward"] = {
                pol: check_decode_vs_forward(
                    dev, c, model, reqs, cont, tol, f"{cfg.name} {pol}")
                for pol, c, tol in (
                    ("full_f32", cfg.replace(policy=FULL_F32),
                     LOGIT_TOL["full_f32"]),
                    ("default", cfg, None))}
        if dev.type == "cuda":
            fam["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        fam["seconds"] = time.perf_counter() - t0
        print(f"{cfg.name} phase: {fam['seconds']:.1f} s, peak device memory "
              f"{fam.get('peak_memory_gb', 0.0):.2f} GB", flush=True)
        del model, res
    free(dev)


# ---------------------------------------------------------------------------
# slice 17: the dispatch crossover and training
# ---------------------------------------------------------------------------

def drive_dispatch_calibration(dev, report):
    """``backend.calibrate_dispatch`` on the card (the complex "H" SBGEMV
    at B = 8, m = 16 on the kernel and the plain path, CUDA-event
    medians) into a TuningCache under a temp dir: the ms of both paths at
    every ratio and the ratio found; a second call answered from the
    cache with nothing measured; the calibrated table's routing shown by
    launch counts (the kernel from the ratio up, none below); the
    default (uncalibrated) table launching the kernel at the paper
    shape's block."""
    import math
    import shutil
    import tempfile
    from repro_torch.backend import (DispatchTable, calibrate_dispatch,
                                     probe_backend)
    from repro_torch.backend.dispatch import (CALIBRATION_RATIOS,
                                              CALIBRATION_ROWS)
    from repro_torch.configs import PAPER_SINGLE
    from repro_torch.kernels import _build, ops
    from repro_torch.tune import TuningCache
    out = report["dispatch_calibration"] = {}
    if dev.type != "cuda":
        return
    spec = probe_backend(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dispatch_")
    try:
        path = pathlib.Path(tmp) / "tune.json"
        times = {}
        t0 = time.perf_counter()
        table = calibrate_dispatch(spec, cache=TuningCache(path),
                                   times=times)
        out["seconds"] = time.perf_counter() - t0
        out["ratio"] = table.short_wide_ratio
        out["ms"] = {str(r): t for r, t in times.items()}
        for r, t in times.items():
            print(f"dispatch calibration: m={CALIBRATION_ROWS} n="
                  f"{int(CALIBRATION_ROWS * r)} (ratio {r}): kernel "
                  f"{t['kernel']:.4f} ms, torch {t['torch']:.4f} ms")
        print(f"dispatch calibration: short-wide ratio {table.short_wide_ratio}"
              f" ({out['seconds']:.1f} s)", flush=True)
        if not table.calibrated or sorted(times) != list(CALIBRATION_RATIOS):
            fail("dispatch calibration: no calibrated table or missing "
                 "ratios")

        def boom(path_, m, n):
            raise AssertionError("measured despite a cached table")

        if calibrate_dispatch(spec, cache=TuningCache(path),
                              measure=boom) != table:
            fail("dispatch calibration: the cached table differs")

        gen = torch.Generator(device=dev).manual_seed(SEED + 51)
        routed = {}
        for r in CALIBRATION_RATIOS:
            m, n = CALIBRATION_ROWS, int(CALIBRATION_ROWS * r)
            A = [torch.randn((8, m, n), generator=gen, device=dev)
                 for _ in range(2)]
            x = [torch.randn((8, m), generator=gen, device=dev)
                 for _ in range(2)]
            _build.reset_launch_counts()
            y = ops.sbgemv(*A, *x, "H", dispatch=table)
            sync(dev)
            launched = _build.launch_counts.get("sbgemv_th_complex", 0)
            want = int(m * table.short_wide_ratio <= n)
            routed[str(r)] = launched
            if launched != want or sum(_build.launch_counts.values()) != \
                    launched:
                fail(f"calibrated table at m={m}, n={n}: "
                     f"{dict(_build.launch_counts)} launches, expected "
                     f"{want} of sbgemv_th_complex")
            plain = ops.sbgemv(*A, *x, "H",
                               dispatch=DispatchTable(force="torch"))
            check_planes(f"calibrated sbgemv m={m} n={n}", y, plain,
                         torch.float32)
        out["launches_by_ratio"] = routed
        cfg = PAPER_SINGLE
        shape = (cfg.N_t + 1, cfg.N_d, cfg.N_m)
        A = [torch.randn(shape, generator=gen, device=dev) for _ in range(2)]
        x = [torch.randn(shape[:2], generator=gen, device=dev)
             for _ in range(2)]
        _build.reset_launch_counts()
        ops.sbgemv(*A, *x, "H", dispatch=DispatchTable())
        sync(dev)
        check_launches(dict(_build.launch_counts), {"sbgemv_th_complex": 1})
        out["default_table_paper_launches"] = dict(_build.launch_counts)
        out["paper_shape_ratio"] = shape[2] / shape[1]
        out["paper_shape_on_kernel_when_calibrated"] = \
            math.isfinite(table.short_wide_ratio) and \
            shape[1] * table.short_wide_ratio <= shape[2]
        del A, x
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


TRAIN_ARCH = "qwen1p5_0p5b"
TRAIN_SEQ = 4096          # train_4k's length (src/repro/configs/shapes.py)
TRAIN_BATCH = 2           # train_4k's global batch of 256, cut to one card
TRAIN_STEPS = 6
TRAIN_LR = 3e-4
LEARN_LR = 1e-3           # the learning check: 4 steps on one batch
CHECK_LAYERS = 2          # the autograd, resume and compression checks
CHECK_SEQ = 256
GRAD_TOL = 1e-4           # loss and grad norm, FULL_F32 against f64
HEAD_GRAD_TOL = 1e-2      # the f32-output product's gradients (bf16)
RESUME_TOL = {"rtol": 1e-5, "atol": 1e-6}   # tests/test_runtime.py


def plain_dense_loss(cfg, P: dict, tokens, labels):
    """The dense family's next-token cross entropy written out plainly
    (full-score causal softmax attention, rotary positions on halves,
    RMS norm, SwiGLU, the tied or untied head), in the dtype of the
    parameters ``P`` (the port's names): the f64 oracle of the autograd
    check."""
    import torch.nn.functional as F
    B, S = tokens.shape
    H, Hk, Dh = cfg.n_heads, cfg.n_kv, cfg.head_dim()
    dt, dev = P["embed"].dtype, tokens.device
    inv = 1.0 / cfg.rope_theta ** (torch.arange(0, Dh, 2, dtype=dt,
                                                device=dev) / Dh)
    ang = torch.arange(S, dtype=dt, device=dev)[:, None] * inv
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]

    def rope(x):
        x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def norm(x, g):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + cfg.norm_eps) * g

    def proj(x, i, name):
        b = P.get(f"layers.{i}.b{name}")
        y = x @ P[f"layers.{i}.w{name}"]
        return y if b is None else y + b

    mask = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    h = P["embed"][tokens]
    for i in range(cfg.n_layers):
        x = norm(h, P[f"layers.{i}.ln1"])
        q = rope(proj(x, i, "q").view(B, S, H, Dh))
        k = rope(proj(x, i, "k").view(B, S, Hk, Dh)).repeat_interleave(
            H // Hk, 2)
        v = proj(x, i, "v").view(B, S, Hk, Dh).repeat_interleave(H // Hk, 2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / Dh ** 0.5
        p = s.masked_fill(~mask, float("-inf")).softmax(-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * Dh)
        h = h + o @ P[f"layers.{i}.wo"]
        x = norm(h, P[f"layers.{i}.ln2"])
        h = h + (F.silu(x @ P[f"layers.{i}.wg"]) * (x @ P[f"layers.{i}.wu"])) \
            @ P[f"layers.{i}.wd"]
    x = norm(h, P["ln_f"])
    head = P["embed"].T if cfg.tie_embeddings else P["lm_head"]
    logits = x @ head
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def check_head_backward(dev, gen) -> dict:
    """The head's f32-output product (``layers.matmul_f32`` on bf16
    operands: ``torch.mm(..., out_dtype=torch.float32)``) differentiated
    on the card through ``layers._ProductF32``, against f64 autograd of
    the same bf16 operands; and whether the overload has a derivative of
    its own in this torch."""
    from repro_torch.models import layers
    x = torch.randn((512, 1024), generator=gen, device=dev).bfloat16()
    w = (torch.randn((1024, 4096), generator=gen, device=dev) / 32).bfloat16()
    r = torch.randn((512, 4096), generator=gen, device=dev)
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = layers.matmul_f32(x, w)
    gx, gw = torch.autograd.grad((y * r).sum(), (x, w))
    xd = x.detach().double().requires_grad_(True)
    wd = w.detach().double().requires_grad_(True)
    yd = xd @ wd
    gxd, gwd = torch.autograd.grad((yd * r.double()).sum(), (xd, wd))
    out = {"forward": rel(y, yd), "grad_x": rel(gx, gxd),
           "grad_w": rel(gw, gwd)}
    try:
        torch.mm(x, w, out_dtype=torch.float32).sum().backward()
        out["mm_dtype_has_derivative"] = True
    except RuntimeError:
        out["mm_dtype_has_derivative"] = False
    if out["forward"] > HEAD_TOL or out["grad_x"] > HEAD_GRAD_TOL \
            or out["grad_w"] > HEAD_GRAD_TOL:
        fail(f"the f32-output product's gradient on the card: {out}")
    print(f"head product backward: forward {out['forward']:.2e}, grad x "
          f"{out['grad_x']:.2e}, grad w {out['grad_w']:.2e} (f64 oracle); "
          f"aten::mm.dtype has a derivative: "
          f"{out['mm_dtype_has_derivative']}", flush=True)
    return out


class _CrashOnce:
    def __init__(self, at):
        self.at, self.done = at, False

    def __call__(self, step):
        if step == self.at and not self.done:
            self.done = True
            raise RuntimeError("injected node failure")


def check_train_small(dev, cfg, out) -> None:
    """The checks on a CHECK_LAYERS-layer model of ``cfg``'s widths at
    ``FULL_F32`` (batch 1, CHECK_SEQ tokens): loss and grad norm against
    ``plain_dense_loss`` in f64 on the same weights (remat full, chunked
    attention); a crash by ``fault_hook`` after a checkpoint, resumed to
    the uninterrupted run's parameters; one int8-compressed step with
    nonzero error-feedback buffers; a grad-enabled flash call raising."""
    import math
    import shutil
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.models.policy import FULL_F32
    from repro_torch.optim import AdamW, Compressor, constant_schedule
    from repro_torch.runtime import Trainer, TrainerConfig
    small = cfg.replace(n_layers=CHECK_LAYERS, policy=FULL_F32)
    pipe = SyntheticPipeline(small, 1, CHECK_SEQ, seed=SEED + 5, device=dev)
    batch = pipe.generate(0)
    model = api.init_params(small, seed=SEED + 6, device=dev)
    names, params = zip(*model.named_parameters())
    loss, _ = api.loss_fn(small, model, batch)
    grads = torch.autograd.grad(loss, params)
    gnorm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    P = {n: p.detach().double().requires_grad_(True)
         for n, p in zip(names, params)}
    want = plain_dense_loss(small, P, batch["tokens"], batch["labels"])
    gd = torch.autograd.grad(want, [P[n] for n in names])
    gnorm_d = torch.stack([g.square().sum() for g in gd]).sum().sqrt()
    grad_rel = (torch.stack([(g.double() - h).square().sum()
                             for g, h in zip(grads, gd)]).sum().sqrt()
                / gnorm_d).item()
    ag = out["autograd_f64"] = {
        "loss": loss.item(), "loss_f64": want.item(),
        "loss_rel": abs(loss.item() - want.item()) / abs(want.item()),
        "grad_norm": gnorm.item(), "grad_norm_f64": gnorm_d.item(),
        "grad_norm_rel": abs(gnorm.item() - gnorm_d.item()) / gnorm_d.item(),
        "grads_rel": grad_rel}
    print(f"autograd ({CHECK_LAYERS} layers, FULL_F32, remat full, chunked) "
          f"vs f64: loss rel {ag['loss_rel']:.2e}, grad norm rel "
          f"{ag['grad_norm_rel']:.2e}, gradients rel {grad_rel:.2e}",
          flush=True)
    if ag["loss_rel"] > GRAD_TOL or ag["grad_norm_rel"] > GRAD_TOL:
        fail(f"autograd on the card against f64: {ag}")
    del grads, gd, P, want, loss

    # flash refuses gradients on the card, and runs under no_grad
    fl = small.replace(attn_impl="flash")
    try:
        api.loss_fn(fl, model, batch)
        fail("a grad-enabled flash call did not raise")
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    _build.reset_launch_counts()
    with torch.no_grad():
        api.loss_fn(fl, model, batch)
    sync(dev)
    check_launches(dict(_build.launch_counts),
                   {"flash_attention_bh_f32": CHECK_LAYERS})
    out["flash_refuses_gradients"] = True

    # one int8-compressed step: nonzero error feedback
    opt = AdamW(constant_schedule(TRAIN_LR))
    state = {"params": model, "opt": opt.init(dict(zip(names, params))),
             "step": torch.zeros((), dtype=torch.int32),
             "efb": {n: torch.zeros_like(p, requires_grad=False)
                     for n, p in zip(names, params)}}
    state, m = api.make_train_step(small, opt, grad_compressor=Compressor(
        "int8"))(state, batch)
    efb_max = max(e.abs().max().item() for e in state["efb"].values())
    out["int8_step"] = {"loss": m["loss"].item(), "efb_max": efb_max,
                        "grad_norm": m["grad_norm"].item()}
    if not efb_max > 0 or not math.isfinite(m["loss"].item()):
        fail(f"int8-compressed step: {out['int8_step']}")
    del state, model, params

    # crash after the step-2 checkpoint, resume, against an uninterrupted run
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        def trainer(d, hook=None):
            tcfg = TrainerConfig(total_steps=4, checkpoint_every=2,
                                 log_every=100, lr=TRAIN_LR, warmup=1)
            return Trainer(small, tcfg, SyntheticPipeline(
                small, 1, CHECK_SEQ, seed=SEED + 7, device=dev),
                Checkpointer(d, keep_last=1), fault_hook=hook)
        t0 = time.perf_counter()
        try:
            trainer(f"{tmp}/a", _CrashOnce(3)).run()
            fail("the injected crash did not raise")
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        t2 = trainer(f"{tmp}/a")
        resumed, status = t2.run()
        plain, _ = trainer(f"{tmp}/b").run()
        diffs = [((a - b).abs().max().item(), b.abs().max().item())
                 for a, b in zip(resumed["params"].parameters(),
                                 plain["params"].parameters())]
        bitwise = all(d == 0 for d, _ in diffs)
        out["resume"] = {"status": status, "steps_after_resume":
                         len(t2.step_times), "bitwise": bitwise,
                         "max_abs_diff": max(d for d, _ in diffs),
                         "deterministic_algorithms":
                             torch.are_deterministic_algorithms_enabled(),
                         "seconds": time.perf_counter() - t0}
        print(f"crash at step 3, resumed from step 2: {len(t2.step_times)} "
              f"steps, final parameters {'bit for bit' if bitwise else 'not bit for bit'}"
              f" with the uninterrupted run's (max abs diff "
              f"{out['resume']['max_abs_diff']:.3e}; "
              f"torch.use_deterministic_algorithms "
              f"{'on' if out['resume']['deterministic_algorithms'] else 'off'})",
              flush=True)
        if status != "done" or len(t2.step_times) != 2:
            fail(f"resume: {out['resume']}")
        for (a, b) in zip(resumed["params"].parameters(),
                          plain["params"].parameters()):
            if not torch.allclose(a, b, **RESUME_TOL):
                fail(f"resumed parameters differ: {out['resume']}")
        del resumed, plain
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def drive_train(dev, full, time_fn, report):
    """The training main path: qwen1.5-0.5b at full width and depth
    (``remat="full"``, chunked attention, the default policy, seeded
    random init) through ``runtime.Trainer.run`` for TRAIN_STEPS steps of
    AdamW on the cosine schedule, ``SyntheticPipeline`` batches of
    TRAIN_BATCH x TRAIN_SEQ, the checkpointer in a temp dir (no
    checkpoint before the run's final one).  Prints the step ms (median
    of steps 2-6), tokens/s, peak memory, loss and grad norm a step, the
    final checkpoint's seconds and GB, a profiled step's device time and
    kernel count (its host-bound share), and that no hand-written kernel
    ran (chunked attention).  Checks: 4 AdamW steps at LEARN_LR on one
    batch lower its loss (a fresh model); the head's product backward
    (:func:`check_head_backward`); :func:`check_train_small`."""
    import math
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.optim import AdamW, constant_schedule
    from repro_torch.runtime import Trainer, TrainerConfig
    out = report["train"] = {}
    free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    cfg = (get_config(TRAIN_ARCH) if full else get_smoke_config(TRAIN_ARCH))
    cfg = cfg.replace(remat="full", attn_impl="chunked")
    B, S = (TRAIN_BATCH, TRAIN_SEQ) if full else (2, 32)
    out.update(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               vocab=cfg.vocab, batch=B, seq=S, steps=TRAIN_STEPS,
               remat=cfg.remat, attn_impl=cfg.attn_impl,
               reduced={"global_batch": "256 -> 2 (one card's memory)"})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        pipe = SyntheticPipeline(cfg, B, S, seed=SEED, device=dev)
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS,
                             checkpoint_every=TRAIN_STEPS + 1, log_every=1,
                             lr=TRAIN_LR, warmup=2)
        trainer = Trainer(cfg, tcfg, pipe, Checkpointer(tmp, keep_last=1))
        saves = []
        save = trainer._save

        def timed_save(state, pstate):
            sync(dev)
            t0 = time.perf_counter()
            save(state, pstate)
            trainer.ckpt.wait()
            saves.append(time.perf_counter() - t0)

        trainer._save = timed_save
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        state, status = trainer.run(seed=SEED)
        out["run_seconds"] = time.perf_counter() - t0
        counts = dict(_build.launch_counts)
        out["launches"] = counts
        if sum(counts.values()):
            fail(f"the training path (chunked attention) launched "
                 f"hand-written kernels: {counts}")
        if status != "done" or int(state["step"]) != TRAIN_STEPS:
            fail(f"train run: {status} at step {int(state['step'])}")
        n_params = sum(p.numel() for p in state["params"].parameters())
        steps = trainer.step_times
        med = sorted(steps[1:])[len(steps[1:]) // 2]
        out.update(
            n_params=n_params, step_ms=[t * 1e3 for t in steps],
            step_ms_median=med * 1e3, tokens_per_s=B * S / med,
            loss=[m["loss"] for m in trainer.metrics_log],
            grad_norm=[m["grad_norm"] for m in trainer.metrics_log],
            checkpoint_seconds=saves[-1],
            checkpoint_gb=os.path.getsize(os.path.join(
                trainer.ckpt.step_dir(TRAIN_STEPS), "arrays.npz")) / 1e9)
        if dev.type == "cuda":
            out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        for m in trainer.metrics_log:
            print(f"train step {m['step']}: loss {m['loss']:.4f}, grad norm "
                  f"{m['grad_norm']:.4f}, {m['ms']:.1f} ms", flush=True)
        if not all(math.isfinite(x) for x in out["loss"] + out["grad_norm"]):
            fail(f"train run: non-finite loss or grad norm {out}")
        print(f"train {cfg.name} ({n_params / 1e6:.1f} M parameters, "
              f"{cfg.n_layers} layers) at batch {B} x {S}: step "
              f"{out['step_ms_median']:.1f} ms (median of steps 2-"
              f"{TRAIN_STEPS}), {out['tokens_per_s']:.0f} tokens/s, peak "
              f"{out.get('peak_memory_gb', 0.0):.2f} GB; final checkpoint "
              f"{out['checkpoint_gb']:.2f} GB in "
              f"{out['checkpoint_seconds']:.1f} s", flush=True)

        # one more step profiled: device time and kernels a step
        model = state["params"]
        step_fn = trainer.step_fn
        batch = pipe.generate(TRAIN_STEPS)
        if dev.type == "cuda":
            sync(dev)
            t0 = time.perf_counter()
            # device activity only: the host's ~10^5 op events a step would
            # cost more to gather than the step
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, _ = step_fn(state, batch)
                sync(dev)
            wall = time.perf_counter() - t0
            kern = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
            if busy_ms:
                out["profile"] = {
                    "device_ms": busy_ms, "kernels": sum(e.count
                                                         for e in kern),
                    "idle_share_of_median_step": 1 - busy_ms / (med * 1e3),
                    "profiled_step_ms": wall * 1e3,
                    "seconds": time.perf_counter() - t0}
                print(f"train step profiled: {busy_ms:.1f} ms of device "
                      f"time, {out['profile']['kernels']} kernels; idle "
                      f"share of the median step "
                      f"{out['profile']['idle_share_of_median_step']:.3f}",
                      flush=True)
        del state, trainer, model
        free(dev)

        # learning: 4 AdamW steps at LEARN_LR on one fixed batch, from a
        # fresh model (after the run's 6 steps on the cosine schedule the
        # random tied head's logits, std ~32, leave lr 1e-3 chaotic)
        t0 = time.perf_counter()
        model = api.init_params(cfg, seed=SEED + 3, device=dev)
        opt = AdamW(constant_schedule(LEARN_LR))
        named = dict(model.named_parameters())
        lstate = {"params": model, "opt": opt.init(named),
                  "step": torch.zeros((), dtype=torch.int32)}
        learn = api.make_train_step(cfg, opt)
        with torch.no_grad():
            before = api.loss_fn(cfg, model, batch)[0].item()
        for _ in range(4):
            lstate, _ = learn(lstate, batch)
        with torch.no_grad():
            after = api.loss_fn(cfg, model, batch)[0].item()
        out["learning"] = {"loss_before": before, "loss_after": after,
                           "seconds": time.perf_counter() - t0}
        print(f"learning check: one batch's loss {before:.4f} -> "
              f"{after:.4f} after 4 AdamW steps at lr {LEARN_LR}",
              flush=True)
        if not after < before:
            fail(f"4 AdamW steps did not lower the batch's loss: "
                 f"{out['learning']}")
        del lstate, model, named, batch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free(dev)
    if dev.type == "cuda":
        gen = torch.Generator(device=dev).manual_seed(SEED + 61)
        out["head_backward"] = check_head_backward(dev, gen)
    t0 = time.perf_counter()
    check_train_small(dev, (get_config(TRAIN_ARCH) if full
                            else get_smoke_config(TRAIN_ARCH)), out)
    out["small_checks_seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"train phase: {out['seconds']:.1f} s", flush=True)
    free(dev)


# ---------------------------------------------------------------------------
# 19-21. The roofline, the static plan linter, the dry run (slice 18)
# ---------------------------------------------------------------------------

ROOFLINE_CONFIGS = ("ddddd", "sssss", "hhhhh")
SHARE_MAX = 1.05        # bound over measured: above it the count is wrong
# the fake-mode peak of the train step over the measured peak of the 2 x
# 4096 step: the fake run counts every live storage's bytes as the caching
# allocator's allocated bytes do; the allocator rounds blocks up and cuBLAS
# takes workspaces through it
TRAIN_PEAK_BAND = (0.8, 1.1)
# PERF.md section 6 rows 3 and 4: the Phase-3 GEMV's bytes at the paper
# shape, by the gemv level's dtype
GEMV_ROW_GB = {"d": 8.0897, "s": 4.0448, "h": 2.0224}
# the dry run's shapes here: prefill_32k's ten cells, about two thirds of
# the whole sweep's host time, run once through the chip tool instead
# (PERF.md, PR 28)
DRYRUN_SHAPES = ("train_4k", "decode_32k", "long_500k")
DRYRUN_JOBS = 8          # cells at once, one process each (8 host cores)
DRYRUN_TIMEOUT = 400     # seconds


def drive_dryrun(report) -> None:
    """The dry run, after every timed phase (its cells are host work on
    fake tensors, and would slow the host-bound phases beside them):
    ``python -m repro_torch.launch.dryrun`` over every arch at
    DRYRUN_SHAPES on the single-card mesh, DRYRUN_JOBS cells at once,
    records in ``chiprun_out/dryrun/``, output in
    ``chiprun_out/dryrun.log``.  Every cell must end ``ok`` or
    ``skipped``."""
    import shutil
    import signal
    from repro_torch.configs import ARCH_IDS
    out = report["roofline"]
    rec_dir = ROOT / "chiprun_out" / "dryrun"
    shutil.rmtree(rec_dir, ignore_errors=True)
    rec_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    with open(ROOT / "chiprun_out" / "dryrun.log", "w") as log:
        # a session of its own, so a timeout stops its pool's workers too
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", "all", "--shape", ",".join(DRYRUN_SHAPES),
             "--jobs", str(DRYRUN_JOBS), "--out", str(rec_dir)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            rc = proc.wait(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            fail(f"the dry run did not end within {DRYRUN_TIMEOUT} s "
                 f"(chiprun_out/dryrun.log)")
    seconds = time.perf_counter() - t0
    cells, failed = {}, []
    for arch in ARCH_IDS:
        for shape in DRYRUN_SHAPES:
            path = rec_dir / f"{arch}__{shape}__h100x1__baseline.json"
            rec = json.loads(path.read_text()) if path.exists() else \
                {"error": "no record"}
            if "error" in rec:
                failed.append(f"{arch} {shape}: {rec['error']}")
                continue
            r = rec.get("roofline")
            cells[f"{arch} {shape}"] = (
                {"skipped": rec["skipped"]} if "skipped" in rec else
                {"bound_ms": r["step_time_bound_s"] * 1e3,
                 "dominant": r["dominant"],
                 "compute_ms": r["compute_s"] * 1e3,
                 "memory_ms": r["memory_s"] * 1e3,
                 "flops_by_dtype": r["flops_by_dtype"],
                 "useful_flop_ratio": rec["useful_flop_ratio"],
                 "roofline_fraction": rec["roofline_fraction"],
                 "peak_gb": rec["memory"]["peak_bytes"] / 1e9,
                 "memory_extrapolated": rec["memory_extrapolated"],
                 "fits_80gb": rec["fits_80gb"],
                 "seconds": rec["seconds"], "card": rec["card"]})
    n_skip = sum("skipped" in c for c in cells.values())
    out["dryrun"] = {"shapes": list(DRYRUN_SHAPES), "cells": cells,
                     "ok": len(cells) - n_skip, "skipped": n_skip,
                     "failed": failed, "rc": rc, "seconds": seconds}
    for k, c in cells.items():
        if "skipped" in c:
            print(f"dryrun {k}: skipped ({c['skipped']})", flush=True)
        else:
            print(f"dryrun {k}: bound {c['bound_ms']:.2f} ms "
                  f"({c['dominant']}), useful {c['useful_flop_ratio']:.2f}, "
                  f"peak {c['peak_gb']:.2f} GB"
                  f"{' (extrapolated)' if c['memory_extrapolated'] else ''}"
                  f", fits 80 GB {c['fits_80gb']}", flush=True)
    print(f"dry run: {len(cells) - n_skip} ok, {n_skip} skipped, "
          f"{len(failed)} failed in {seconds:.1f} s", flush=True)
    if failed or rc != 0:
        fail(f"dry-run cells failed (rc {rc}): {failed}")


def drive_roofline(dev, N_t, N_d, N_m, time_fn, report):
    """The roofline phase.  (a) F and F* at the paper shape for ddddd,
    sssss and hhhhh, run once under ``launch.roofline.OpCounter`` (the
    kernels report their FLOPs and bytes): the FLOPs by dtype, raw and
    floor bytes, the bound and its side, the ms measured here (median of
    20 events) and the share, bound over measured (above SHARE_MAX fails:
    the count is wrong); the GEMV's counted bytes must be PERF.md rows 3
    and 4.  (b) qwen1.5-0.5b: the train step at drive_train's 2 x 4096
    counted under fake tensors (``launch.dryrun``, the chunked path that
    phase times), the prefill of drive_serve's longer batch as that phase
    counted it on the flash path it times (``count_flash_prefill``);
    ``train_mfu`` and ``prefill_mfu`` from those phases' measured times
    (model FLOPs over seconds times the bf16 peak), each with its bound
    over its measured time; the fake-mode peak of the train step against
    drive_train's measured peak (TRAIN_PEAK_BAND)."""
    from repro_torch.backend import H100
    from repro_torch.configs import ShapeSpec, get_config, get_smoke_config
    from repro_torch.configs.fftmatvec_paper import FFTMatvecConfig
    from repro_torch.core import precision as prec
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import (CollectiveStats, model_flops,
                                             roofline_terms)
    out = report["roofline"] = {"card": dryrun.card_info()}
    t_phase = time.perf_counter()
    full = dev.type == "cuda"
    dims = FFTMatvecConfig("roofline", N_t=N_t, N_d=N_d, N_m=N_m)
    K = N_t + 1
    cells = out["fftmatvec"] = {}
    for cfg_s in ROOFLINE_CONFIGS:
        op = dryrun.fftmatvec_operator(dims, cfg_s, dev, seed=SEED + 71)
        level = op.precision.gemv
        dt = prec.real_dtype(level)
        for adjoint in (False, True):
            name = f"{cfg_s} {'Fstar' if adjoint else 'F'}"
            gemv = "sbgemv_th_complex" if adjoint else "sbgemv_n_complex"
            _build.reset_launch_counts()
            rec = dryrun.lower_fftmatvec_cell(
                precision=cfg_s, adjoint=adjoint, dims=dims, device=dev,
                op=op, time_fn=time_fn, seed=SEED + 71)
            launches = dict(_build.launch_counts)
            if full:
                check_launched(launches, ("pad_cast", gemv, "unpad_cast"))
            r, c = rec["roofline"], rec["counts"]
            kernel = c["by_op"].get(gemv) if full else None
            want = dt.itemsize * 2 * K * (N_d * N_m + N_m + N_d)
            cell = cells[name] = {
                "flops_by_dtype": c["flops_by_dtype"],
                "raw_bytes": c["raw_bytes"], "floor_bytes": c["floor_bytes"],
                "bound_ms": r["step_time_bound_s"] * 1e3,
                "bound_by": r["dominant"], "ms": rec["ms"],
                "share": rec["share"], "launches": launches,
                "gemv_bytes": kernel["bytes"] if kernel else None,
                "gemv_flops": kernel["flops"] if kernel else None,
                "model_flops": rec["model_flops"], "card": rec["card"]}
            print(f"roofline {name}: FLOPs {c['flops_by_dtype']}, raw "
                  f"{c['raw_bytes'] / 1e9:.4f} GB, floor "
                  f"{c['floor_bytes'] / 1e9:.4f} GB; bound "
                  f"{cell['bound_ms']:.4f} ms ({r['dominant']}), measured "
                  f"{rec['ms']:.4f} ms, share {rec['share']:.3f}"
                  + (f"; GEMV {kernel['bytes'] / 1e9:.4f} GB, "
                     f"{kernel['flops']:.4e} FLOPs" if kernel else ""),
                  flush=True)
            if not rec["share"] <= SHARE_MAX:
                fail(f"roofline {name}: share {rec['share']:.3f} > "
                     f"{SHARE_MAX}: the count misses work")
            if full:
                if kernel is None or kernel["bytes"] != want or \
                        round(want / 1e9, 4) != GEMV_ROW_GB[level]:
                    fail(f"roofline {name}: the GEMV counted {kernel}, "
                         f"expected {want} bytes ({GEMV_ROW_GB[level]} GB, "
                         f"PERF.md rows 3-4)")
                if kernel["flops"] != 8 * K * N_d * N_m:
                    fail(f"roofline {name}: GEMV FLOPs {kernel['flops']}, "
                         f"expected 8 K N_d N_m")
        del op
        free(dev)

    if full:
        # the flash kernel reports from its launch (it is no custom op)
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.launch.roofline import OpCounter
        gen = torch.Generator(device=dev).manual_seed(SEED + 73)
        q, k, v = (torch.randn((2, 700, 4, 64), generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        with torch.no_grad(), OpCounter() as c:
            o = fa.flash_attention(q, k, v, causal=True)
        entry = next(iter(k for k in c.by_op if k.startswith("flash")), None)
        got = c.by_op.get(entry, {})
        want = (4 * 2 * 4 * 64 * fa.attn_pairs(700, 700, True),
                4 * q.numel() * q.element_size())
        out["flash_count"] = {"entry": entry, **got}
        print(f"roofline flash count: {entry} {got}", flush=True)
        if (got.get("flops"), got.get("bytes")) != want:
            fail(f"the flash kernel reported {got}, expected FLOPs and "
                 f"bytes {want}")
        del q, k, v, o

    # (b) qwen1.5-0.5b: the train step counted under fake tensors (the
    # chunked path drive_train times), the prefill as drive_serve counted
    # it on the flash path it times
    t0 = time.perf_counter()
    cfg = (get_config if full else get_smoke_config)(TRAIN_ARCH)
    cfg = cfg.replace(remat="full", attn_impl="chunked")
    B, S = (TRAIN_BATCH, TRAIN_SEQ) if full else (2, 32)
    shape = ShapeSpec("drive_train", "train", S, B)
    n, n_act = dryrun.param_counts(cfg)
    lm = out["lm"] = {}
    train = report.get("train", {})
    serve = report.get("serve", {})
    cost = dryrun.analysis_cost(cfg, shape)
    mem = dryrun.memory_cost(cfg, shape)
    counts = [("train", shape.batch, shape.seq, "train",
               train.get("step_ms_median"),
               {"flops": cost["flops"], "flops_by_dtype":
                cost["flops_by_dtype"], "raw_bytes": cost["bytes"],
                "floor_bytes": cost["bytes_floor"]})]
    if "flash_prefill_count" in serve:
        pc = serve["flash_prefill_count"]
        counts.append(("prefill", *pc["tokens"], "prefill",
                       serve["flash"]["prefill_ms"][1], pc))
    for key, b, seq, kind, measured_ms, c in counts:
        terms = roofline_terms({"flops": c["flops"],
                                "flops_by_dtype": c["flops_by_dtype"],
                                "bytes accessed": c["raw_bytes"]},
                               CollectiveStats({}, {}, 0),
                               bytes_floor=c["floor_bytes"])
        mf = model_flops(n, n_act, b * seq, kind)
        row = lm[key] = {
            "shape": [b, seq], "model_flops": mf,
            "path": "chunked, fake tensors" if key == "train" else
            "flash, counted on the card",
            "counted_flops_by_dtype": c["flops_by_dtype"],
            "floor_bytes": c["floor_bytes"],
            "bound_ms": terms["step_time_bound_s"] * 1e3,
            "bound_by": terms["dominant"],
            "measured_ms": measured_ms, "card": out["card"]}
        if key == "train":
            row["peak_gb"] = mem["peak_bytes"] / 1e9
            row["memory_extrapolated"] = mem["memory_extrapolated"]
        if measured_ms:
            row[f"{key}_mfu"] = mf / (measured_ms / 1e3 * H100.peak())
            row["share_of_bound"] = row["bound_ms"] / measured_ms
        print(f"roofline qwen {key} {b} x {seq} ({row['path']}): model "
              f"{mf:.4e} FLOPs, counted {c['flops_by_dtype']}; bound "
              f"{row['bound_ms']:.1f} ms ({terms['dominant']})"
              + (f"; fake peak {row['peak_gb']:.2f} GB" if key == "train"
                 else "")
              + (f"; measured {measured_ms:.1f} ms: {key}_mfu "
                 f"{row[f'{key}_mfu']:.4f}, bound/measured "
                 f"{row['share_of_bound']:.3f} ({out['card']})"
                 if measured_ms else ""), flush=True)
    measured_gb = train.get("peak_memory_gb")
    if measured_gb:
        ratio = lm["train"]["peak_gb"] / measured_gb
        lm["train"]["peak_over_measured"] = ratio
        print(f"train peak: fake {lm['train']['peak_gb']:.2f} GB against "
              f"measured {measured_gb:.2f} GB: {ratio:.3f} (band "
              f"{TRAIN_PEAK_BAND})", flush=True)
        if not TRAIN_PEAK_BAND[0] <= ratio <= TRAIN_PEAK_BAND[1]:
            fail(f"the fake-mode train peak is {ratio:.3f} of the measured "
                 f"one, outside {TRAIN_PEAK_BAND}")
    lm["seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"roofline phase: {out['seconds']:.1f} s", flush=True)


def drive_lint(dev, N_t, N_d, N_m, report):
    """The plan linter: ``python -m repro_torch.analysis`` at the paper
    shape over every registered backend (on the card ``h100`` too) exits
    0; the ``h100`` matvec trace holds one node per kernel call (pad, the
    SBGEMV, unpad), the kernels' custom ops; the reference's seeded bad
    plan (an ``unpad`` that downgrades its output,
    ``tests/test_analysis.py``) makes the CLI exit nonzero."""
    from repro_torch import analysis
    from repro_torch.analysis import cli
    from repro_torch.core import ExecOpts, matvec_plan, pipeline
    from repro_torch.core.precision import DOUBLE
    out = report["lint"] = {}
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [] if dev.type == "cuda" else ["--smoke"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=900)
    tail = r.stdout.strip().splitlines()[-1:] or [r.stderr[-300:]]
    out.update(rc=r.returncode, summary=tail[0],
               sweep_seconds=time.perf_counter() - t0)
    print(f"lint sweep: rc {r.returncode}, {tail[0]} "
          f"({out['sweep_seconds']:.1f} s)", flush=True)
    if r.returncode != 0:
        fail(f"python -m repro_torch.analysis exited {r.returncode}:\n"
             f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
    if dev.type == "cuda":
        ctx = analysis.PlanContext.from_plan(
            matvec_plan(DOUBLE), ExecOpts(backend="h100"), N_t=N_t, N_d=N_d,
            N_m=N_m)
        kernels = [analysis.op_name(n) for n, _, _ in ctx.eqns()
                   if analysis.op_name(n).startswith("repro_torch.")]
        out["h100_matvec_kernel_nodes"] = kernels
        print(f"lint h100 ddddd matvec trace: kernel nodes {kernels}",
              flush=True)
        if kernels != ["repro_torch.pad_cast", "repro_torch.sbgemv_n_complex",
                       "repro_torch.unpad_cast"]:
            fail(f"the h100 matvec trace holds kernel nodes {kernels}")
    orig = pipeline._STAGE_IMPLS["unpad"]

    def degraded(stage, x, operands, N_t, S, opts):
        return orig(stage, x, operands, N_t, S, opts).to(torch.float32)

    pipeline._STAGE_IMPLS["unpad"] = degraded
    try:
        backend = "h100" if dev.type == "cuda" else "cpu-torch"
        rc = cli.main(["--backend", backend, "--config", "ddddd", "--plan",
                       "matvec", *args])
    finally:
        pipeline._STAGE_IMPLS["unpad"] = orig
    out["seeded_rc"] = rc
    print(f"lint seeded downgrade on {backend}: rc {rc}", flush=True)
    if rc == 0:
        fail("the seeded downgrading unpad linted clean")
    out["seconds"] = time.perf_counter() - t0


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
    # the real-A products
    "sbgemv_th_real": ("src/repro_torch/kernels/csrc/sbgemv.cu",
                       "src/repro/kernels/sbgemv.py:152", "float64"),
    "sbgemv_n_real": ("src/repro_torch/kernels/csrc/sbgemv.cu",
                      "src/repro/kernels/sbgemv.py:182", "float64"),
    "sbgemm_th_real": ("src/repro_torch/kernels/csrc/sbgemm.cu",
                       "src/repro/kernels/sbgemv.py:373",
                       f"float64 S={S_BLOCK}"),
    "sbgemm_n_real": ("src/repro_torch/kernels/csrc/sbgemm.cu",
                      "src/repro/kernels/sbgemv.py:404",
                      f"float64 S={S_BLOCK}"),
    "sbgemm_th_real_tiled": ("src/repro_torch/kernels/csrc/sbgemm.cu",
                             "src/repro/kernels/sbgemv.py:590",
                             f"float64 S={S_BLOCK} 2x2"),
    "sbgemm_n_real_tiled": ("src/repro_torch/kernels/csrc/sbgemm.cu",
                            "src/repro/kernels/sbgemv.py:624",
                            f"float64 S={S_BLOCK} 2x2"),
    # the LM serving path at the serve phase's longer prefill batch: bf16
    # heads of Dh 64 on the wgmma kernel, f32 (FULL_F32) on the f32 kernel;
    # the general bf16 kernel (other head dims, unaligned rows) runs on no
    # path of the serve phase and is timed through its C entry at the same
    # bf16 shape
    "flash_attention_bh": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                           "src/repro/kernels/flash_attention.py:70",
                           "bfloat16 serve"),
    "flash_attention_bh_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:70", "bfloat16 serve"),
    "flash_attention_bh_f32": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:70", "float32 serve"),
    # the data-space Gram of bf16 planes (the hhhhh G_hat) on wgmma
    "sbgemm_gram_complex_wgmma": ("src/repro_torch/kernels/csrc/sbgemm.cu",
                                  "src/repro/kernels/sbgemv.py:342",
                                  "bfloat16 data"),
}


def kernel_line(results, launches, other_phases):
    """The per-kernel JSON: top-level numbers at f64 (the paper's ddddd
    planes) at the main path's shape, every dtype and shape under
    ``by_dtype``.  ``launches`` is the count from the kernel's own path; a
    kernel that a phase of ``other_phases`` launched too has that phase's
    count under ``other_phase_launches``, never added in."""
    out = []
    for k, (src, rep, key) in REPLACES.items():
        top = results[k][key]
        entry = {"name": k, "route": "cuda", "source": src,
                 "replaces": rep, "launches": launches.get(k, 0),
                 "max_abs_err": top["max_abs_err"],
                 "ms": top["ms"], "plain_ms": top["plain_ms"],
                 "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                 "library_ms": top["library_ms"], "at": key,
                 "by_dtype": results[k]}
        other = {p: c[k] for p, c in other_phases.items() if c.get(k)}
        if other:
            entry["other_phase_launches"] = other
        out.append(entry)
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
    # whole 16-byte vectors in every row at every dtype pair (vector path)
    check_pad_kernels(dev, 7, 96, 200, False, results, time_fn)
    check_sbgemv_kernels(dev, 3, 3, 77, False, results, time_fn)
    check_sbgemv_kernels(dev, 2, 300, 50, False, results, time_fn)
    # the N kernel's vector path with a lane tail, and its element path on
    # planes that start one element in
    for shape in ((3, 5, 264), (2, 7, 1000)):
        for offset in (0, 1):
            check_sbgemv_kernels(dev, *shape, False, results, time_fn,
                                 offset)
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
    # the staged f64 kernels' edges: m and n around the 128-row items, odd n
    # (8-byte copies), n and m off the chunk widths (40 for N, 16 for T/H),
    # S across the 8/16/32 passes, P around the Gram's 64-tiles and its
    # 112-row bin
    check_sbgemm_kernels(dev, 3, 77, 133, (1, 8, 9, 32, 33), False, results,
                         time_fn)
    check_sbgemm_kernels(dev, 2, 129, 257, (8, 32), False, results, time_fn)
    for shape in ((3, 64, 31), (2, 65, 257), (2, 112, 66), (2, 113, 66),
                  (2, 129, 66), (2, 33, 129)):
        check_gram_kernel(dev, *shape, ("parameter", "data"), False, results,
                          time_fn)
    # the bf16 tensor-core kernels' and the staged f32 kernels' edges
    check_bf16_tensor_core_kernels(dev)
    check_f32_kernels(dev)
    check_wgmma_kernels(dev)
    # parameter-space G_hat at the paper shape is (1001, 5000, 5000) a
    # plane: only the data space is held there
    check_gram_kernel(dev, N_t + 1, N_d, N_m, ("data",), timed, results,
                      time_fn)
    free(dev)
    if timed and dev.type == "cuda":
        report["bound_probe"] = probe_bounds(dev, N_t + 1, N_d, N_m, time_fn)
        report["bound_probe"].update(probe_sbgemv_bounds(
            dev, N_t + 1, N_d, N_m, time_fn))
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
    check_tiled_kernels(dev, 3, 5, 264, (1,), "NTH", False, results, time_fn)
    check_tiled_kernels(dev, 2, 300, 50, (1, 9), "NTH", False, results,
                        time_fn)
    check_tiled_kernels(dev, 3, 77, 133, (8, 9, 32, 33), "NH", False, results,
                        time_fn)
    for shape in ((3, 7, 130), (2, 300, 50), (3, 70, 9), (2, 129, 66),
                  (2, 65, 257)):
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
    free(dev)
    # slice 4: the real-A products and the Fig. 1 sweep
    check_real_kernels(dev, 3, 7, 130, (1, 5, 33), False, results, time_fn)
    # odd n: the N kernel's element path at every dtype
    check_real_kernels(dev, 3, 5, 263, (1,), False, results, time_fn)
    check_real_kernels(dev, 2, 300, 50, (1, 9), False, results, time_fn)
    check_real_kernels(dev, 3, 77, 133, (8, 9, 32, 33), False, results,
                       time_fn)
    # the real SBGEMMs' layouts (slice 13): every edge against the plain
    # versions; the tiled builds at the bf16 N item and k-chunk, the f32 N
    # 3-row tile, a 40-row band past it and the T items (bf16 224, f32 256)
    check_real_gemm_kernels(dev)
    check_real_kernels(dev, 2, 113, 257, (1, 9, 17, 33), False, results,
                       time_fn)
    check_real_kernels(dev, 2, 24, 130, (8, 32), False, results, time_fn)
    check_real_kernels(dev, 2, 65, 225, (16, 40), False, results, time_fn)
    if dev.type == "cuda":
        report["real_dispatch_launches"] = check_real_dispatch_on_card(dev)
    check_real_kernels(dev, N_t + 1, N_d, N_m, (1, S_BLOCK, S_WIDE), timed,
                       results, time_fn)
    free(dev)
    if dev.type == "cuda":
        drive_fig1(dev, report)
    free(dev)
    # slice 5: the flash kernel and the LM serving path
    full = dev.type == "cuda"
    cfg, _, _, _, batch_lens = serve_plan(full)
    serve_shape = (4 * cfg.n_heads, batch_lens[1], batch_lens[1],
                   cfg.head_dim(), True)
    long_shape = (4 * cfg.n_heads, FLASH_LONG, FLASH_LONG, cfg.head_dim(),
                  True)
    check_flash_kernel(dev, FLASH_RAGGED, {}, results, time_fn)
    check_flash_entries(dev)
    check_flash_kernel(dev, (serve_shape, long_shape) if full else
                       (serve_shape,),
                       {serve_shape: "serve", long_shape: f"S={FLASH_LONG}"}
                       if timed else {}, results, time_fn)
    free(dev)
    if timed and dev.type == "cuda":
        report["bound_probe"].update(probe_flash_bounds(
            dev, (serve_shape, long_shape), time_fn))
        free(dev)
    drive_serve(dev, full, time_fn, report)
    free(dev)
    # slice 15: the solve server at the paper shape
    drive_solve_serve(dev, N_t, N_d, N_m, time_fn, report)
    free(dev)
    # slice 19: the operator on a process grid (one NCCL rank; gloo ranks
    # sharing the card)
    drive_mesh(dev, N_t, N_d, N_m, time_fn, report)
    free(dev)
    # slice 16: the MoE, SSM, hybrid and encoder-decoder families
    drive_families(dev, full, time_fn, report)
    # slice 17: the dispatch crossover, and training at full width
    drive_dispatch_calibration(dev, report)
    free(dev)
    drive_train(dev, full, time_fn, report)
    free(dev)
    # slice 18: the roofline and the dry run, the plan linter
    drive_roofline(dev, N_t, N_d, N_m, time_fn, report)
    free(dev)
    drive_lint(dev, N_t, N_d, N_m, report)
    if dev.type == "cuda":
        drive_dryrun(report)
    return results, report


STAGED = ("zgemm_f64_kernel", "zgram_f64_kernel", "zgemm_bf16_kernel",
          "zgram_bf16_kernel", "zgemm_f32_kernel", "zgemm_th_f32_kernel",
          "zgram_f32_kernel", "zgram_wgmma_kernel", "flash_wgmma_kernel",
          "flash_f32_kernel", "sbgemv_n_kernel")


def staged_ptxas(logs) -> dict:
    """Registers and spill bytes of each instantiation of the staged f64,
    the bf16 tensor-core and the f32 N kernels, from the ``ptxas -v``
    lines of the build logs (mangled names shortened to the kernel and its
    template arguments)."""
    out, cur = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line)
            if m:
                cur = next((k for k in STAGED if k in m.group(1)), None)
                name = m.group(1)
                continue
            if cur is None:
                continue
            key = f"{cur}[{name.split(cur, 1)[1].split('EEv')[0]}]"
            info = out.setdefault(key, {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                info["spill_stores"], info["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                info["registers"] = int(m.group(1))
    return {k: {"registers": v.get("registers"),
                "spill_stores": v.get("spill_stores", 0),
                "spill_loads": v.get("spill_loads", 0)} for k, v in out.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.backend import H100
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
    logs = _build.build(variants=[(src, d)
                                  for src in ("sbgemm", "sbgemm_real")
                                  for d in BOUND_PROBES.values()]
                        + [("flash_attention", d)
                           for d in FLASH_PROBES.values()]
                        + [("sbgemv", d) for d in SBGEMV_PROBES.values()])
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
    staged = staged_ptxas({k: v for k, v in logs.items()
                           if k in _build.SOURCES})
    for fn, info in staged.items():
        print(f"  {fn}: {info['registers']} registers, spill stores "
              f"{info['spill_stores']} B, spill loads {info['spill_loads']} B")

    def time_fn(fn, arg, repeats=REPEATS, warmup=3, mode="median"):
        return time_callable(fn, arg, repeats=repeats, warmup=warmup,
                             mode=mode)

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = PAPER_SINGLE
    results, report = run(dev, cfg.N_t, cfg.N_d, cfg.N_m, True, time_fn)
    report["peak_memory_gb"] = max(
        report.get("peak_memory_gb_before_autotune", 0.0),
        report.get("peak_memory_gb_before_serve", 0.0),
        report.get("peak_memory_gb_before_solve_serve", 0.0),
        report.get("peak_memory_gb_before_families", 0.0),
        *(f.get("peak_memory_gb", 0.0) for f in report["families"].values()),
        report["train"].get("peak_memory_gb", 0.0),
        torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"peak device memory {report['peak_memory_gb']:.2f} GB", flush=True)
    report["seconds"] = time.perf_counter() - t_start
    print(f"chip_smoke: every check passed in {report['seconds']:.1f} s "
          f"(build {build_s:.1f} s)", flush=True)
    # each kernel's launches on the main path that uses it
    launches = {**report["launches"],
                **{k: report["block"]["launches"][k]
                   for k in ("sbgemm_n_complex", "sbgemm_th_complex")},
                "sbgemm_gram_complex":
                    report["circulant"]["launches"]["sbgemm_gram_complex"],
                **{k: v for k, v in
                   report["tiled_configs"]["launches_total"].items()
                   if k.endswith("_tiled")},
                # the real kernels: the ops dispatch phase, which drives
                # all six; the Fig. 1 sweep's own counts are kept apart
                **{k: report["real_dispatch_launches"].get(k, 0)
                   for k in REPLACES if "_real" in k},
                # the wgmma Gram: the hhhhh G_hat setup
                "sbgemm_gram_complex_wgmma":
                    report["circulant"]["hhhhh"]["launches"]
                    ["sbgemm_gram_complex_wgmma"],
                # flash: the counted serve call (bf16, the wgmma kernel; the
                # general bf16 kernel 0) and its FULL_F32 check (f32, the
                # f32 kernel)
                **{k: report["serve"]["launches"].get(k, 0)
                   for k in ("flash_attention_bh_wgmma",
                             "flash_attention_bh")},
                "flash_attention_bh_f32": report["serve"]["full_f32_launches"]
                    .get("flash_attention_bh_f32", 0)}
    # the other serve paths' flash launches (slice 16) are kept apart too
    line = kernel_line(results, launches, {
        "fig1": report["fig1"]["launches"],
        **{f"serve {name}": f["launches"]
           for name, f in report["families"].items()}})

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_s": build_s,
         "staged_ptxas": staged,
         "hbm_bytes_per_s": H100.hbm_bandwidth,
         "peak_flops": dict(H100.peak_flops),
         "repeats": REPEATS, "kernels": line["kernels"], **report},
        indent=1))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
