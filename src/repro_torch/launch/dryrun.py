"""Dry run on one H100: count every (architecture x input shape) cell's
step, and the paper operator's, for the roofline analysis.

    python -m repro_torch.launch.dryrun --arch all --shape all \\
        --out chiprun_out/dryrun
    python -m repro_torch.launch.dryrun --arch fftmatvec --set precision=ddddd

Twin of ``src/repro/launch/dryrun.py``, which lowers and compiles each
cell with XLA against 256 or 512 placeholder TPU devices.  Eager PyTorch
compiles nothing, so here:

* **LM cells** (:func:`lower_lm_cell`) run the step (``api.
  make_train_step``, ``api.prefill_step``, ``api.decode_step``) under
  ``FakeTensorMode``: nothing is allocated, on a fake card device when
  there is a card (the card's code paths: its f32-output products), else
  on a fake CPU.  Attention is the config's default, ``chunked``, so no
  hand-written kernel runs.  :class:`~repro_torch.launch.roofline.
  OpCounter` counts the step.  The reference's per-step cost method is
  kept: the analysis overrides (:func:`_analysis_overrides`: chunks of
  seq/8, the SSM chunk caps) at 1 and 2 layers, extrapolated linearly
  (:func:`analysis_cost`; the hybrid's and the encoder-decoder's three
  runs).  Their counts are integers, so the extrapolation is exact
  wherever a layer's count does not depend on its index.
* **Memory**: argument and output bytes are exact, from the shapes; the
  peak is the most bytes of live (fake) storage across the step
  (:class:`LiveBytes`), run at the config's own chunk sizes.  Where a
  full-depth run would exceed ``FULL_DEPTH_OPS`` fake ops, the peak is
  extrapolated from the 1- and 2-layer runs the same way
  (``"memory_extrapolated": true``).  ``"fits_80gb"`` says whether the
  peak fits the card's 80 GB: one card cannot hold llama3-405b, and
  "does not fit" is a result, not an error.
* **FFTMatvec cells** (:func:`lower_fftmatvec_cell`): F and F* at
  ``PAPER_SINGLE`` run for real under the op counter, on the card through
  the hand-written kernels (they need real pointers), without a card
  through the plain lowering on the CPU at the size given.  p = 1, so
  weak scaling is the same shape.

A single card stands in for the reference's ``pod16x16`` mesh (mesh name
``h100x1``); ``--mesh multi`` and ``--mesh both`` wait for item 13b.
Records keep the reference's JSON keys and add the card's name and power
limit, as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, input_specs,
                                 shape_applicable)
from repro_torch.configs.fftmatvec_paper import PAPER_SINGLE
from repro_torch.core import FFTMatvec, PrecisionConfig
from repro_torch.core import precision as prec
from repro_torch.models import api
from repro_torch.optim import AdamW, constant_schedule

from .roofline import (CollectiveStats, OpCounter, _tensors, model_flops,
                       roofline_fraction, roofline_terms, useful_ratio)

MESH_NAME = "h100x1"          # one card: the reference's pod16x16 stand-in
CARD_BYTES = 80e9             # the H100's 80 GB of HBM3
FULL_DEPTH_OPS = 60_000       # ops a full-depth memory run may dispatch
_MULTI = ("multi-pod meshes wait for ROADMAP.md queue 1 item 13b "
          "(multi-GPU); the port runs on one card")


@functools.lru_cache(maxsize=None)
def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    ``"no card"``."""
    if not torch.cuda.is_available():
        return "no card"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def _check_mesh(mesh) -> None:
    if mesh not in (None, "single", MESH_NAME):
        raise NotImplementedError(_MULTI)


# ---------------------------------------------------------------------------
# Live bytes: the peak of a (fake) step
# ---------------------------------------------------------------------------

class LiveBytes(TorchDispatchMode):
    """Bytes of live storage across the ops run inside it: every storage
    an op returns counts from that op until it is freed (a weak reference
    to the storage sees it go); :meth:`track` adds storages that were
    alive before (parameters, state, inputs).  ``peak`` is the most at any
    time.  Works on fake tensors, whose storages are fake too."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.n_ops = 0
        self._refs: dict = {}

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key,
                                                             n))

    def _free(self, key, n, _ref) -> None:
        if self._refs.pop(key, None) is not None:
            self.live -= n

    def track(self, *trees) -> None:
        for t in _tensors(trees):
            self._add(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.n_ops += 1
        for t in _tensors(out):
            self._add(t)
        return out


def _nbytes(tree) -> int:
    """Bytes of the distinct tensors in ``tree`` (a tensor twice, or two
    handles of one view, count once)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        key = (t.untyped_storage()._cdata, t.storage_offset(),
               tuple(t.shape), tuple(t.stride()))
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


# ---------------------------------------------------------------------------
# One step under FakeTensorMode
# ---------------------------------------------------------------------------

def step_device() -> str:
    """The fake device the LM steps run on: the card's when there is one
    (its code paths), else the CPU's (a CPU-only torch cannot fake views
    of card tensors)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _fake_batch(cfg, shape, device) -> dict:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in input_specs(cfg, shape).items()}


def run_step(cfg, shape, *, device=None, opt_state_dtype="float32",
             count: bool = True, memory: bool = True) -> dict:
    """One step of ``shape.kind`` for ``cfg`` under ``FakeTensorMode``:
    with ``count`` its cost vector (FLOPs by dtype, raw and floor bytes,
    collectives), with ``memory`` its peak bytes; always the argument and
    output bytes and the ops dispatched (``n_ops``)."""
    device = device or step_device()
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = api.family_module(cfg).Model(cfg, device=device)
        batch = _fake_batch(cfg, shape, device)
        counter, live = OpCounter(), LiveBytes()
        modes = [m for m, on in ((live, memory), (counter, count)) if on]
        with contextlib.ExitStack() as stack:
            if shape.kind == "train":
                opt = AdamW(constant_schedule(1e-4),
                            state_dtype=opt_state_dtype)
                named = dict(model.named_parameters())
                state = {"params": model, "opt": opt.init(named),
                         # 0-d constants the host reads (the lr, the bias
                         # correction), as the real counts are
                         "step": torch.tensor(0, dtype=torch.int32)}
                state["opt"]["count"] = torch.tensor(0, dtype=torch.int32)
                args = (model, state["opt"]["mu"], state["opt"]["nu"], batch)
                step = api.make_train_step(cfg, opt)
                live.track(args)
                for m in modes:
                    stack.enter_context(m)
                state, metrics = step(state, batch)
                outs = (model, state["opt"]["mu"], state["opt"]["nu"],
                        metrics)
            else:
                stack.enter_context(torch.no_grad())
                if shape.kind == "prefill":
                    args = (model, batch)
                    live.track(args)
                    for m in modes:
                        stack.enter_context(m)
                    outs = api.prefill_step(cfg, model, batch, shape.seq)
                else:
                    dstate = api.init_decode_state(cfg, shape.batch,
                                                   shape.seq, device=device)
                    dstate["pos"] = shape.seq - 1         # a filled cache
                    args = (model, dstate, batch)
                    live.track(args)
                    for m in modes:
                        stack.enter_context(m)
                    outs = api.decode_step(cfg, model, dstate,
                                           batch["tokens"])
        counter.count_io(args, outs)
        arg_b, out_b = _nbytes(args), _nbytes(outs)
    coll = counter.collectives
    return {"flops": float(counter.flops),
            "flops_by_dtype": {k: float(v) for k, v
                               in counter.flops_by_dtype.items()},
            "bytes": float(counter.raw_bytes),
            "bytes_floor": float(counter.floor_bytes),
            "coll_bytes": float(coll.total_bytes),
            "coll_counts": dict(coll.counts),
            "coll_bytes_by_type": dict(coll.bytes_by_type),
            "peak_bytes": float(live.peak),
            "argument_bytes": float(arg_b), "output_bytes": float(out_b),
            "n_ops": float(max(live.n_ops, counter.n_ops))}


# ---------------------------------------------------------------------------
# The reference's extrapolation
# ---------------------------------------------------------------------------

_SCALARS = ("flops", "bytes", "bytes_floor", "coll_bytes", "peak_bytes",
            "argument_bytes", "output_bytes", "n_ops")
_DICTS = ("flops_by_dtype", "coll_counts", "coll_bytes_by_type")


def _combine(c0, deltas_and_mults):
    """c0 + sum_i mult_i * delta_i over the scalar fields + count dicts."""
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in c0.items()}
    for delta, mult in deltas_and_mults:
        for k in _SCALARS:
            out[k] += mult * delta[k]
        for dk in _DICTS:
            for t, v in delta[dk].items():
                out[dk][t] = out[dk].get(t, 0) + mult * v
    return out


def _diff(c2, c1):
    d = {k: c2[k] - c1[k] for k in _SCALARS}
    for dk in _DICTS:
        d[dk] = {t: c2[dk].get(t, 0) - c1[dk].get(t, 0)
                 for t in set(c2[dk]) | set(c1[dk])}
    return d


def _analysis_overrides(cfg, shape):
    """The reference's analysis knobs.  Attention chunks of seq/8:
    chunked attention's FLOPs do not depend on the chunking.  SSMs: their
    FLOPs do, so the chunk is capped as the reference caps it (Mamba-1 at
    32 chunks, the hybrid's SSD at 64)."""
    seq = shape.seq if shape.kind != "decode" else 1
    ov = dict(
        analysis_mode=True, scan_layers=False,
        attn_q_chunk=max(cfg.attn_q_chunk, shape.seq // 8),
        attn_kv_chunk=max(cfg.attn_kv_chunk, shape.seq // 8),
    )
    if cfg.mamba_version == 1 or cfg.family == "ssm":
        ov["ssm_chunk"] = max(cfg.ssm_chunk, seq // 32)
    elif cfg.family == "hybrid":
        ov["ssm_chunk"] = max(cfg.ssm_chunk, seq // 64)
    return ov


def extrapolate(run, cfg, shape, ov: dict):
    """A full-depth cost vector from reduced-layer runs of ``run(cfg,
    shape)`` (the reference's method): dense/moe/vlm/ssm ``c1 + (L-1)(c2 -
    c1)``; hybrid ``base + L mamba + n_shared shared``; enc-dec ``base +
    Le enc + Ld dec`` (no encoder at decode)."""
    if cfg.family == "hybrid":
        v0 = run(cfg.replace(n_layers=1, shared_attn_every=2, **ov), shape)
        v1 = run(cfg.replace(n_layers=2, shared_attn_every=3, **ov), shape)
        v2 = run(cfg.replace(n_layers=1, shared_attn_every=1, **ov), shape)
        n_shared = cfg.n_layers // cfg.shared_attn_every
        return _combine(v0, [(_diff(v1, v0), cfg.n_layers - 1),
                             (_diff(v2, v0), n_shared)])
    if cfg.family == "encdec":
        v0 = run(cfg.replace(n_layers=1, enc_layers=1, **ov), shape)
        v1 = run(cfg.replace(n_layers=1, enc_layers=2, **ov), shape)
        v2 = run(cfg.replace(n_layers=2, enc_layers=1, **ov), shape)
        enc_mult = 0 if shape.kind == "decode" else cfg.enc_layers - 1
        return _combine(v0, [(_diff(v1, v0), enc_mult),
                             (_diff(v2, v0), cfg.n_layers - 1)])
    v1 = run(cfg.replace(n_layers=1, **ov), shape)
    v2 = run(cfg.replace(n_layers=2, **ov), shape)
    return _combine(v1, [(_diff(v2, v1), cfg.n_layers - 1)])


def analysis_cost(arch_cfg, shape, mesh=None, *, fsdp="data",
                  opt_state_dtype="float32", device=None):
    """Per-step cost vector via reduced-layer runs at the analysis
    overrides."""
    _check_mesh(mesh)
    run = functools.partial(run_step, device=device,
                            opt_state_dtype=opt_state_dtype, memory=False)
    return extrapolate(run, arch_cfg, shape,
                       _analysis_overrides(arch_cfg, shape))


def memory_cost(cfg, shape, *, opt_state_dtype="float32", device=None,
                full_depth_ops: int = FULL_DEPTH_OPS) -> dict:
    """Argument, output and peak bytes of the step at the config's own
    chunk sizes: a full-depth fake run, or, where the 1-layer run's ops
    times the depth exceed ``full_depth_ops``, extrapolated from reduced
    layers (``memory_extrapolated``)."""
    runs: dict = {}

    def run(c, s):               # the 1-layer run serves both uses
        if c not in runs:
            runs[c] = run_step(c, s, device=device,
                               opt_state_dtype=opt_state_dtype, count=False)
        return runs[c]

    one = run(cfg.replace(n_layers=1), shape)
    depth = cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec" else 0)
    if one["n_ops"] * depth <= full_depth_ops:
        v, extrapolated = run(cfg, shape), False
    else:
        v, extrapolated = extrapolate(run, cfg, shape, {}), True
    return {"argument_bytes": v["argument_bytes"],
            "output_bytes": v["output_bytes"],
            "temp_bytes": max(0.0, v["peak_bytes"] - v["argument_bytes"]),
            "peak_bytes": v["peak_bytes"],
            "memory_extrapolated": extrapolated}


def _param_counts(cfg, model):
    named = dict(model.named_parameters())
    total = sum(p.numel() for p in named.values())
    active = total
    if cfg.n_experts and cfg.top_k:
        expert = sum(p.numel() for n, p in named.items()
                     if n.startswith("layers.")
                     and n.rsplit(".", 1)[-1] in ("wg", "wu", "wd"))
        active = total - expert + expert * cfg.top_k // cfg.n_experts
    return total, active


def param_counts(cfg, device=None):
    with FakeTensorMode():
        return _param_counts(cfg, api.family_module(cfg).Model(
            cfg, device=device or step_device()))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

SPECIAL_OVERRIDES = ("fsdp", "opt_state_dtype", "precision", "use_pallas")


def lower_lm_cell(arch: str, shape_name: str, mesh=None, *, overrides=None,
                  skip_analysis=False, device=None, cfg=None, shape=None):
    """One LM cell on one card: memory (the step at the config's own
    chunks), then the per-step cost (the analysis runs) and its roofline
    against the H100's peaks.  ``cfg`` and ``shape`` (a ``ShapeSpec``)
    stand in for the registered config and shape (smoke runs)."""
    _check_mesh(mesh)
    cfg = cfg if cfg is not None else get_config(arch)
    overrides = dict(overrides or {})
    special = {k: overrides.pop(k) for k in list(overrides)
               if k in SPECIAL_OVERRIDES}
    if special.get("fsdp", "data") not in (None, "none", "data"):
        raise NotImplementedError(_MULTI)
    osd = special.get("opt_state_dtype", "float32")
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape if shape is not None else SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"skipped": reason}
    n_devices = 1
    n_params, n_active = param_counts(cfg, device)
    tokens = (shape.batch * shape.seq if shape.kind in ("train", "prefill")
              else shape.batch)

    t0 = time.time()
    mem = memory_cost(cfg, shape, opt_state_dtype=osd, device=device)
    rec = {
        "memory": {k: mem[k] for k in ("argument_bytes", "output_bytes",
                                       "temp_bytes", "peak_bytes")},
        "memory_extrapolated": mem["memory_extrapolated"],
        "fits_80gb": mem["peak_bytes"] <= CARD_BYTES,
        "production_collectives": CollectiveStats({}, {}, 0).to_dict(),
        "compile_s": time.time() - t0,
        "n_devices": n_devices,
        "n_params": n_params,
        "n_active_params": n_active,
        "tokens_per_step": tokens,
        "step_device": device or step_device(),
        "card": card_info(),
    }
    if not skip_analysis:
        t1 = time.time()
        cost = analysis_cost(cfg, shape, mesh, opt_state_dtype=osd,
                             device=device)
        rec["analysis_compile_s"] = time.time() - t1
        coll = CollectiveStats(cost["coll_counts"], cost["coll_bytes_by_type"],
                               int(cost["coll_bytes"]))
        terms = roofline_terms({"flops": cost["flops"],
                                "flops_by_dtype": cost["flops_by_dtype"],
                                "bytes accessed": cost["bytes"]}, coll,
                               bytes_floor=cost["bytes_floor"])
        mf = model_flops(n_params, n_active, tokens, shape.kind)
        rec.update({
            "collectives": coll.to_dict(),
            "roofline": terms,
            "model_flops": mf,
            "useful_flop_ratio": useful_ratio(mf, terms["flops_per_device"],
                                              n_devices),
            "roofline_fraction": roofline_fraction(
                mf, terms["step_time_bound_s"], n_devices),
        })
    return rec


# ---------------------------------------------------------------------------
# FFTMatvec cells (the paper's own workload)
# ---------------------------------------------------------------------------

def fftmatvec_operator(dims, precision: str, device, seed: int = 0):
    """An operator at ``dims`` with seeded random F_hat planes stored at
    the config's gemv level (the Phase-0 FFT is setup, not the cell)."""
    cfgp = PrecisionConfig.from_string(precision)
    K = dims.N_t + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = prec.real_dtype(cfgp.gemv)
    planes = [torch.randn((K, dims.N_d, dims.N_m), generator=gen,
                          device=device, dtype=torch.float32).to(dt)
              for _ in range(2)]
    return FFTMatvec(planes[0], planes[1], dims.N_t, cfgp)


def lower_fftmatvec_cell(mesh=None, *, precision="sssss", adjoint=False,
                         weak_scale=True, use_pallas=False, dims=None,
                         device=None, op=None, time_fn=None, seed=0):
    """F (or F* with ``adjoint``) at ``dims`` (default ``PAPER_SINGLE``)
    run once under the op counter: on the card through the kernels,
    without one through the plain lowering on the CPU.  ``op`` reuses an
    operator; ``time_fn(fn, arg) -> ms`` adds the measured ms and the
    share, bound over measured.  p = 1: weak scaling is the same shape."""
    _check_mesh(mesh)
    fc = dims or PAPER_SINGLE
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    t0 = time.time()
    if op is None:
        op = fftmatvec_operator(fc, precision, device, seed)
    K = fc.N_t + 1
    rows = fc.N_d if adjoint else fc.N_m
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((rows, fc.N_t), generator=gen, device=device,
                    dtype=torch.float32).to(op.io_dtype)
    fn = op.rmatvec if adjoint else op.matvec
    fn(x)                                   # builds the kernels first
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    counter, live = OpCounter(), LiveBytes()
    args = (op.F_hat_re, op.F_hat_im, x)
    live.track(args)
    with live, counter:
        y = fn(x)
    counter.count_io(args, y)
    compile_s = time.time() - t0
    coll = counter.collectives
    terms = roofline_terms(counter.cost(), coll,
                           bytes_floor=counter.floor_bytes)
    mf = 8.0 * K * fc.N_d * fc.N_m     # complex block-diag matvec real flops
    arg_b, out_b = _nbytes(args), _nbytes(y)
    rec = {
        "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                   "temp_bytes": max(0, live.peak - arg_b),
                   "peak_bytes": live.peak},
        "collectives": coll.to_dict(),
        "roofline": terms,
        "model_flops": mf,
        "useful_flop_ratio": useful_ratio(mf, terms["flops_per_device"], 1),
        "roofline_fraction": roofline_fraction(
            mf, terms["step_time_bound_s"], 1),
        "n_devices": 1,
        "problem": {"N_t": fc.N_t, "N_d": fc.N_d, "N_m": fc.N_m,
                    "precision": op.precision.to_string(),
                    "adjoint": adjoint},
        "counts": counter.to_dict(),
        "compile_s": compile_s,
        "device": str(device),
        "card": card_info(),
    }
    if device.type == "cuda":
        rec["memory"]["device_peak_bytes"] = \
            torch.cuda.max_memory_allocated(device)
    if time_fn is not None:
        ms = time_fn(fn, x)
        rec["ms"] = ms
        rec["share"] = terms["step_time_bound_s"] * 1e3 / ms
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _format_record(rec, t0) -> str:
    if "skipped" in rec:
        return f"  SKIP: {rec['skipped']}"
    r = rec["roofline"]
    peak = rec["memory"]["peak_bytes"]
    return (f"  ok total={time.time() - t0:.0f}s "
            f"compute={r['compute_s'] * 1e3:.2f}ms "
            f"memory={r['memory_s'] * 1e3:.2f}ms "
            f"coll={r['collective_s'] * 1e3:.2f}ms "
            f"dom={r['dominant']} "
            f"useful={rec.get('useful_flop_ratio', 0):.2f} "
            f"peak={peak / 2 ** 30:.2f}GiB"
            + ("" if "fits_80gb" not in rec else
               f" fits_80gb={rec['fits_80gb']}"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all', or 'fftmatvec'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="chiprun_out/dryrun")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-analysis", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="LM cells: run this many cells at once, each in a "
                         "process of its own (host work only)")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        raise NotImplementedError(_MULTI)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    os.makedirs(args.out, exist_ok=True)
    print(f"card: {card_info()}", flush=True)
    cells = [(a, s) for arch in archs
             for a, s in ([("fftmatvec", "F"), ("fftmatvec", "Fstar")]
                          if arch == "fftmatvec"
                          else [(arch, s) for s in shapes])]
    run = functools.partial(_run_cell, out=args.out, tag=args.tag,
                            overrides=overrides,
                            skip_analysis=args.skip_analysis)
    lm = [c for c in cells if c[0] != "fftmatvec"]
    if args.jobs > 1 and len(lm) > 1:
        import concurrent.futures
        import multiprocessing
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            done = dict(zip(lm, pool.map(run, lm)))
    else:
        done = {}
    n_fail = 0
    for cell in cells:
        text, ok = done[cell] if cell in done else run(cell)
        print(text, flush=True)
        n_fail += not ok
    return 1 if n_fail else 0


def _run_cell(cell, *, out, tag, overrides, skip_analysis):
    """One cell of the CLI: its record written to ``out``; returns (the
    lines to print, whether it ended ok or skipped)."""
    a, s = cell
    name = f"{a}__{s}__{MESH_NAME}__{tag}"
    path = os.path.join(out, name + ".json")
    t0 = time.time()
    try:
        if a == "fftmatvec":
            rec = lower_fftmatvec_cell(
                precision=str(overrides.get("precision", "sssss")),
                adjoint=(s == "Fstar"))
        else:
            rec = lower_lm_cell(a, s, overrides=overrides,
                                skip_analysis=skip_analysis)
        rec["cell"] = {"arch": a, "shape": s, "mesh": MESH_NAME,
                       "tag": tag, "overrides": overrides}
        rec["seconds"] = time.time() - t0
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return f"=== {name} ===\n" + _format_record(rec, t0), True
    except Exception as e:
        with open(path, "w") as f:
            json.dump({"error": str(e), "traceback": traceback.format_exc(),
                       "cell": {"arch": a, "shape": s, "mesh": MESH_NAME}},
                      f, indent=1)
        return f"=== {name} ===\n  FAIL: {e}", False


if __name__ == "__main__":
    raise SystemExit(main())
