"""Paper Figure 1: the short-wide (conjugate-)transpose SBGEMV, on the card;
the twin of ``benchmarks/fig1_sbgemv.py``.

The paper compares its rocBLAS kernel with the stock one by achieved
memory bandwidth over (m x n) skews and datatypes.  For each case this
times, at the paper's batch of 100:

  - the hand kernel through ``ops`` (``ops.sbgemv`` mode "H" for complex
    planes, ``ops.sbgemv_real`` mode "T" for real ones);
  - the stock pass: for complex data four independent real GEMVs (the
    reference's ``_split_pass``, each A plane read twice), for real data
    cuBLAS through ``torch.bmm`` on the transposed view;
  - for complex data, the library's complex ``torch.bmm`` on A^H.

Each path's GB/s is the bytes the function must move (A once, x and y)
over its time, and its share of HBM peak that rate over the card's 3.35
TB/s.  Each row also holds the kernel's max abs error against its plain
version (``kernels/sbgemv.py``).

    python -m repro_torch.examples.fig1_sbgemv                    # the card
    python -m repro_torch.examples.fig1_sbgemv --device cpu --smoke

On the card times are CUDA-event device times (median of 20 after 3
warm-ups).  On the CPU the example times with the host clock and says so;
those are CPU times, and no share of HBM peak is given for them.
"""

from __future__ import annotations

import argparse
import collections
import time

import torch

from repro_torch.backend import H100_HBM_BYTES_PER_S, default_device
from repro_torch.core.timing import time_callable
from repro_torch.kernels import _build, ops
from repro_torch.kernels import sbgemv as sk

# (m, n, dtype name): the reference's cases (paper: skews 1:64 .. 1:16,
# light and heavy datatypes), plus the paper shape at real f64
CASES = [
    (16, 4096, "c32"), (64, 4096, "c32"), (100, 5000, "c32"),
    (256, 4096, "c32"), (100, 5000, "c64"), (64, 4096, "r32"),
    (100, 5000, "r64"),
]
SMOKE_CASES = [(16, 512, "c32"), (16, 512, "r32")]
BATCH = 100                   # the paper's batch


def split_pass(Ar, Ai, xr, xi):
    """The stock complex pass: four independent real GEMVs, A^H x."""
    rr = torch.einsum("bmn,bm->bn", Ar, xr)
    ii = torch.einsum("bmn,bm->bn", Ai, xi)
    ri = torch.einsum("bmn,bm->bn", Ai, xr)
    ir = torch.einsum("bmn,bm->bn", Ar, xi)
    return rr + ii, ir - ri


def host_time_ms(fn, arg, repeats: int = 3) -> float:
    """Milliseconds per call on the host clock: the CPU's stand-in for the
    CUDA-event timer (a CPU time, not a device metric)."""
    fn(arg)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(arg)
    return (time.perf_counter() - t0) / repeats * 1e3


def run_case(dev, m: int, n: int, dname: str, time_ms, seed: int = 0) -> dict:
    """One case: the paths' times, GB/s and (on the card) share of HBM
    peak, the kernel's max abs error against its plain version, and the
    launches of its one checked call (``launches``; none on the CPU, where
    ``ops`` runs the plain version)."""
    dt = torch.float64 if dname.endswith("64") else torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                    dtype=dt)
    s = dt.itemsize
    if dname.startswith("r"):
        A, x = mk(BATCH, m, n), mk(BATCH, m)
        nbytes = s * BATCH * (m * n + m + n)
        kernel = lambda _: [ops.sbgemv_real(A, x, "T")]
        want = [sk.sbgemv_th_real_plain(A, x, dt)]
        At, xc = A.mT, x[..., None]
        paths = {"kernel": kernel,
                 "stock": lambda _: torch.bmm(At, xc)}
    else:
        Ar, Ai, xr, xi = mk(BATCH, m, n), mk(BATCH, m, n), mk(BATCH, m), \
            mk(BATCH, m)
        nbytes = 2 * s * BATCH * (m * n + m + n)
        kernel = lambda _: ops.sbgemv(Ar, Ai, xr, xi, "H")
        want = sk.sbgemv_th_complex_plain(Ar, Ai, xr, xi, True, dt)
        Ac, xc = torch.complex(Ar, Ai).mH, torch.complex(xr, xi)[..., None]
        paths = {"kernel": kernel,
                 "stock": lambda _: split_pass(Ar, Ai, xr, xi),
                 "library": lambda _: torch.bmm(Ac, xc)}
    before = collections.Counter(_build.launch_counts)
    got = kernel(None)
    launches = dict(_build.launch_counts - before)
    diff = [(g - w) for g, w in zip(got, want)]
    row = {"m": m, "n": n, "dtype": dname, "batch": BATCH, "bytes": nbytes,
           "launches": launches,
           "max_abs_err": max(d.abs().max().item() for d in diff),
           "rel_err": (sum(d.norm() ** 2 for d in diff)
                       / sum(w.norm() ** 2 for w in want)).sqrt().item()}
    del got, want, diff
    for name, fn in paths.items():
        ms = time_ms(fn, None)
        row[f"{name}_ms"] = ms
        row[f"{name}_gbps"] = nbytes / ms / 1e6
        if dev.type == "cuda":
            row[f"{name}_hbm_share"] = (nbytes / ms / 1e-3
                                         / H100_HBM_BYTES_PER_S)
    return row


def format_row(r: dict) -> str:
    cells = [f"{r['dtype']} {r['m']}:{r['n']}"]
    for name in ("kernel", "stock", "library"):
        if f"{name}_ms" not in r:
            cells.append(f"{name} -")
            continue
        share = r.get(f"{name}_hbm_share")
        cells.append(f"{name} {r[f'{name}_ms']:.4f} ms "
                     f"{r[f'{name}_gbps']:.1f} GB/s"
                     + (f" ({100 * share:.1f} % of HBM)" if share is not None
                        else ""))
    cells.append(f"kernel vs plain: max abs {r['max_abs_err']:.2e}, rel "
                 f"{r['rel_err']:.2e}; launches {r['launches']}")
    return " | ".join(cells)


def run(device=None, smoke: bool = False, verbose: bool = True) -> list:
    """The sweep on ``device`` (None: the card); returns one dict a case."""
    dev = default_device(device)
    time_ms = host_time_ms if dev.type == "cpu" else time_callable
    rows = []
    for i, (m, n, dname) in enumerate(SMOKE_CASES if smoke else CASES):
        rows.append(run_case(dev, m, n, dname, time_ms, seed=i))
        if verbose:
            print("fig1 " + format_row(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's two small smoke cases")
    args = ap.parse_args(argv)
    rows = run(args.device, args.smoke)
    if rows and "kernel_hbm_share" not in rows[0]:
        print("(times: host clock on the CPU, not device times)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
