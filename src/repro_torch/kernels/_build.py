"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/repro_torch_kernels/`` at the
root of the checkout, named by a hash of the sources and the flags, so a
stale build is never loaded.  A missing ``nvcc`` or a failed build
raises: there is no fallback.

Every wrapper counts its launches in :data:`launch_counts`, so a run can
show that the main path went through the kernels, and reports each
launch's FLOPs and bytes to the active op counters
(``launch.roofline.OpCounter``, :data:`active_counters`).  Under a
dispatch mode or on fake tensors (:func:`traced`) the SBGEMV, SBGEMM and
pad/unpad entries run as custom ops (:func:`kernel_op`), so a
``FakeTensorMode`` run or a ``make_fx`` trace on card tensors holds one
node per kernel call with its input and output dtypes.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode as \
    _current_mode

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# build/ at the root of the checkout (src/repro_torch/kernels -> root)
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
# C entries per source (csrc/<source>.cu): (pointers, int64 sizes, ints),
# then the stream.  A tiled entry takes one more pointer, to a host array of
# tile-map levels, and the grid's R and C among its ints.
ENTRIES = {
    "pad_cast": {"pad_cast": (2, 4, 3), "unpad_cast": (2, 3, 3)},
    "sbgemv": {"sbgemv_n_complex": (6, 3, 3), "sbgemv_th_complex": (6, 3, 4),
               "sbgemv_n_complex_tiled": (7, 3, 5),
               "sbgemv_th_complex_tiled": (7, 3, 6),
               "sbgemv_n_real": (3, 3, 3), "sbgemv_th_real": (3, 3, 3)},
    "sbgemm": {"sbgemm_n_complex": (6, 4, 3), "sbgemm_th_complex": (6, 4, 4),
               "sbgemm_gram_complex": (4, 3, 4),
               "sbgemm_gram_complex_wgmma": (4, 3, 4),
               "sbgemm_n_complex_tiled": (7, 4, 5),
               "sbgemm_th_complex_tiled": (7, 4, 6),
               "sbgemm_gram_tiled": (5, 3, 6)},
    "sbgemm_real": {"sbgemm_n_real": (3, 4, 3), "sbgemm_th_real": (3, 4, 3),
                    "sbgemm_n_real_tiled": (4, 4, 5),
                    "sbgemm_th_real_tiled": (4, 4, 5)},
    # q, k, v, o; B, Hq, Hkv, Sq, Skv, Dh and (batch, head, row) strides of
    # each; causal, dtype, device
    "flash_attention": {"flash_attention_bh": (4, 18, 3),
                        "flash_attention_bh_wgmma": (4, 18, 3),
                        "flash_attention_bh_f32": (4, 18, 3)},
}
SOURCES = tuple(ENTRIES)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The C entries' dtype codes (csrc/common.cuh:DType).
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}

# One Python integer per kernel, bumped where the wrapper launches it.
launch_counts: collections.Counter = collections.Counter()

_libs: dict = {}
_lock = threading.Lock()


# Op counters (``launch.roofline.OpCounter``) that are counting.
active_counters: list = []


def reset_launch_counts() -> None:
    launch_counts.clear()


def report(kernel: str, flops: int, dtype, tensors, nbytes=None) -> None:
    """Report one call of ``kernel`` to the active op counters: ``flops``
    at ``dtype``'s peak, ``tensors`` (its inputs and outputs) moved, each
    byte once, or ``nbytes`` of them where the kernel reads only part."""
    for c in active_counters:
        c.add_kernel(kernel, flops, dtype, tensors, nbytes)


def traced(t) -> bool:
    """Whether a kernel call on ``t`` goes through its custom op (one node
    in a trace, a report to the op counters): under a dispatch mode
    (``FakeTensorMode``, ``make_fx``, an op counter) or on a fake tensor.
    Otherwise the wrapper launches straight away: the op's dispatch adds
    host time to every call, and an S = 1 ``matvec`` is host-bound."""
    return _current_mode() is not None or isinstance(t, FakeTensor)


def _tensors_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors_of(a)


def kernel_op(name: str, schema: str, launch, fake, flops, nbytes=None):
    """Register a kernel as the custom op ``repro_torch::<name>`` and
    return it.  ``launch(*args)`` runs it on CUDA tensors, ``fake(*args)``
    makes its outputs' shapes and dtypes, ``flops(*args)`` is its FLOP
    count and ``nbytes(*args)``, where given, the bytes it moves (else
    every input and output byte once).  Both implementations report to
    the active op counters, the FLOPs at the first tensor's dtype.  A
    wrapper calls the op only where :func:`traced` says so; the op's
    dispatch pops every mode before ``launch`` runs."""
    def reporting(fn):
        def run(*args):
            out = fn(*args)
            if active_counters:
                tensors = list(_tensors_of((args, out)))
                report(name, flops(*args), tensors[0].dtype, tensors,
                       nbytes and nbytes(*args))
            return out
        return run

    op = torch.library.custom_op(f"repro_torch::{name}", reporting(launch),
                                 mutates_args=(), device_types="cuda",
                                 schema=schema)
    op.register_fake(reporting(fake))
    return op


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and the csrc files it includes, transitively
    (``#include "..."``; sbgemm_real.cu includes sbgemm.cu)."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        f = todo.pop()
        if f not in seen:
            seen.append(f)
            todo += re.findall(r'^#include "([^"]+)"',
                               (CSRC / f).read_text(), re.M)
    return sorted(seen)


def _target(name: str, defines: tuple = ()) -> pathlib.Path:
    # the library's own sources only: an edit elsewhere rebuilds nothing here
    h = hashlib.sha256()
    for f in _sources(name):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(f"-D{d}" for d in defines)).encode())
    tag = "".join(f"_{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}_{h.hexdigest()[:16]}.so"


def _key(name: str, defines: tuple) -> str:
    return " ".join((name, *(f"-D{d}" for d in defines)))


def build(names=SOURCES, variants=()) -> dict:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together; ``variants``, (source, macros) pairs,
    are built beside them, each source compiled with those ``-D`` macros
    into a library of its own (measurement builds, which no wrapper loads).
    Returns ``{name: nvcc output}`` for the libraries compiled by this call
    (a variant under "<source> -D<macro> .."); raises if any build fails."""
    jobs = [(n, ()) for n in names] + [(n, tuple(d)) for n, d in variants]
    todo = [j for j in jobs if not _target(*j).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, defines in todo:
        tmp = _target(n, defines).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[_key(n, defines)] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, _target(n, defines))
    logs, failed = {}, []
    for k, (p, tmp, target) in procs.items():
        logs[k] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(k)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[k] for k in failed))
    return logs


def library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (compiled with the ``-D``
    macros ``defines``: a measurement build), built at first use, with the
    argument types of its C entries declared."""
    key = _key(name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build((), ((name, defines),))
            lib = ctypes.CDLL(str(_target(name, tuple(defines))))
            for fn_name, counts in ENTRIES[name].items():
                _declare(getattr(lib, fn_name), *counts)
            _libs[key] = lib
        return lib



def _declare(fn, n_ptrs: int, n_sizes: int, n_ints: int) -> None:
    # every pointer and the stream as c_void_p: ctypes would otherwise pass
    # a Python int as a 32-bit int and cut the pointer
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int64] * n_sizes
                   + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


# PyTorch's raw current-stream handle (CUDA builds): no Stream object is
# made, a few microseconds a call that small kernels would wait on
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, kernel: str) -> None:
    """Raise on the ``cudaGetLastError()`` a C entry returned."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
