"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  Libraries land in ``build/repro_torch_kernels/`` at the
root of the checkout, named by a hash of the source and the flags, so a
stale build is never loaded.  A missing ``nvcc`` or a failed build
raises: there is no fallback.

Every wrapper counts its launches in :data:`launch_counts`, so a run can
show that the main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

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
               "sbgemv_th_complex_tiled": (7, 3, 6)},
    "sbgemm": {"sbgemm_n_complex": (6, 4, 3), "sbgemm_th_complex": (6, 4, 4),
               "sbgemm_gram_complex": (4, 3, 4),
               "sbgemm_n_complex_tiled": (7, 4, 5),
               "sbgemm_th_complex_tiled": (7, 4, 6),
               "sbgemm_gram_tiled": (5, 3, 6)},
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


def reset_launch_counts() -> None:
    launch_counts.clear()


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


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: nvcc output}`` for the
    sources compiled by this call; raises if any build fails."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    logs, failed = {}, []
    for n, (p, tmp) in procs.items():
        logs[n] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use, with
    the argument types of its C entries declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)))
            for fn_name, counts in ENTRIES[name].items():
                _declare(getattr(lib, fn_name), *counts)
            _libs[name] = lib
        return lib



def _declare(fn, n_ptrs: int, n_sizes: int, n_ints: int) -> None:
    # every pointer and the stream as c_void_p: ctypes would otherwise pass
    # a Python int as a 32-bit int and cut the pointer
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int64] * n_sizes
                   + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, kernel: str) -> None:
    """Raise on the ``cudaGetLastError()`` a C entry returned."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {err}")
