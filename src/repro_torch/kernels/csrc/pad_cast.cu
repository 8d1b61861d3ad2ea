// Fused zero-pad + cast and unpad + cast (FFTMatvec Phases 1 and 5).
//
// Replaces the TPU kernels src/repro/kernels/pad_cast.py:pad_cast and
// :unpad_cast.  Both are pure memory operations: the bound is the bytes
// moved, each input element read once and each output element written
// once (pad: R*T*in + R*P*out; unpad: R*keep*(in + out)).  The design is
// the simplest one that streams at that bound: a block row per matrix
// row, one thread per output column, so neighbouring threads touch
// neighbouring addresses in both the load and the store, and no thread
// divides a flat index.  Columns >= T of the padded output are written as
// zeros without a load.  The input row stride is an argument, so a
// row-strided view needs no copy.  The TPU version padded rows to an
// 8-row block; here the grid covers the exact shape and masks its edge.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename I, typename O>
__global__ void pad_cast_kernel(const I* __restrict__ x, O* __restrict__ y,
                                int64_t R, int64_t T, int64_t P, int64_t ld) {
  for (int64_t r = blockIdx.y; r < R; r += gridDim.y) {
    const I* xr = x + r * ld;
    O* yr = y + r * P;
    for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < P;
         c += (int64_t)gridDim.x * blockDim.x) {
      yr[c] = c < T ? convert<O>(xr[c]) : Store<O>::from(0.0f);
    }
  }
}

template <typename I, typename O>
__global__ void unpad_cast_kernel(const I* __restrict__ x, O* __restrict__ y,
                                  int64_t R, int64_t keep, int64_t ld) {
  for (int64_t r = blockIdx.y; r < R; r += gridDim.y) {
    const I* xr = x + r * ld;
    O* yr = y + r * keep;
    for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < keep;
         c += (int64_t)gridDim.x * blockDim.x) {
      yr[c] = convert<O>(xr[c]);
    }
  }
}

// Column blocks cover the row (capped; the loops stride past the cap);
// row blocks up to the grid's y limit.
dim3 grid_for(int64_t R, int64_t cols) {
  int64_t bx = (cols + kThreads - 1) / kThreads;
  bx = bx < 1024 ? bx : 1024;
  int64_t by = R < 65535 ? R : 65535;
  return dim3((unsigned)bx, (unsigned)by);
}

}  // namespace

extern "C" {

// (R, T) rows of stride ld -> (R, P) contiguous, zero for columns >= T.
int pad_cast(const void* x, void* y, int64_t R, int64_t T, int64_t P, int64_t ld,
             int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (R == 0 || P == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dt_in, I, DISPATCH_DTYPE(dt_out, O,
    pad_cast_kernel<I, O><<<grid_for(R, P), kThreads, 0, s>>>(
        static_cast<const I*>(x), static_cast<O*>(y), R, T, P, ld);
  ))
  return (int)cudaGetLastError();
}

// (R, >= keep) rows of stride ld -> (R, keep) contiguous.
int unpad_cast(const void* x, void* y, int64_t R, int64_t keep, int64_t ld,
               int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (R == 0 || keep == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dt_in, I, DISPATCH_DTYPE(dt_out, O,
    unpad_cast_kernel<I, O><<<grid_for(R, keep), kThreads, 0, s>>>(
        static_cast<const I*>(x), static_cast<O*>(y), R, keep, ld);
  ))
  return (int)cudaGetLastError();
}

}  // extern "C"
