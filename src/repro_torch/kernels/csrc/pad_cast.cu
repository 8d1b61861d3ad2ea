// Fused zero-pad + cast and unpad + cast (FFTMatvec Phases 1 and 5).
//
// Replaces the TPU kernels src/repro/kernels/pad_cast.py:pad_cast and
// :unpad_cast.  Both are pure memory operations: the bound is the bytes
// moved, each input element read once and each output element written
// once (pad: R*T*in + R*P*out; unpad: R*keep*(in + out)).  The input row
// stride is an argument, so a row-strided view needs no copy.  The TPU
// version padded rows to an 8-row block; here the grid covers the exact
// shape and masks its edge.
//
// pad_cast, the simplest design that streams near that bound: a block row
// per matrix row, one thread per output column, so neighbouring threads
// touch neighbouring addresses in both the load and the store, and no
// thread divides a flat index.  Columns >= T of the padded output are
// written as zeros without a load.
//
// unpad_cast: one thread an element left it behind one PyTorch copy, so it
// moves 16-byte vectors at the wider side's width (2 f64, 4 f32 or 8 bf16
// elements; the narrower side moves 4 or 8 bytes) wherever both row starts
// allow it (x 16-byte aligned at that width, ld and keep multiples of the
// vector), else single elements.  The grid is a few waves of the SMs, and
// each thread walks a flat grid-stride loop over (row, vector) with 4
// vectors in flight: loads first, then the casts and stores.
#include <cstring>

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

// The raw type of B bytes, for vector loads and stores.
template <int B> struct Raw;
template <> struct Raw<2> { using T = unsigned short; };
template <> struct Raw<4> { using T = uint32_t; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

constexpr int kInFlight = 4;     // vectors a thread loads before it stores

// VE elements a vector; n = R (keep / VE) vectors, vector v at row v / kv,
// columns VE (v % kv) ..
template <typename I, typename O, int VE>
__global__ void __launch_bounds__(kThreads)
unpad_cast_kernel(const I* __restrict__ x, O* __restrict__ y, int64_t R, int64_t keep,
                  int64_t ld) {
  using RI = typename Raw<VE * sizeof(I)>::T;
  using RO = typename Raw<VE * sizeof(O)>::T;
  const int64_t kv = keep / VE, n = R * kv;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t dr = stride / kv, dc = stride % kv;      // the stride as (rows, vectors)
  int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t r = v / kv, c = v % kv;
  for (; v < n; v += kInFlight * stride) {
    RI in[kInFlight];
    int64_t dst[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      dst[u] = r * keep + c * VE;
      if (v + u * stride < n) in[u] = *reinterpret_cast<const RI*>(x + r * ld + c * VE);
      r += dr;
      c += dc;
      if (c >= kv) c -= kv, ++r;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (v + u * stride >= n) break;
      I e[VE];
      O f[VE];
      memcpy(e, &in[u], sizeof(RI));
#pragma unroll
      for (int w = 0; w < VE; ++w) f[w] = convert<O>(e[w]);
      RO out;
      memcpy(&out, f, sizeof(RO));
      *reinterpret_cast<RO*>(y + dst[u]) = out;
    }
  }
}

// Vectors when both sides' row starts allow them, else single elements;
// at most 8 blocks an SM.
template <typename I, typename O>
int launch_unpad(const void* x, void* y, int64_t R, int64_t keep, int64_t ld, int device,
                 cudaStream_t s) {
  constexpr int VE = 16 / (sizeof(I) > sizeof(O) ? sizeof(I) : sizeof(O));
  static int sms[64] = {};                 // SMs a device, read once
  int n_sm = device < 64 ? sms[device] : 0;
  if (n_sm == 0) {
    cudaError_t e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    if (device < 64) sms[device] = n_sm;
  }
  const bool vec = (uintptr_t)x % (VE * sizeof(I)) == 0 &&
                   (uintptr_t)y % (VE * sizeof(O)) == 0 && ld % VE == 0 && keep % VE == 0;
  const int ve = vec ? VE : 1;
  const int64_t per_block = (int64_t)kThreads * kInFlight;
  int64_t blocks = (R * (keep / ve) + per_block - 1) / per_block;
  blocks = blocks < 8 * (int64_t)n_sm ? blocks : 8 * (int64_t)n_sm;
  const auto* xi = static_cast<const I*>(x);
  auto* yo = static_cast<O*>(y);
  if (vec)
    unpad_cast_kernel<I, O, VE><<<(unsigned)blocks, kThreads, 0, s>>>(xi, yo, R, keep, ld);
  else
    unpad_cast_kernel<I, O, 1><<<(unsigned)blocks, kThreads, 0, s>>>(xi, yo, R, keep, ld);
  return (int)cudaGetLastError();
}

// pad_cast's grid: column blocks cover the row (capped; the loops stride
// past the cap); row blocks up to the grid's y limit.
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
    return launch_unpad<I, O>(x, y, R, keep, ld, device, s);
  ))
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
