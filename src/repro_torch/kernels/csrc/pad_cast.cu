// Fused zero-pad + cast and unpad + cast (FFTMatvec Phases 1 and 5).
//
// Replaces the TPU kernels src/repro/kernels/pad_cast.py:pad_cast and
// :unpad_cast.  Both are pure memory operations: the bound is the bytes
// moved, each input element read once and each output element written
// once (pad: R*T*in + R*P*out; unpad: R*keep*(in + out)).  The input row
// stride is an argument, so a row-strided view needs no copy.  The TPU
// version padded rows to an 8-row block; here the loop covers the exact
// shape.
//
// One kernel serves both: it writes P output columns a row, of which the
// first T are loaded and cast and the rest are zeros (stored with no
// load); unpad_cast is the kernel with P == T.  One thread an element
// leaves a copy of this kind behind one PyTorch call, so it moves 16-byte
// vectors at the wider side's width (2 f64, 4 f32 or 8 bf16 elements; the
// narrower side moves 4 or 8 bytes) wherever both sides allow it (x and y
// 16-byte aligned at that width, ld, T and P multiples of the vector),
// else single elements in the same code.  The grid is at most 8 blocks an
// SM, and each thread walks a flat grid-stride loop over (row, vector)
// with 4 vectors in flight: loads first, then the casts and stores.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;     // vectors a thread loads before it stores

// VE elements a vector; pv = P / VE vectors an output row, of which the
// first tv = T / VE come from x; vector v at row v / pv, columns
// VE (v % pv) ..
template <typename I, typename O, int VE>
__global__ void __launch_bounds__(kThreads)
cast_rows_kernel(const I* __restrict__ x, O* __restrict__ y, int64_t R, int64_t T,
                int64_t P, int64_t ld) {
  using RI = typename Raw<VE * sizeof(I)>::T;
  using RO = typename Raw<VE * sizeof(O)>::T;
  const int64_t pv = P / VE, tv = T / VE, n = R * pv;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t dr = stride / pv, dc = stride % pv;      // the stride as (rows, vectors)
  int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t r = v / pv, c = v % pv;
  for (; v < n; v += kInFlight * stride) {
    RI in[kInFlight];
    int64_t dst[kInFlight];
    bool live[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      dst[u] = r * P + c * VE;
      live[u] = c < tv;
      if (live[u] && v + u * stride < n)
        in[u] = *reinterpret_cast<const RI*>(x + r * ld + c * VE);
      r += dr;
      c += dc;
      if (c >= pv) c -= pv, ++r;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (v + u * stride >= n) break;
      RO out{};                          // +0 in every dtype
      if (live[u]) {
        I e[VE];
        O f[VE];
        memcpy(e, &in[u], sizeof(RI));
#pragma unroll
        for (int w = 0; w < VE; ++w) f[w] = convert<O>(e[w]);
        memcpy(&out, f, sizeof(RO));
      }
      *reinterpret_cast<RO*>(y + dst[u]) = out;
    }
  }
}

// Vectors when both sides allow them, else single elements; at most 8
// blocks an SM.
template <typename I, typename O>
int launch(const void* x, void* y, int64_t R, int64_t T, int64_t P, int64_t ld,
           int device, cudaStream_t s) {
  constexpr int VE = 16 / (sizeof(I) > sizeof(O) ? sizeof(I) : sizeof(O));
  static int sms[64] = {};                 // SMs a device, read once
  int n_sm = device < 64 ? sms[device] : 0;
  if (n_sm == 0) {
    cudaError_t e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    if (device < 64) sms[device] = n_sm;
  }
  const bool vec = (uintptr_t)x % (VE * sizeof(I)) == 0 &&
                   (uintptr_t)y % (VE * sizeof(O)) == 0 && ld % VE == 0 &&
                   T % VE == 0 && P % VE == 0;
  const int ve = vec ? VE : 1;
  const int64_t per_block = (int64_t)kThreads * kInFlight;
  int64_t blocks = (R * (P / ve) + per_block - 1) / per_block;
  blocks = blocks < 8 * (int64_t)n_sm ? blocks : 8 * (int64_t)n_sm;
  const auto* xi = static_cast<const I*>(x);
  auto* yo = static_cast<O*>(y);
  if (vec)
    cast_rows_kernel<I, O, VE><<<(unsigned)blocks, kThreads, 0, s>>>(xi, yo, R, T, P, ld);
  else
    cast_rows_kernel<I, O, 1><<<(unsigned)blocks, kThreads, 0, s>>>(xi, yo, R, T, P, ld);
  return (int)cudaGetLastError();
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
    return launch<I, O>(x, y, R, T, P, ld, device, s);
  ))
  return (int)cudaErrorInvalidValue;
}

// (R, >= keep) rows of stride ld -> (R, keep) contiguous.
int unpad_cast(const void* x, void* y, int64_t R, int64_t keep, int64_t ld,
               int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (R == 0 || keep == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dt_in, I, DISPATCH_DTYPE(dt_out, O,
    return launch<I, O>(x, y, R, keep, keep, ld, device, s);
  ))
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
