// Strided-batched complex GEMV on split re/im planes (FFTMatvec Phase 3).
//
// Replaces the TPU kernels src/repro/kernels/sbgemv.py:sbgemv_n_complex
// (y = A x, the forward F) and :sbgemv_th_complex (y = A^T x, or A^H x
// with conj, the adjoint F*).  A planes are (B, m, n) contiguous; at the
// paper shape B = 1001 bins, m = N_d = 100, n = N_m = 5000.
//
// Bound: bytes.  Each kernel does 8 flops per complex element of A, whose
// two planes it reads once: 0.5 flop per byte at f64, 2 at bf16, far
// under the card's flop/byte balance.  The designs therefore only have to
// read A once, coalesced, with enough loads in flight:
//
//   N (sum over the long n):  one warp per output row (b, i), 100,100
//     warps at the paper shape.  Lanes stride over n with coalesced loads
//     of A_re[b,i,:], A_im[b,i,:] and x[b,:]; each A element feeds both
//     output planes (the kernel's traffic win over four real GEMVs).  The
//     warp reduces with a fixed shuffle tree: no atomics, no cross-block
//     pass, so every row sums in the same order on every run.
//   T/H (sum over the short m):  one thread per output column j, blocks
//     tiling the long n axis: the paper's fix for the short-wide
//     conjugate transpose.  x[b, :] is staged in shared memory (in chunks
//     of the block size, so any m fits) and the loop over i runs in
//     order, with loads of A[b, i, j] coalesced along j.
//
// Sums run in double for f64 planes and in float for f32 and bf16 planes
// (the JAX kernels accumulate in f32); the output is stored in its dtype
// straight from the accumulator.  Offsets are int64: one f64 plane at the
// paper shape is 500.5 M elements (4.0 GB).  Ragged edges are masked in
// the kernels, so no call pads A (the TPU wrapper padded n to a block
// multiple on every call, a 4-8 GB copy per matvec at the paper shape).
//
// Tiled builds (TILED = true; sbgemv_*_complex_tiled, which replace the
// TPU kernels :sbgemm_n_complex_tiled and :sbgemm_th_complex_tiled for one
// right-hand side) round each A element through its tile-map cell's level
// as it is loaded (common.cuh: TileGrid), and are otherwise the same code,
// so on planes quantized up front they give the untiled build's bits.  T/H
// threads own a column, so they look the level up once a batch and skip
// the rounding in cells at the carrier's level; N lanes stride the columns
// and look it up per element.  The bytes are the untiled kernel's: A
// stays stored at the carrier type.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, typename O, bool TILED>
__global__ void __launch_bounds__(kThreads)
sbgemv_n_kernel(const T* __restrict__ Ar, const T* __restrict__ Ai,
                const T* __restrict__ xr, const T* __restrict__ xi,
                O* __restrict__ yr, O* __restrict__ yi,
                int64_t B, int64_t m, int64_t n, TileGrid tg) {
  using A = typename AccOf<T>::type;
  const int lane = threadIdx.x & 31;
  const int64_t rows = B * m;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += (int64_t)gridDim.x * kWarps) {
    const int64_t b = row / m;
    const T* ar = Ar + row * n;
    const T* ai = Ai + row * n;
    const T* vr = xr + b * n;
    const T* vi = xi + b * n;
    const uint32_t cells = TILED ? tile_row(tg, b) : 0u;
    A rr = 0, ii = 0, ri = 0, ir = 0;
#pragma unroll 4
    for (int64_t j = lane; j < n; j += 32) {
      A a_r = widen<A>(ar[j]), a_i = widen<A>(ai[j]);
      if (TILED) {
        const int lv = tile_level(tg, cells, j);
        a_r = quantize(a_r, lv);
        a_i = quantize(a_i, lv);
      }
      const A v_r = widen<A>(vr[j]), v_i = widen<A>(vi[j]);
      rr += a_r * v_r;
      ii += a_i * v_i;
      ri += a_i * v_r;
      ir += a_r * v_i;
    }
    A re = rr - ii, im = ir + ri;
    // the whole warp shares `row`, so every lane reaches the shuffles
    for (int off = 16; off > 0; off >>= 1) {
      re += __shfl_down_sync(0xffffffffu, re, off);
      im += __shfl_down_sync(0xffffffffu, im, off);
    }
    if (lane == 0) {
      yr[row] = Store<O>::from(re);
      yi[row] = Store<O>::from(im);
    }
  }
}

template <typename T, typename O, bool TILED>
__global__ void __launch_bounds__(kThreads)
sbgemv_th_kernel(const T* __restrict__ Ar, const T* __restrict__ Ai,
                 const T* __restrict__ xr, const T* __restrict__ xi,
                 O* __restrict__ yr, O* __restrict__ yi,
                 int64_t B, int64_t m, int64_t n, int conj, TileGrid tg) {
  using A = typename AccOf<T>::type;
  __shared__ A sxr[kThreads];
  __shared__ A sxi[kThreads];
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const T* ar = Ar + b * m * n + j;
    const T* ai = Ai + b * m * n + j;
    const int lv = TILED ? tile_level(tg, tile_row(tg, b), j) : 2;
    A rr = 0, ii = 0, ri = 0, ir = 0;
    for (int64_t i0 = 0; i0 < m; i0 += kThreads) {
      const int len = (int)(m - i0 < kThreads ? m - i0 : kThreads);
      __syncthreads();  // the previous chunk (or batch) is consumed
      if (threadIdx.x < len) {
        sxr[threadIdx.x] = widen<A>(xr[b * m + i0 + threadIdx.x]);
        sxi[threadIdx.x] = widen<A>(xi[b * m + i0 + threadIdx.x]);
      }
      __syncthreads();
      auto sweep = [&](auto q) {
#pragma unroll 4
        for (int k = 0; k < len; ++k) {
          const int64_t off = (i0 + k) * n;
          A a_r = widen<A>(ar[off]), a_i = widen<A>(ai[off]);
          if constexpr (decltype(q)::value) {
            a_r = quantize(a_r, lv);
            a_i = quantize(a_i, lv);
          }
          rr += a_r * sxr[k];
          ii += a_i * sxi[k];
          ri += a_i * sxr[k];
          ir += a_r * sxi[k];
        }
      };
      if (j < n) {
        if (TILED && rounds<A>(lv)) sweep(std::true_type{});
        else sweep(std::false_type{});
      }
    }
    if (j < n) {
      const A re = conj ? rr + ii : rr - ii;   // conj: Re(conj(A) x)
      const A im = conj ? ir - ri : ir + ri;
      yr[b * n + j] = Store<O>::from(re);
      yi[b * n + j] = Store<O>::from(im);
    }
  }
}

template <bool TILED>
int launch_n(const void* Ar, const void* Ai, const void* xr, const void* xi,
             void* yr, void* yi, int64_t B, int64_t m, int64_t n, const TileGrid& tg,
             int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || m == 0) return 0;
  int64_t blocks = (B * m + kWarps - 1) / kWarps;
  blocks = blocks < (1 << 20) ? blocks : (1 << 20);  // rows grid-stride past this
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dt_in, T, DISPATCH_DTYPE(dt_out, O,
    sbgemv_n_kernel<T, O, TILED><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(Ar), static_cast<const T*>(Ai),
        static_cast<const T*>(xr), static_cast<const T*>(xi),
        static_cast<O*>(yr), static_cast<O*>(yi), B, m, n, tg);
  ))
  return (int)cudaGetLastError();
}

template <bool TILED>
int launch_th(const void* Ar, const void* Ai, const void* xr, const void* xi,
              void* yr, void* yi, int64_t B, int64_t m, int64_t n, int conj,
              const TileGrid& tg, int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || n == 0) return 0;
  const int64_t bx = (n + kThreads - 1) / kThreads;
  if (bx > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)bx, (unsigned)(B < 65535 ? B : 65535));
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dt_in, T, DISPATCH_DTYPE(dt_out, O,
    sbgemv_th_kernel<T, O, TILED><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(Ar), static_cast<const T*>(Ai),
        static_cast<const T*>(xr), static_cast<const T*>(xi),
        static_cast<O*>(yr), static_cast<O*>(yi), B, m, n, conj, tg);
  ))
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, m) = A (B, m, n) x (B, n), split planes.
int sbgemv_n_complex(const void* Ar, const void* Ai, const void* xr, const void* xi,
                     void* yr, void* yi, int64_t B, int64_t m, int64_t n,
                     int dt_in, int dt_out, int device, void* stream) {
  return launch_n<false>(Ar, Ai, xr, xi, yr, yi, B, m, n, TileGrid{}, dt_in, dt_out,
                         device, stream);
}

// y (B, n) = A^T x, or A^H x when conj != 0; x is (B, m).
int sbgemv_th_complex(const void* Ar, const void* Ai, const void* xr, const void* xi,
                      void* yr, void* yi, int64_t B, int64_t m, int64_t n, int conj,
                      int dt_in, int dt_out, int device, void* stream) {
  return launch_th<false>(Ar, Ai, xr, xi, yr, yi, B, m, n, conj, TileGrid{}, dt_in,
                          dt_out, device, stream);
}

// sbgemv_n_complex with A rounded per tile-map cell: levels is a host array
// of R x C ladder indices, row-major.
int sbgemv_n_complex_tiled(const void* Ar, const void* Ai, const void* xr,
                           const void* xi, void* yr, void* yi, const int* levels,
                           int64_t B, int64_t m, int64_t n, int R, int C,
                           int dt_in, int dt_out, int device, void* stream) {
  TileGrid tg;
  const int err = make_tile_grid(levels, R, C, B, n, &tg);
  if (err) return err;
  return launch_n<true>(Ar, Ai, xr, xi, yr, yi, B, m, n, tg, dt_in, dt_out, device,
                        stream);
}

// sbgemv_th_complex with A rounded per tile-map cell (levels as above).
int sbgemv_th_complex_tiled(const void* Ar, const void* Ai, const void* xr,
                            const void* xi, void* yr, void* yi, const int* levels,
                            int64_t B, int64_t m, int64_t n, int conj, int R, int C,
                            int dt_in, int dt_out, int device, void* stream) {
  TileGrid tg;
  const int err = make_tile_grid(levels, R, C, B, n, &tg);
  if (err) return err;
  return launch_th<true>(Ar, Ai, xr, xi, yr, yi, B, m, n, conj, tg, dt_in, dt_out,
                         device, stream);
}

}  // extern "C"
