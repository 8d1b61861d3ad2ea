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
//     warps at the paper shape.  A lane loads 16-byte vectors of
//     A_re[b,i,:], A_im[b,i,:] and x[b,:] (2 f64, 4 f32 or 8 bf16
//     elements), four warp-wide steps of each plane before it uses any:
//     128 bytes of A a lane in flight at every dtype, and each warp reads
//     2 KB of a plane's row at a time.  f64 planes keep two such buffers
//     and start the next four steps' loads before this step's products:
//     there the products (FP64 units, two elements a vector) leave a
//     warp's loads idle long enough to show in the build without products
//     (chip_smoke.py's bound probe); at f32 and bf16 a second buffer only
//     costs occupancy.  Each A element feeds both output planes (the
//     kernel's traffic win over four real GEMVs).  A lane sums its vectors
//     in order, then the warp reduces with a fixed shuffle tree: no
//     atomics, no cross-block pass, so every row sums in the same order on
//     every run.  The loop's last step masks the lanes past the row.
//     Planes whose starts or n leave no room for whole 16-byte vectors
//     take the element path: the same code on single elements.  Loads of
//     x[b, :] repeat for each of a bin's rows and the caches serve them;
//     a warp on several rows that share each x vector measured slower on
//     an H100 (PERF.md), since it splits the warp's bytes of A into
//     shorter runs.
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
// and look it up per element.  The bytes are the untiled kernel's: A stays
// stored at the carrier type.  At a bf16 carrier every cell's rounding is
// the identity, so the tiled builds of bf16 planes run the untiled kernels
// (kTiled), with no level lookups.
//
// Real builds (REAL = true; sbgemv_n_real and sbgemv_th_real, which
// replace the TPU kernels :sbgemv_n_real and :sbgemv_th_real) are the same
// kernels with the imaginary planes compiled away: one A plane, y = A x or
// A^T x.  Each A element then carries half the bytes and half the
// arithmetic; the T kernel unrolls twice as far to keep as many bytes in
// flight, the N kernel keeps its four vector steps (64 bytes a lane).
// Bound: bytes (2 flops per A element: 0.25 flop per byte at f64).  The
// real T kernel is the real short-wide case of the paper's Fig. 1.
#include <cstring>

#include "common.cuh"

namespace {

// Whether a tiled build of T planes rounds at all: not at a bf16 carrier.
template <typename T, bool TILED>
constexpr bool kTiled = TILED && !std::is_same<T, __nv_bfloat16>::value;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Warp-wide vector steps of a row that the N kernel loads before it uses
// any (see the head).
constexpr int kSteps = 4;

// VE elements a vector: 16 bytes (2 f64, 4 f32, 8 bf16), or 1 on the
// element path.  A warp owns row w = b * m + i; lane l takes its vectors
// l, l + 32, .., kSteps warp-wide steps loaded into a buffer before any is
// used.  Measurement build SBGEMV_N_NO_PRODUCTS folds each loaded word into
// the sums by XOR instead of multiplying: the loads alone.
template <typename T, typename O, bool TILED, bool REAL, int VE>
__global__ void __launch_bounds__(kThreads)
sbgemv_n_kernel(const T* __restrict__ Ar, const T* __restrict__ Ai,
                const T* __restrict__ xr, const T* __restrict__ xi,
                O* __restrict__ yr, O* __restrict__ yi,
                int64_t B, int64_t m, int64_t n, TileGrid tg) {
  using A = typename AccOf<T>::type;
  using V = typename Raw<VE * sizeof(T)>::T;
  const int lane = threadIdx.x & 31;
  const int64_t nv = n / VE;                       // vectors a row (n % VE == 0)
  for (int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); w < B * m;
       w += (int64_t)gridDim.x * kWarps) {
    const int64_t b = w / m;
    const V* ar = reinterpret_cast<const V*>(Ar + w * n);
    const V* ai = reinterpret_cast<const V*>(REAL ? Ar : Ai + w * n);   // REAL: Ai is null
    const V* vr = reinterpret_cast<const V*>(xr + b * n);
    const V* vi = reinterpret_cast<const V*>(REAL ? xr : xi + b * n);
    const uint32_t cells = TILED ? tile_row(tg, b) : 0u;
    A acc[4] = {};                                 // rr, ii, ri, ir
    struct Buf { V a_r[kSteps], a_i[kSteps], v_r[kSteps], v_i[kSteps]; };
    // kSteps warp-wide steps from vector j0, lanes past the row loading
    // nothing
    auto load = [&](Buf& f, int64_t j0) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int64_t j = j0 + 32 * s;
        if (j < nv) {
          f.v_r[s] = vr[j];
          if constexpr (!REAL) f.v_i[s] = vi[j];
          f.a_r[s] = ar[j];
          if constexpr (!REAL) f.a_i[s] = ai[j];
        }
      }
    };
    auto use = [&](const Buf& f, int64_t j0) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (j0 + 32 * s >= nv) break;
#ifdef SBGEMV_N_NO_PRODUCTS
        // measurement build: every loaded word folded in, no products
        constexpr int kWords = sizeof(V) >= 4 ? sizeof(V) / 4 : 1;
        uint32_t fold = 0;
        auto fold_in = [&](const V& raw) {
          uint32_t word[kWords] = {};
          memcpy(word, &raw, sizeof(V));
#pragma unroll
          for (int q = 0; q < kWords; ++q) fold ^= word[q];
        };
        fold_in(f.v_r[s]);
        if constexpr (!REAL) fold_in(f.v_i[s]);
        fold_in(f.a_r[s]);
        if constexpr (!REAL) fold_in(f.a_i[s]);
        acc[0] += (A)(fold & 1u);
#else
        T xe_r[VE], xe_i[VE], ae_r[VE], ae_i[VE];
        memcpy(xe_r, &f.v_r[s], sizeof(V));
        if constexpr (!REAL) memcpy(xe_i, &f.v_i[s], sizeof(V));
        memcpy(ae_r, &f.a_r[s], sizeof(V));
        if constexpr (!REAL) memcpy(ae_i, &f.a_i[s], sizeof(V));
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          const A x_r = widen<A>(xe_r[e]);
          const A x_i = REAL ? (A)0 : widen<A>(xe_i[e]);
          A a_re = widen<A>(ae_r[e]), a_im = 0;
          if constexpr (!REAL) a_im = widen<A>(ae_i[e]);
          if (TILED) {
            const int lv = tile_level(tg, cells, (j0 + 32 * s) * VE + e);
            a_re = quantize(a_re, lv);
            a_im = quantize(a_im, lv);
          }
          acc[0] += a_re * x_r;
          if constexpr (!REAL) {
            acc[1] += a_im * x_i;
            acc[2] += a_im * x_r;
            acc[3] += a_re * x_i;
          }
        }
#endif
      }
    };
    if constexpr (sizeof(T) == 8) {
      // f64: two buffers, the next steps' loads started before this step's
      // products (unrolled by two, so neither buffer is indexed at run time)
      Buf f0, f1;
      int64_t j0 = lane;
      load(f0, j0);
      while (j0 < nv) {
        load(f1, j0 + 32 * kSteps);
        use(f0, j0);
        j0 += 32 * kSteps;
        if (j0 >= nv) break;
        load(f0, j0 + 32 * kSteps);
        use(f1, j0);
        j0 += 32 * kSteps;
      }
    } else {
      for (int64_t j0 = lane; j0 < nv; j0 += 32 * kSteps) {
        Buf f;
        load(f, j0);
        use(f, j0);
      }
    }
    // the whole warp shares w, so every lane reaches the shuffles
    A re = REAL ? acc[0] : acc[0] - acc[1], im = acc[3] + acc[2];
    for (int off = 16; off > 0; off >>= 1) {
      re += __shfl_down_sync(0xffffffffu, re, off);
      if constexpr (!REAL) im += __shfl_down_sync(0xffffffffu, im, off);
    }
    if (lane == 0) {
      yr[w] = Store<O>::from(re);
      if constexpr (!REAL) yi[w] = Store<O>::from(im);
    }
  }
}

template <typename T, typename O, bool TILED, bool REAL>
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
    const T* ai = Ai + (REAL ? 0 : b * m * n + j);
    const int lv = TILED ? tile_level(tg, tile_row(tg, b), j) : 2;
    A rr = 0, ii = 0, ri = 0, ir = 0;
    for (int64_t i0 = 0; i0 < m; i0 += kThreads) {
      const int len = (int)(m - i0 < kThreads ? m - i0 : kThreads);
      __syncthreads();  // the previous chunk (or batch) is consumed
      if (threadIdx.x < len) {
        sxr[threadIdx.x] = widen<A>(xr[b * m + i0 + threadIdx.x]);
        if constexpr (!REAL) sxi[threadIdx.x] = widen<A>(xi[b * m + i0 + threadIdx.x]);
      }
      __syncthreads();
      auto sweep = [&](auto q) {
#pragma unroll (REAL ? 8 : 4)
        for (int k = 0; k < len; ++k) {
          const int64_t off = (i0 + k) * n;
          A a_r = widen<A>(ar[off]), a_i = 0;
          if constexpr (!REAL) a_i = widen<A>(ai[off]);
          if constexpr (decltype(q)::value) {
            a_r = quantize(a_r, lv);
            a_i = quantize(a_i, lv);
          }
          rr += a_r * sxr[k];
          if constexpr (!REAL) {
            ii += a_i * sxi[k];
            ri += a_i * sxr[k];
            ir += a_r * sxi[k];
          }
        }
      };
      if (j < n) {
        if (TILED && rounds<A>(lv)) sweep(std::true_type{});
        else sweep(std::false_type{});
      }
    }
    if (j < n) {
      if constexpr (REAL) {
        yr[b * n + j] = Store<O>::from(rr);
      } else {
        const A re = conj ? rr + ii : rr - ii;   // conj: Re(conj(A) x)
        const A im = conj ? ir - ri : ir + ri;
        yr[b * n + j] = Store<O>::from(re);
        yi[b * n + j] = Store<O>::from(im);
      }
    }
  }
}

// 16-byte vectors when every plane's start and n allow them, else the
// element path; a warp a row, rows grid-striding past 2^20 blocks.
template <typename T, typename O, bool TILED, bool REAL>
void launch_n_typed(const T* Ar, const T* Ai, const T* xr, const T* xi, O* yr, O* yi,
                    int64_t B, int64_t m, int64_t n, const TileGrid& tg, cudaStream_t s) {
  constexpr int VE = 16 / sizeof(T);
  auto aligned = [](const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; };
  const bool vec = n % VE == 0 && aligned(Ar) && aligned(Ai) && aligned(xr) && aligned(xi);
  int64_t blocks = (B * m + kWarps - 1) / kWarps;
  blocks = blocks < (1 << 20) ? blocks : (1 << 20);
  constexpr bool TL = kTiled<T, TILED>;
  if (vec)
    sbgemv_n_kernel<T, O, TL, REAL, VE><<<(unsigned)blocks, kThreads, 0, s>>>(
        Ar, Ai, xr, xi, yr, yi, B, m, n, tg);
  else
    sbgemv_n_kernel<T, O, TL, REAL, 1><<<(unsigned)blocks, kThreads, 0, s>>>(
        Ar, Ai, xr, xi, yr, yi, B, m, n, tg);
}

template <bool TILED, bool REAL>
int launch_n(const void* Ar, const void* Ai, const void* xr, const void* xi,
             void* yr, void* yi, int64_t B, int64_t m, int64_t n, const TileGrid& tg,
             int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || m == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dt_in, T, DISPATCH_DTYPE(dt_out, O,
    launch_n_typed<T, O, TILED, REAL>(
        static_cast<const T*>(Ar), static_cast<const T*>(Ai),
        static_cast<const T*>(xr), static_cast<const T*>(xi),
        static_cast<O*>(yr), static_cast<O*>(yi), B, m, n, tg, s);
  ))
  return (int)cudaGetLastError();
}

template <bool TILED, bool REAL>
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
    sbgemv_th_kernel<T, O, (kTiled<T, TILED>), REAL><<<grid, kThreads, 0, s>>>(
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
  return launch_n<false, false>(Ar, Ai, xr, xi, yr, yi, B, m, n, TileGrid{}, dt_in,
                                dt_out, device, stream);
}

// y (B, n) = A^T x, or A^H x when conj != 0; x is (B, m).
int sbgemv_th_complex(const void* Ar, const void* Ai, const void* xr, const void* xi,
                      void* yr, void* yi, int64_t B, int64_t m, int64_t n, int conj,
                      int dt_in, int dt_out, int device, void* stream) {
  return launch_th<false, false>(Ar, Ai, xr, xi, yr, yi, B, m, n, conj, TileGrid{},
                                 dt_in, dt_out, device, stream);
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
  return launch_n<true, false>(Ar, Ai, xr, xi, yr, yi, B, m, n, tg, dt_in, dt_out,
                               device, stream);
}

// sbgemv_th_complex with A rounded per tile-map cell (levels as above).
int sbgemv_th_complex_tiled(const void* Ar, const void* Ai, const void* xr,
                            const void* xi, void* yr, void* yi, const int* levels,
                            int64_t B, int64_t m, int64_t n, int conj, int R, int C,
                            int dt_in, int dt_out, int device, void* stream) {
  TileGrid tg;
  const int err = make_tile_grid(levels, R, C, B, n, &tg);
  if (err) return err;
  return launch_th<true, false>(Ar, Ai, xr, xi, yr, yi, B, m, n, conj, tg, dt_in,
                                dt_out, device, stream);
}

// y (B, m) = A (B, m, n) x (B, n), one real plane.
int sbgemv_n_real(const void* A, const void* x, void* y, int64_t B, int64_t m,
                  int64_t n, int dt_in, int dt_out, int device, void* stream) {
  return launch_n<false, true>(A, nullptr, x, nullptr, y, nullptr, B, m, n, TileGrid{},
                               dt_in, dt_out, device, stream);
}

// y (B, n) = A^T x, one real plane; x is (B, m).
int sbgemv_th_real(const void* A, const void* x, void* y, int64_t B, int64_t m,
                   int64_t n, int dt_in, int dt_out, int device, void* stream) {
  return launch_th<false, true>(A, nullptr, x, nullptr, y, nullptr, B, m, n, 0,
                                TileGrid{}, dt_in, dt_out, device, stream);
}

}  // extern "C"
