// Strided-batched complex GEMM (S right-hand sides) and per-bin Gram blocks
// on split re/im planes: Phase 3 of matmat / rmatmat, of the exact Gram
// pipeline, and the circulant Gram setup.
//
// Replaces the TPU kernels src/repro/kernels/sbgemv.py:sbgemm_n_complex
// (Y = A X), :sbgemm_th_complex (Y = A^T X, or A^H X with conj) and
// :sbgemm_gram_complex (G = A^H A).  A planes are (B, m, n) contiguous; X
// and Y carry the right-hand-side axis last, (B, n|m, S).  At the paper
// shape B = 1001 bins, m = N_d = 100, n = N_m = 5000, S = 8 .. 32.
//
// f64 planes run on the FP64 tensor cores (67 TFLOP/s against 34 for the
// FP64 vector units): one kernel, zgemm_f64_kernel below, takes every
// product of this file through strides.  bf16 and f32 planes (f32 sums)
// run on the vector units, in the kernels described here.  Bounds and
// designs:
//
//   N (sum over the long n), bytes-bound at S = 8 (8 S flops per complex
//     A element: S flop per byte at f32, 2 S at bf16), the f32 product
//     turning compute-bound near S = 32.  The sbgemv_n design widened to
//     S columns: a warp owns two output rows of one bin and a pass of SC
//     columns; its lanes stride over n, so every A load is coalesced and
//     goes straight to registers, where it serves all SC columns.  The
//     block's eight warps share each chunk of X (2048 elements a plane),
//     staged in shared memory column by column, so lanes read consecutive
//     k without bank conflicts and one staged element serves two rows.
//     Each lane sums its k in order and the warp adds its lanes with a
//     fixed butterfly: no atomics, no cross-block pass, so every sum runs
//     in one order on every run.
//   T/H (sum over the short m): the paper's short-wide pathology with S
//     columns.  One thread per output column j, blocks tiling the long n
//     axis, as in sbgemv_th; the X panel (an m-chunk x SC columns) sits in
//     shared memory, read as broadcasts, and loads of A[b, i, j] are
//     coalesced along j.  Each A element is read once for all SC columns.
//   Gram G[p, q] = sum_k conj(U[k, p]) U[k, q], compute-bound (8 flops per
//     A element and output column).  U = A (parameter space, k over m) or
//     U = A^H (data space, k over n: the kernel reads A in its stored
//     layout, so no transposed copy of A is made).  A block computes a
//     64 x 64 output tile on or above the diagonal and writes the tile
//     below it as its conjugate (G is Hermitian), so half the off-diagonal
//     work is skipped.  Each k-chunk of both column panels is staged in
//     shared memory, the next chunk's loads in flight in registers while
//     this one is used; each thread accumulates a 4 x 4 register tile in k
//     order, its rows and columns 16 apart so the panel reads are
//     conflict-free.
//
// Columns come in passes of SC = 1, 8 or 16 for N and SC = 1, 8 or 32 for T/H
// (the smallest that holds S, at most 16 or 32; wider blocks loop over
// passes inside the kernel and read A once per pass).  Columns past S are
// zero in the staged panel and never stored.
// Sums run in double for f64 planes and in float otherwise; outputs are
// stored in their dtype straight from the accumulator.  Offsets are int64
// and ragged edges are masked in the kernels, so no call pads A.
//
// Tiled builds (TILED = true) replace the TPU kernels
// :sbgemm_n_complex_tiled, :sbgemm_th_complex_tiled and :sbgemm_gram_tiled:
// each A element is rounded through its tile-map cell's level as it is
// loaded (common.cuh: TileGrid), before any product (on the f64 path,
// before the fragment enters the mma.sync), and nothing else changes, so
// on planes quantized up front they give the untiled build's bits.  In the
// Gram both factors of a product are rounded at their own cells.  They
// move the untiled kernels' bytes: A stays stored at the carrier type.
//
// Real builds (REAL = true) replace the TPU kernels :sbgemm_n_real,
// :sbgemm_th_real, :sbgemm_n_real_tiled and :sbgemm_th_real_tiled: the
// same kernels with the imaginary planes compiled away (one A, X and Y
// plane; on the f64 path one DMMA a tile pair instead of four).  With one
// plane an A element carries 2 S flops: bytes-bound at every S here.  The
// tiled real builds take the TILED flag unchanged.  Their C entries are
// built from this file as a second library (sbgemm_real.cu defines
// SBGEMM_REAL_ENTRIES), so the complex and the real instantiations compile
// in parallel.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // T/H: threads of a block
constexpr int kPanel = 2048;    // T/H: staged X panel, elements per plane
constexpr int kNWarps = 8;      // N: warps of a block
constexpr int kNRows = 2;       // N: output rows of a warp
constexpr int kNStage = 2048;   // N: staged X chunk, elements per plane
constexpr int kTile = 64;       // Gram output tile (kTile x kTile)
constexpr int kMicro = 4;       // Gram register tile per thread (4 x 4)
constexpr int kChunk = 16;      // Gram contraction chunk staged a step
constexpr int kGramThreads = (kTile / kMicro) * (kTile / kMicro);
constexpr int kMmaWarps = 8;    // f64 tensor-core kernel: warps of a block

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <typename T, typename O, int SC, bool TILED, bool REAL>
__global__ void __launch_bounds__(kNWarps * 32)
sbgemm_n_kernel(const T* __restrict__ Ar, const T* __restrict__ Ai,
                const T* __restrict__ Xr, const T* __restrict__ Xi,
                O* __restrict__ Yr, O* __restrict__ Yi,
                int64_t B, int64_t m, int64_t n, int64_t S, TileGrid tg) {
  using A = typename AccOf<T>::type;
  constexpr int R = kNRows;
  constexpr int KC = kNStage / SC;          // k-chunk staged a step
  static_assert(KC % 32 == 0, "the lanes split a chunk evenly");
  // the X chunk column by column, so lanes read consecutive k; the pad
  // spreads the transposing stores over the banks
  __shared__ A sxr[SC][KC + 1];
  __shared__ A sxi[SC][KC + 1];
  __shared__ unsigned char slv[TILED ? KC : 1];   // the chunk's column levels
  const int lane = threadIdx.x & 31;
  const int64_t row0 = ((int64_t)blockIdx.x * kNWarps + (threadIdx.x >> 5)) * R;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const T* xr = Xr + b * n * S;
    const T* xi = Xi + (REAL ? 0 : b * n * S);  // REAL: Xi is null
    const uint32_t cells = TILED ? tile_row(tg, b) : 0u;
    for (int64_t s0 = 0; s0 < S; s0 += SC) {
      const int sc = (int)min64(SC, S - s0);
      A acc_r[R][SC], acc_i[R][SC];
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int s = 0; s < SC; ++s) acc_r[u][s] = acc_i[u][s] = 0;
      for (int64_t k0 = 0; k0 < n; k0 += KC) {
        __syncthreads();  // the previous chunk is consumed
        for (int e = threadIdx.x; e < KC * SC; e += kNWarps * 32) {
          const int kk = e / SC, s = e % SC;   // s fastest: coalesced reads
          const int64_t k = k0 + kk;
          A vr = 0, vi = 0;
          if (k < n && s < sc) {
            vr = widen<A>(xr[k * S + s0 + s]);
            if constexpr (!REAL) vi = widen<A>(xi[k * S + s0 + s]);
          }
          sxr[s][kk] = vr;
          if constexpr (!REAL) sxi[s][kk] = vi;
        }
        if (TILED)
          for (int e = threadIdx.x; e < KC; e += kNWarps * 32)
            slv[e] = (unsigned char)tile_level(tg, cells, k0 + e);
        __syncthreads();
        if (row0 >= m) continue;               // whole warp: no rows here
        // a constant trip count, so the loads of four steps are in flight
#pragma unroll 4
        for (int kk = lane; kk < KC; kk += 32) {
          const int64_t k = k0 + kk;
          A a_r[R], a_i[R];
          const int lv = TILED ? slv[kk] : 2;
#pragma unroll
          for (int u = 0; u < R; ++u) {
            a_r[u] = a_i[u] = 0;
            if (row0 + u < m && k < n) {
              const int64_t off = (b * m + row0 + u) * n + k;
              a_r[u] = widen<A>(Ar[off]);
              if constexpr (!REAL) a_i[u] = widen<A>(Ai[off]);
              if (TILED && rounds<A>(lv)) {
                a_r[u] = quantize(a_r[u], lv);
                a_i[u] = quantize(a_i[u], lv);
              }
            }
          }
#pragma unroll
          for (int s = 0; s < SC; ++s) {
            const A x_r = sxr[s][kk];
            if constexpr (REAL) {
#pragma unroll
              for (int u = 0; u < R; ++u) acc_r[u][s] += a_r[u] * x_r;
            } else {
              const A x_i = sxi[s][kk];
#pragma unroll
              for (int u = 0; u < R; ++u) {
                acc_r[u][s] += a_r[u] * x_r - a_i[u] * x_i;
                acc_i[u][s] += a_r[u] * x_i + a_i[u] * x_r;
              }
            }
          }
        }
      }
      if (row0 >= m) continue;
      // butterfly over the lanes: both lanes of a pair add the same two
      // operands, so every lane ends with the same total, bit for bit
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int s = 0; s < SC; ++s)
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            acc_r[u][s] += __shfl_xor_sync(0xffffffffu, acc_r[u][s], off);
            if constexpr (!REAL)
              acc_i[u][s] += __shfl_xor_sync(0xffffffffu, acc_i[u][s], off);
          }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (row0 + u >= m) continue;
        const int64_t out = (b * m + row0 + u) * S + s0;
#pragma unroll
        for (int s = 0; s < SC; ++s) {
          if (s == lane && s < sc) {          // lane s stores column s
            Yr[out + s] = Store<O>::from(acc_r[u][s]);
            if constexpr (!REAL) Yi[out + s] = Store<O>::from(acc_i[u][s]);
          }
        }
      }
    }
  }
}

template <typename T, typename O, int SC, bool TILED, bool REAL>
__global__ void __launch_bounds__(kThreads)
sbgemm_th_kernel(const T* __restrict__ Ar, const T* __restrict__ Ai,
                 const T* __restrict__ Xr, const T* __restrict__ Xi,
                 O* __restrict__ Yr, O* __restrict__ Yi,
                 int64_t B, int64_t m, int64_t n, int64_t S, int conj, TileGrid tg) {
  using A = typename AccOf<T>::type;
  constexpr int MC = kPanel / SC;           // m-chunk of a staged panel
  __shared__ A sxr[MC * SC];
  __shared__ A sxi[MC * SC];
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const A sgn = conj ? A(-1) : A(1);        // conj(A): negate Im(A)
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const T* ar = Ar + b * m * n + j;
    const T* ai = Ai + (REAL ? 0 : b * m * n + j);   // REAL: Ai, Xi are null
    const T* xr = Xr + b * m * S;
    const T* xi = Xi + (REAL ? 0 : b * m * S);
    const int lv = TILED ? tile_level(tg, tile_row(tg, b), j) : 2;
    for (int64_t s0 = 0; s0 < S; s0 += SC) {
      const int sc = (int)min64(SC, S - s0);
      A acc_r[SC], acc_i[SC];
#pragma unroll
      for (int s = 0; s < SC; ++s) acc_r[s] = acc_i[s] = 0;
      for (int64_t i0 = 0; i0 < m; i0 += MC) {
        const int len = (int)min64(MC, m - i0);
        __syncthreads();  // the previous panel is consumed
#pragma unroll
        for (int l = 0; l < MC * SC / kThreads; ++l) {
          const int e = threadIdx.x + l * kThreads;
          const int ii = e / SC, s = e % SC;
          A vr = 0, vi = 0;
          if (ii < len && s < sc) {
            const int64_t off = (i0 + ii) * S + s0 + s;
            vr = widen<A>(xr[off]);
            if constexpr (!REAL) vi = widen<A>(xi[off]);
          }
          sxr[e] = vr;
          if constexpr (!REAL) sxi[e] = vi;
        }
        __syncthreads();
        auto sweep = [&](auto q) {
          // four rows' loads in flight a step (eight with one plane)
#pragma unroll (REAL ? 8 : 4)
          for (int k = 0; k < len; ++k) {
            const int64_t off = (i0 + k) * n;
            A a_r = widen<A>(ar[off]), a_i = 0;
            if constexpr (!REAL) a_i = widen<A>(ai[off]);
            if constexpr (decltype(q)::value) {
              a_r = quantize(a_r, lv);
              a_i = quantize(a_i, lv);
            }
            a_i = sgn * a_i;
#pragma unroll
            for (int s = 0; s < SC; ++s) {
              const A x_r = sxr[k * SC + s];
              if constexpr (REAL) {
                acc_r[s] += a_r * x_r;
              } else {
                const A x_i = sxi[k * SC + s];
                acc_r[s] += a_r * x_r - a_i * x_i;
                acc_i[s] += a_r * x_i + a_i * x_r;
              }
            }
          }
        };
        if (j < n) {
          if (TILED && rounds<A>(lv)) sweep(std::true_type{});
          else sweep(std::false_type{});
        }
      }
      if (j < n) {
        O* yr = Yr + (b * n + j) * S + s0;
        O* yi = Yi + (REAL ? 0 : (b * n + j) * S + s0);
#pragma unroll
        for (int s = 0; s < SC; ++s) {
          if (s < sc) {
            yr[s] = Store<O>::from(acc_r[s]);
            if constexpr (!REAL) yi[s] = Store<O>::from(acc_i[s]);
          }
        }
      }
    }
  }
}

template <typename T, typename O, bool TILED>
__global__ void __launch_bounds__(kGramThreads)
sbgemm_gram_kernel(const T* __restrict__ Ar, const T* __restrict__ Ai,
                   O* __restrict__ Gr, O* __restrict__ Gi,
                   int64_t B, int64_t m, int64_t n, int data, TileGrid tg) {
  using A = typename AccOf<T>::type;
  constexpr int TD = kTile / kMicro;        // threads along each tile axis
  static_assert(TD * TD == kGramThreads, "one thread per register tile");
  // U[k, p] sits at k * sk + p * sp, its imaginary part times sgn
  const int64_t K = data ? n : m, P = data ? m : n;
  const int64_t sk = data ? 1 : n, sp = data ? n : 1;
  const A sgn = data ? A(-1) : A(1);
  constexpr int L = 2 * kChunk * kTile / kGramThreads;  // staged a thread
  // the lower tiles are the upper ones conjugated: only p0 <= q0 runs
  if (blockIdx.y > blockIdx.x) return;
  // [panel (p or q)][k][column], columns padded against bank conflicts
  __shared__ A sur[2][kChunk][kTile + 1];
  __shared__ A sui[2][kChunk][kTile + 1];
  const int tx = threadIdx.x % TD, ty = threadIdx.x / TD;
  const int64_t p0 = (int64_t)blockIdx.y * kTile, q0 = (int64_t)blockIdx.x * kTile;
  // element l of this thread's share of a chunk: panel, k and column, with
  // the unit-stride axis fastest so the loads coalesce
  auto slot = [&](int l, int& panel, int& kk, int& pp) {
    const int e = threadIdx.x + l * kGramThreads;
    const int r = e % (kChunk * kTile);
    panel = e / (kChunk * kTile);
    kk = sp == 1 ? r / kTile : r % kChunk;
    pp = sp == 1 ? r % kTile : r / kChunk;
  };
  for (int64_t b = blockIdx.z; b < B; b += gridDim.z) {
    const T* ar = Ar + b * m * n;
    const T* ai = Ai + b * m * n;
    const uint32_t cells = TILED ? tile_row(tg, b) : 0u;
    // the next chunk, loaded into registers while this one is used
    A nr[L], ni[L];
    auto fetch = [&](int64_t k0) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        int panel, kk, pp;
        slot(l, panel, kk, pp);
        const int64_t k = k0 + kk, p = (panel ? q0 : p0) + pp;
        nr[l] = ni[l] = 0;
        if (k < K && p < P) {
          A vr = widen<A>(ar[k * sk + p * sp]), vi = widen<A>(ai[k * sk + p * sp]);
          if (TILED) {                        // A's column: k (data) or p
            const int lv = tile_level(tg, cells, data ? k : p);
            if (rounds<A>(lv)) {
              vr = quantize(vr, lv);
              vi = quantize(vi, lv);
            }
          }
          nr[l] = vr;
          ni[l] = sgn * vi;
        }
      }
    };
    A gr[kMicro][kMicro], gi[kMicro][kMicro];
#pragma unroll
    for (int u = 0; u < kMicro; ++u)
#pragma unroll
      for (int v = 0; v < kMicro; ++v) gr[u][v] = gi[u][v] = 0;
    fetch(0);
    for (int64_t k0 = 0; k0 < K; k0 += kChunk) {
      __syncthreads();  // the previous chunk is consumed
#pragma unroll
      for (int l = 0; l < L; ++l) {
        int panel, kk, pp;
        slot(l, panel, kk, pp);
        sur[panel][kk][pp] = nr[l];
        sui[panel][kk][pp] = ni[l];
      }
      __syncthreads();
      if (k0 + kChunk < K) fetch(k0 + kChunk);
#pragma unroll 4
      for (int kk = 0; kk < kChunk; ++kk) {
        A ur[kMicro], ui[kMicro], vr[kMicro], vi[kMicro];
#pragma unroll
        for (int u = 0; u < kMicro; ++u) {
          ur[u] = sur[0][kk][ty + TD * u];
          ui[u] = sui[0][kk][ty + TD * u];
          vr[u] = sur[1][kk][tx + TD * u];
          vi[u] = sui[1][kk][tx + TD * u];
        }
#pragma unroll
        for (int u = 0; u < kMicro; ++u)
#pragma unroll
          for (int v = 0; v < kMicro; ++v) {
            // conj(U[k, p]) U[k, q] = (ur - i ui)(vr + i vi)
            gr[u][v] += ur[u] * vr[v] + ui[u] * vi[v];
            gi[u][v] += ur[u] * vi[v] - ui[u] * vr[v];
          }
      }
    }
    const bool mirror = blockIdx.x != blockIdx.y;
#pragma unroll
    for (int u = 0; u < kMicro; ++u) {
      const int64_t p = p0 + ty + TD * u;
      if (p >= P) continue;
#pragma unroll
      for (int v = 0; v < kMicro; ++v) {
        const int64_t q = q0 + tx + TD * v;
        if (q >= P) continue;
        Gr[(b * P + p) * P + q] = Store<O>::from(gr[u][v]);
        Gi[(b * P + p) * P + q] = Store<O>::from(gi[u][v]);
        if (mirror) {                           // G[q, p] = conj(G[p, q])
          Gr[(b * P + q) * P + p] = Store<O>::from(gr[u][v]);
          Gi[(b * P + q) * P + p] = Store<O>::from(-gi[u][v]);
        }
      }
    }
  }
}

// As DISPATCH_DTYPE, for the plane types of the vector-unit kernels (f64
// planes go to the tensor-core kernel).
#define DISPATCH_NARROW(code, T, ...)                               \
  switch (code) {                                                   \
    case DT_BF16: { using T = __nv_bfloat16; __VA_ARGS__ } break;   \
    case DT_F32: { using T = float; __VA_ARGS__ } break;            \
    default: return (int)cudaErrorInvalidValue;                     \
  }

// Run the statements in __VA_ARGS__ with SC bound to the column pass width
// for S right-hand sides: 1, 8, or 32 (wider blocks take passes of 32).
#define DISPATCH_PASS(S, SC, ...)                          \
  if ((S) <= 1) { constexpr int SC = 1; __VA_ARGS__ }      \
  else if ((S) <= 8) { constexpr int SC = 8; __VA_ARGS__ } \
  else { constexpr int SC = 32; __VA_ARGS__ }

// The same for the N kernel: passes of 1, 8 or 16 columns.
#define DISPATCH_N_PASS(S, SC, ...)                        \
  if ((S) <= 1) { constexpr int SC = 1; __VA_ARGS__ }      \
  else if ((S) <= 8) { constexpr int SC = 8; __VA_ARGS__ } \
  else { constexpr int SC = 16; __VA_ARGS__ }

unsigned batch_grid(int64_t B) { return (unsigned)(B < 65535 ? B : 65535); }

// ---------------------------------------------------------------------------
// f64 planes: one complex product on the FP64 tensor cores, bytes-bound
// for the SBGEMMs (S / 2 flop per byte, under the card's 20 up to
// S = 32) and compute-bound for the Gram.  C (M x N) per batch =
// opA (M x K) opB (K x N), each operand read through strides, so one
// kernel serves N (opA = A, opB = X), T/H (opA = A^T or A^H) and both
// Gram spaces.  A warp owns a (TM x 8) x (TN x 8) tile of C and walks K
// in steps of 4, each step four m8n8k4 DMMAs a pair of 8 x 8 tiles (the
// real products Re Re, -Im Im, Re Im, Im Re).  Fragments load straight
// from global memory, every load whole 32-byte sectors, with the K loop
// unrolled by four; the loads are what bound it (no shared-memory staging
// yet).  Each output sums its K products in one warp, in order: no
// atomics, no cross-warp pass.
// ---------------------------------------------------------------------------

// Element (b, r, c) of an operand at b * sb + r * sr + c * sc; its
// imaginary part is read times sgn (-1: the conjugate).  acol says which
// index is A's column when the operand is (a view of) A, for the tiled
// builds: 1 the first (r), 2 the second (c); 0 for X.
struct Operand {
  int64_t sb, sr, sc;
  double sgn;
  int acol;
};

// Round a loaded pair at level lv (2, the carrier's level: unchanged).
__device__ __forceinline__ void tile_round(int lv, double& vr, double& vi) {
  if (lv < 2) {
    vr = quantize(vr, lv);
    vi = quantize(vi, lv);
  }
}

// d += a b for one m8n8k4 f64 tile pair.  Fragments (PTX ISA, mma.m8n8k4
// .f64): lane l holds a = A[l / 4][l % 4], b = B[l % 4][l / 4] and
// d = D[l / 4][2 (l % 4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

template <typename O, int TM, int TN, bool TILED, bool REAL>
__global__ void __launch_bounds__(kMmaWarps * 32)
zgemm_f64_kernel(const double* __restrict__ Ar, const double* __restrict__ Ai,
                 const double* __restrict__ Br, const double* __restrict__ Bi,
                 O* __restrict__ Cr, O* __restrict__ Ci,
                 int64_t B, int64_t M, int64_t N, int64_t K, Operand a,
                 Operand b, int64_t c_sb, int64_t c_sr, int herm, TileGrid tg) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t RT = (M + 8 * TM - 1) / (8 * TM), CT = (N + 8 * TN - 1) / (8 * TN);
  // consecutive warps take consecutive row tiles of one column tile, so a
  // block's warps read the same opB fragments (cache hits)
  const int64_t w = (int64_t)blockIdx.x * kMmaWarps + (threadIdx.x >> 5);
  if (w >= RT * CT) return;                  // whole warp
  const int64_t rt = w % RT, ct = w / RT;
  // Hermitian C: only tiles on and above the diagonal run (TM == TN)
  if (herm && rt > ct) return;
  const int64_t r0 = rt * 8 * TM, c0 = ct * 8 * TN;
  for (int64_t bb = blockIdx.y; bb < B; bb += gridDim.y) {
    const double* ar = Ar + bb * a.sb;
    const double* ai = Ai + (REAL ? 0 : bb * a.sb);   // REAL: Ai, Bi are null
    const double* br = Br + bb * b.sb;
    const double* bi = Bi + (REAL ? 0 : bb * b.sb);
    // tiled: the levels of the fragment rows (opA) and columns (opB) that
    // are A's column, fixed over k, 2 bits each; a k column's is looked up
    // once a step
    const uint32_t cells = TILED ? tile_row(tg, bb) : 0u;
    uint32_t lv_a = 0, lv_b = 0;
    if (TILED) {
#pragma unroll
      for (int u = 0; u < TM; ++u)
        lv_a |= (uint32_t)(a.acol == 1 ? tile_level(tg, cells, r0 + u * 8 + g) : 2)
                << (2 * u);
#pragma unroll
      for (int v = 0; v < TN; ++v)
        lv_b |= (uint32_t)(b.acol == 2 ? tile_level(tg, cells, c0 + v * 8 + g) : 2)
                << (2 * v);
    }
    double cre[TM][TN][2], cim[TM][TN][2];
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v)
        cre[u][v][0] = cre[u][v][1] = cim[u][v][0] = cim[u][v][1] = 0;
#pragma unroll 4
    for (int64_t k0 = 0; k0 < K; k0 += 4) {
      const int64_t k = k0 + t;
      const int lv_k = TILED && (a.acol == 2 || b.acol == 1) && k < K
                           ? tile_level(tg, cells, k) : 2;
      double fa_r[TM], fa_i[TM], fb_r[TN], fb_i[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        const int64_t r = r0 + u * 8 + g;
        fa_r[u] = fa_i[u] = 0;
        if (r < M && k < K) {
          fa_r[u] = ar[r * a.sr + k * a.sc];
          if constexpr (!REAL) fa_i[u] = ai[r * a.sr + k * a.sc];
          if (TILED)
            tile_round(a.acol == 2 ? lv_k : (int)(lv_a >> (2 * u)) & 3, fa_r[u], fa_i[u]);
          fa_i[u] *= a.sgn;
        }
      }
#pragma unroll
      for (int v = 0; v < TN; ++v) {
        const int64_t c = c0 + v * 8 + g;
        fb_r[v] = fb_i[v] = 0;
        if (c < N && k < K) {
          fb_r[v] = br[k * b.sr + c * b.sc];
          if constexpr (!REAL) fb_i[v] = bi[k * b.sr + c * b.sc];
          if (TILED)
            tile_round(b.acol == 1 ? lv_k : (int)(lv_b >> (2 * v)) & 3, fb_r[v], fb_i[v]);
          fb_i[v] *= b.sgn;
        }
      }
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) {
          dmma(cre[u][v], fa_r[u], fb_r[v]);
          if constexpr (!REAL) {
            dmma(cre[u][v], -fa_i[u], fb_i[v]);
            dmma(cim[u][v], fa_r[u], fb_i[v]);
            dmma(cim[u][v], fa_i[u], fb_r[v]);
          }
        }
    }
    const bool mirror = herm && rt != ct;
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int64_t r = r0 + u * 8 + g;
      if (r >= M) continue;
#pragma unroll
      for (int v = 0; v < TN; ++v)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t c = c0 + v * 8 + 2 * t + h;
          if (c >= N) continue;
          Cr[bb * c_sb + r * c_sr + c] = Store<O>::from(cre[u][v][h]);
          if constexpr (!REAL)
            Ci[bb * c_sb + r * c_sr + c] = Store<O>::from(cim[u][v][h]);
          if (mirror) {                        // C[c, r] = conj(C[r, c])
            Cr[bb * c_sb + c * c_sr + r] = Store<O>::from(cre[u][v][h]);
            if constexpr (!REAL)
              Ci[bb * c_sb + c * c_sr + r] = Store<O>::from(-cim[u][v][h]);
          }
        }
    }
  }
}

// Launch the f64 tensor-core product: warp tiles of 16 x 8 (N <= 8) or
// 16 x 32 columns for the GEMMs, 32 x 32 for the Hermitian Gram.
template <typename O, bool TILED, bool REAL>
int launch_zgemm_f64(const void* Ar, const void* Ai, const void* Br, const void* Bi,
                     void* Cr, void* Ci, int64_t B, int64_t M, int64_t N, int64_t K,
                     Operand a, Operand b, int64_t c_sb, int64_t c_sr, int herm,
                     const TileGrid& tg, cudaStream_t s) {
  auto go = [&](auto kernel, int tm, int tn) {
    const int64_t tiles = ((M + 8 * tm - 1) / (8 * tm)) * ((N + 8 * tn - 1) / (8 * tn));
    const int64_t bx = (tiles + kMmaWarps - 1) / kMmaWarps;
    if (bx > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    kernel<<<dim3((unsigned)bx, batch_grid(B)), kMmaWarps * 32, 0, s>>>(
        static_cast<const double*>(Ar), static_cast<const double*>(Ai),
        static_cast<const double*>(Br), static_cast<const double*>(Bi),
        static_cast<O*>(Cr), static_cast<O*>(Ci), B, M, N, K, a, b, c_sb, c_sr,
        herm, tg);
    return (int)cudaGetLastError();
  };
  if constexpr (!REAL)        // the real products are never Hermitian
    if (herm) return go(zgemm_f64_kernel<O, 4, 4, TILED, REAL>, 4, 4);
  if (N <= 8) return go(zgemm_f64_kernel<O, 2, 1, TILED, REAL>, 2, 1);
  return go(zgemm_f64_kernel<O, 2, 4, TILED, REAL>, 2, 4);
}

// Y (B, m, S) = A (B, m, n) X (B, n, S); REAL: the planes Ar, Xr, Yr only.
template <bool TILED, bool REAL>
int launch_n(const void* Ar, const void* Ai, const void* Xr, const void* Xi, void* Yr,
             void* Yi, int64_t B, int64_t m, int64_t n, int64_t S, const TileGrid& tg,
             int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || m == 0 || S == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dt_in == DT_F64) {                     // opA = A, opB = X
    DISPATCH_DTYPE(dt_out, O,
      return launch_zgemm_f64<O, TILED, REAL>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, S, n,
                                              Operand{m * n, n, 1, 1.0, 2},
                                              Operand{n * S, S, 1, 1.0, 0},
                                              m * S, S, 0, tg, s);
    )
  }
  const int64_t rows = kNWarps * kNRows;     // output rows of a block
  const int64_t bx = (m + rows - 1) / rows;
  if (bx > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)bx, batch_grid(B));
  DISPATCH_NARROW(dt_in, T, DISPATCH_DTYPE(dt_out, O, DISPATCH_N_PASS(S, SC,
    sbgemm_n_kernel<T, O, SC, TILED, REAL><<<grid, kNWarps * 32, 0, s>>>(
        static_cast<const T*>(Ar), static_cast<const T*>(Ai),
        static_cast<const T*>(Xr), static_cast<const T*>(Xi),
        static_cast<O*>(Yr), static_cast<O*>(Yi), B, m, n, S, tg);
  )))
  return (int)cudaGetLastError();
}

// Y (B, n, S) = A^T X, or A^H X when conj != 0; X is (B, m, S).
template <bool TILED, bool REAL>
int launch_th(const void* Ar, const void* Ai, const void* Xr, const void* Xi, void* Yr,
              void* Yi, int64_t B, int64_t m, int64_t n, int64_t S, int conj,
              const TileGrid& tg, int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || n == 0 || S == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dt_in == DT_F64) {                     // opA = A^T (conj: A^H), opB = X
    DISPATCH_DTYPE(dt_out, O,
      return launch_zgemm_f64<O, TILED, REAL>(Ar, Ai, Xr, Xi, Yr, Yi, B, n, S, m,
                                              Operand{m * n, 1, n, conj ? -1.0 : 1.0, 1},
                                              Operand{m * S, S, 1, 1.0, 0}, n * S, S, 0,
                                              tg, s);
    )
  }
  const int64_t bx = (n + kThreads - 1) / kThreads;
  if (bx > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)bx, batch_grid(B));
  DISPATCH_NARROW(dt_in, T, DISPATCH_DTYPE(dt_out, O, DISPATCH_PASS(S, SC,
    sbgemm_th_kernel<T, O, SC, TILED, REAL><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(Ar), static_cast<const T*>(Ai),
        static_cast<const T*>(Xr), static_cast<const T*>(Xi),
        static_cast<O*>(Yr), static_cast<O*>(Yi), B, m, n, S, conj, tg);
  )))
  return (int)cudaGetLastError();
}

// G = A^H A, (B, n, n), or with data != 0 G = A A^H, (B, m, m).  The tiles
// below the diagonal are the conjugates of those above; the diagonal tiles
// are not symmetrized (the wrapper does that).
template <bool TILED>
int launch_gram(const void* Ar, const void* Ai, void* Gr, void* Gi, int64_t B,
                int64_t m, int64_t n, int data, const TileGrid& tg, int dt_in,
                int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int64_t P = data ? m : n;
  if (B == 0 || P == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dt_in == DT_F64) {
    // parameter: opA[p][i] = conj(A[i, p]), opB[i][q] = A[i, q];
    // data: opA[p][j] = A[p, j], opB[j][q] = conj(A[q, j])
    const Operand a = data ? Operand{m * n, n, 1, 1.0, 2}
                           : Operand{m * n, 1, n, -1.0, 1};
    const Operand b = data ? Operand{m * n, 1, n, -1.0, 1}
                           : Operand{m * n, n, 1, 1.0, 2};
    DISPATCH_DTYPE(dt_out, O,
      return launch_zgemm_f64<O, TILED, false>(Ar, Ai, Ar, Ai, Gr, Gi, B, P, P,
                                               data ? n : m, a, b, P * P, P, 1, tg, s);
    )
  }
  const int64_t tiles = (P + kTile - 1) / kTile;
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)tiles, batch_grid(B));
  DISPATCH_NARROW(dt_in, T, DISPATCH_DTYPE(dt_out, O,
    sbgemm_gram_kernel<T, O, TILED><<<grid, kGramThreads, 0, s>>>(
        static_cast<const T*>(Ar), static_cast<const T*>(Ai),
        static_cast<O*>(Gr), static_cast<O*>(Gi), B, m, n, data, tg);
  ))
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#ifndef SBGEMM_REAL_ENTRIES

int sbgemm_n_complex(const void* Ar, const void* Ai, const void* Xr, const void* Xi,
                     void* Yr, void* Yi, int64_t B, int64_t m, int64_t n, int64_t S,
                     int dt_in, int dt_out, int device, void* stream) {
  return launch_n<false, false>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, n, S, TileGrid{}, dt_in,
                                dt_out, device, stream);
}

int sbgemm_th_complex(const void* Ar, const void* Ai, const void* Xr, const void* Xi,
                      void* Yr, void* Yi, int64_t B, int64_t m, int64_t n, int64_t S,
                      int conj, int dt_in, int dt_out, int device, void* stream) {
  return launch_th<false, false>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, n, S, conj, TileGrid{},
                                 dt_in, dt_out, device, stream);
}

int sbgemm_gram_complex(const void* Ar, const void* Ai, void* Gr, void* Gi,
                        int64_t B, int64_t m, int64_t n, int data,
                        int dt_in, int dt_out, int device, void* stream) {
  return launch_gram<false>(Ar, Ai, Gr, Gi, B, m, n, data, TileGrid{}, dt_in, dt_out,
                            device, stream);
}

// The tiled builds: A rounded per tile-map cell; levels is a host array of
// R x C ladder indices, row-major.
int sbgemm_n_complex_tiled(const void* Ar, const void* Ai, const void* Xr,
                           const void* Xi, void* Yr, void* Yi, const int* levels,
                           int64_t B, int64_t m, int64_t n, int64_t S, int R, int C,
                           int dt_in, int dt_out, int device, void* stream) {
  TileGrid tg;
  const int err = make_tile_grid(levels, R, C, B, n, &tg);
  if (err) return err;
  return launch_n<true, false>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, n, S, tg, dt_in, dt_out,
                               device, stream);
}

int sbgemm_th_complex_tiled(const void* Ar, const void* Ai, const void* Xr,
                            const void* Xi, void* Yr, void* Yi, const int* levels,
                            int64_t B, int64_t m, int64_t n, int64_t S, int conj,
                            int R, int C, int dt_in, int dt_out, int device,
                            void* stream) {
  TileGrid tg;
  const int err = make_tile_grid(levels, R, C, B, n, &tg);
  if (err) return err;
  return launch_th<true, false>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, n, S, conj, tg, dt_in,
                                dt_out, device, stream);
}

int sbgemm_gram_tiled(const void* Ar, const void* Ai, void* Gr, void* Gi,
                      const int* levels, int64_t B, int64_t m, int64_t n, int data,
                      int R, int C, int dt_in, int dt_out, int device, void* stream) {
  TileGrid tg;
  const int err = make_tile_grid(levels, R, C, B, n, &tg);
  if (err) return err;
  return launch_gram<true>(Ar, Ai, Gr, Gi, B, m, n, data, tg, dt_in, dt_out, device,
                           stream);
}

#else  // sbgemm_real.cu: the real products, one plane each of A, X and Y

int sbgemm_n_real(const void* A, const void* X, void* Y, int64_t B, int64_t m,
                  int64_t n, int64_t S, int dt_in, int dt_out, int device,
                  void* stream) {
  return launch_n<false, true>(A, nullptr, X, nullptr, Y, nullptr, B, m, n, S,
                               TileGrid{}, dt_in, dt_out, device, stream);
}

int sbgemm_th_real(const void* A, const void* X, void* Y, int64_t B, int64_t m,
                   int64_t n, int64_t S, int dt_in, int dt_out, int device,
                   void* stream) {
  return launch_th<false, true>(A, nullptr, X, nullptr, Y, nullptr, B, m, n, S, 0,
                                TileGrid{}, dt_in, dt_out, device, stream);
}

int sbgemm_n_real_tiled(const void* A, const void* X, void* Y, const int* levels,
                        int64_t B, int64_t m, int64_t n, int64_t S, int R, int C,
                        int dt_in, int dt_out, int device, void* stream) {
  TileGrid tg;
  const int err = make_tile_grid(levels, R, C, B, n, &tg);
  if (err) return err;
  return launch_n<true, true>(A, nullptr, X, nullptr, Y, nullptr, B, m, n, S, tg, dt_in,
                              dt_out, device, stream);
}

int sbgemm_th_real_tiled(const void* A, const void* X, void* Y, const int* levels,
                         int64_t B, int64_t m, int64_t n, int64_t S, int R, int C,
                         int dt_in, int dt_out, int device, void* stream) {
  TileGrid tg;
  const int err = make_tile_grid(levels, R, C, B, n, &tg);
  if (err) return err;
  return launch_th<true, true>(A, nullptr, X, nullptr, Y, nullptr, B, m, n, S, 0, tg,
                               dt_in, dt_out, device, stream);
}

#endif  // SBGEMM_REAL_ENTRIES

}  // extern "C"
