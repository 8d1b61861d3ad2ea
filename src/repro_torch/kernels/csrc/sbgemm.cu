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
// Columns come in passes of SC = 8 or 16 for N and SC = 1, 8 or 32 for T/H
// (the smallest that holds S, at most 16 or 32; wider blocks loop over
// passes inside the kernel and read A once per pass).  Columns past S are
// zero in the staged panel and never stored.
// Sums run in double for f64 planes and in float otherwise; outputs are
// stored in their dtype straight from the accumulator.  Offsets are int64
// and ragged edges are masked in the kernels, so no call pads A.
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

template <typename T, typename O, int SC>
__global__ void __launch_bounds__(kNWarps * 32)
sbgemm_n_kernel(const T* __restrict__ Ar, const T* __restrict__ Ai,
                const T* __restrict__ Xr, const T* __restrict__ Xi,
                O* __restrict__ Yr, O* __restrict__ Yi,
                int64_t B, int64_t m, int64_t n, int64_t S) {
  using A = typename AccOf<T>::type;
  constexpr int R = kNRows;
  constexpr int KC = kNStage / SC;          // k-chunk staged a step
  static_assert(KC % 32 == 0, "the lanes split a chunk evenly");
  // the X chunk column by column, so lanes read consecutive k; the pad
  // spreads the transposing stores over the banks
  __shared__ A sxr[SC][KC + 1];
  __shared__ A sxi[SC][KC + 1];
  const int lane = threadIdx.x & 31;
  const int64_t row0 = ((int64_t)blockIdx.x * kNWarps + (threadIdx.x >> 5)) * R;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const T* xr = Xr + b * n * S;
    const T* xi = Xi + b * n * S;
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
            vi = widen<A>(xi[k * S + s0 + s]);
          }
          sxr[s][kk] = vr;
          sxi[s][kk] = vi;
        }
        __syncthreads();
        if (row0 >= m) continue;               // whole warp: no rows here
        // a constant trip count, so the loads of four steps are in flight
#pragma unroll 4
        for (int kk = lane; kk < KC; kk += 32) {
          const int64_t k = k0 + kk;
          A a_r[R], a_i[R];
#pragma unroll
          for (int u = 0; u < R; ++u) {
            a_r[u] = a_i[u] = 0;
            if (row0 + u < m && k < n) {
              const int64_t off = (b * m + row0 + u) * n + k;
              a_r[u] = widen<A>(Ar[off]);
              a_i[u] = widen<A>(Ai[off]);
            }
          }
#pragma unroll
          for (int s = 0; s < SC; ++s) {
            const A x_r = sxr[s][kk], x_i = sxi[s][kk];
#pragma unroll
            for (int u = 0; u < R; ++u) {
              acc_r[u][s] += a_r[u] * x_r - a_i[u] * x_i;
              acc_i[u][s] += a_r[u] * x_i + a_i[u] * x_r;
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
            Yi[out + s] = Store<O>::from(acc_i[u][s]);
          }
        }
      }
    }
  }
}

template <typename T, typename O, int SC>
__global__ void __launch_bounds__(kThreads)
sbgemm_th_kernel(const T* __restrict__ Ar, const T* __restrict__ Ai,
                 const T* __restrict__ Xr, const T* __restrict__ Xi,
                 O* __restrict__ Yr, O* __restrict__ Yi,
                 int64_t B, int64_t m, int64_t n, int64_t S, int conj) {
  using A = typename AccOf<T>::type;
  constexpr int MC = kPanel / SC;           // m-chunk of a staged panel
  __shared__ A sxr[MC * SC];
  __shared__ A sxi[MC * SC];
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const A sgn = conj ? A(-1) : A(1);        // conj(A): negate Im(A)
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const T* ar = Ar + b * m * n + j;
    const T* ai = Ai + b * m * n + j;
    const T* xr = Xr + b * m * S;
    const T* xi = Xi + b * m * S;
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
            vi = widen<A>(xi[off]);
          }
          sxr[e] = vr;
          sxi[e] = vi;
        }
        __syncthreads();
        if (j < n) {
          // four rows' loads in flight a step
#pragma unroll 4
          for (int k = 0; k < len; ++k) {
            const int64_t off = (i0 + k) * n;
            const A a_r = widen<A>(ar[off]), a_i = sgn * widen<A>(ai[off]);
#pragma unroll
            for (int s = 0; s < SC; ++s) {
              const A x_r = sxr[k * SC + s], x_i = sxi[k * SC + s];
              acc_r[s] += a_r * x_r - a_i * x_i;
              acc_i[s] += a_r * x_i + a_i * x_r;
            }
          }
        }
      }
      if (j < n) {
        O* yr = Yr + (b * n + j) * S + s0;
        O* yi = Yi + (b * n + j) * S + s0;
#pragma unroll
        for (int s = 0; s < SC; ++s) {
          if (s < sc) {
            yr[s] = Store<O>::from(acc_r[s]);
            yi[s] = Store<O>::from(acc_i[s]);
          }
        }
      }
    }
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kGramThreads)
sbgemm_gram_kernel(const T* __restrict__ Ar, const T* __restrict__ Ai,
                   O* __restrict__ Gr, O* __restrict__ Gi,
                   int64_t B, int64_t m, int64_t n, int data) {
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
          nr[l] = widen<A>(ar[k * sk + p * sp]);
          ni[l] = sgn * widen<A>(ai[k * sk + p * sp]);
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

// The same for the N kernel: passes of 8 or 16 columns.
#define DISPATCH_N_PASS(S, SC, ...)                        \
  if ((S) <= 8) { constexpr int SC = 8; __VA_ARGS__ }      \
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
// imaginary part is read times sgn (-1: the conjugate).
struct Operand {
  int64_t sb, sr, sc;
  double sgn;
};

// d += a b for one m8n8k4 f64 tile pair.  Fragments (PTX ISA, mma.m8n8k4
// .f64): lane l holds a = A[l / 4][l % 4], b = B[l % 4][l / 4] and
// d = D[l / 4][2 (l % 4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

template <typename O, int TM, int TN>
__global__ void __launch_bounds__(kMmaWarps * 32)
zgemm_f64_kernel(const double* __restrict__ Ar, const double* __restrict__ Ai,
                 const double* __restrict__ Br, const double* __restrict__ Bi,
                 O* __restrict__ Cr, O* __restrict__ Ci,
                 int64_t B, int64_t M, int64_t N, int64_t K, Operand a,
                 Operand b, int64_t c_sb, int64_t c_sr, int herm) {
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
    const double* ai = Ai + bb * a.sb;
    const double* br = Br + bb * b.sb;
    const double* bi = Bi + bb * b.sb;
    double cre[TM][TN][2], cim[TM][TN][2];
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v)
        cre[u][v][0] = cre[u][v][1] = cim[u][v][0] = cim[u][v][1] = 0;
#pragma unroll 4
    for (int64_t k0 = 0; k0 < K; k0 += 4) {
      const int64_t k = k0 + t;
      double fa_r[TM], fa_i[TM], fb_r[TN], fb_i[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        const int64_t r = r0 + u * 8 + g;
        fa_r[u] = fa_i[u] = 0;
        if (r < M && k < K) {
          fa_r[u] = ar[r * a.sr + k * a.sc];
          fa_i[u] = a.sgn * ai[r * a.sr + k * a.sc];
        }
      }
#pragma unroll
      for (int v = 0; v < TN; ++v) {
        const int64_t c = c0 + v * 8 + g;
        fb_r[v] = fb_i[v] = 0;
        if (c < N && k < K) {
          fb_r[v] = br[k * b.sr + c * b.sc];
          fb_i[v] = b.sgn * bi[k * b.sr + c * b.sc];
        }
      }
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) {
          dmma(cre[u][v], fa_r[u], fb_r[v]);
          dmma(cre[u][v], -fa_i[u], fb_i[v]);
          dmma(cim[u][v], fa_r[u], fb_i[v]);
          dmma(cim[u][v], fa_i[u], fb_r[v]);
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
          Ci[bb * c_sb + r * c_sr + c] = Store<O>::from(cim[u][v][h]);
          if (mirror) {                        // C[c, r] = conj(C[r, c])
            Cr[bb * c_sb + c * c_sr + r] = Store<O>::from(cre[u][v][h]);
            Ci[bb * c_sb + c * c_sr + r] = Store<O>::from(-cim[u][v][h]);
          }
        }
    }
  }
}

// Launch the f64 tensor-core product: warp tiles of 16 x 8 (N <= 8) or
// 16 x 32 columns for the GEMMs, 32 x 32 for the Hermitian Gram.
template <typename O>
int launch_zgemm_f64(const void* Ar, const void* Ai, const void* Br, const void* Bi,
                     void* Cr, void* Ci, int64_t B, int64_t M, int64_t N, int64_t K,
                     Operand a, Operand b, int64_t c_sb, int64_t c_sr, int herm,
                     cudaStream_t s) {
  auto go = [&](auto kernel, int tm, int tn) {
    const int64_t tiles = ((M + 8 * tm - 1) / (8 * tm)) * ((N + 8 * tn - 1) / (8 * tn));
    const int64_t bx = (tiles + kMmaWarps - 1) / kMmaWarps;
    if (bx > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    kernel<<<dim3((unsigned)bx, batch_grid(B)), kMmaWarps * 32, 0, s>>>(
        static_cast<const double*>(Ar), static_cast<const double*>(Ai),
        static_cast<const double*>(Br), static_cast<const double*>(Bi),
        static_cast<O*>(Cr), static_cast<O*>(Ci), B, M, N, K, a, b, c_sb, c_sr,
        herm);
    return (int)cudaGetLastError();
  };
  if (herm) return go(zgemm_f64_kernel<O, 4, 4>, 4, 4);
  if (N <= 8) return go(zgemm_f64_kernel<O, 2, 1>, 2, 1);
  return go(zgemm_f64_kernel<O, 2, 4>, 2, 4);
}

}  // namespace

extern "C" {

// Y (B, m, S) = A (B, m, n) X (B, n, S), split planes.
int sbgemm_n_complex(const void* Ar, const void* Ai, const void* Xr, const void* Xi,
                     void* Yr, void* Yi, int64_t B, int64_t m, int64_t n, int64_t S,
                     int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || m == 0 || S == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dt_in == DT_F64) {                     // opA = A, opB = X
    DISPATCH_DTYPE(dt_out, O,
      return launch_zgemm_f64<O>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, S, n,
                                 Operand{m * n, n, 1, 1.0}, Operand{n * S, S, 1, 1.0},
                                 m * S, S, 0, s);
    )
  }
  const int64_t rows = kNWarps * kNRows;     // output rows of a block
  const int64_t bx = (m + rows - 1) / rows;
  if (bx > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)bx, batch_grid(B));
  DISPATCH_NARROW(dt_in, T, DISPATCH_DTYPE(dt_out, O, DISPATCH_N_PASS(S, SC,
    sbgemm_n_kernel<T, O, SC><<<grid, kNWarps * 32, 0, s>>>(
        static_cast<const T*>(Ar), static_cast<const T*>(Ai),
        static_cast<const T*>(Xr), static_cast<const T*>(Xi),
        static_cast<O*>(Yr), static_cast<O*>(Yi), B, m, n, S);
  )))
  return (int)cudaGetLastError();
}

// Y (B, n, S) = A^T X, or A^H X when conj != 0; X is (B, m, S).
int sbgemm_th_complex(const void* Ar, const void* Ai, const void* Xr, const void* Xi,
                      void* Yr, void* Yi, int64_t B, int64_t m, int64_t n, int64_t S,
                      int conj, int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || n == 0 || S == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dt_in == DT_F64) {                     // opA = A^T (conj: A^H), opB = X
    DISPATCH_DTYPE(dt_out, O,
      return launch_zgemm_f64<O>(Ar, Ai, Xr, Xi, Yr, Yi, B, n, S, m,
                                 Operand{m * n, 1, n, conj ? -1.0 : 1.0},
                                 Operand{m * S, S, 1, 1.0}, n * S, S, 0, s);
    )
  }
  const int64_t bx = (n + kThreads - 1) / kThreads;
  if (bx > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)bx, batch_grid(B));
  DISPATCH_NARROW(dt_in, T, DISPATCH_DTYPE(dt_out, O, DISPATCH_PASS(S, SC,
    sbgemm_th_kernel<T, O, SC><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(Ar), static_cast<const T*>(Ai),
        static_cast<const T*>(Xr), static_cast<const T*>(Xi),
        static_cast<O*>(Yr), static_cast<O*>(Yi), B, m, n, S, conj);
  )))
  return (int)cudaGetLastError();
}

// G = A^H A, (B, n, n), or with data != 0 G = A A^H, (B, m, m).  The tiles
// below the diagonal are the conjugates of those above; the diagonal tiles
// are not symmetrized (the wrapper does that).
int sbgemm_gram_complex(const void* Ar, const void* Ai, void* Gr, void* Gi,
                        int64_t B, int64_t m, int64_t n, int data,
                        int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int64_t P = data ? m : n;
  if (B == 0 || P == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dt_in == DT_F64) {
    // parameter: opA[p][i] = conj(A[i, p]), opB[i][q] = A[i, q];
    // data: opA[p][j] = A[p, j], opB[j][q] = conj(A[q, j])
    const Operand a = data ? Operand{m * n, n, 1, 1.0} : Operand{m * n, 1, n, -1.0};
    const Operand b = data ? Operand{m * n, 1, n, -1.0} : Operand{m * n, n, 1, 1.0};
    DISPATCH_DTYPE(dt_out, O,
      return launch_zgemm_f64<O>(Ar, Ai, Ar, Ai, Gr, Gi, B, P, P, data ? n : m,
                                 a, b, P * P, P, 1, s);
    )
  }
  const int64_t tiles = (P + kTile - 1) / kTile;
  if (tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)tiles, batch_grid(B));
  DISPATCH_NARROW(dt_in, T, DISPATCH_DTYPE(dt_out, O,
    sbgemm_gram_kernel<T, O><<<grid, kGramThreads, 0, s>>>(
        static_cast<const T*>(Ar), static_cast<const T*>(Ai),
        static_cast<O*>(Gr), static_cast<O*>(Gi), B, m, n, data);
  ))
  return (int)cudaGetLastError();
}

}  // extern "C"
