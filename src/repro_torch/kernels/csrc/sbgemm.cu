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
// FP64 vector units), in the staged kernels of the f64 section below.  The
// complex N, T/H and Gram of bf16 planes and the real N and T of bf16
// planes, untiled and tiled, run on the bf16 tensor cores with f32 sums
// (sbgemm_bf16.cuh), but for the tiled complex T/H; the complex
// N, T/H and Gram and the real N and T of f32 planes, untiled and tiled,
// in staged FP32 kernels (sbgemm_f32.cuh).  The tiled complex T/H of bf16
// planes runs on the vector units, in the kernel described here:
//
//   T/H (sum over the short m): the paper's short-wide pathology with S
//     columns.  One thread per output column j, blocks tiling the long n
//     axis, as in sbgemv_th; the X panel (an m-chunk x SC columns) sits in
//     shared memory, read as broadcasts, and loads of A[b, i, j] are
//     coalesced along j.  Each A element is read once for all SC columns,
//     in passes of SC = 1, 8 or 32 (the smallest that holds S, at most 32;
//     wider blocks loop over passes inside the kernel and read A once per
//     pass).  Columns past S are zero in the staged panel and never
//     stored.  Sums run in float; outputs are stored in their dtype
//     straight from the accumulator.
//
// Offsets are int64 and ragged edges are masked in the kernels, so no call
// pads A.
//
// Tiled builds (TILED = true) replace the TPU kernels
// :sbgemm_n_complex_tiled, :sbgemm_th_complex_tiled and :sbgemm_gram_tiled:
// each A element is rounded through its tile-map cell's level as it is
// loaded (common.cuh: TileGrid), before any product (on the f64 path, as
// its fragment is read, from shared memory in the staged kernels, before
// it enters the mma.sync; in the f32 N kernel as it leaves shared memory),
// and nothing else changes, so on planes
// quantized up front they give the untiled build's bits.  In the
// Gram both factors of a product are rounded at their own cells.  They
// move the untiled kernels' bytes: A stays stored at the carrier type.
// At a bf16 carrier every cell's rounding is the identity, so the tiled
// N and Gram of bf16 planes run their untiled builds (launch_n,
// launch_gram).
//
// Real builds (REAL = true) replace the TPU kernels :sbgemm_n_real,
// :sbgemm_th_real, :sbgemm_n_real_tiled and :sbgemm_th_real_tiled: the
// staged kernels of each plane type with the imaginary planes compiled
// away (one A, X and Y plane; on the f64 path one DMMA a tile pair instead
// of four, on the bf16 path one mma.sync; the Gram has no real build).
// The tiled real builds take the TILED flag unchanged on f64 and f32
// planes; on bf16 planes they run the untiled build (launch_n).  Their C
// entries are built from this file as a second library (sbgemm_real.cu
// defines SBGEMM_REAL_ENTRIES), so the complex and the real instantiations
// compile in parallel.
#include "common.cuh"
#if defined(SBGEMM_BF16_NO_MMA) && !defined(WGMMA_NO_MMA)
#define WGMMA_NO_MMA   // the bound probe's build without products: wgmma's too
#endif
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;   // T/H: threads of a block
constexpr int kPanel = 2048;    // T/H: staged X panel, elements per plane

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <typename T, typename O, int SC, bool TILED>
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
    const T* ai = Ai + b * m * n + j;
    const T* xr = Xr + b * m * S;
    const T* xi = Xi + b * m * S;
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
            vi = widen<A>(xi[off]);
          }
          sxr[e] = vr;
          sxi[e] = vi;
        }
        __syncthreads();
        auto sweep = [&](auto q) {
          // four rows' loads in flight a step
#pragma unroll 4
          for (int k = 0; k < len; ++k) {
            const int64_t off = (i0 + k) * n;
            A a_r = widen<A>(ar[off]), a_i = widen<A>(ai[off]);
            if constexpr (decltype(q)::value) {
              a_r = quantize(a_r, lv);
              a_i = quantize(a_i, lv);
            }
            a_i = sgn * a_i;
#pragma unroll
            for (int s = 0; s < SC; ++s) {
              const A x_r = sxr[k * SC + s], x_i = sxi[k * SC + s];
              acc_r[s] += a_r * x_r - a_i * x_i;
              acc_i[s] += a_r * x_i + a_i * x_r;
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

// Run the statements in __VA_ARGS__ with SC bound to the column pass width
// for S right-hand sides: 1, 8, or 32 (wider blocks take passes of 32).
#define DISPATCH_PASS(S, SC, ...)                          \
  if ((S) <= 1) { constexpr int SC = 1; __VA_ARGS__ }      \
  else if ((S) <= 8) { constexpr int SC = 8; __VA_ARGS__ } \
  else { constexpr int SC = 32; __VA_ARGS__ }

unsigned batch_grid(int64_t B) { return (unsigned)(B < 65535 ? B : 65535); }

// ---------------------------------------------------------------------------
// f64 planes on the FP64 tensor cores.  wgmma has no f64 type, so every
// f64 product is mma.sync, in sm_90's m16n8k4 shape, which reaches the
// FP64 tensor cores' full rate where the older m8n8k4 does not.  A complex
// product is four real products a tile pair, always in the order Re Re,
// -Im Im (into Re), Re Im, Im Re (into Im); with the REAL flag one.
//
// Both kernels stage their operands in shared memory through a cp.async
// pipeline: a block copies k-chunks of its operand panels asynchronously
// (8-byte copies, 16-byte ones where the rows allow) into a ring of
// stages, then its warps read the fragments from shared memory.  Staged
// rows are padded by kPad doubles, so the (g, t) lanes of a fragment read
// hit 16 distinct bank pairs.  k past the end is zero-filled by the
// copies; rows and columns past the end of the other axes are not copied,
// and what they hold reaches only outputs that are not stored.  Tile
// rounding (TILED) happens as a fragment leaves shared memory: the copies
// land the stored bits, so every tiled build is its untiled build with
// rounded fragments.
//
//   N (Y = A X) and T/H (Y = A^T X, A^H X): zgemm_f64_kernel, bytes-bound
//     up to S = 32.  Work items are (bin, 128 output rows, a pass of SP =
//     8, 16 or 32 columns): N's bin (m = 100) is one item, so its X panel
//     is read once.  A block is persistent: it takes items blockIdx.x, +
//     gridDim.x, ... and runs one pipeline of k-chunks across them (N: 40
//     wide, 2 deep, the widest that fits at SP = 32; T/H: 16 wide, 2 deep,
//     so that two or three blocks fit an SM), so it never waits on a cold
//     pipeline between items (a cursor walks the chunks: no 64-bit
//     division a chunk; the real T, half the bytes a chunk, takes 32-wide
//     chunks 3 deep).  Each chunk stages the A panel (N: 128 rows x 40 k,
//     320-byte runs of A's rows; T/H: 16 of A's rows x 128 columns, 1 KB
//     runs) and the X panel (chunk x SP) once for the block's 8 warps.  A
//     warp owns one m16 row tile and all SP columns, so each A fragment is
//     read, and rounded, by one warp, and each output sums its k products
//     in one warp in k order.
//   Gram, G = opA opB with opA = A, opB = A^H (data space, k over n) or
//     opA = A^H, opB = A (parameter space, k over m): zgram_f64_kernel.
//     Blocks own 128 x 128 (a bin's whole G, for 64 < P <= 112: data space
//     at the paper shape) or 64 x 64 output tiles on and above the
//     diagonal.  A 16-wide k-chunk of the block's rows of A is staged once
//     and feeds both fragments (on a diagonal tile both panels are the
//     same rows), so a bin is read from HBM once; 4 chunks deep at 128, 2
//     at 64.  The 8 warps own 32 x 16 tiles (two each at 128, of the 16
//     with entries on or above the diagonal inside P <= 112; one each of
//     2 x 4 at 64), 32 accumulators a tile, and skip their m16 x n8
//     sub-tiles that lie wholly below the diagonal or outside G.  A warp
//     loads a row sub-tile's fragments, then each column sub-tile's just
//     before its four DMMAs, to hold few registers live (no spills).  Each
//     entry on or above the diagonal is written, and its conjugate below
//     it, so G is Hermitian but for the diagonal's imaginary parts
//     (ops.sbgemm_gram averages those away).
//   Every output sums its k products in one warp, in k order, on every run.
//   No atomics, no cross-warp sums.
// ---------------------------------------------------------------------------

constexpr int kGemmRows = 128;  // GEMM: output rows of an item, 8 warps of m16
// GEMM: the k-chunk staged a step and the chunks in the pipeline, for N,
// T/H and the real T (one plane: half the bytes a chunk)
constexpr int kGemmNChunk = 40, kGemmNStages = 2;
constexpr int kGemmTChunk = 16, kGemmTStages = 2;
constexpr int kGemmTRealChunk = 32, kGemmTRealStages = 3;
constexpr int kGChunk = 16;     // Gram: k-chunk staged a step
constexpr int kPad = 4;         // doubles of padding a staged row

// Round a fragment pair at level lv (2, the carrier's level: unchanged).
__device__ __forceinline__ void tile_round(int lv, double& vr, double& vi) {
  if (lv < 2) {
    vr = quantize(vr, lv);
    vi = quantize(vi, lv);
  }
}

// d += a b for one m16n8k4 f64 tile pair (PTX ISA, mma.m16n8k4 .f64):
// lane l, g = l / 4, t = l % 4, holds a = {A[g][t], A[g + 8][t]},
// b = B[t][g] and d = {D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]}.
__device__ __forceinline__ void dmma16(double (&d)[4], double a0, double a1,
                                       double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Stage a ROWS x COLS tile of doubles or floats whose rows start at src +
// r ld (contiguous along c) into shared memory at dst + r DLD + c, the
// block's NT threads sharing the copies: rows r < rv and columns c < cv are
// copied.  The k axis is the rows (KROWS) or the columns: past its end (r
// >= rv, or c >= cv) the tile is zero-filled, so the products need no k
// mask; past the end of the other axis nothing is written, and the stale
// values there reach only outputs that are not stored.  vec: 16-byte
// copies of V elements (ld, the tile's start and cv multiples of V, the
// plane 16-byte aligned); otherwise one copy an element.
template <int ROWS, int COLS, int DLD, int NT, bool KROWS, typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t ld, int rv, int cv,
                                      bool vec) {
  constexpr int V = 16 / sizeof(T), E = sizeof(T);
  static_assert(COLS % V == 0 && DLD % V == 0, "rows of whole 16-byte runs");
  const uint32_t d0 = smem_addr(dst);
  const int rows = KROWS ? ROWS : rv;        // rows written
  if (vec) {
    constexpr int CP = COLS / V;
    for (int e = threadIdx.x; e < rows * CP; e += NT) {
      const int r = e / CP, c = V * (e % CP);
      if (KROWS && c >= cv) continue;        // past the other axis
      const bool ok = r < rv && c < cv;
      cp_async<16>(d0 + E * (r * DLD + c), ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * COLS; e += NT) {
      const int r = e / COLS, c = e % COLS;
      if (KROWS && c >= cv) continue;
      const bool ok = r < rv && c < cv;
      cp_async<E>(d0 + E * (r * DLD + c), ok ? src + r * ld + c : src, ok);
    }
  }
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

// Launch a persistent kernel of `threads` threads and `bytes` of dynamic
// shared memory: as many blocks as fit on the card at once, at most one an
// item.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int threads, int bytes, int64_t items, int device,
                      cudaStream_t s, Args... args) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int sms = 0, per_sm = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)min64(items, (int64_t)sms * per_sm), threads, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

// Shared-memory layout of a GEMM stage for NT column tiles of 8: the A
// panel of each plane (kGemmRows x KC for N, KC x kGemmRows for T/H) and
// the X panel of each plane (KC x SP).
template <int NT, bool TRANS, bool REAL>
struct GemmLayout {
  static constexpr int SP = 8 * NT;           // columns of a pass
  static constexpr int PL = REAL ? 1 : 2;     // planes
  static constexpr int KC =
      !TRANS ? kGemmNChunk : REAL ? kGemmTRealChunk : kGemmTChunk;
  static constexpr int NS =
      !TRANS ? kGemmNStages : REAL ? kGemmTRealStages : kGemmTStages;
  static constexpr int ALD = TRANS ? kGemmRows + kPad : KC + kPad;
  static constexpr int XLD = SP + kPad;
  static constexpr int A_TILE = (TRANS ? KC : kGemmRows) * ALD;
  static constexpr int X_TILE = KC * XLD;
  static constexpr int STAGE = PL * (A_TILE + X_TILE);
  static constexpr int BYTES = 8 * NS * STAGE;
};

template <typename O, int NT, bool TRANS, bool TILED, bool REAL>
__global__ void __launch_bounds__(kGemmRows / 16 * 32, 1)
zgemm_f64_kernel(const double* __restrict__ Ar, const double* __restrict__ Ai,
                 const double* __restrict__ Xr, const double* __restrict__ Xi,
                 O* __restrict__ Yr, O* __restrict__ Yi, int64_t B, int64_t m,
                 int64_t n, int64_t S, int conj, int vec_a, int vec_x, TileGrid tg) {
  using L = GemmLayout<NT, TRANS, REAL>;
  constexpr int BM = kGemmRows, KC = L::KC, NS = L::NS;
  constexpr int NTH = BM / 16 * 32, SP = L::SP, PL = L::PL;
  extern __shared__ __align__(16) double smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // Y (B, M, S) = opA (M x K) X (K x S) per bin
  const int64_t M = TRANS ? n : m, K = TRANS ? m : n;
  const int64_t RTS = (M + BM - 1) / BM, SPS = (S + SP - 1) / SP;
  const int64_t items = B * RTS * SPS, KCH = (K + KC - 1) / KC;
  const double sgn = conj ? -1.0 : 1.0;      // conj(A): negate Im(A)
  // A position in this block's chunk stream: item it (blockIdx.x, +
  // gridDim.x, ...), its chunk c and the stage it goes to.  Advanced one
  // chunk at a time, so the 64-bit divisions run once an item.
  struct Cursor {
    int64_t it, c, b, r0, s0;
    int rv, sv, slot;
    uint32_t cells;                          // tiled: the bin's row of cells
  };
  auto at_item = [&](Cursor& q) {
    q.c = 0;
    if (q.it >= items) return;
    q.b = q.it / (RTS * SPS);
    q.r0 = (q.it / SPS) % RTS * BM;
    q.s0 = q.it % SPS * SP;
    q.rv = (int)min64(BM, M - q.r0);
    q.sv = (int)min64(SP, S - q.s0);
    q.cells = TILED ? tile_row(tg, q.b) : 0u;
  };
  auto advance = [&](Cursor& q) {
    q.slot = q.slot + 1 == NS ? 0 : q.slot + 1;
    if (++q.c == KCH) {
      q.it += gridDim.x;
      at_item(q);
    }
  };
  // the load cursor's chunk into its stage; one copy group a chunk (empty
  // past the last), so the wait below counts chunks
  auto load = [&](const Cursor& w) {
    if (w.it < items) {
      const int64_t k0 = w.c * KC;
      const int kv = (int)min64(KC, K - k0);
      double* st = smem + w.slot * L::STAGE;
#pragma unroll
      for (int pl = 0; pl < PL; ++pl) {
        const double* a = (pl ? Ai : Ar) + w.b * m * n;
        double* sa = st + pl * L::A_TILE;
        if (TRANS)   // A's rows k0.. (k), its columns r0.. (output rows)
          stage<KC, BM, L::ALD, NTH, true>(sa, a + k0 * n + w.r0, n, kv, w.rv, vec_a);
        else         // A's rows r0.., its columns k0..
          stage<BM, KC, L::ALD, NTH, false>(sa, a + w.r0 * n + k0, n, w.rv, kv, vec_a);
        const double* x = (pl ? Xi : Xr) + (w.b * K + k0) * S + w.s0;
        stage<KC, SP, L::XLD, NTH, true>(st + PL * L::A_TILE + pl * L::X_TILE, x, S, kv,
                                         w.sv, vec_x);
      }
    }
    cp_async_commit();
  };
  double acc[PL][NT][4];
#pragma unroll
  for (int p = 0; p < PL; ++p)
#pragma unroll
    for (int v = 0; v < NT; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][v][e] = 0;
  int lv_r = 0;   // T/H tiled: the levels of the fragment rows (A's columns)
  Cursor w, ld;                              // compute and load cursors
  w.it = blockIdx.x;
  w.slot = 0;
  at_item(w);
  ld = w;
#pragma unroll
  for (int f = 0; f < NS - 1; ++f) {
    load(ld);
    advance(ld);
  }
  for (; w.it < items; advance(w)) {
    cp_async_wait<NS - 2>();         // this thread's copies of chunk w landed
    __syncthreads();                 // everyone's; the chunk before is consumed
    load(ld);
    advance(ld);
    const int64_t c = w.c;
    const bool rows = 16 * warp < w.rv;      // whole warp: rows in its tile
    const int r = 16 * warp + g;             // this lane's fragment rows r, r + 8
    if (TILED && TRANS && c == 0 && rows)
      lv_r = tile_level(tg, w.cells, min64(w.r0 + r, M - 1)) |
             tile_level(tg, w.cells, min64(w.r0 + r + 8, M - 1)) << 2;
    if (rows) {
      const double* st = smem + w.slot * L::STAGE;
      const double* sx = st + PL * L::A_TILE + g;
#pragma unroll
      for (int j = 0; j < KC / 4; ++j) {
        const int kk = 4 * j + t;            // this lane's k in the chunk
        const int o0 = TRANS ? kk * L::ALD + r : r * L::ALD + kk;
        const int o1 = o0 + (TRANS ? 8 : 8 * L::ALD);
        double a0r = st[o0], a1r = st[o1], a0i = 0, a1i = 0;
        if constexpr (!REAL) {
          a0i = st[L::A_TILE + o0];
          a1i = st[L::A_TILE + o1];
        }
        if (TILED) {
          const int lv0 = TRANS ? lv_r & 3 : tile_level(tg, w.cells, c * KC + kk);
          tile_round(lv0, a0r, a0i);
          tile_round(TRANS ? lv_r >> 2 : lv0, a1r, a1i);
        }
        if constexpr (!REAL) {
          a0i *= sgn;
          a1i *= sgn;
        }
#pragma unroll
        for (int v = 0; v < NT; ++v) {
          const double br = sx[kk * L::XLD + 8 * v];
          dmma16(acc[0][v], a0r, a1r, br);
          if constexpr (!REAL) {
            const double bi = sx[L::X_TILE + kk * L::XLD + 8 * v];
            dmma16(acc[0][v], -a0i, -a1i, bi);
            dmma16(acc[1][v], a0r, a1r, bi);
            dmma16(acc[1][v], a0i, a1i, br);
          }
        }
      }
    }
    if (c == KCH - 1 && rows) {              // the item's last chunk: store
#pragma unroll
      for (int p = 0; p < PL; ++p)
#pragma unroll
        for (int v = 0; v < NT; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r + 8 * (e >> 1), col = 8 * v + 2 * t + (e & 1);
            if (row < w.rv && col < w.sv)
              (p ? Yi : Yr)[(w.b * M + w.r0 + row) * S + w.s0 + col] =
                  Store<O>::from(acc[p][v][e]);
            acc[p][v][e] = 0;
          }
    }
  }
}

// The Gram kernel's block shape: BP x BP output tiles, 8 warps of TW
// 32 x 16 tiles each (2 at BP = 128, 1 at 64), one staged panel of A's rows
// (BP = 128, which runs only as a whole bin's diagonal tile) or two (the p
// and q rows), both planes, STAGES chunks deep.  A panel holds BP rows x kGChunk k (data
// space: rows of A along n) or kGChunk k x BP columns (parameter space:
// rows of A along n = p).
template <int BP>
struct GramLayout {
  static constexpr int WARPS = 8, TW = BP == 128 ? 2 : 1;
  static constexpr int PANELS = BP == 128 ? 1 : 2;
  static constexpr int STAGES = BP == 128 ? 4 : 2;
  static constexpr int DATA_LD = kGChunk + kPad, PARAM_LD = BP + kPad;
  static constexpr int PANEL = BP * DATA_LD > kGChunk * PARAM_LD ? BP * DATA_LD
                                                                 : kGChunk * PARAM_LD;
  static constexpr int STAGE = PANELS * 2 * PANEL;
  static constexpr int BYTES = 8 * STAGES * STAGE;
};

// BP = 128's 32 x 16 tiles (i, j) (rows 32 i, columns 16 j): the 16 with
// entries on or above the diagonal for P <= 112.  Warp w takes tiles w
// and w + 8, so that the four SM sub-partitions (warp % 4) get 12-13 of the
// 49 m16 x n8 sub-tiles each at P = 100.
__constant__ unsigned char kGramTiles128[16][2] = {
    {0, 1}, {0, 2}, {0, 3}, {0, 4}, {0, 5}, {1, 3}, {1, 4}, {1, 5},
    {0, 0}, {0, 6}, {1, 2}, {2, 5}, {1, 6}, {2, 4}, {2, 6}, {3, 6}};

template <typename O, int BP, bool DATA, bool TILED>
__global__ void __launch_bounds__(GramLayout<BP>::WARPS * 32, 1)
zgram_f64_kernel(const double* __restrict__ Ar, const double* __restrict__ Ai,
                 O* __restrict__ Gr, O* __restrict__ Gi, int64_t B, int64_t m,
                 int64_t n, int vec, TileGrid tg) {
  using L = GramLayout<BP>;
  constexpr int KC = kGChunk, NTH = L::WARPS * 32, TW = L::TW;
  // staged element (panel row r, k) at r * SR + k * SK
  constexpr int SR = DATA ? L::DATA_LD : 1, SK = DATA ? 1 : L::PARAM_LD;
  // imaginary signs: data opA = A, opB = A^H; parameter opA = A^H, opB = A
  constexpr double SA = DATA ? 1.0 : -1.0, SB = -SA;
  extern __shared__ __align__(16) double smem[];
  const int64_t P = DATA ? m : n, K = DATA ? n : m;
  // this block's tile (pt, qt), pt <= qt, in row-major order of the upper
  // triangle of T x T tiles
  const int T = (int)((P + BP - 1) / BP);
  int pt = 0, x = blockIdx.x;
  while (x >= T - pt) {
    x -= T - pt;
    ++pt;
  }
  const int qt = pt + x;
  const bool diag = pt == qt;
  const int64_t p0 = (int64_t)pt * BP, q0 = (int64_t)qt * BP;
  const int pv = (int)min64(BP, P - p0), qv = (int)min64(BP, P - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warp's tiles (i, j) and, for each, the m16 x n8 sub-tiles (u, v)
  // to compute: inside G, and on a diagonal tile not wholly below the
  // diagonal; bit 2 u + v
  int ti[TW], tj[TW];
  uint32_t need[TW];
#pragma unroll
  for (int w = 0; w < TW; ++w) {
    ti[w] = BP == 128 ? kGramTiles128[warp + 8 * w][0] : warp >> 2;
    tj[w] = BP == 128 ? kGramTiles128[warp + 8 * w][1] : warp & 3;
    need[w] = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int r = 32 * ti[w] + 16 * u, c = 16 * tj[w] + 8 * v;
        if (r < pv && c < qv && (!diag || c + 7 >= r)) need[w] |= 1u << (2 * u + v);
      }
  }
  const int64_t chunks = (K + KC - 1) / KC;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const double* base_r = Ar + b * m * n;
    const double* base_i = Ai + b * m * n;
    const uint32_t cells = TILED ? tile_row(tg, b) : 0u;
    // parameter space, tiled: the levels of each tile's fragment rows (opA:
    // A's columns p) and columns (opB: q), fixed over k, 2 bits each
    uint32_t lv_pq[TW];
#pragma unroll
    for (int w = 0; w < TW; ++w) {
      lv_pq[w] = 0;
      if (TILED && !DATA) {
#pragma unroll
        for (int h = 0; h < 4; ++h)
          lv_pq[w] |= (uint32_t)tile_level(tg, cells,
                                           min64(p0 + 32 * ti[w] + 8 * h + g, P - 1))
                      << (2 * h);
#pragma unroll
        for (int v = 0; v < 2; ++v)
          lv_pq[w] |= (uint32_t)tile_level(tg, cells,
                                           min64(q0 + 16 * tj[w] + 8 * v + g, P - 1))
                      << (8 + 2 * v);
      }
    }
    auto load = [&](int64_t c) {
      if (c < chunks) {
        double* st = smem + (c % L::STAGES) * L::STAGE;
        const int64_t k0 = c * KC;
        const int kv = (int)min64(KC, K - k0);
#pragma unroll
        for (int panel = 0; panel < L::PANELS; ++panel) {
          if (panel && diag) break;            // one panel serves both sides
          const int64_t r0 = panel ? q0 : p0;
          const int rv = panel ? qv : pv;
#pragma unroll
          for (int pl = 0; pl < 2; ++pl) {
            double* dst = st + (2 * panel + pl) * L::PANEL;
            const double* src = pl ? base_i : base_r;
            if (DATA)
              stage<BP, KC, L::DATA_LD, NTH, false>(dst, src + r0 * n + k0, n, rv, kv,
                                                    vec);
            else
              stage<KC, BP, L::PARAM_LD, NTH, true>(dst, src + k0 * n + r0, n, kv, rv,
                                                    vec);
          }
        }
      }
      cp_async_commit();
    };
    double cre[TW][2][2][4], cim[TW][2][2][4];
#pragma unroll
    for (int w = 0; w < TW; ++w)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) cre[w][u][v][e] = cim[w][u][v][e] = 0;
#pragma unroll
    for (int c = 0; c < L::STAGES - 1; ++c) load(c);
    for (int64_t c = 0; c < chunks; ++c) {
      cp_async_wait<L::STAGES - 2>();
      __syncthreads();
      load(c + L::STAGES - 1);
      const double* pp = smem + (c % L::STAGES) * L::STAGE;   // p rows
      const double* qq = pp + (diag ? 0 : 2 * L::PANEL);      // q rows
#pragma unroll
      for (int jj = 0; jj < KC / 4; ++jj) {
        const int kk = 4 * jj + t;
        const int lv_k = TILED && DATA ? tile_level(tg, cells, c * KC + kk) : 2;
#pragma unroll
        for (int w = 0; w < TW; ++w)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (!(need[w] & (3u << (2 * u)))) continue;   // row tile u unused
            double ar[2], ai[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int off = (32 * ti[w] + 16 * u + 8 * h + g) * SR + kk * SK;
              ar[h] = pp[off];
              ai[h] = SA * pp[L::PANEL + off];
              if (TILED)
                tile_round(DATA ? lv_k : (int)(lv_pq[w] >> (2 * (2 * u + h))) & 3,
                           ar[h], ai[h]);
            }
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              if (!(need[w] & (1u << (2 * u + v)))) continue;
              const int off = (16 * tj[w] + 8 * v + g) * SR + kk * SK;
              double br = qq[off], bi = SB * qq[L::PANEL + off];
              if (TILED)
                tile_round(DATA ? lv_k : (int)(lv_pq[w] >> (8 + 2 * v)) & 3, br, bi);
              dmma16(cre[w][u][v], ar[0], ar[1], br);
              dmma16(cre[w][u][v], -ai[0], -ai[1], bi);
              dmma16(cim[w][u][v], ar[0], ar[1], bi);
              dmma16(cim[w][u][v], ai[0], ai[1], br);
            }
          }
      }
    }
    cp_async_wait<0>();
    // this bin's G from this block's tile origin: (r, c) of the tile at
    // r * P + c, (c, r) at c * P + r (P^2 < 2^31, checked at launch)
    const int Pi = (int)P;
    O* gr = Gr + (b * P + p0) * P + q0;
    O* gi = Gi + (b * P + p0) * P + q0;
    O* hr = Gr + (b * P + q0) * P + p0;
    O* hi = Gi + (b * P + q0) * P + p0;
#pragma unroll
    for (int w = 0; w < TW; ++w)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          if (!(need[w] & (1u << (2 * u + v)))) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 32 * ti[w] + 16 * u + g + 8 * (e >> 1);
            const int c = 16 * tj[w] + 8 * v + 2 * t + (e & 1);
            if (r >= pv || c >= qv || (diag && r > c)) continue;
            gr[r * Pi + c] = Store<O>::from(cre[w][u][v][e]);
            gi[r * Pi + c] = Store<O>::from(cim[w][u][v][e]);
            if (!diag || r < c) {              // G[q, p] = conj(G[p, q])
              hr[c * Pi + r] = Store<O>::from(cre[w][u][v][e]);
              hi[c * Pi + r] = Store<O>::from(-cim[w][u][v][e]);
            }
          }
        }
    __syncthreads();   // the stages are free before the next bin's copies
  }
}

// Launch the staged GEMM: N (TRANS false, Y (B, m, S) = A X) or T/H (Y
// (B, n, S) = A^T X, A^H X with conj), passes of 8, 16 or 32 columns, as
// many persistent blocks as fit on the card at once.
template <typename O, bool TRANS, bool TILED, bool REAL>
int launch_gemm_f64(const void* Ar, const void* Ai, const void* Xr, const void* Xi,
                    void* Yr, void* Yi, int64_t B, int64_t m, int64_t n, int64_t S,
                    int conj, const TileGrid& tg, int device, cudaStream_t s) {
  const int vec_a = n % 2 == 0 && aligned16(Ar) && aligned16(Ai);
  const int vec_x = S % 2 == 0 && aligned16(Xr) && aligned16(Xi);
  const int64_t M = TRANS ? n : m;
  if ((TRANS ? m : n) == 0) {              // an empty sum: Y = 0
    const size_t bytes = (size_t)(B * M * S) * sizeof(O);
    cudaError_t e = cudaMemsetAsync(Yr, 0, bytes, s);
    if (e == cudaSuccess && !REAL) e = cudaMemsetAsync(Yi, 0, bytes, s);
    return (int)e;
  }
  auto go = [&](auto kernel, int nt, int bytes) {
    const int64_t items =
        B * ((M + kGemmRows - 1) / kGemmRows) * ((S + 8 * nt - 1) / (8 * nt));
    return launch_persistent(
        kernel, kGemmRows / 16 * 32, bytes, items, device, s,
        static_cast<const double*>(Ar), static_cast<const double*>(Ai),
        static_cast<const double*>(Xr), static_cast<const double*>(Xi),
        static_cast<O*>(Yr), static_cast<O*>(Yi), B, m, n, S, conj, vec_a, vec_x, tg);
  };
  if (S <= 8)
    return go(zgemm_f64_kernel<O, 1, TRANS, TILED, REAL>, 1,
              GemmLayout<1, TRANS, REAL>::BYTES);
  if (S <= 16)
    return go(zgemm_f64_kernel<O, 2, TRANS, TILED, REAL>, 2,
              GemmLayout<2, TRANS, REAL>::BYTES);
  return go(zgemm_f64_kernel<O, 4, TRANS, TILED, REAL>, 4,
            GemmLayout<4, TRANS, REAL>::BYTES);
}

// Launch the staged Gram kernel: one 128 x 128 block a bin for
// 64 < P <= 112, else 64 x 64 blocks on and above the diagonal.
template <typename O, bool TILED>
int launch_gram_f64(const void* Ar, const void* Ai, void* Gr, void* Gi, int64_t B,
                    int64_t m, int64_t n, int data, const TileGrid& tg,
                    cudaStream_t s) {
  const int64_t P = data ? m : n;
  const int vec = n % 2 == 0 && aligned16(Ar) && aligned16(Ai);
  if (P * P > 0x7fffffff) return (int)cudaErrorInvalidValue;   // a bin's G: int offsets
  auto go = [&](auto kernel, int64_t bp, int warps, int bytes) {
    const int64_t T = (P + bp - 1) / bp, tiles = T * (T + 1) / 2;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3((unsigned)tiles, batch_grid(B)), warps * 32, bytes, s>>>(
        static_cast<const double*>(Ar), static_cast<const double*>(Ai),
        static_cast<O*>(Gr), static_cast<O*>(Gi), B, m, n, vec, tg);
    return (int)cudaGetLastError();
  };
  if (P > 64 && P <= 112)
    return data ? go(zgram_f64_kernel<O, 128, true, TILED>, 128, GramLayout<128>::WARPS,
                     GramLayout<128>::BYTES)
                : go(zgram_f64_kernel<O, 128, false, TILED>, 128, GramLayout<128>::WARPS,
                     GramLayout<128>::BYTES);
  return data ? go(zgram_f64_kernel<O, 64, true, TILED>, 64, GramLayout<64>::WARPS,
                   GramLayout<64>::BYTES)
              : go(zgram_f64_kernel<O, 64, false, TILED>, 64, GramLayout<64>::WARPS,
                   GramLayout<64>::BYTES);
}

#include "sbgemm_bf16.cuh"
#include "sbgemm_f32.cuh"

// Y (B, m, S) = A (B, m, n) X (B, n, S); REAL: the planes Ar, Xr, Yr only.
template <bool TILED, bool REAL>
int launch_n(const void* Ar, const void* Ai, const void* Xr, const void* Xi, void* Yr,
             void* Yi, int64_t B, int64_t m, int64_t n, int64_t S, const TileGrid& tg,
             int dt_in, int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || m == 0 || S == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dt_in == DT_F64) {
    DISPATCH_DTYPE(dt_out, O,
      return launch_gemm_f64<O, false, TILED, REAL>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, n, S,
                                                    0, tg, device, s);
    )
  }
  if (dt_in == DT_F32) {
    DISPATCH_DTYPE(dt_out, O,
      return f32simt::launch_n<O, TILED, REAL>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, n, S, tg,
                                               device, s);
    )
  }
  if (dt_in != DT_BF16) return (int)cudaErrorInvalidValue;
  // bf16 planes: the tensor cores, tiled or not.  A tiled build's map was
  // checked by its entry; at a bf16 carrier every cell's rounding is the
  // identity (rounds<float> holds only at h, and round_bf16 returns a bf16
  // value as it is), so the tiled complex and real builds run the untiled
  // build and give its bits by construction.
  DISPATCH_DTYPE(dt_out, O,
    return bf16tc::launch_gemm<O, false, REAL>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, n, S, 0,
                                               device, s);
  )
  return (int)cudaErrorInvalidValue;
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
  if (dt_in == DT_F64) {
    DISPATCH_DTYPE(dt_out, O,
      return launch_gemm_f64<O, true, TILED, REAL>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, n, S,
                                                   conj, tg, device, s);
    )
  }
  if (dt_in == DT_F32) {
    DISPATCH_DTYPE(dt_out, O,
      return f32simt::launch_th<O, TILED, REAL>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, n, S, conj,
                                                tg, device, s);
    )
  }
  if (dt_in != DT_BF16) return (int)cudaErrorInvalidValue;
  // bf16 planes: the tensor cores, but for the tiled complex build (the
  // tiled real build runs the untiled build, as in launch_n).  The tiled
  // complex T/H keeps the vector kernel, sbgemm_th_kernel: its sums run in
  // another order than the tensor-core T/H's, so it cannot yet give their
  // bits.
  if constexpr (!TILED || REAL) {
    DISPATCH_DTYPE(dt_out, O,
      return bf16tc::launch_gemm<O, true, REAL>(Ar, Ai, Xr, Xi, Yr, Yi, B, m, n, S, conj,
                                                device, s);
    )
    return (int)cudaErrorInvalidValue;
  } else {   // the tiled complex build of bf16 planes: the vector kernel
    const int64_t bx = (n + kThreads - 1) / kThreads;
    if (bx > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)bx, batch_grid(B));
    using T = __nv_bfloat16;
    DISPATCH_DTYPE(dt_out, O, DISPATCH_PASS(S, SC,
      sbgemm_th_kernel<T, O, SC, TILED><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(Ar), static_cast<const T*>(Ai),
          static_cast<const T*>(Xr), static_cast<const T*>(Xi),
          static_cast<O*>(Yr), static_cast<O*>(Yi), B, m, n, S, conj, tg);
    ))
    return (int)cudaGetLastError();
  }
}

// G = A^H A, (B, n, n), or with data != 0 G = A A^H, (B, m, m).  The tiles
// below the diagonal are the conjugates of those above; the kernels'
// diagonal entries are not symmetrized (ops.sbgemm_gram does that).
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
    DISPATCH_DTYPE(dt_out, O,
      return launch_gram_f64<O, TILED>(Ar, Ai, Gr, Gi, B, m, n, data, tg, s);
    )
  }
  if (dt_in == DT_F32) {
    DISPATCH_DTYPE(dt_out, O,
      return f32simt::launch_gram<O, TILED>(Ar, Ai, Gr, Gi, B, m, n, data, tg, device, s);
    )
  }
  if (dt_in != DT_BF16) return (int)cudaErrorInvalidValue;
  // bf16 planes: the tensor cores.  The tiled build runs the untiled build
  // (as in launch_n): the data space at P <= kWgmmaGramMaxP on wgmma (the
  // calls of sbgemm_gram_complex_wgmma, which bf16tc::launch_gram refuses),
  // the rest on the general bf16 Gram.
  if (TILED && data && m <= bf16tc::kWgmmaGramMaxP) {
    DISPATCH_DTYPE(dt_out, O,
      return bf16tc::launch_gram_wgmma<O>(Ar, Ai, Gr, Gi, B, m, n, device, s);
    )
  }
  DISPATCH_DTYPE(dt_out, O,
    return bf16tc::launch_gram<O>(Ar, Ai, Gr, Gi, B, m, n, data, device, s);
  )
  return (int)cudaErrorInvalidValue;
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

// The data-space Gram of bf16 planes with P = m <= 128 on Hopper's wgmma
// (bf16tc::zgram_wgmma_kernel), which sbgemm_gram_complex refuses; any
// other call is refused here (the wrapper sends it to sbgemm_gram_complex).
int sbgemm_gram_complex_wgmma(const void* Ar, const void* Ai, void* Gr, void* Gi,
                              int64_t B, int64_t m, int64_t n, int data, int dt_in,
                              int dt_out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!data || dt_in != DT_BF16 || m < 1 || m > bf16tc::kWgmmaGramMaxP)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  DISPATCH_DTYPE(dt_out, O,
    return bf16tc::launch_gram_wgmma<O>(Ar, Ai, Gr, Gi, B, m, n, device, s);
  )
  return (int)cudaErrorInvalidValue;
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
