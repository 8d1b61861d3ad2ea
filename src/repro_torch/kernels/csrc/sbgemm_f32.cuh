// f32 planes on the FP32 vector units: the complex N, T/H and Gram blocks
// of sbgemm.cu and the real N and T products, with f32 sums, untiled and
// tiled.
//
// Replaces, for f32 planes, the TPU kernels
// src/repro/kernels/sbgemv.py:sbgemm_n_complex (Y = A X: Yr = rr - ii, Yi =
// ir + ri, the contraction over the long n), :sbgemm_th_complex (Y = A^T X,
// or A^H X with conj, over the short m), :sbgemm_gram_complex (G = A^H A
// per bin, or A A^H in data space, from A as stored), their tiled twins
// :sbgemm_n_complex_tiled, :sbgemm_th_complex_tiled and :sbgemm_gram_tiled,
// and, with the REAL flag of the N and T/H kernels (one A, X and Y plane),
// :sbgemm_n_real, :sbgemm_th_real, :sbgemm_n_real_tiled and
// :sbgemm_th_real_tiled.
// "s" is IEEE f32: every product is an FFMA on the vector units (no TF32,
// no tensor cores, no atomics), so the kernels compute the TPU kernels'
// function up to the order of the sums.  Every output sums its k products
// in one thread, in k order, on every run: no split of a sum across
// threads or blocks.  The tiled builds (TILED) round each A value at its
// cell's level after it lands in shared memory and before any product
// reads it, only where the chunk or item touches a cell that rounds (for
// an f32 carrier a bf16 cell), so on planes quantized up front they give
// the untiled builds' bits: N as each lane reads it, T/H and the Gram once
// for the block, in place, behind one more barrier (a value there feeds
// few FFMAs a lane, so rounding it in each of the 8 or more lanes that
// read it would cost more than the products).
//
// Included by sbgemm.cu inside its anonymous namespace, after the f64 and
// bf16 sections, whose stage(), smem_addr, min64, aligned16 and
// launch_persistent it uses, with common.cuh's cp_async / cp_async_commit /
// cp_async_wait.  Measurement builds of sbgemm.cu and sbgemm_real.cu
// (chip_smoke.py's bound probe; no wrapper loads them) compile one side of
// all three kernels out: SBGEMM_F32_NO_FMA the
// products (the copy pipeline alone), SBGEMM_F32_NO_COPY the operand
// copies (the products alone, on whatever shared memory holds).
//
// All three are persistent (blocks take items blockIdx.x, + gridDim.x,
// ...) and run one cp.async ring of k-chunks across their items, as
// zgemm_f64_kernel does; a block's Walk adds gridDim.x to the item's digits
// with carries, so no division runs past the first item (an item can be a
// single chunk).  16-byte copies where rows allow, else one copy an
// element; rows and columns past the ends of the output axes are not
// copied, and what they hold reaches only outputs that are not stored.
//
// Bounds at the paper shape (1001, 100, 5000), NVIDIA H100 SXM (3.35 TB/s,
// 67 TFLOP/s of FP32 FFMA): a complex A element (8 bytes) carries 8 S
// flops in N and T/H, so both are bytes-bound at S = 8 (4.33 GB, 1.29 ms)
// and bound by the FP32 units at S = 32 (0.128 TFLOP, 1.91 ms, against
// 5.31 GB in 1.59 ms); the data-space Gram does 8 K flops for each of the
// P (P + 1) / 2 entries on and above the diagonal (0.202 TFLOP, 3.02 ms,
// against 4.08 GB in 1.22 ms): FFMA-bound.  So each design reads A once
// and fills the instruction slots with FFMAs, from register tiles that
// take many FFMAs for each shared-memory load:
//
//   N (zgemm_f32_kernel): items are (bin, 100 output rows, a pass of SP =
//     8, 16 or 32 columns): a bin's m = 100 rows are one item, with no
//     padded rows.  A block of 5 warps; each chunk stages both A planes
//     (100 rows x KC k, A's rows as stored) and both X planes (KC k x SP)
//     (16-wide chunks and three blocks an SM at SP = 32, 32-wide chunks
//     and two blocks below).  Warp w owns rows 20 w .. 20 w + 19 and all SP
//     columns; lane (lr, lc) = (lane / 8, lane % 8) holds rows 20 w + lr + 4
//     i (i < 5) and columns C lc .. C lc + C - 1 (C = SP / 8): a 5 x C
//     complex register tile.  A is read as float4 along k, one address per
//     lr, so the 8 lanes of a row share each read; staged A rows are an odd
//     number of 16 bytes long, so the 4 rows a warp reads at one k lie in 4
//     distinct bank groups.  At SP = 32 a step of 4 k is 18 shared loads
//     against 320 FFMAs.  Sums: Re + Ar Xr, then - Ai Xi; Im + Ar Xi, then
//     + Ai Xr.
//   T/H (zgemm_th_f32_kernel): the output rows are A's columns and k is
//     A's short m, so items are (bin, 128 output rows, a pass of SP
//     columns), 40 a bin at n = 5000, each a few k-chunks (m = 100: five
//     20-wide, or seven 16-wide at SP = 32).  A block of 4 warps, three
//     blocks an SM, a ring 3 deep; each chunk stages both A planes [k][r]
//     as stored (512-byte runs along n) and the bin's X rows (KC k x SP),
//     read again from L2 for each row tile.  Lane (lr, lc) of warp w holds
//     rows 32 w + 4 lr + 16 i + q (i < 2, q < 4) and columns C lc .. + C -
//     1: an 8 x C complex tile, A read as two float4 along the rows a plane
//     (the 8 lanes of an lr share each), X as C floats a plane; at SP = 32
//     a k is 6 shared loads against 128 FFMAs.  T and H differ only in the
//     sign of Im(A), which the FFMAs take as an operand modifier (each
//     chunk's products are compiled for both): Re + Ar Xr, then - (s Ai)
//     Xi; Im + Ar Xi, then + (s Ai) Xr, s = -1 for H.  The tiled cell is
//     fixed by (bin, output row): thread t rounds staged rows t (and t +
//     128, REAL).
//   REAL (N and T): one plane, so a real A element (4 bytes) carries 2 S
//     flops: bytes-bound at S = 8 (0.65 ms of bytes, 0.12 of FFMA at the
//     paper shape) and still at S = 32 (0.79 ms against 0.48).  A lane's
//     R x C tile takes R + C shared loads a k-step for R C FFMAs, half the
//     complex tile's 4 R C for 2 (R + C), so the registers of the complex
//     tile's imaginary plane go to twice its columns: lane (lr, lc) = (lane
//     / 4, lane % 4) holds 2 C columns from 2 C lc, and the warp twice the
//     rows, so each load feeds as many products as the complex tile's
//     nearly (N: 13 loads for 160 FFMAs a 4-k step at SP = 32; T: 4 for
//     64 a k).  N: warps of 40 rows, rows lr + 8 i (i < 5), 3 warps an
//     item of 100 rows (the third holds rows 80 .. 99 in a 3-row tile,
//     rows lr + 8 i, i < 3); chunks of 32 k (64 at SP < 32).  T: items of
//     256 output rows, warps of 64, rows 64 w + 4 lr + 32 i + q.  A stage
//     holds the complex build's bytes.
//   Gram (zgram_f32_kernel, DATA: G = A A^H (B, m, m) over k < n, else A^H
//     A (B, n, n) over k < m): tiles of 100 x 100 (25 quads of 4 indices a
//     side); a block of 11 warps, one an SM, a ring 3 deep of k-chunks
//     staged [k][p] (100 floats a k).  Parameter space is [k][p] as stored
//     (16-byte copies); data space transposes in its 4-byte copies, a
//     warp's copy 32 k of one row, so its global read is one 128-byte run.
//     Items are (bin, (i, j) of the T x T tile grid): (t, t) a diagonal
//     tile, whose 325 quad pairs on and above the diagonal (the row-major
//     triangle) are the lanes' 4 x 4 complex tiles; (i, j), i < j, the
//     first 13 p-quads of tile i against tile j, and (j, i) the other 12,
//     each quad pair a lane.  For P <= 100 (the paper's data space) a bin
//     is one item, read from HBM once: one staged panel of 64-wide chunks
//     (256-byte runs of A's rows) feeds both factors; above, 32-wide chunks
//     of the p and q panels.  A lane reads a float4 of each factor a plane
//     a k: 4 shared loads against 64 FFMAs.  Sums: Re + Pr Qr, then + Pi
//     Qi; Im (data) + Pi Qr, then - Pr Qi, (parameter) + Pr Qi, then - Pi
//     Qr.  Each entry on or above the diagonal is written, and its
//     conjugate below it; the diagonal's imaginary parts are not zeroed
//     (ops.sbgemm_gram symmetrizes).  The tiled data-space cell is fixed by
//     (bin, k), the parameter-space one by (bin, p) for each factor;
//     thread t rounds column t % 100 of panel t / 100.
//
// Measured (PERF.md, chip_smoke.py's bound probe): the T/H is bound by its
// copies at S = 8 and by its FFMAs at S = 32, the Gram by its FFMAs, and
// the FFMA sides run well under the FP32 peak with the SM clock at its
// maximum.  The real N and T are bound by their copies at S = 8 and S =
// 32; at S = 32 each side alone takes about 70 % of the whole.

namespace f32simt {

// ---------------------------------------------------------------------------
// Shared by the three kernels
// ---------------------------------------------------------------------------

// A block's position in its stream of chunks: item (b, rt, sp) of the B x
// RTS x SPS items (bin, row tile, pass) in row-major order, taken
// blockIdx.x, + gridDim.x, ..., chunk c of the item's KCH, and the ring
// stage it goes to.
struct Steps {                              // the block's step in each digit
  int RTS, SPS, rt, sp;
  int64_t b;
  __device__ Steps(int rts, int sps)
      : RTS(rts), SPS(sps), rt((int)(gridDim.x / sps % rts)), sp((int)(gridDim.x % sps)),
        b(gridDim.x / ((int64_t)rts * sps)) {}
};

template <int NS>
struct Walk {
  int64_t b, c;
  int rt, sp, slot;
  __device__ void first(const Steps& g) {
    b = blockIdx.x / ((int64_t)g.RTS * g.SPS);
    rt = (int)(blockIdx.x / g.SPS % g.RTS);
    sp = (int)(blockIdx.x % g.SPS);
    c = 0;
    slot = 0;
  }
  // to the next chunk; true where it starts the next item
  __device__ bool next(const Steps& g, int64_t KCH) {
    slot = slot + 1 == NS ? 0 : slot + 1;
    if (++c < KCH) return false;
    c = 0;
    if ((sp += g.sp) >= g.SPS) sp -= g.SPS, ++rt;
    if ((rt += g.rt) >= g.RTS) rt -= g.RTS, ++b;
    b += g.b;
    return true;
  }
};

// Whether a column in [lo, hi) lies in a cell of a bin's row of cells that
// rounds an f32 carrier.  Cells c >= C start at INT32_MAX: never.
__device__ __forceinline__ bool cells_round(const TileGrid& tg, uint32_t cells, int64_t lo,
                                            int64_t hi) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    const int64_t a = tg.col0[i], e = i + 1 < kMaxTiles ? tg.col0[i + 1] : INT32_MAX;
    any |= a < hi && e > lo && rounds<float>((int)(cells >> (2 * i)) & 3);
  }
  return any;
}

// Bit j set where column lo + j (j < len <= 64) lies in such a cell.
__device__ __forceinline__ uint64_t round_bits(const TileGrid& tg, uint32_t cells,
                                               int64_t lo, int len) {
  uint64_t bits = 0;
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    if (!rounds<float>((int)(cells >> (2 * i)) & 3)) continue;
    const int64_t e = i + 1 < kMaxTiles ? tg.col0[i + 1] : INT32_MAX;
    const int s = (int)min64(len, tg.col0[i] > lo ? tg.col0[i] - lo : 0);
    const int t = (int)min64(len, e > lo ? e - lo : 0);
    if (s < t) bits |= (t == 64 ? ~0ull : (1ull << t) - 1ull) & ~((1ull << s) - 1ull);
  }
  return bits;
}

// C consecutive floats of shared memory (16-, 8- or 4-byte aligned).
template <int C>
__device__ __forceinline__ void load_row(float (&v)[C], const float* p) {
  if constexpr (C == 8) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    const float4 r = *reinterpret_cast<const float4*>(p + 4);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    v[4] = r.x, v[5] = r.y, v[6] = r.z, v[7] = r.w;
  } else if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (C == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ float part(const float4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// Store the outputs v[j] with bit j of mask at p[j]; vec: p is aligned to
// the whole run, which is then one vector store when every bit is set.
template <typename O, int N>
__device__ __forceinline__ void store_run(O* p, const float (&v)[N], uint32_t mask,
                                          bool vec) {
  if (vec && mask == (1u << N) - 1u) {
    struct alignas(sizeof(O) * N > 16 ? 16 : sizeof(O) * N) Run { O e[N]; } r;
#pragma unroll
    for (int j = 0; j < N; ++j) r.e[j] = Store<O>::from(v[j]);
    *reinterpret_cast<Run*>(p) = r;
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (mask >> j & 1) p[j] = Store<O>::from(v[j]);
}

// ---------------------------------------------------------------------------
// N: Y (B, m, S) = A (B, m, n) X (B, n, S)
// ---------------------------------------------------------------------------

constexpr int kTRows = 5;                   // rows of a lane's tile: lr + LR i
constexpr int kRows = 100;                  // rows of an item

// Shared-memory layout of a stage for passes of SP = 8 C columns: the A
// panel of each of the PL planes (PROWS x KC) and the X panel of each
// plane (KC x SP), NS stages, BLOCKS blocks an SM.  Complex: 5 warps of WROWS = 20
// rows, lane (lr, lc) = (lane / 8, lane % 8) with a 5 x C tile (CT = C
// columns); at SP = 32 (the FFMA-bound pass) 16-wide chunks and three
// blocks an SM (15 warps, the register tile in 128 registers); narrower
// passes (bytes-bound) 32-wide chunks and two blocks.  REAL: 3 warps of 40
// rows, lane (lane / 4, lane % 4) with a 5 x 2 C tile, chunks twice as
// wide; the panel has 104 rows, as the third warp's 3-row tile reads rows
// 80 .. 103 (rows past the item are never stored).
template <int C, bool REAL>
struct Layout {
  static constexpr int SP = 8 * C, XLD = SP, PL = REAL ? 1 : 2;
  static constexpr int WARPS = REAL ? 3 : 5, THREADS = 32 * WARPS;
  static constexpr int LCB = REAL ? 2 : 3, LC = 1 << LCB, LR = 32 / LC, CT = SP / LC;
  static constexpr int WROWS = kTRows * LR;   // rows of a warp's band
  static constexpr int PROWS = REAL ? 104 : kRows;
  static constexpr int KC = (C == 4 ? 16 : 32) * (REAL ? 2 : 1), NS = 3;
  static constexpr int BLOCKS = C == 4 ? (REAL ? 4 : 3) : 2;
  static constexpr int ALD = KC + 4;       // a staged A row: an odd number of 16 bytes
  static constexpr int A_TILE = PROWS * ALD, X_TILE = KC * XLD;
  static constexpr int STAGE = PL * (A_TILE + X_TILE);         // floats
  static constexpr int BYTES = 4 * NS * STAGE;
  static_assert((ALD / 4) % 2 == 1, "the LR rows a warp reads lie in distinct bank groups");
};

template <typename O, int C, bool TILED, bool REAL>
__global__ void __launch_bounds__(Layout<C, REAL>::THREADS, Layout<C, REAL>::BLOCKS)
zgemm_f32_kernel(const float* __restrict__ Ar, const float* __restrict__ Ai,
                 const float* __restrict__ Xr, const float* __restrict__ Xi,
                 O* __restrict__ Yr, O* __restrict__ Yi, int64_t B, int64_t m, int64_t n,
                 int64_t S, AStrides as, int vec_a, int vec_x, TileGrid tg) {
  using L = Layout<C, REAL>;
  constexpr int SP = L::SP, KC = L::KC, NS = L::NS, ALD = L::ALD, PL = L::PL;
  constexpr int LR = L::LR, CT = L::CT, NTH = L::THREADS;
  extern __shared__ __align__(16) float sf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lc = lane & (L::LC - 1);
  const int row0 = L::WROWS * warp + (lane >> L::LCB);   // this thread's rows row0 + LR i
  const int64_t M = m, KCH = (n + KC - 1) / KC;
  const Steps g((int)((M + kRows - 1) / kRows), (int)((S + SP - 1) / SP));
  struct Cursor : Walk<NS> {
    int64_t r0, s0;
    int rv, sv;
    uint32_t cells;                          // tiled: the bin's row of cells
  };
  auto at_item = [&](Cursor& q) {     // past the last item, q.b >= B
    q.cells = TILED && q.b < B ? tile_row(tg, q.b) : 0u;
    q.r0 = (int64_t)q.rt * kRows;
    q.s0 = (int64_t)q.sp * SP;
    q.rv = (int)min64(kRows, M - q.r0);
    q.sv = (int)min64(SP, S - q.s0);
  };
  auto advance = [&](Cursor& q) {
    if (q.next(g, KCH)) at_item(q);
  };
  // one copy group a chunk (empty past the last), so the wait counts chunks
  auto load = [&](const Cursor& w) {
#ifndef SBGEMM_F32_NO_COPY
    if (w.b < B) {
      const int64_t k0 = w.c * KC;
      const int kv = (int)min64(KC, n - k0);
      float* st = sf + w.slot * L::STAGE;
#pragma unroll
      for (int pl = 0; pl < PL; ++pl) {
        const float* a = (pl ? Ai : Ar) + w.b * as.batch + w.r0 * as.ld + k0;
        stage<kRows, KC, ALD, NTH, false>(st + pl * L::A_TILE, a, as.ld, w.rv, kv,
                                          vec_a);
        const float* x = (pl ? Xi : Xr) + (w.b * n + k0) * S + w.s0;
        stage<KC, SP, L::XLD, NTH, true>(st + PL * L::A_TILE + pl * L::X_TILE, x, S, kv,
                                         w.sv, vec_x);
      }
    }
#endif
    cp_async_commit();
  };
  float acc[PL][kTRows][CT];
#pragma unroll
  for (int p = 0; p < PL; ++p)
#pragma unroll
    for (int i = 0; i < kTRows; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[p][i][c] = 0.f;
  Cursor w, ld;                              // compute and load cursors
  w.first(g);
  at_item(w);
  ld = w;
#pragma unroll
  for (int f = 0; f < NS - 1; ++f) {
    load(ld);
    advance(ld);
  }
  for (; w.b < B; advance(w)) {
    cp_async_wait<NS - 2>();    // this thread's copies of chunk w landed
    __syncthreads();                 // everyone's; the chunk before is consumed
    load(ld);
    advance(ld);
    const int band = w.rv - L::WROWS * warp;  // whole warp: rows left in its band
#ifndef SBGEMM_F32_NO_FMA
    if (band > 0) {
      const float* pa = sf + w.slot * L::STAGE + row0 * ALD;
      const float* px = sf + w.slot * L::STAGE + PL * L::A_TILE + CT * lc;
      // the chunk's products on the lane's first R rows; ROUND (tiled, the
      // chunk holds a column whose cell rounds): each A value rounded at its
      // column's level first, the k-steps not unrolled (unrolled, the
      // levels' registers spill)
      auto products = [&](auto rounding, auto tile_rows) {
        constexpr bool ROUND = decltype(rounding)::value;
        constexpr int R = decltype(tile_rows)::value;
#pragma unroll (ROUND ? 1 : KC / 4)
        for (int k4 = 0; k4 < KC; k4 += 4) {
          float4 a[PL][R];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int p = 0; p < PL; ++p)
              a[p][i] = *reinterpret_cast<const float4*>(pa + p * L::A_TILE +
                                                         LR * i * ALD + k4);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float x[PL][CT];
#pragma unroll
            for (int p = 0; p < PL; ++p)
              load_row<CT>(x[p], px + p * L::X_TILE + (k4 + kk) * L::XLD);
            const int lv = ROUND ? tile_level(tg, w.cells, w.c * KC + k4 + kk) : 1;
#pragma unroll
            for (int i = 0; i < R; ++i) {
              float re = part(a[0][i], kk);
              if (ROUND) re = quantize(re, lv);
              if constexpr (REAL) {
#pragma unroll
                for (int c = 0; c < CT; ++c) acc[0][i][c] = fmaf(re, x[0][c], acc[0][i][c]);
              } else {
                float im = part(a[PL - 1][i], kk);
                if (ROUND) im = quantize(im, lv);
#pragma unroll
                for (int c = 0; c < CT; ++c) {
                  acc[0][i][c] = fmaf(re, x[0][c], acc[0][i][c]);
                  acc[0][i][c] = fmaf(-im, x[PL - 1][c], acc[0][i][c]);
                  acc[PL - 1][i][c] = fmaf(re, x[PL - 1][c], acc[PL - 1][i][c]);
                  acc[PL - 1][i][c] = fmaf(im, x[0][c], acc[PL - 1][i][c]);
                }
              }
            }
          }
        }
      };
      // REAL: a band of at most 24 rows (the item's last) takes a 3-row tile
      auto rows_of = [&](auto rounding) {
        if constexpr (REAL) {
          if (band <= 3 * LR) return products(rounding, std::integral_constant<int, 3>{});
        }
        products(rounding, std::integral_constant<int, kTRows>{});
      };
      if (TILED && cells_round(tg, w.cells, w.c * KC, w.c * KC + KC))
        rows_of(std::true_type{});
      else
        rows_of(std::false_type{});
    }
#endif
    if (w.c == KCH - 1 && band > 0) {        // the item's last chunk: store
#pragma unroll
      for (int p = 0; p < PL; ++p)
#pragma unroll
        for (int i = 0; i < kTRows; ++i)
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const int row = row0 + LR * i, col = CT * lc + c;
            if (row < w.rv && col < w.sv)
              (p ? Yi : Yr)[(w.b * m + w.r0 + row) * S + w.s0 + col] =
                  Store<O>::from(acc[p][i][c]);
            acc[p][i][c] = 0.f;
          }
    }
  }
}

// Y (B, m, S) = A (B, m, n) X (B, n, S) on f32 planes, passes of 8, 16 or
// 32 columns; REAL: the planes Ar, Xr, Yr only (Ai, Xi, Yi null).
template <typename O, bool TILED, bool REAL>
int launch_n(const void* Ar, const void* Ai, const void* Xr, const void* Xi, void* Yr,
             void* Yi, int64_t B, int64_t m, int64_t n, int64_t S, AStrides as,
             const TileGrid& tg, int device, cudaStream_t s) {
  if (n == 0) {                              // an empty sum: Y = 0
    const size_t bytes = (size_t)(B * m * S) * sizeof(O);
    cudaError_t e = cudaMemsetAsync(Yr, 0, bytes, s);
    if (e == cudaSuccess && !REAL) e = cudaMemsetAsync(Yi, 0, bytes, s);
    return (int)e;
  }
  const int vec_a = vec_rows<4>(n, as) && aligned16(Ar) && aligned16(Ai);
  const int vec_x = S % 4 == 0 && aligned16(Xr) && aligned16(Xi);
  const int64_t rts = (m + kRows - 1) / kRows;
  auto go = [&](auto kernel, int c, int threads, int bytes) {
    return launch_persistent(kernel, threads, bytes,
                             B * rts * ((S + 8 * c - 1) / (8 * c)), device, s,
                             static_cast<const float*>(Ar), static_cast<const float*>(Ai),
                             static_cast<const float*>(Xr), static_cast<const float*>(Xi),
                             static_cast<O*>(Yr), static_cast<O*>(Yi), B, m, n, S, as,
                             vec_a, vec_x, tg);
  };
  using L1 = Layout<1, REAL>;
  using L2 = Layout<2, REAL>;
  using L4 = Layout<4, REAL>;
  if (S <= 8) return go(zgemm_f32_kernel<O, 1, TILED, REAL>, 1, L1::THREADS, L1::BYTES);
  if (S <= 16) return go(zgemm_f32_kernel<O, 2, TILED, REAL>, 2, L2::THREADS, L2::BYTES);
  return go(zgemm_f32_kernel<O, 4, TILED, REAL>, 4, L4::THREADS, L4::BYTES);
}

// ---------------------------------------------------------------------------
// T/H: Y (B, n, S) = A^T X, or A^H X with conj; X (B, m, S)
// ---------------------------------------------------------------------------

constexpr int kTHWarps = 4;
constexpr int kTHThreads = 32 * kTHWarps;

// A stage: the A panel of each of the PL planes (KC k x ROWS, [k][r]) and
// the X panel of each plane (KC k x SP), NS stages, three blocks an SM (12
// warps to cover the barriers; 16-wide chunks at SP = 32 so that three
// fit).  Complex: items of 128 output rows, 32 a warp, lane (lr, lc) =
// (lane / 8, lane % 8), CT = C columns; REAL: 256 rows, 64 a warp, lane
// (lane / 4, lane % 4), CT = 2 C columns.
template <int C, bool REAL>
struct THLayout {
  static constexpr int SP = 8 * C, KC = C == 4 ? 16 : 20, NS = 3, BLOCKS = 3;
  static constexpr int PL = REAL ? 1 : 2, LCB = REAL ? 2 : 3, LC = 1 << LCB, LR = 32 / LC;
  static constexpr int CT = SP / LC;
  static constexpr int ROWS = 8 * LR * kTHWarps;
  static constexpr int A_TILE = KC * ROWS, X_TILE = KC * SP;
  static constexpr int STAGE = PL * (A_TILE + X_TILE);         // floats
  static constexpr int BYTES = 4 * NS * STAGE;
  static_assert(ROWS % kTHThreads == 0, "the threads round the tiled A panel's rows");
};

template <typename O, int C, bool TILED, bool REAL>
__global__ void __launch_bounds__(kTHThreads, THLayout<C, REAL>::BLOCKS)
zgemm_th_f32_kernel(const float* __restrict__ Ar, const float* __restrict__ Ai,
                    const float* __restrict__ Xr, const float* __restrict__ Xi,
                    O* __restrict__ Yr, O* __restrict__ Yi, int64_t B, int64_t m,
                    int64_t n, int64_t S, AStrides as, int conj, int vec_a, int vec_x,
                    int vec_y, TileGrid tg) {
  using L = THLayout<C, REAL>;
  constexpr int SP = L::SP, KC = L::KC, NS = L::NS, PL = L::PL, LR = L::LR;
  constexpr int CT = L::CT, ROWS = L::ROWS, RPT = ROWS / kTHThreads;
  extern __shared__ __align__(16) float sf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lc = lane & (L::LC - 1);
  // rows row0 + 4 LR i + q (i < 2, q < 4): the warp's 8 LR rows
  const int row0 = 8 * LR * warp + 4 * (lane >> L::LCB);
  const bool vy = vec_y && S % CT == 0;      // each lane's run of CT aligned
  const int64_t KCH = (m + KC - 1) / KC;
  const Steps g((int)((n + ROWS - 1) / ROWS), (int)((S + SP - 1) / SP));
  struct Cursor : Walk<NS> {
    int64_t r0, s0;
    int rv, sv;
    uint32_t cells;                          // tiled: the bin's row of cells
  };
  auto at_item = [&](Cursor& q) {     // past the last item, q.b >= B
    q.cells = TILED && q.b < B ? tile_row(tg, q.b) : 0u;
    q.r0 = (int64_t)q.rt * ROWS;
    q.s0 = (int64_t)q.sp * SP;
    q.rv = (int)min64(ROWS, n - q.r0);
    q.sv = (int)min64(SP, S - q.s0);
  };
  auto advance = [&](Cursor& q) {
    if (q.next(g, KCH)) at_item(q);
  };
  auto load = [&](const Cursor& w) {
#ifndef SBGEMM_F32_NO_COPY
    if (w.b < B) {
      const int64_t k0 = w.c * KC;
      const int kv = (int)min64(KC, m - k0);
      float* st = sf + w.slot * L::STAGE;
#pragma unroll
      for (int pl = 0; pl < PL; ++pl) {
        // A's rows k0.. (k), its columns r0.. (the output rows)
        const float* a = (pl ? Ai : Ar) + w.b * as.batch + k0 * as.ld + w.r0;
        stage<KC, ROWS, ROWS, kTHThreads, true>(st + pl * L::A_TILE, a, as.ld, kv, w.rv,
                                                vec_a);
        const float* x = (pl ? Xi : Xr) + (w.b * m + k0) * S + w.s0;
        stage<KC, SP, SP, kTHThreads, true>(st + PL * L::A_TILE + pl * L::X_TILE, x, S,
                                             kv, w.sv, vec_x);
      }
    }
#endif
    cp_async_commit();
  };
  float acc[PL][2][4][CT];                   // plane, i, q, column
#pragma unroll
  for (int p = 0; p < PL; ++p)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < CT; ++c) acc[p][i][q][c] = 0.f;
  bool item_rounds = false;   // tiled: the item has a row whose cell rounds
  uint32_t own_rounds = 0;    // tiled: bit j, so does row threadIdx.x + 128 j
  Cursor w, ld;                              // compute and load cursors
  w.first(g);
  at_item(w);
  ld = w;
#pragma unroll
  for (int f = 0; f < NS - 1; ++f) {
    load(ld);
    advance(ld);
  }
  for (; w.b < B; advance(w)) {
    cp_async_wait<NS - 2>();    // this thread's copies of chunk w landed
    __syncthreads();                 // everyone's; the chunk before is consumed
    load(ld);
    advance(ld);
    const bool rows = 8 * LR * warp < w.rv;  // whole warp: rows in its band
    const int kv = (int)min64(KC, m - w.c * KC);
    if (TILED && w.c == 0) {
      item_rounds = cells_round(tg, w.cells, w.r0, w.r0 + w.rv);
      own_rounds = 0;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int64_t r = w.r0 + threadIdx.x + kTHThreads * j;
        own_rounds |= (uint32_t)cells_round(tg, w.cells, r, r + 1) << j;
      }
    }
    if (TILED && item_rounds) {
      // the chunk's A values of rounding rows rounded to bf16 once, in
      // place, before any lane reads them: thread t owns rows t + 128 j
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (!(own_rounds >> j & 1)) continue;
        float* a = sf + w.slot * L::STAGE + threadIdx.x + kTHThreads * j;
        for (int k = 0; k < kv; ++k)
#pragma unroll
          for (int p = 0; p < PL; ++p)
            a[p * L::A_TILE + k * ROWS] = round_bf16(a[p * L::A_TILE + k * ROWS]);
      }
      __syncthreads();
    }
#ifndef SBGEMM_F32_NO_FMA
    if (rows) {
      const float* pa = sf + w.slot * L::STAGE + row0;
      const float* px = sf + w.slot * L::STAGE + PL * L::A_TILE + CT * lc;
      // CONJ: Im(A) negated, a sign the FFMAs take for free.  REAL: two k
      // a step (with four the tiled build's 8 x 8 tile spilled; two run as
      // fast)
      auto products = [&](auto conjugate) {
        [[maybe_unused]] constexpr float SGN = decltype(conjugate)::value ? -1.f : 1.f;
#pragma unroll (REAL ? 2 : 4)
        for (int k = 0; k < kv; ++k) {
          float4 a[PL][2];
          float x[PL][CT];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int p = 0; p < PL; ++p)
              a[p][i] = *reinterpret_cast<const float4*>(pa + p * L::A_TILE + k * ROWS +
                                                         4 * LR * i);
#pragma unroll
          for (int p = 0; p < PL; ++p) load_row<CT>(x[p], px + p * L::X_TILE + k * SP);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float re = part(a[0][i], q);
              if constexpr (REAL) {
#pragma unroll
                for (int c = 0; c < CT; ++c)
                  acc[0][i][q][c] = fmaf(re, x[0][c], acc[0][i][q][c]);
              } else {
                const float im = part(a[PL - 1][i], q);
#pragma unroll
                for (int c = 0; c < CT; ++c) {
                  acc[0][i][q][c] = fmaf(re, x[0][c], acc[0][i][q][c]);
                  acc[0][i][q][c] = fmaf(-SGN * im, x[PL - 1][c], acc[0][i][q][c]);
                  acc[PL - 1][i][q][c] = fmaf(re, x[PL - 1][c], acc[PL - 1][i][q][c]);
                  acc[PL - 1][i][q][c] = fmaf(SGN * im, x[0][c], acc[PL - 1][i][q][c]);
                }
              }
            }
        }
      };
      if (!REAL && conj) products(std::true_type{});
      else products(std::false_type{});
    }
#endif
    if (w.c == KCH - 1 && rows) {            // the item's last chunk: store
      const int cv = w.sv - CT * lc;         // this lane's columns in the pass
      const uint32_t cols = cv >= CT ? (1u << CT) - 1u : cv > 0 ? (1u << cv) - 1u : 0u;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = row0 + 4 * LR * i + q;
          const int64_t off = (w.b * n + w.r0 + row) * S + w.s0 + CT * lc;
#pragma unroll
          for (int p = 0; p < PL; ++p) {
            if (row < w.rv) store_run<O, CT>((p ? Yi : Yr) + off, acc[p][i][q], cols, vy);
#pragma unroll
            for (int c = 0; c < CT; ++c) acc[p][i][q][c] = 0.f;
          }
        }
    }
  }
}

// Y (B, n, S) = A^T X (A^H X with conj) on f32 planes, passes of 8, 16 or
// 32 columns; REAL: the planes Ar, Xr, Yr only (Ai, Xi, Yi null; conj 0).
template <typename O, bool TILED, bool REAL>
int launch_th(const void* Ar, const void* Ai, const void* Xr, const void* Xi, void* Yr,
              void* Yi, int64_t B, int64_t m, int64_t n, int64_t S, AStrides as,
              int conj, const TileGrid& tg, int device, cudaStream_t s) {
  if (m == 0) {                              // an empty sum: Y = 0
    const size_t bytes = (size_t)(B * n * S) * sizeof(O);
    cudaError_t e = cudaMemsetAsync(Yr, 0, bytes, s);
    if (e == cudaSuccess && !REAL) e = cudaMemsetAsync(Yi, 0, bytes, s);
    return (int)e;
  }
  const int vec_a = vec_rows<4>(n, as) && aligned16(Ar) && aligned16(Ai);
  const int vec_x = S % 4 == 0 && aligned16(Xr) && aligned16(Xi);
  const int vec_y = aligned16(Yr) && aligned16(Yi);
  constexpr int rows = THLayout<1, REAL>::ROWS;   // an item's output rows
  const int64_t rts = (n + rows - 1) / rows;
  auto go = [&](auto kernel, int c, int bytes) {
    return launch_persistent(kernel, kTHThreads, bytes,
                             B * rts * ((S + 8 * c - 1) / (8 * c)), device, s,
                             static_cast<const float*>(Ar), static_cast<const float*>(Ai),
                             static_cast<const float*>(Xr), static_cast<const float*>(Xi),
                             static_cast<O*>(Yr), static_cast<O*>(Yi), B, m, n, S, as,
                             conj, vec_a, vec_x, vec_y, tg);
  };
  if (S <= 8)
    return go(zgemm_th_f32_kernel<O, 1, TILED, REAL>, 1, THLayout<1, REAL>::BYTES);
  if (S <= 16)
    return go(zgemm_th_f32_kernel<O, 2, TILED, REAL>, 2, THLayout<2, REAL>::BYTES);
  return go(zgemm_th_f32_kernel<O, 4, TILED, REAL>, 4, THLayout<4, REAL>::BYTES);
}

// ---------------------------------------------------------------------------
// Gram: G = A A^H (DATA, (B, m, m)) or A^H A ((B, n, n))
// ---------------------------------------------------------------------------

constexpr int kGQuads = 25;                          // quads of 4 indices a tile side
constexpr int kGTile = 4 * kGQuads;                  // 100
constexpr int kGSlots = kGQuads * (kGQuads + 1) / 2; // a diagonal tile's quad pairs: 325
constexpr int kGHalf = (kGQuads + 1) / 2;            // p-quads of an off-diagonal tile's first item
constexpr int kGWarps = (kGSlots + 31) / 32;         // 11
constexpr int kGThreads = 32 * kGWarps;

// A stage: the panels (each KC k x kGTile, [k][p]) of both planes.  ONE (P
// <= 100, a bin one diagonal tile): one panel of 64-wide chunks, 256-byte
// runs of A's rows in data space; else the p and q panels, 32 wide.
template <bool ONE>
struct GLayout {
  static constexpr int KC = ONE ? 64 : 32, NS = 3, LD = kGTile, PANELS = ONE ? 1 : 2;
  static constexpr int PANEL = KC * LD;
  static constexpr int STAGE = 2 * PANELS * PANEL;           // floats
  static constexpr int BYTES = 4 * NS * STAGE;
};

// Stage rows r < rv of A (row r at src + r ld, along k) as [k][r]: element
// (r, k), k < kv, to dst[k LD + r].  A warp copies 32 k of one row, so its
// global read is one 128-byte run.
template <int KC, int LD>
__device__ __forceinline__ void stage_transposed(float* dst, const float* src, int64_t ld,
                                                 int rv, int kv) {
  const uint32_t d0 = smem_addr(dst);
  for (int e = threadIdx.x; e < kGTile * KC; e += kGThreads) {
    const int u = e >> 5;
    const int r = u % kGTile, k = 32 * (u / kGTile) + (e & 31);
    if (r < rv && k < kv) cp_async<4>(d0 + 4 * (k * LD + r), src + r * ld + k, true);
  }
}

template <typename O, bool DATA, bool TILED, bool ONE>
__global__ void __launch_bounds__(kGThreads, 1)
zgram_f32_kernel(const float* __restrict__ Ar, const float* __restrict__ Ai,
                 O* __restrict__ Gr, O* __restrict__ Gi, int64_t B, int64_t m, int64_t n,
                 int vec, int vec_g, TileGrid tg) {
  using L = GLayout<ONE>;
  constexpr int KC = L::KC, NS = L::NS, LD = L::LD;
  extern __shared__ __align__(16) float sf[];
  const int64_t P = DATA ? m : n, K = DATA ? n : m;
  const int T = (int)((P + kGTile - 1) / kGTile);
  const int64_t KCH = (K + KC - 1) / KC;
  const Steps g(T * T, 1);
  // this thread's quad pair: (dp, dq) of a diagonal tile (the row-major
  // triangle; none from slot kGSlots on), (op, oq) of an off-diagonal item.
  // A thread without one reads quad 0, inside the stage.
  int dp = 0, dq = threadIdx.x;
  while (dp < kGQuads && dq >= kGQuads - dp) dq -= kGQuads - dp++;
  dq += dp;
  const int op = threadIdx.x / kGQuads, oq = threadIdx.x % kGQuads;
  struct Cursor : Walk<NS> {
    int64_t p0, q0;
    int pv, qv, gp, gq;
    bool diag, valid;
    uint32_t cells;                          // tiled: the bin's row of cells
  };
  // item rt of a bin: (i, j) of the T x T tiles; (t, t) the diagonal tile t,
  // (i, j) with i < j p-quads 0 .. 12 of tile i against tile j, (j, i) the
  // p-quads 13 .. 24 of tile i against tile j
  auto at_item = [&](Cursor& q) {
    const int i = q.rt / T, j = q.rt % T;
    q.diag = i == j;
    q.p0 = (int64_t)min(i, j) * kGTile;
    q.q0 = (int64_t)max(i, j) * kGTile;
    q.pv = (int)min64(kGTile, P - q.p0);
    q.qv = (int)min64(kGTile, P - q.q0);
    if (q.diag) {
      q.gp = dp, q.gq = dq;
      q.valid = dp < kGQuads;
    } else {
      q.gp = i < j ? op : op + kGHalf;
      q.gq = oq;
      q.valid = op < (i < j ? kGHalf : kGQuads - kGHalf);
    }
    if (!q.valid) q.gp = q.gq = 0;
    q.valid = q.valid && 4 * q.gp < q.pv && 4 * q.gq < q.qv;
    q.cells = TILED && q.b < B ? tile_row(tg, q.b) : 0u;
  };
  auto advance = [&](Cursor& q) {
    if (q.next(g, KCH)) at_item(q);
  };
  auto load = [&](const Cursor& w) {
#ifndef SBGEMM_F32_NO_COPY
    if (w.b < B) {
      const int64_t k0 = w.c * KC;
      const int kv = (int)min64(KC, K - k0);
      float* st = sf + w.slot * L::STAGE;
#pragma unroll
      for (int panel = 0; panel < 2; ++panel) {
        if (panel && (ONE || w.diag)) break;   // one panel feeds both factors
        const int64_t r0 = panel ? w.q0 : w.p0;
        const int rv = panel ? w.qv : w.pv;
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
          float* dst = st + (2 * panel + pl) * L::PANEL;
          const float* src = (pl ? Ai : Ar) + w.b * m * n;
          if (DATA)   // A's rows r0.. (p), its columns k0.. (k)
            stage_transposed<KC, LD>(dst, src + r0 * n + k0, n, rv, kv);
          else        // A's rows k0.. (k), its columns r0.. (p)
            stage<KC, kGTile, LD, kGThreads, true>(dst, src + k0 * n + r0, n, kv, rv,
                                                   vec);
        }
      }
    }
#endif
    cp_async_commit();
  };
  float cr[4][4], ci[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) cr[u][v] = ci[u][v] = 0.f;
  bool on = false;            // the warp has a lane tile in the item
  // tiled, parameter space: a factor's cell rounds; so does the panel
  // column this thread rounds (thread t: column t % kGTile of panel t /
  // kGTile)
  bool item_rounds = false, own_rounds = false;
  Cursor w, ld;                              // compute and load cursors
  w.first(g);
  at_item(w);
  ld = w;
#pragma unroll
  for (int f = 0; f < NS - 1; ++f) {
    load(ld);
    advance(ld);
  }
  for (; w.b < B; advance(w)) {
    cp_async_wait<NS - 2>();    // this thread's copies of chunk w landed
    __syncthreads();                 // everyone's; the chunk before is consumed
    load(ld);
    advance(ld);
    const int64_t k0 = w.c * KC;
    const int kv = (int)min64(KC, K - k0);
    const int panels = ONE || w.diag ? 1 : 2;
    if (w.c == 0) {
      on = __any_sync(0xffffffffu, w.valid);
      if (TILED && !DATA) {
        const int64_t col = (threadIdx.x < kGTile ? w.p0 : w.q0) + threadIdx.x % kGTile;
        item_rounds = cells_round(tg, w.cells, w.p0, w.p0 + w.pv) ||
                      cells_round(tg, w.cells, w.q0, w.q0 + w.qv);
        own_rounds = cells_round(tg, w.cells, col, col + 1);
      }
    }
    // tiled, data space: bit k, column k0 + k rounds
    const uint64_t k_bits = TILED && DATA ? round_bits(tg, w.cells, k0, kv) : 0u;
    if (TILED && (DATA ? k_bits != 0 : item_rounds)) {
      // the chunk's factors in rounding cells rounded to bf16 once, in
      // place, before any lane reads them
      if ((int)threadIdx.x < panels * kGTile) {
        float* a = sf + w.slot * L::STAGE + 2 * (threadIdx.x / kGTile) * L::PANEL +
                   threadIdx.x % kGTile;
        for (int k = 0; k < kv; ++k)
          if (DATA ? (k_bits >> k & 1) : own_rounds) {
            a[k * LD] = round_bf16(a[k * LD]);
            a[L::PANEL + k * LD] = round_bf16(a[L::PANEL + k * LD]);
          }
      }
      __syncthreads();
    }
#ifndef SBGEMM_F32_NO_FMA
    if (on) {
      const float* pp = sf + w.slot * L::STAGE + 4 * w.gp;
      const float* qq = sf + w.slot * L::STAGE + (panels - 1) * 2 * L::PANEL + 4 * w.gq;
#pragma unroll 4
      for (int k = 0; k < kv; ++k) {
        const float4 p_r = *reinterpret_cast<const float4*>(pp + k * LD);
        const float4 p_i = *reinterpret_cast<const float4*>(pp + L::PANEL + k * LD);
        const float4 q_r = *reinterpret_cast<const float4*>(qq + k * LD);
        const float4 q_i = *reinterpret_cast<const float4*>(qq + L::PANEL + k * LD);
        const float ar[4] = {p_r.x, p_r.y, p_r.z, p_r.w}, ai[4] = {p_i.x, p_i.y, p_i.z, p_i.w};
        const float br[4] = {q_r.x, q_r.y, q_r.z, q_r.w}, bi[4] = {q_i.x, q_i.y, q_i.z, q_i.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            cr[u][v] = fmaf(ar[u], br[v], cr[u][v]);
            cr[u][v] = fmaf(ai[u], bi[v], cr[u][v]);
            if (DATA) {                       // A[p] conj(A[q])
              ci[u][v] = fmaf(ai[u], br[v], ci[u][v]);
              ci[u][v] = fmaf(-ar[u], bi[v], ci[u][v]);
            } else {                          // conj(A[p]) A[q]
              ci[u][v] = fmaf(ar[u], bi[v], ci[u][v]);
              ci[u][v] = fmaf(-ai[u], br[v], ci[u][v]);
            }
          }
      }
    }
#endif
    if (w.c == KCH - 1) {                    // the item's last chunk: store
      if (w.valid) {
        const int p = 4 * w.gp, q = 4 * w.gq;   // tile-local
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // G[p + u][q + v], v < 4, on or above the diagonal
          uint32_t mask = 0;
#pragma unroll
          for (int v = 0; v < 4; ++v)
            mask |= (uint32_t)(p + u < w.pv && q + v < w.qv && (!w.diag || p + u <= q + v))
                    << v;
          const int64_t off = (w.b * P + w.p0 + p + u) * P + w.q0 + q;
          store_run<O, 4>(Gr + off, cr[u], mask, vec_g);
          store_run<O, 4>(Gi + off, ci[u], mask, vec_g);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // G[q + v][p + u] = conj(G[p + u][q + v]), u < 4, strictly below
          uint32_t mask = 0;
          float hr[4], hi[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            mask |= (uint32_t)(p + u < w.pv && q + v < w.qv && (!w.diag || p + u < q + v))
                    << u;
            hr[u] = cr[u][v];
            hi[u] = -ci[u][v];
          }
          const int64_t off = (w.b * P + w.q0 + q + v) * P + w.p0 + p;
          store_run<O, 4>(Gr + off, hr, mask, vec_g);
          store_run<O, 4>(Gi + off, hi, mask, vec_g);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) cr[u][v] = ci[u][v] = 0.f;
    }
  }
}

// G on f32 planes: T x T tiles of 100, T^2 items a bin (one for P <= 100).
template <typename O, bool TILED>
int launch_gram(const void* Ar, const void* Ai, void* Gr, void* Gi, int64_t B, int64_t m,
                int64_t n, int data, const TileGrid& tg, int device, cudaStream_t s) {
  const int64_t P = data ? m : n, T = (P + kGTile - 1) / kGTile;
  if ((data ? n : m) == 0) {                 // empty sums: G = 0
    const size_t bytes = (size_t)(B * P * P) * sizeof(O);
    cudaError_t e = cudaMemsetAsync(Gr, 0, bytes, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(Gi, 0, bytes, s);
    return (int)e;
  }
  if (T * T > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int vec = n % 4 == 0 && aligned16(Ar) && aligned16(Ai);
  const int vec_g = P % 4 == 0 && aligned16(Gr) && aligned16(Gi);
  auto go = [&](auto kernel, int bytes) {
    return launch_persistent(kernel, kGThreads, bytes, B * T * T, device, s,
                             static_cast<const float*>(Ar), static_cast<const float*>(Ai),
                             static_cast<O*>(Gr), static_cast<O*>(Gi), B, m, n, vec, vec_g,
                             tg);
  };
  if (T == 1)
    return data ? go(zgram_f32_kernel<O, true, TILED, true>, GLayout<true>::BYTES)
                : go(zgram_f32_kernel<O, false, TILED, true>, GLayout<true>::BYTES);
  return data ? go(zgram_f32_kernel<O, true, TILED, false>, GLayout<false>::BYTES)
              : go(zgram_f32_kernel<O, false, TILED, false>, GLayout<false>::BYTES);
}

}  // namespace f32simt
