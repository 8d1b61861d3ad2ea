// f32 planes on the FP32 vector units: the complex N product of sbgemm.cu,
// Y = A X per bin, with f32 sums, untiled and tiled.
//
// Replaces, for f32 planes, the TPU kernel
// src/repro/kernels/sbgemv.py:sbgemm_n_complex (Yr = rr - ii, Yi = ir + ri,
// the contraction over the long n).  "s" is IEEE f32: every product is an
// FFMA on the vector units (no TF32, no tensor cores), so the kernel
// computes the vector kernel's function up to the order of the sums.  The
// tiled build (TILED, replacing :sbgemm_n_complex_tiled for f32 planes)
// rounds each A value at its cell's level as it leaves shared memory, so on
// planes quantized up front it gives the untiled build's bits.
//
// Included by sbgemm.cu inside its anonymous namespace, after the f64 and
// bf16 sections, whose stage(), cp_async_commit / cp_async_wait, min64,
// aligned16 and launch_persistent it uses.  Measurement builds of sbgemm.cu
// (chip_smoke.py's bound probe; no wrapper loads them) compile one side
// out: SBGEMM_F32_NO_FMA the products (the copy pipeline alone),
// SBGEMM_F32_NO_COPY the operand copies (the products alone, on whatever
// shared memory holds).
//
// Bound: a complex A element (8 bytes) carries 8 S flops, so at the paper
// shape (1001, 100, 5000) the product is bytes-bound at S = 8 (4.33 GB,
// 1.29 ms at the HBM rate) and bound by the FP32 units at S = 32 (0.128
// TFLOP at 67 TFLOP/s, 1.91 ms, against 5.31 GB in 1.59 ms).  So the design
// reads A once (passes of up to 32 columns) and fills the instruction slots
// with FFMAs:
//   Items are (bin, 100 output rows, a pass of SP = 8, 16 or 32 columns):
//   a bin's m = 100 rows are one item, with no padded rows.  A block of 5
//   warps is persistent and runs one cp.async ring of k-chunks, 3 deep,
//   across its items, as zgemm_f64_kernel does (Layout: 16-wide chunks and
//   three blocks an SM at SP = 32, 32-wide chunks and two blocks below):
//   each chunk stages both A planes (100 rows x KC k, A's rows as stored)
//   and both X planes (KC k x SP) once for the block, 16-byte copies where
//   rows allow (n % 4 == 0, and S % 4 == 0 for X), else one copy an
//   element.  A block's cursor steps through the items without a division.
//   Warp w owns rows 20 w .. 20 w + 19 and all SP columns; lane (lr, lc) =
//   (lane / 8, lane % 8) holds rows 20 w + lr + 4 i (i < 5) and columns C lc
//   .. C lc + C - 1 (C = SP / 8): a 5 x C complex register tile.  A is read
//   as float4 along k, one address per lr, so the 8 lanes of a row share
//   each read; staged A rows are an odd number of 16 bytes long, so the 4
//   rows a warp reads at one k lie in 4 distinct bank groups.  X is read as
//   C consecutive floats a k.  At SP = 32 a step of 4 k is 18 shared loads
//   against 320 FFMAs.
//   k past the end is zero-filled in both operands; rows and columns past
//   the ends of the other axes are not copied, and what they hold reaches
//   only outputs that are not stored.  Every output sums its k products in
//   one thread, in k order (Re: + Ar Xr, then - Ai Xi; Im: + Ar Xi, then +
//   Ai Xr), on every run: no atomics, no split of a sum across threads or
//   blocks.

namespace f32simt {

constexpr int kWarps = 5;
constexpr int kThreads = 32 * kWarps;
constexpr int kTRows = 5;                   // rows of a thread: lr + 4 i
constexpr int kWarpRows = 4 * kTRows;       // rows of a warp
constexpr int kRows = kWarps * kWarpRows;   // rows of an item: 100

// Shared-memory layout of a stage for C columns a lane: the A panel of
// each plane (kRows x KC) and the X panel of each plane (KC x SP), NS
// stages, BLOCKS blocks an SM.  At SP = 32 (the FFMA-bound pass) 16-wide
// chunks and three blocks an SM (15 warps, the register tile in 128
// registers); narrower passes (bytes-bound) 32-wide chunks and two blocks.
template <int C>
struct Layout {
  static constexpr int SP = 8 * C, XLD = SP;
  static constexpr int KC = C == 4 ? 16 : 32, NS = 3, BLOCKS = C == 4 ? 3 : 2;
  static constexpr int ALD = KC + 4;       // a staged A row: an odd number of 16 bytes
  static constexpr int A_TILE = kRows * ALD, X_TILE = KC * XLD;
  static constexpr int STAGE = 2 * (A_TILE + X_TILE);          // floats
  static constexpr int BYTES = 4 * NS * STAGE;
  static_assert((ALD / 4) % 2 == 1, "the 4 rows a warp reads lie in distinct bank groups");
};

// C consecutive floats of shared memory (16-, 8- or 4-byte aligned).
template <int C>
__device__ __forceinline__ void load_row(float (&v)[C], const float* p) {
  if constexpr (C == 4) {
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

template <typename O, int C, bool TILED>
__global__ void __launch_bounds__(kThreads, Layout<C>::BLOCKS)
zgemm_f32_kernel(const float* __restrict__ Ar, const float* __restrict__ Ai,
                 const float* __restrict__ Xr, const float* __restrict__ Xi,
                 O* __restrict__ Yr, O* __restrict__ Yi, int64_t B, int64_t m, int64_t n,
                 int64_t S, int vec_a, int vec_x, TileGrid tg) {
  using L = Layout<C>;
  constexpr int SP = L::SP, KC = L::KC, NS = L::NS, ALD = L::ALD;
  extern __shared__ __align__(16) float sf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lc = lane & 7;
  const int row0 = kWarpRows * warp + (lane >> 3);   // this thread's rows row0 + 4 i
  const int64_t M = m, KCH = (n + KC - 1) / KC;
  // A position in this block's chunk stream: item (b, rt, sp) of the B x
  // RTS x SPS items (bin, kRows output rows, SP columns), taken blockIdx.x,
  // + gridDim.x, ..., its chunk c and the ring stage it goes to.  gridDim.x
  // is added to the item digit by digit, with carries, so no division runs
  // past the first item (an item can be a single chunk).
  const int RTS = (int)((M + kRows - 1) / kRows), SPS = (int)((S + SP - 1) / SP);
  const int64_t step_b = gridDim.x / ((int64_t)RTS * SPS);
  const int step_rt = (int)(gridDim.x / SPS % RTS), step_sp = (int)(gridDim.x % SPS);
  struct Cursor {
    int64_t b, c, r0, s0;
    int rt, sp, rv, sv, slot;
    uint32_t cells;                          // tiled: the bin's row of cells
  };
  auto at_item = [&](Cursor& q) {     // past the last item, q.b >= B
    q.c = 0;
    q.cells = TILED && q.b < B ? tile_row(tg, q.b) : 0u;
    q.r0 = (int64_t)q.rt * kRows;
    q.s0 = (int64_t)q.sp * SP;
    q.rv = (int)min64(kRows, M - q.r0);
    q.sv = (int)min64(SP, S - q.s0);
  };
  auto advance = [&](Cursor& q) {
    q.slot = q.slot + 1 == NS ? 0 : q.slot + 1;
    if (++q.c == KCH) {
      if ((q.sp += step_sp) >= SPS) q.sp -= SPS, ++q.rt;
      if ((q.rt += step_rt) >= RTS) q.rt -= RTS, ++q.b;
      q.b += step_b;
      at_item(q);
    }
  };
  // tiled: whether the cursor's chunk holds a column whose cell rounds (an
  // f32 carrier rounds only in bf16 cells); cells c >= C start at INT32_MAX
  auto chunk_rounds = [&](const Cursor& q) {
    const int64_t k0 = q.c * KC;
    bool any = false;
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) {
      const int64_t lo = tg.col0[i], hi = i + 1 < kMaxTiles ? tg.col0[i + 1] : INT32_MAX;
      any |= lo < k0 + KC && hi > k0 && rounds<float>((int)(q.cells >> (2 * i)) & 3);
    }
    return any;
  };
  // one copy group a chunk (empty past the last), so the wait counts chunks
  auto load = [&](const Cursor& w) {
#ifndef SBGEMM_F32_NO_COPY
    if (w.b < B) {
      const int64_t k0 = w.c * KC;
      const int kv = (int)min64(KC, n - k0);
      float* st = sf + w.slot * L::STAGE;
#pragma unroll
      for (int pl = 0; pl < 2; ++pl) {
        const float* a = (pl ? Ai : Ar) + (w.b * m + w.r0) * n + k0;
        stage<kRows, KC, ALD, kThreads, false>(st + pl * L::A_TILE, a, n, w.rv, kv,
                                                    vec_a);
        const float* x = (pl ? Xi : Xr) + (w.b * n + k0) * S + w.s0;
        stage<KC, SP, L::XLD, kThreads, true>(st + 2 * L::A_TILE + pl * L::X_TILE, x,
                                                  S, kv, w.sv, vec_x);
      }
    }
#endif
    cp_async_commit();
  };
  float acc[2][kTRows][C];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < kTRows; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[p][i][c] = 0.f;
  Cursor w, ld;                              // compute and load cursors
  w.b = blockIdx.x / ((int64_t)RTS * SPS);
  w.rt = (int)(blockIdx.x / SPS % RTS);
  w.sp = (int)(blockIdx.x % SPS);
  w.slot = 0;
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
    const bool rows = kWarpRows * warp < w.rv;   // whole warp: rows in its band
#ifndef SBGEMM_F32_NO_FMA
    if (rows) {
      const float* pa = sf + w.slot * L::STAGE + row0 * ALD;
      const float* px = sf + w.slot * L::STAGE + 2 * L::A_TILE + C * lc;
      // the chunk's products; ROUND (tiled, the chunk holds a column whose
      // cell rounds): each A value rounded at its column's level first, the
      // k-steps not unrolled (unrolled, the levels' registers spill)
      auto products = [&](auto rounding) {
        constexpr bool ROUND = decltype(rounding)::value;
#pragma unroll (ROUND ? 1 : KC / 4)
        for (int k4 = 0; k4 < KC; k4 += 4) {
          float4 a_r[kTRows], a_i[kTRows];
#pragma unroll
          for (int i = 0; i < kTRows; ++i) {
            a_r[i] = *reinterpret_cast<const float4*>(pa + 4 * i * ALD + k4);
            a_i[i] = *reinterpret_cast<const float4*>(pa + L::A_TILE + 4 * i * ALD + k4);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float x_r[C], x_i[C];
            load_row<C>(x_r, px + (k4 + kk) * L::XLD);
            load_row<C>(x_i, px + L::X_TILE + (k4 + kk) * L::XLD);
            const int lv = ROUND ? tile_level(tg, w.cells, w.c * KC + k4 + kk) : 1;
#pragma unroll
            for (int i = 0; i < kTRows; ++i) {
              float re = part(a_r[i], kk), im = part(a_i[i], kk);
              if (ROUND) {
                re = quantize(re, lv);
                im = quantize(im, lv);
              }
#pragma unroll
              for (int c = 0; c < C; ++c) {
                acc[0][i][c] = fmaf(re, x_r[c], acc[0][i][c]);
                acc[0][i][c] = fmaf(-im, x_i[c], acc[0][i][c]);
                acc[1][i][c] = fmaf(re, x_i[c], acc[1][i][c]);
                acc[1][i][c] = fmaf(im, x_r[c], acc[1][i][c]);
              }
            }
          }
        }
      };
      if (TILED && chunk_rounds(w)) products(std::true_type{});
      else products(std::false_type{});
    }
#endif
    if (w.c == KCH - 1 && rows) {            // the item's last chunk: store
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < kTRows; ++i)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int row = row0 + 4 * i, col = C * lc + c;
            if (row < w.rv && col < w.sv)
              (p ? Yi : Yr)[(w.b * m + w.r0 + row) * S + w.s0 + col] =
                  Store<O>::from(acc[p][i][c]);
            acc[p][i][c] = 0.f;
          }
    }
  }
}

// Y (B, m, S) = A (B, m, n) X (B, n, S) on f32 planes, passes of 8, 16 or
// 32 columns.
template <typename O, bool TILED>
int launch_n(const void* Ar, const void* Ai, const void* Xr, const void* Xi, void* Yr,
             void* Yi, int64_t B, int64_t m, int64_t n, int64_t S, const TileGrid& tg,
             int device, cudaStream_t s) {
  if (n == 0) {                              // an empty sum: Y = 0
    const size_t bytes = (size_t)(B * m * S) * sizeof(O);
    cudaError_t e = cudaMemsetAsync(Yr, 0, bytes, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(Yi, 0, bytes, s);
    return (int)e;
  }
  const int vec_a = n % 4 == 0 && aligned16(Ar) && aligned16(Ai);
  const int vec_x = S % 4 == 0 && aligned16(Xr) && aligned16(Xi);
  const int64_t rts = (m + kRows - 1) / kRows;
  auto go = [&](auto kernel, int c, int bytes) {
    return launch_persistent(kernel, kThreads, bytes,
                             B * rts * ((S + 8 * c - 1) / (8 * c)), device, s,
                             static_cast<const float*>(Ar), static_cast<const float*>(Ai),
                             static_cast<const float*>(Xr), static_cast<const float*>(Xi),
                             static_cast<O*>(Yr), static_cast<O*>(Yi), B, m, n, S, vec_a,
                             vec_x, tg);
  };
  if (S <= 8) return go(zgemm_f32_kernel<O, 1, TILED>, 1, Layout<1>::BYTES);
  if (S <= 16) return go(zgemm_f32_kernel<O, 2, TILED>, 2, Layout<2>::BYTES);
  return go(zgemm_f32_kernel<O, 4, TILED>, 4, Layout<4>::BYTES);
}

}  // namespace f32simt
