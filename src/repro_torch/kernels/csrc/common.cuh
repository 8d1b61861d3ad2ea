// Shared helpers of the hand-written kernels: dtype codes, raw vector
// types, casts and the cp.async copy helpers.
//
// Dtype codes match repro_torch/kernels/_build.py:DTYPE_CODES.
// Every cast to bf16 rounds through f32 (__float2bfloat16_rn((float)x)):
// that is what PyTorch's and JAX's own f64 -> bf16 casts do, so the
// kernels agree bit for bit with the plain versions.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum DType : int { DT_BF16 = 0, DT_F32 = 1, DT_F64 = 2 };

// The raw type of B bytes, for vector loads and stores.
template <int B> struct Raw;
template <> struct Raw<2> { using T = unsigned short; };
template <> struct Raw<4> { using T = uint32_t; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

// Accumulator of a plane type: f64 stays f64, bf16 and f32 sum in f32.
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

// Widen a stored element to the arithmetic type A (float or double); exact.
template <typename A> __device__ __forceinline__ A widen(__nv_bfloat16 v) {
  return (A)__bfloat162float(v);
}
template <typename A> __device__ __forceinline__ A widen(float v) { return (A)v; }
template <typename A> __device__ __forceinline__ A widen(double v) { return (A)v; }

// Narrow (or widen) a float or double to the stored type O, rounding to
// nearest even; double -> bf16 rounds through float.
template <typename O> struct Store;
template <> struct Store<float> {
  __device__ __forceinline__ static float from(float v) { return v; }
  __device__ __forceinline__ static float from(double v) { return (float)v; }
};
template <> struct Store<double> {
  __device__ __forceinline__ static double from(float v) { return (double)v; }
  __device__ __forceinline__ static double from(double v) { return v; }
};
template <> struct Store<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 from(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ __forceinline__ static __nv_bfloat16 from(double v) {
    return __float2bfloat16_rn((float)v);
  }
};

// Cast one stored element of type I to type O.  Goes through the wider of
// the two arithmetic types, so every widening is exact and every
// narrowing rounds once (twice for f64 -> bf16, as above).
template <typename O, typename I> __device__ __forceinline__ O convert(I v) {
  using W = typename AccOf<I>::type;      // float for bf16/f32, double for f64
  return Store<O>::from(widen<W>(v));
}

// ---------------------------------------------------------------------------
// Tile-centric precision.  A tile map's R x C grid partitions A's batch
// axis B and column axis n element-wise: element (b, :, j) lies in cell
// ((b R) / B, (j C) / n), and is rounded through that cell's ladder level
// (h = 0 bf16, s = 1 f32, d = 2 f64) when a tiled kernel loads it; X and
// the sums stay in the carrier type.  The cell is found per element with
// no alignment condition, so no copy of A is ever made.  A level at or
// above the carrier is the identity (the mantissas nest).
// ---------------------------------------------------------------------------

constexpr int kMaxTiles = 8;    // at most 8 x 8 cells

struct TileGrid {
  int64_t B;                    // the batch extent the row cells split
  int R;
  int col0[kMaxTiles];          // first column of cell c, ceil(c n / C);
                                // INT32_MAX for c >= C
  uint64_t lvl[2];              // row r: 16 bits at word r / 4, bit 16 (r % 4);
                                // cell c of the row: 2 bits at 2 c
};

// Fill a grid from R x C row-major ladder indices; nonzero (a cudaError)
// for a grid above kMaxTiles, a level outside 0..2, or n >= 2^31 columns.
inline int make_tile_grid(const int* levels, int R, int C, int64_t B, int64_t n,
                          TileGrid* g) {
  if (R < 1 || C < 1 || R > kMaxTiles || C > kMaxTiles || n >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  g->B = B;
  g->R = R;
  for (int c = 0; c < kMaxTiles; ++c)
    g->col0[c] = c < C ? (int)((c * n + C - 1) / C) : INT32_MAX;
  g->lvl[0] = g->lvl[1] = 0;
  for (int r = 0; r < R; ++r)
    for (int c = 0; c < C; ++c) {
      const int v = levels[r * C + c];
      if (v < 0 || v > 2) return (int)cudaErrorInvalidValue;
      g->lvl[r / 4] |= (uint64_t)v << (16 * (r % 4) + 2 * c);
    }
  return 0;
}

// The 2-bit levels of batch b's row of cells.
__device__ __forceinline__ uint32_t tile_row(const TileGrid& g, int64_t b) {
  const int r = (int)((b * g.R) / g.B);
  return (uint32_t)(((r < 4) ? g.lvl[0] : g.lvl[1]) >> (16 * (r & 3))) & 0xffffu;
}

// The level of column j (< n < 2^31) in a row of cells.
__device__ __forceinline__ int tile_level(const TileGrid& g, uint32_t row, int64_t j) {
  int c = 0;
#pragma unroll
  for (int i = 1; i < kMaxTiles; ++i) c += (int)j >= g.col0[i];
  return (int)(row >> (2 * c)) & 3;
}

// Whether level lvl rounds an element of arithmetic type A: below f32 for
// float sums (bf16 and f32 planes), below f64 for double.
template <typename A> __device__ __forceinline__ bool rounds(int lvl) {
  return lvl < (std::is_same<A, double>::value ? 2 : 1);
}

// f32 -> bf16 -> f32, rounding to nearest even on the bits: keep the top
// 16 bits after adding 0x7fff and the lowest kept bit.  Equal to
// __float2bfloat16_rn for every finite value (subnormals and the round up
// to infinity included) at integer-unit cost; a NaN passes through.
__device__ __forceinline__ float round_bf16(float v) {
  const uint32_t u = __float_as_uint(v);
  const float r = __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
  return v != v ? v : r;
}

// Round a widened element through ladder level lvl and back; f64 -> bf16
// rounds through f32, as the casts of both frameworks do.
__device__ __forceinline__ float quantize(float v, int lvl) {
  return lvl == 0 ? round_bf16(v) : v;
}
__device__ __forceinline__ double quantize(double v, int lvl) {
  if (lvl >= 2) return v;
  const float f = __double2float_rn(v);
  return (double)(lvl == 0 ? round_bf16(f) : f);
}

// Asynchronous global -> shared copy of N = 4, 8 or 16 aligned bytes; !ok
// reads nothing and zero-fills the destination.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(N), "r"(ok ? N : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Run the statements in __VA_ARGS__ with T bound to the C++ type of a
// dtype code; an unknown code returns cudaErrorInvalidValue.  Nests.
#define DISPATCH_DTYPE(code, T, ...)                                \
  switch (code) {                                                   \
    case DT_BF16: { using T = __nv_bfloat16; __VA_ARGS__ } break;   \
    case DT_F32: { using T = float; __VA_ARGS__ } break;            \
    case DT_F64: { using T = double; __VA_ARGS__ } break;           \
    default: return (int)cudaErrorInvalidValue;                     \
  }
