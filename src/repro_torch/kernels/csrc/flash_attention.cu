// Flash attention: causal (or full) online-softmax attention on heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_bh (kernel body _flash_kernel).  It computes, per head,
//   s = q k^T * Dh^-1/2 (f32 sums), masked to -1e30 where a key lies after
//   its query (causal; positions from 0 on both axes),
// an online softmax over 64-key tiles with f32 running max m, denominator
// l and accumulator, p rounded to v's dtype before the p v product, and
// the output acc / max(l, 1e-30) in q's dtype.
//
// Bound on this card: at Dh = 64 a key-query pair costs 4 Dh flops on
// 4 Dh bytes of q, k, v, o per row, so the bf16 kernel is operations-bound
// from a few hundred rows up (989 TFLOP/s on the tensor cores); the f32
// path runs on the FP32 units (67 TFLOP/s).
//
// Three kernels, chosen by the wrapper from (dtype, Dh, alignment), each
// behind its own C entry: flash_wgmma_kernel for bf16 with Dh 64 or 128
// and 16-byte-aligned rows (every full config's heads), flash_f32_kernel
// for every f32 call, flash_kernel for the other bf16 calls.
//
// flash_wgmma_kernel (bf16, Dh 64 / 128): operations-bound from a few
// hundred rows up, so its products run on wgmma, Hopper's full-rate bf16
// path (wgmma.cuh).  A block is one consumer warpgroup of 64 query rows
// and one producer warp.  One producer thread loads the Q tile once and
// then each 64-key tile of K and V with TMA (tensor maps of the heads made
// on the host; keys past Skv read as zeros) into a 2-deep ring of
// 128-byte-swizzled stages, each stage's full barrier completed by the
// copies' bytes; the consumer releases a stage on its empty barrier once
// its products have read it, so the copies of the next tile overlap the
// work on this one.  Per tile: S = Q K^T is Dh / 16 wgmma m64n64k16 with
// both operands in shared memory; the online softmax runs in the
// accumulator layout on the scores in place: the mask (-1e30: zero-filled
// keys score 0 and must still be masked) only on the tiles that cross the
// diagonal or Skv's end, the max on the raw scores, then p = exp2(s
// scale log2(e) - m) as one FFMA and exp2f; p is packed to bf16 in
// registers (the reference rounds p to v's dtype) and O += P V is 4 x
// Dh / 64 wgmma m64n64k16 with P as the register operand and V read from
// shared memory through the transpose bit.  Row max and sum: the
// thread's 16 values of a row as a tree, then the fixed butterfly over
// the 4 lanes of the row; no atomics.  With causal masking the query
// blocks are launched longest walk first (grid.y counts down the rows),
// so the short walks fill the card's tail.  m, l and the accumulator stay
// f32; the output is acc / max(l, 1e-30) in bf16.
// Measured on the card (PERF.md): the softmax's vector instructions and
// the blocks an SM bound it, not L2 or the tensor cores: two or three
// consumer warpgroups sharing a block's K/V tiles, issuing the next
// tile's scores beside this tile's P V (more registers, fewer blocks), or
// a third stage (three blocks an SM at Dh 64) were slower.  Measurement
// builds: WGMMA_NO_MMA drops the products, FLASH_NO_COPY the TMA copies.
//
// flash_f32_kernel (f32 at any Dh <= 128, aligned rows or not): IEEE
// FFMA on the FP32 units (no TF32), operations-bound (67 TFLOP/s), so its
// design keeps the FFMA pipes fed.  A block of 4 warps takes 64 query rows
// of one head and walks 64-key tiles; a thread owns 4 rows x 8 keys of
// the scores (rows rg + 16 i, keys kg + 8 j: 16 row groups x 8 key groups)
// and the same 4 rows x 4 NC columns of the output (4 kg + 32 c ..).
//   - Register-blocked outer products: Q, K and V sit in shared memory in
//     their own row layout (rows DHP + 4 floats apart, 4 banks), read as
//     16-byte vectors along the summed axis; one vector feeds 16 FFMAs and
//     the lanes of a row group (or a key group) read the same vector, so
//     12 LDS.128 feed 128 FFMAs a lane (12.8 FFMAs per word the warp reads).
//   - Copies overlapped with the math, by cp.async (16-byte copies with
//     zero fill on 16-byte-aligned rows, 4-byte copies otherwise; rows >= S
//     and columns >= Dh read as zeros): Q once; K and V one stage each,
//     refilled in turn, so K(t + 1) lands while tile t's softmax and P V
//     run and V(t + 1) while tile t + 1's scores run.  Three blocks share
//     an SM at Dh <= 64; a ring of two stages of each fit two and measured
//     4-6 % slower.
//   - Softmax: the mask only on tiles that cross the diagonal or Skv's
//     end, the max on the raw scores, p = exp2(s scale log2(e) - m) as one
//     FFMA and exp2f; row max and sum over the thread's 8 keys as a tree,
//     then the fixed butterfly over the 8 lanes of the row group.
//   - P goes through a per-warp buffer once a tile (the warp's own rows),
//     read back as 16-byte vectors along the keys.
//   - With causal masking the query blocks launch longest walk first.
// Measured on the card (PERF.md): its products run at about half the FP32
// peak, and its shared-memory loads do not bind them (the products with
// their loads hoisted out of the loops were 11 % faster, wrong results);
// 8 rows a thread (128-row blocks) or full unrolling were no faster.
// Measurement builds: FLASH_F32_NO_FMA drops both products,
// FLASH_NO_COPY the copies.
//
// flash_kernel (bf16 at any other Dh, or unaligned rows), right and simple
// first: a block of 4 warps takes 64 query rows of one head, 16 rows a
// warp, and walks the key axis in 64-key tiles that all its warps share
// from shared memory.  The TPU kernel's sequential k grid axis and its VMEM
// scratch become this loop and registers: each thread holds its rows'
// scores, running max, denominator and accumulator in the accumulator
// layout of mma.sync.m16n8k16 (bf16 in, f32 accumulate), so the scores of
// one product are the operand of the next with no trip through memory;
// q's fragments stay in registers for the whole walk.
// Row max and sum: the thread's own values in order, then a fixed
// butterfly over the 4 threads that share a row; no atomics.
//
// In all three kernels: with causal, the walk stops at the tile holding
// the block's last query: tiles wholly above the diagonal contribute p = 0
// and alpha = 1 exactly, because the first tile holds key 0 and so every
// row has a finite max.  Ragged Sq and Skv are masked here (keys >= Skv
// score -1e30 and their shared-memory rows are zero), and a Dh that is not
// a multiple of 16 is zero-filled in shared memory, so nothing is padded or
// copied.  Heads are addressed by (batch, head) strides, and a query head h
// reads key head h / (Hq / Hkv), so grouped-query attention repeats
// nothing.
#include <cmath>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kRows = 64;       // query rows a block (4 warps x 16)
constexpr int kKeys = 64;       // keys a shared-memory tile
constexpr int kThreads = 128;
constexpr int kNT = kKeys / 8;  // 8-key column tiles of the score fragment
constexpr float kMasked = -1e30f;
static_assert(kRows == kKeys, "load_tile stages 64-row tiles of q, k and v");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t Hq, group, Sq, Skv;   // group = Hq / Hkv
  int Dh, causal;
  float scale;
  int vec;                      // rows 16-byte aligned: vector loads
  int64_t qs[3], ks[3], vs[3], os[3];   // (batch, head, row) strides
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 in one register, the first in the low half (the mma operand order).
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// Rows [r0, r0 + 64) of a (S, Dh) bf16 head matrix with row stride ss into
// shared memory (row stride ld, DHP >= Dh columns); rows >= S and columns
// >= Dh are zero.  With vec, Dh, ss and the base are 16-byte multiples.
template <int DHP>
__device__ void load_tile(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, int64_t ss,
                          int64_t r0, int64_t S, int Dh, bool vec) {
  if (vec) {
    constexpr int NV = DHP / 8;
    for (int i = threadIdx.x; i < kKeys * NV; i += kThreads) {
      const int r = i / NV, c = (i % NV) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < S && c < Dh)
        val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kKeys * DHP; i += kThreads) {
      const int r = i / DHP, c = i % DHP;
      dst[r * ld + c] = (r0 + r < S && c < Dh) ? src[(r0 + r) * ss + c]
                                               : __float2bfloat16_rn(0.0f);
    }
  }
}

// One tile's online-softmax step on a warp's score fragment.  s[j][e]:
// row g (e < 2) or g + 8, key kbase + 8 j + 2 t + (e & 1).  On return
// s holds p = exp(s - m_new) in f32, m and l are updated and the
// accumulator o is rescaled by alpha.
template <int NO>
__device__ __forceinline__ void softmax_step(float (&s)[kNT][4], float (&m)[2],
                                             float (&l)[2], float (&o)[NO][4],
                                             int64_t kbase, int64_t row0,
                                             const Params& p, int t) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t key = kbase + 8 * j + 2 * t + (e & 1);
      const int64_t row = row0 + (e < 2 ? 0 : 8);
      const bool keep = key < p.Skv && (!p.causal || key <= row);
      s[j][e] = keep ? s[j][e] * p.scale : kMasked;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mc = kMasked;
#pragma unroll
    for (int j = 0; j < kNT; ++j) mc = fmaxf(mc, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    const float mn = fmaxf(m[r], mc);
    const float alpha = expf(m[r] - mn);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      s[j][2 * r] = expf(s[j][2 * r] - mn);
      s[j][2 * r + 1] = expf(s[j][2 * r + 1] - mn);
      sum += s[j][2 * r];
      sum += s[j][2 * r + 1];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = l[r] * alpha + sum;
    m[r] = mn;
#pragma unroll
    for (int jn = 0; jn < NO; ++jn) {
      o[jn][2 * r] *= alpha;
      o[jn][2 * r + 1] *= alpha;
    }
  }
}

// Tiles the block walks: up to the one holding its last query when causal.
__device__ __forceinline__ int64_t n_tiles(const Params& p, int64_t q0) {
  const int64_t n = (p.Skv + kKeys - 1) / kKeys;
  if (!p.causal) return n;
  const int64_t last = q0 + kRows - 1 < p.Sq - 1 ? q0 + kRows - 1 : p.Sq - 1;
  return n < last / kKeys + 1 ? n : last / kKeys + 1;
}

// KD = ceil(Dh / 16) column chunks of 16.
template <int KD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Params p) {
  using T = __nv_bfloat16;
  constexpr int DHP = 16 * KD;    // Dh padded to the mma depth
  constexpr int NO = 2 * KD;      // 8-column tiles of the output fragment
  constexpr int LD = DHP + 8;     // 16-byte rows; 4-word skew between rows
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.y, b = bh / p.Hq, h = bh % p.Hq, hk = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  T* out = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1];
  const int64_t q0 = (int64_t)blockIdx.x * kRows;
  const int64_t row0 = q0 + warp * 16 + g;      // this thread's rows: row0, row0 + 8
  const bool vec = p.vec != 0;

  float o[NO][4];
#pragma unroll
  for (int jn = 0; jn < NO; ++jn) o[jn][0] = o[jn][1] = o[jn][2] = o[jn][3] = 0.0f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  const int64_t nt = n_tiles(p, q0);

  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kKeys * LD;
  // q's A fragments: a0 (row g, cols 2t, 2t+1), a1 (row g+8), a2 / a3 the
  // same rows at cols + 8; zero past Sq and Dh
  uint32_t qf[KD][4];
  auto qat = [&](int64_t row, int c) {
    return (row < p.Sq && c < p.Dh) ? q[row * p.qs[2] + c] : __float2bfloat16_rn(0.0f);
  };
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) {
    const int c = 16 * kc + 2 * t;
    qf[kc][0] = pack(qat(row0, c), qat(row0, c + 1));
    qf[kc][1] = pack(qat(row0 + 8, c), qat(row0 + 8, c + 1));
    qf[kc][2] = pack(qat(row0, c + 8), qat(row0, c + 9));
    qf[kc][3] = pack(qat(row0 + 8, c + 8), qat(row0 + 8, c + 9));
  }
  for (int64_t kt = 0; kt < nt; ++kt) {
    __syncthreads();            // every warp is done with the last tile
    load_tile<DHP>(Ks, LD, k, p.ks[2], kt * kKeys, p.Skv, p.Dh, vec);
    load_tile<DHP>(Vs, LD, v, p.vs[2], kt * kKeys, p.Skv, p.Dh, vec);
    __syncthreads();
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        // B = k^T: b0 (key 8j+g, cols 2t, 2t+1), b1 (cols + 8)
        const T* kr = Ks + (8 * j + g) * LD + 16 * kc + 2 * t;
        mma_bf16(s[j], qf[kc], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    softmax_step<NO>(s, m, l, o, kt * kKeys, row0, p, t);
    // o += p v: p's accumulator fragments of key tiles 2kk, 2kk+1 are the
    // A fragment of keys 16kk..16kk+15, rounded to bf16 (v's dtype)
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const T* vr = Vs + (16 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int jn = 0; jn < NO; ++jn) {
        // B = v: b0 (keys 2t, 2t+1 at col 8jn+g), b1 (keys + 8)
        const T* vc = vr + 8 * jn;
        mma_bf16(o[jn], a, pack(vc[0], vc[LD]), pack(vc[8 * LD], vc[9 * LD]));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int jn = 0; jn < NO; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * jn + 2 * t + e;
        if (c < p.Dh) out[row * p.os[2] + c] = __float2bfloat16_rn(o[jn][2 * r + e] / den);
      }
  }
}

template <int KD>
int launch(const Params& p, int64_t BH, cudaStream_t s) {
  const int bytes = 2 * kKeys * (16 * KD + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<KD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((p.Sq + kRows - 1) / kRows), (unsigned)BH);
  flash_kernel<KD><<<grid, kThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

int launch_dh(const Params& p, int64_t BH, cudaStream_t s) {
  switch ((p.Dh + 15) / 16) {
    case 1: return launch<1>(p, BH, s);
    case 2: return launch<2>(p, BH, s);
    case 3: return launch<3>(p, BH, s);
    case 4: return launch<4>(p, BH, s);
    case 5: return launch<5>(p, BH, s);
    case 6: return launch<6>(p, BH, s);
    case 7: return launch<7>(p, BH, s);
    case 8: return launch<8>(p, BH, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// flash_f32_kernel: f32 at any Dh <= 128, IEEE FFMA on the FP32 units
// ---------------------------------------------------------------------------

namespace ff32 {

constexpr int kRM = 4;           // a thread's rows: rg + 16 i
constexpr int kKN = 8;           // a thread's keys of a tile: kg + 8 j
static_assert(kRows == 16 * kRM && kKeys == 8 * kKN && kThreads == 16 * 8,
              "16 row groups x 8 key groups, one thread each");

// Shared memory, in floats: the Q tile, the K tile, the V tile (64 rows of
// DHP = 32 NC columns each, rows LD floats apart), then each warp's 16 rows
// of P.  LD = DHP + 4 puts consecutive rows 4 banks apart (the 4 row groups
// of a warp, the 8 key groups), LP = 72 puts P's rows 8 apart.  One stage
// of K and one of V (69 KB at Dh <= 64) let three blocks share an SM; a
// second stage of each measured slower, at two blocks an SM.
template <int NC>
struct Layout {
  static constexpr int DHP = 32 * NC;
  static constexpr int LD = DHP + 4;
  static constexpr int LP = kKeys + 8;
  static constexpr int TILE = kKeys * LD;
  static constexpr int Q = 0, K = TILE, V = 2 * TILE, P = 3 * TILE;
  static constexpr int BYTES = 4 * (P + 4 * 16 * LP);
  static constexpr int BLOCKS = BYTES <= 74 * 1024 ? 3 : BYTES <= 112 * 1024 ? 2 : 1;
};

// Rows [r0, r0 + 64) of a (S, Dh) head matrix with row stride ss into the
// tile at shared address dst (rows LD floats apart, DHP columns) by
// cp.async; rows >= S and columns >= Dh read as zeros.  vec: Dh, ss and
// the base are 16-byte multiples.
template <int DHP, int LD>
__device__ __forceinline__ void copy_tile(uint32_t dst, const float* src, int64_t ss,
                                          int64_t r0, int64_t S, int Dh, bool vec) {
#ifndef FLASH_NO_COPY
  if (vec) {
    // a thread copies one 16-byte chunk of every RS-th row; CP chunk slots
    // a row, a power of two (Dh 96's 24 chunks take 32 slots, 8 idle)
    constexpr int CV = DHP / 4, CP = CV <= 8 ? 8 : CV <= 16 ? 16 : 32;
    constexpr int RS = kThreads / CP;
    const int r = threadIdx.x / CP, c = 4 * (threadIdx.x % CP);
    if constexpr (CP != CV)
      if (c >= DHP) return;
    const float* s0 = src + (r0 + r) * ss + c;
    const uint32_t d0 = dst + 4 * (r * LD + c);
#pragma unroll
    for (int n = 0; n < kKeys / RS; ++n) {
      const bool ok = c < Dh && r0 + r + n * RS < S;
      cp_async<16>(d0 + 4 * n * RS * LD, ok ? s0 + n * RS * ss : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kKeys * DHP; i += kThreads) {
      const int r = i / DHP, c = i % DHP;
      const bool ok = r0 + r < S && c < Dh;
      cp_async<4>(dst + 4 * (r * LD + c), ok ? src + (r0 + r) * ss + c : src, ok);
    }
  }
#endif
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// NC = ceil(Dh / 32): a thread's output columns are 4 kg + 32 c + e.
// Copy groups: K(t) and V(t) each their own, so a wait for one leaves the
// newer one in flight.
template <int NC>
__global__ void __launch_bounds__(kThreads, Layout<NC>::BLOCKS)
flash_f32_kernel(const Params p) {
  using L = Layout<NC>;
  constexpr int DHP = L::DHP, LD = L::LD, LP = L::LP;
  extern __shared__ __align__(16) float fsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rl = lane >> 3, kg = lane & 7;      // row group in the warp, key group
  const int rg = 4 * warp + rl;                 // rows rg + 16 i of the block
  const int64_t bh = blockIdx.x, b = bh / p.Hq, h = bh % p.Hq, hk = h / p.group;
  const int64_t nqb = (p.Sq + kRows - 1) / kRows;
  const int64_t q0 = (p.causal ? nqb - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int64_t nt = n_tiles(p, q0);
  const float* q = static_cast<const float*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const float* k = static_cast<const float*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const float* v = static_cast<const float*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  const bool vec = p.vec != 0;
  const uint32_t base = wg::smem_u32(fsm);
  copy_tile<DHP, LD>(base + 4 * L::Q, q, p.qs[2], q0, p.Sq, p.Dh, vec);
  copy_tile<DHP, LD>(base + 4 * L::K, k, p.ks[2], 0, p.Skv, p.Dh, vec);
  cp_async_commit();
  copy_tile<DHP, LD>(base + 4 * L::V, v, p.vs[2], 0, p.Skv, p.Dh, vec);
  cp_async_commit();

  const float sl2 = p.scale * 1.4426950408889634f;   // scale log2(e)
  float o[kRM][NC][4];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c][0] = o[i][c][1] = o[i][c][2] = o[i][c][3] = 0.f;
  float m[kRM], l[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) m[i] = kMasked, l[i] = 0.f;
  const float* qr = fsm + L::Q + rg * LD;            // row rg + 16 i at + 16 i LD
  const float* kr = fsm + L::K + kg * LD;            // key kg + 8 j at + 8 j LD
  const float* vr = fsm + L::V + 4 * kg;             // key u, column 4 kg + 32 c
  float* pw = fsm + L::P + warp * 16 * LP + rl * LP; // row rg + 16 i at + 4 i LP

  for (int64_t t = 0; t < nt; ++t) {
    cp_async_wait<1>();  // K(t) landed (V(t) is the newer group)
    __syncthreads();

    // S = Q K^T: per 4-wide step of Dh, 4 + 8 vector loads and 128 FFMAs
    float s[kRM][kKN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kKN; ++j) s[i][j] = 0.f;
#ifndef FLASH_F32_NO_FMA
#pragma unroll 4
    for (int d = 0; d < DHP; d += 4) {
      float4 a[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) a[i] = *reinterpret_cast<const float4*>(qr + 16 * i * LD + d);
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
        const float4 bk = *reinterpret_cast<const float4*>(kr + 8 * j * LD + d);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < kRM; ++i) s[i][j] = fmaf(at(a[i], e), at(bk, e), s[i][j]);
      }
    }
#endif
    __syncthreads();     // every warp is done with K(t): K(t + 1) into its place
    if (t + 1 < nt)
      copy_tile<DHP, LD>(base + 4 * L::K, k, p.ks[2], (t + 1) * kKeys, p.Skv, p.Dh, vec);
    cp_async_commit();

    // the online softmax, row by row
    const int64_t kbase = t * kKeys;
    if (kbase + kKeys > p.Skv || (p.causal && kbase + kKeys - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kKN; ++j) {
          const int64_t key = kbase + kg + 8 * j, row = q0 + rg + 16 * i;
          if (key >= p.Skv || (p.causal && key > row)) s[i][j] = kMasked;
        }
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      float mx = fmaxf(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])),
                       fmaxf(fmaxf(s[i][4], s[i][5]), fmaxf(s[i][6], s[i][7])));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx * sl2);
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < kKN; ++j) s[i][j] = exp2f(fmaf(s[i][j], sl2, -mn));
      float sum = ((s[i][0] + s[i][1]) + (s[i][2] + s[i][3])) +
                  ((s[i][4] + s[i][5]) + (s[i][6] + s[i][7]));
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha;
#pragma unroll
      for (int j = 0; j < kKN; ++j) pw[4 * i * LP + kg + 8 * j] = s[i][j];
    }
    cp_async_wait<1>();  // V(t) landed (K(t + 1) is the newer group)
    __syncthreads();     // and the warp's P rows are written

    // O += P V: per 4 keys, 4 + 4 NC vector loads and 64 NC FFMAs
#ifndef FLASH_F32_NO_FMA
#pragma unroll 4
    for (int kk = 0; kk < kKeys; kk += 4) {
      float4 pa[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) pa[i] = *reinterpret_cast<const float4*>(pw + 4 * i * LP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 w = *reinterpret_cast<const float4*>(vr + (kk + u) * LD + 32 * c);
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            const float pu = at(pa[i], u);
            o[i][c][0] = fmaf(pu, w.x, o[i][c][0]);
            o[i][c][1] = fmaf(pu, w.y, o[i][c][1]);
            o[i][c][2] = fmaf(pu, w.z, o[i][c][2]);
            o[i][c][3] = fmaf(pu, w.w, o[i][c][3]);
          }
        }
    }
#endif
    __syncthreads();     // every warp is done with V(t): V(t + 1) into its place
    if (t + 1 < nt)
      copy_tile<DHP, LD>(base + 4 * L::V, v, p.vs[2], (t + 1) * kKeys, p.Skv, p.Dh, vec);
    cp_async_commit();
  }
  float* out = static_cast<float*>(p.o) + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int64_t row = q0 + rg + 16 * i;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * kg + 32 * c + e;
        if (col < p.Dh) out[row * p.os[2] + col] = o[i][c][e] / den;
      }
  }
}

template <int NC>
int launch(const Params& p, int64_t BH, cudaStream_t s) {
  const int bytes = Layout<NC>::BYTES;
  static bool sized[64] = {};              // the attribute, set once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !sized[dev])) {
    e = cudaFuncSetAttribute(flash_f32_kernel<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess && dev < 64) sized[dev] = true;
  }
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)BH, (unsigned)((p.Sq + kRows - 1) / kRows));
  flash_f32_kernel<NC><<<grid, kThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace ff32

// ---------------------------------------------------------------------------
// flash_wgmma_kernel: bf16, Dh = 64 or 128, rows 16-byte aligned
// ---------------------------------------------------------------------------

namespace fwg {

constexpr int kWgRows = 64;                // query rows a block: one warpgroup
constexpr int kKeys = 64;                  // keys a tile
constexpr int kThreads = 128 + 32;         // the consumer warpgroup, the producer warp
static_assert(kWgRows == kKeys, "Q, K and V tiles share one layout");

// Shared memory: the Q tile, the K ring, the V ring (each tile 64 rows x
// DH bf16 as DH / 64 swizzled atoms of 8 KB), then the barriers.  With a
// 2-deep ring and ~95 / 127 registers a thread, four blocks fit an SM at
// Dh 64 (40 KB each) and two at Dh 128 (80 KB).
template <int DH>
struct Layout {
  static constexpr int STAGES = 2;
  static constexpr int ATOMS = DH / 64;
  static constexpr int ATOM = kKeys * wg::kAtomBytes;          // 8 KB
  static constexpr int TILE = ATOMS * ATOM;
  static constexpr int Q = 0, K = TILE, V = K + STAGES * TILE;
  static constexpr int BARS = V + STAGES * TILE;               // full, empty, q
  static constexpr int BYTES = BARS + 8 * (2 * STAGES + 1);
};

// tq, tk, tv: tensor maps of q, k and v as (Dh, S, heads, batch) in boxes
// of 64 x 64 x 1 x 1 (one swizzled atom; rows past S read as zeros).
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv) {
  using L = Layout<DH>;
  constexpr int kStages = L::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle needs 1024-byte-aligned atoms
  unsigned char* smem = smem_raw + ((wg::kSwizzleBytes - wg::smem_u32(smem_raw) %
                                     wg::kSwizzleBytes) % wg::kSwizzleBytes);
  const uint32_t base = wg::smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  const int64_t bh = blockIdx.x, b = bh / p.Hq, h = bh % p.Hq, hk = h / p.group;
  const int64_t nqb = (p.Sq + kWgRows - 1) / kWgRows;
  const int64_t q0 = (p.causal ? nqb - 1 - blockIdx.y : blockIdx.y) * kWgRows;
  const int64_t nt = n_tiles(p, q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::bar_init(&full[i], 1);           // the producer, expecting the bytes
      wg::bar_init(&empty[i], 4);          // the consumer's warps
    }
    wg::bar_init(qbar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // producer, one thread: the Q tile once, then tile t's K and V into
    // stage t % kStages once the consumer has released the tile kStages
    // before it
    if (lane != 0) return;
#ifndef FLASH_NO_COPY
    const int qh = (int)h, kh = (int)hk, bb = (int)b;
    wg::bar_arrive_tx(qbar, L::TILE);
#pragma unroll
    for (int a = 0; a < DH / 64; ++a)
      wg::tma_load_4d(base + L::Q + a * L::ATOM, &tq, qbar, 64 * a, (int)q0, qh, bb);
#else
    wg::bar_arrive(qbar);
#endif
    for (int64_t t = 0; t < nt; ++t) {
      const int st = (int)(t % kStages);
      if (t >= kStages) wg::bar_wait(&empty[st], (uint32_t)((t / kStages - 1) & 1));
#ifndef FLASH_NO_COPY
      wg::bar_arrive_tx(&full[st], 2 * L::TILE);
#pragma unroll
      for (int a = 0; a < DH / 64; ++a) {
        const uint32_t off = st * L::TILE + a * L::ATOM;
        wg::tma_load_4d(base + L::K + off, &tk, &full[st], 64 * a, (int)(t * kKeys), kh, bb);
        wg::tma_load_4d(base + L::V + off, &tv, &full[st], 64 * a, (int)(t * kKeys), kh, bb);
      }
#else
      wg::bar_arrive(&full[st]);
#endif
    }
    return;
  }

  // consumer warpgroup: rows q0 + 16 warp + g and + 8 of the accumulators
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = (int)q0 + 16 * warp + g;
  const uint32_t qt = base + L::Q;
  const float sl2 = p.scale * 1.4426950408889634f;   // scale log2(e)
  float o[DH / 64][32], s[32];
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int a = 0; a < DH / 64; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  // S = Q K^T of the tile in stage st: k16 step kk is 32 bytes into atom
  // kk / 4 of both tiles
  auto scores = [&](int st) {
    const uint32_t kt = base + L::K + st * L::TILE;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk >> 2) * L::ATOM + 32 * (kk & 3);
      wg::mma_ss_n64(s, wg::desc(qt + off), wg::desc(kt + off), kk > 0);
    }
  };
  // O += P V of the tile in stage st: keys 16 kk .. 16 kk + 15 are the n8
  // blocks 2 kk and 2 kk + 1 of the scores, in bf16 pairs the register A
  // fragment
  auto values = [&](int st, const uint32_t (&pa)[4][4]) {
    const uint32_t vt = base + L::V + st * L::TILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < DH / 64; ++a)
        wg::mma_rs_n64_tb(o[a], pa[kk], wg::desc(vt + a * L::ATOM + kk * 16 * wg::kAtomBytes),
                          1);
  };
  // The online softmax of tile t's scores, in the accumulator layout: the
  // mask (-1e30) only where the tile crosses the diagonal or Skv's end;
  // the max on the raw scores (scale > 0 commutes with it), then p =
  // exp2(s scale log2(e) - m) as one FFMA and exp2f, packed to bf16 into
  // pa; m and l move on and alpha is the factor that rescales O.  Row max
  // and sum: the thread's 16 values of a row as a tree, then the fixed
  // butterfly over the 4 lanes of the row.  No product is in flight: the
  // scores are overwritten in place.
  auto softmax = [&](int64_t t, uint32_t (&pa)[4][4], float (&alpha)[2]) {
    const int kbase = (int)(t * kKeys);
    if (kbase + kKeys > p.Skv || (p.causal && kbase + kKeys - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kbase + 8 * j + 2 * t4 + (e & 1), row = row0 + 8 * (e >> 1);
          if (key >= p.Skv || (p.causal && key > row)) s[4 * j + e] = kMasked;
        }
    }
    float mn[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx[j] = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) mx[j] = fmaxf(mx[j], mx[j + w]);
      float mc = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      mn[r] = fmaxf(m[r], mc * sl2);
      alpha[r] = exp2f(m[r] - mn[r]);
      m[r] = mn[r];
    }
    float ps[2][8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = exp2f(fmaf(s[4 * j + 2 * r], sl2, -mn[r]));
        const float p1 = exp2f(fmaf(s[4 * j + 2 * r + 1], sl2, -mn[r]));
        ps[r][j] = p0 + p1;
        // n8 block j, row half r: register r + 2 (j % 2) of k16 step j / 2
        pa[j >> 1][r + 2 * (j & 1)] = pack(p0, p1);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) ps[r][j] += ps[r][j + w];
      const float sum = ps[r][0] + __shfl_xor_sync(0xffffffffu, ps[r][0], 1);
      l[r] = l[r] * alpha[r] + sum + __shfl_xor_sync(0xffffffffu, sum, 2);
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int a = 0; a < DH / 64; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[a][4 * j + e] *= alpha[e >> 1];
  };
  uint32_t pa[4][4];
  float alpha[2];
  wg::bar_wait(qbar, 0);
  // tile t: S, its softmax and the rescale of O, then P V; the stage goes
  // back to the producer once P V has read it
  for (int64_t t = 0; t < nt; ++t) {
    const int st = (int)(t % kStages);
    wg::bar_wait(&full[st], (uint32_t)((t / kStages) & 1));
    wg::fence();
    scores(st);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);
    softmax(t, pa, alpha);
    rescale(alpha);
    wg::fence();
    values(st, pa);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int a = 0; a < DH / 64; ++a) wg::fence_regs(o[a]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::fence_regs(pa[kk]);
    __syncwarp();
    if (lane == 0) wg::bar_arrive(&empty[st]);
  }
  auto* out = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int a = 0; a < DH / 64; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * a + 8 * j + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(out + row * p.os[2] + c) =
            __floats2bfloat162_rn(o[a][4 * j + 2 * r] / den, o[a][4 * j + 2 * r + 1] / den);
      }
  }
}

// The tensor map of a (B, S, H, Dh) head tensor given by its (batch,
// head, row) element strides: dims (Dh, S, H, B), 64 x 64 boxes.  A
// stride of a dim of one element (the folded layout's heads) is never
// stepped, and is given as the next one in to keep the map valid.
inline int head_map(CUtensorMap* map, const void* base, int64_t Dh, int64_t S, int64_t H,
                    int64_t B, const int64_t (&st)[3]) {
  const uint64_t dims[4] = {(uint64_t)Dh, (uint64_t)S, (uint64_t)H, (uint64_t)B};
  uint64_t strides[4] = {2, 2 * (uint64_t)st[2], 2 * (uint64_t)st[1], 2 * (uint64_t)st[0]};
  for (int i = 2; i < 4; ++i)
    if (dims[i] == 1) strides[i] = strides[i - 1] * dims[i - 1];
  const uint32_t box[4] = {64, (uint32_t)kKeys, 1, 1};
  return wg::make_tensor_map(map, base, 4, dims, strides, box);
}

template <int DH>
int launch(const Params& p, int64_t B, int64_t Hkv, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int err = head_map(&tq, p.q, DH, p.Sq, p.Hq, B, p.qs);
  if (err == 0) err = head_map(&tk, p.k, DH, p.Skv, Hkv, B, p.ks);
  if (err == 0) err = head_map(&tv, p.v, DH, p.Skv, Hkv, B, p.vs);
  if (err != 0) return err;
  const int bytes = Layout<DH>::BYTES + wg::kSwizzleBytes;   // + the base's alignment
  static bool sized[64] = {};              // the attribute, set once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !sized[dev])) {
    e = cudaFuncSetAttribute(flash_wgmma_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess && dev < 64) sized[dev] = true;
  }
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * p.Hq), (unsigned)((p.Sq + kWgRows - 1) / kWgRows));
  flash_wgmma_kernel<DH><<<grid, kThreads, bytes, s>>>(p, tq, tk, tv);
  return (int)cudaGetLastError();
}

}  // namespace fwg

// The Params of a call, from the C entries' arguments; vec: q, k and v
// 16-byte aligned with every stride a multiple of 16 bytes.
Params make_params(const void* q, const void* k, const void* v, void* o, int64_t Hq,
                   int64_t Hkv, int64_t Sq, int64_t Skv, int64_t Dh, const int64_t (&qs)[3],
                   const int64_t (&ks)[3], const int64_t (&vs)[3], const int64_t (&os)[3],
                   int causal, int esize) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.Hq = Hq; p.group = Hq / Hkv; p.Sq = Sq; p.Skv = Skv;
  p.Dh = (int)Dh; p.causal = causal;
  p.scale = (float)(1.0 / sqrt((double)Dh));
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = qs[i]; p.ks[i] = ks[i]; p.vs[i] = vs[i]; p.os[i] = os[i];
  }
  const int64_t ve = 16 / esize;
  const bool aligned = ((uintptr_t)k % 16 == 0) && ((uintptr_t)v % 16 == 0) &&
                       ((uintptr_t)q % 16 == 0);
  p.vec = aligned && Dh % ve == 0;
  for (int i = 0; i < 3; ++i)
    p.vec = p.vec && qs[i] % ve == 0 && ks[i] % ve == 0 && vs[i] % ve == 0;
  return p;
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, Dh) and k, v (B, Skv, Hkv, Dh) given by (batch, head,
// row) strides with unit column stride; o likewise, in q's dtype.  The
// folded (BH, S, Dh) layout is B = BH, Hq = Hkv = 1.  flash_kernel: bf16
// only (f32 is refused: flash_attention_bh_f32 takes it).
int flash_attention_bh(const void* q, const void* k, const void* v, void* o,
                       int64_t B, int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Skv,
                       int64_t Dh, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                       int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
                       int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
                       int64_t o_ss, int causal, int dtype, int device,
                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B * Hq == 0 || Sq == 0) return 0;
  if (dtype != DT_BF16 || Dh < 1 || Dh > 128 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      B * Hq > 65535 || (Sq + kRows - 1) / kRows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, Hq, Hkv, Sq, Skv, Dh, {q_sb, q_sh, q_ss},
                               {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
                               causal, 2);
  return launch_dh(p, B * Hq, static_cast<cudaStream_t>(stream));
}

// The same function on flash_f32_kernel: f32 only, any Dh <= 128, any
// strides (16-byte copies where q, k, v and their strides allow them).
int flash_attention_bh_f32(const void* q, const void* k, const void* v, void* o,
                           int64_t B, int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Skv,
                           int64_t Dh, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                           int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
                           int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
                           int64_t o_ss, int causal, int dtype, int device,
                           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B * Hq == 0 || Sq == 0) return 0;
  if (dtype != DT_F32 || Dh < 1 || Dh > 128 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      B * Hq > INT32_MAX || (Sq + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, Hq, Hkv, Sq, Skv, Dh, {q_sb, q_sh, q_ss},
                               {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
                               causal, 4);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((Dh + 31) / 32) {
    case 1: return ff32::launch<1>(p, B * Hq, s);
    case 2: return ff32::launch<2>(p, B * Hq, s);
    case 3: return ff32::launch<3>(p, B * Hq, s);
    default: return ff32::launch<4>(p, B * Hq, s);
  }
}

// The same function on flash_wgmma_kernel: bf16 only, Dh 64 or 128, q, k,
// v and o 16-byte aligned with every stride a multiple of 8 elements.
// Anything else is refused (the wrapper sends other bf16 calls to
// flash_attention_bh, f32 to flash_attention_bh_f32).
int flash_attention_bh_wgmma(const void* q, const void* k, const void* v, void* o,
                             int64_t B, int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Skv,
                             int64_t Dh, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                             int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
                             int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
                             int64_t o_ss, int causal, int dtype, int device,
                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B * Hq == 0 || Sq == 0) return 0;
  if (dtype != DT_BF16 || (Dh != 64 && Dh != 128) || Skv < 1 || Hkv < 1 ||
      Hq % Hkv != 0 || B * Hq > INT32_MAX || Sq > INT32_MAX || Skv > INT32_MAX ||
      (Sq + fwg::kWgRows - 1) / fwg::kWgRows > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, Hq, Hkv, Sq, Skv, Dh, {q_sb, q_sh, q_ss},
                               {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
                               causal, 2);
  const bool o_vec = (uintptr_t)o % 16 == 0 && o_sb % 8 == 0 && o_sh % 8 == 0 &&
                     o_ss % 8 == 0;
  if (!p.vec || !o_vec) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return Dh == 64 ? fwg::launch<64>(p, B, Hkv, s) : fwg::launch<128>(p, B, Hkv, s);
}

}  // extern "C"
