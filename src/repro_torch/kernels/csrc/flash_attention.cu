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
// Two kernels, chosen by the wrapper from (dtype, Dh, alignment):
// flash_wgmma_kernel for bf16 with Dh 64 or 128 and 16-byte-aligned rows
// (every full config's heads), flash_kernel for everything else.
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
// flash_kernel (f32; bf16 at any other Dh or unaligned rows), right and
// simple first: a block of 4 warps takes 64 query rows of one head, 16 rows
// a warp, and walks the key axis in 64-key tiles that all its warps share
// from shared memory.  The TPU kernel's sequential k grid axis and its VMEM
// scratch become this loop and registers: each thread holds its rows'
// scores, running max, denominator and accumulator in the accumulator
// layout of mma.sync.m16n8k16, so the scores of one product are the
// operand of the next with no trip through memory.
//   - bf16: both products on mma.sync.m16n8k16 (bf16 in, f32 accumulate);
//     q's fragments stay in registers for the whole walk.
//   - f32: the same fragment layout computed with IEEE f32 FMAs from shared
//     memory (q staged once, p through a per-warp buffer); no TF32.
// Row max and sum: the thread's own values in order, then a fixed
// butterfly over the 4 threads that share a row; no atomics.  With
// causal, the walk stops at the tile holding the block's last query:
// tiles wholly above the diagonal contribute p = 0 and alpha = 1 exactly,
// because the first tile holds key 0 and so every row has a finite max.
// Ragged Sq and Skv are masked here (keys >= Skv score -1e30 and their
// shared-memory rows are zero), and a Dh that is not a multiple of 16 is
// zero-filled in shared memory, so nothing is padded or copied.  Heads
// are addressed by (batch, head) strides, and a query head h reads key
// head h / (Hq / Hkv), so grouped-query attention repeats nothing.
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

// Rows [r0, r0 + 64) of a (S, Dh) head matrix with row stride ss into
// shared memory (row stride ld, DHP >= Dh columns); rows >= S and columns
// >= Dh are zero.  With vec, Dh, ss and the base are 16-byte multiples.
template <typename T, int DHP>
__device__ void load_tile(T* dst, int ld, const T* src, int64_t ss, int64_t r0,
                          int64_t S, int Dh, bool vec) {
  if (vec) {
    constexpr int VE = 16 / sizeof(T);
    constexpr int NV = DHP / VE;
    for (int i = threadIdx.x; i < kKeys * NV; i += kThreads) {
      const int r = i / NV, c = (i % NV) * VE;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < S && c < Dh)
        val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c);
      if constexpr (sizeof(T) == 2) {   // bf16 rows are 16-byte multiples
        *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
      } else {                          // f32 rows are odd-strided
        const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
        for (int u = 0; u < VE; ++u) dst[r * ld + c + u] = e[u];
      }
    }
  } else {
    for (int i = threadIdx.x; i < kKeys * DHP; i += kThreads) {
      const int r = i / DHP, c = i % DHP;
      dst[r * ld + c] = (r0 + r < S && c < Dh) ? src[(r0 + r) * ss + c]
                                               : Store<T>::from(0.0f);
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

template <typename T, int NO>
__device__ __forceinline__ void store_rows(const float (&o)[NO][4], const float (&l)[2],
                                           T* out, int64_t os, int64_t row0,
                                           const Params& p, int t) {
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
        if (c < p.Dh) out[row * os + c] = Store<T>::from(o[jn][2 * r + e] / den);
      }
  }
}

// KD = ceil(Dh / 16) column chunks of 16.
template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Params p) {
  constexpr int DHP = 16 * KD;    // Dh padded to the mma depth
  constexpr int NO = 2 * KD;      // 8-column tiles of the output fragment
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

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int LD = DHP + 8;   // 16-byte rows; 4-word skew between rows
    T* Ks = reinterpret_cast<T*>(smem);
    T* Vs = Ks + kKeys * LD;
    // q's A fragments: a0 (row g, cols 2t, 2t+1), a1 (row g+8), a2 / a3 the
    // same rows at cols + 8; zero past Sq and Dh
    uint32_t qf[KD][4];
    auto qat = [&](int64_t row, int c) {
      return (row < p.Sq && c < p.Dh) ? q[row * p.qs[2] + c] : Store<T>::from(0.0f);
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
      load_tile<T, DHP>(Ks, LD, k, p.ks[2], kt * kKeys, p.Skv, p.Dh, vec);
      load_tile<T, DHP>(Vs, LD, v, p.vs[2], kt * kKeys, p.Skv, p.Dh, vec);
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
  } else {
    constexpr int LD = DHP + 1;   // odd row stride: rows 2t apart hit other banks
    constexpr int LP = kKeys + 1;
    T* Qs = reinterpret_cast<T*>(smem);
    T* Ks = Qs + kRows * LD;
    T* Vs = Ks + kKeys * LD;
    T* Ps = Vs + kKeys * LD + warp * 16 * LP;
    load_tile<T, DHP>(Qs, LD, q, p.qs[2], q0, p.Sq, p.Dh, vec);
    const T* qa = Qs + (warp * 16 + g) * LD;
    const T* qb = qa + 8 * LD;
    for (int64_t kt = 0; kt < nt; ++kt) {
      __syncthreads();
      load_tile<T, DHP>(Ks, LD, k, p.ks[2], kt * kKeys, p.Skv, p.Dh, vec);
      load_tile<T, DHP>(Vs, LD, v, p.vs[2], kt * kKeys, p.Skv, p.Dh, vec);
      __syncthreads();
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < DHP; ++d) {
        const float a0 = qa[d], a1 = qb[d];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float k0 = Ks[(8 * j + 2 * t) * LD + d];
          const float k1 = Ks[(8 * j + 2 * t + 1) * LD + d];
          s[j][0] = fmaf(a0, k0, s[j][0]);
          s[j][1] = fmaf(a0, k1, s[j][1]);
          s[j][2] = fmaf(a1, k0, s[j][2]);
          s[j][3] = fmaf(a1, k1, s[j][3]);
        }
      }
      softmax_step<NO>(s, m, l, o, kt * kKeys, row0, p, t);
      __syncwarp();               // the last tile's p is read
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = 8 * j + 2 * t;
        Ps[g * LP + c] = s[j][0];
        Ps[g * LP + c + 1] = s[j][1];
        Ps[(g + 8) * LP + c] = s[j][2];
        Ps[(g + 8) * LP + c + 1] = s[j][3];
      }
      __syncwarp();
#pragma unroll 4
      for (int kk = 0; kk < kKeys; ++kk) {
        const float pa = Ps[g * LP + kk], pb = Ps[(g + 8) * LP + kk];
        const T* vr = Vs + kk * LD + 2 * t;
#pragma unroll
        for (int jn = 0; jn < NO; ++jn) {
          const float v0 = vr[8 * jn], v1 = vr[8 * jn + 1];
          o[jn][0] = fmaf(pa, v0, o[jn][0]);
          o[jn][1] = fmaf(pa, v1, o[jn][1]);
          o[jn][2] = fmaf(pb, v0, o[jn][2]);
          o[jn][3] = fmaf(pb, v1, o[jn][3]);
        }
      }
    }
  }
  store_rows<T, NO>(o, l, out, p.os[2], row0, p, t);
}

template <typename T, int KD>
size_t smem_bytes() {
  constexpr int DHP = 16 * KD;
  if (std::is_same<T, __nv_bfloat16>::value) return 2 * kKeys * (DHP + 8) * sizeof(T);
  return ((kRows + 2 * kKeys) * (DHP + 1) + 4 * 16 * (kKeys + 1)) * sizeof(T);
}

template <typename T, int KD>
int launch(const Params& p, int64_t BH, cudaStream_t s) {
  const size_t bytes = smem_bytes<T, KD>();
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, KD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((p.Sq + kRows - 1) / kRows), (unsigned)BH);
  flash_kernel<T, KD><<<grid, kThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const Params& p, int64_t BH, cudaStream_t s) {
  switch ((p.Dh + 15) / 16) {
    case 1: return launch<T, 1>(p, BH, s);
    case 2: return launch<T, 2>(p, BH, s);
    case 3: return launch<T, 3>(p, BH, s);
    case 4: return launch<T, 4>(p, BH, s);
    case 5: return launch<T, 5>(p, BH, s);
    case 6: return launch<T, 6>(p, BH, s);
    case 7: return launch<T, 7>(p, BH, s);
    case 8: return launch<T, 8>(p, BH, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
// folded (BH, S, Dh) layout is B = BH, Hq = Hkv = 1.  dtype: bf16 or f32.
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
  if (Dh < 1 || Dh > 128 || Skv < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      B * Hq > 65535 || (Sq + kRows - 1) / kRows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, Hq, Hkv, Sq, Skv, Dh, {q_sb, q_sh, q_ss},
                               {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
                               causal, dtype == DT_BF16 ? 2 : 4);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) return launch_dh<__nv_bfloat16>(p, B * Hq, s);
  if (dtype == DT_F32) return launch_dh<float>(p, B * Hq, s);
  return (int)cudaErrorInvalidValue;
}

// The same function on flash_wgmma_kernel: bf16 only, Dh 64 or 128, q, k,
// v and o 16-byte aligned with every stride a multiple of 8 elements.
// Anything else is refused (the wrapper sends it to flash_attention_bh).
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
