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
// Design (right and simple first; wgmma, TMA and warp specialisation are
// later work): a block of 4 warps takes 64 query rows of one head, 16 rows
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
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.Hq = Hq; p.group = Hq / Hkv; p.Sq = Sq; p.Skv = Skv;
  p.Dh = (int)Dh; p.causal = causal;
  p.scale = (float)(1.0 / sqrt((double)Dh));
  const int64_t qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                vs[3] = {v_sb, v_sh, v_ss}, os[3] = {o_sb, o_sh, o_ss};
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = qs[i]; p.ks[i] = ks[i]; p.vs[i] = vs[i]; p.os[i] = os[i];
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int esize = dtype == DT_BF16 ? 2 : 4;
  const int64_t ve = 16 / esize;
  const bool aligned = ((uintptr_t)k % 16 == 0) && ((uintptr_t)v % 16 == 0) &&
                       ((uintptr_t)q % 16 == 0);
  p.vec = aligned && Dh % ve == 0 && k_ss % ve == 0 && k_sb % ve == 0 &&
          k_sh % ve == 0 && v_ss % ve == 0 && v_sb % ve == 0 && v_sh % ve == 0 &&
          q_ss % ve == 0 && q_sb % ve == 0 && q_sh % ve == 0;
  if (dtype == DT_BF16) return launch_dh<__nv_bfloat16>(p, B * Hq, s);
  if (dtype == DT_F32) return launch_dh<float>(p, B * Hq, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
