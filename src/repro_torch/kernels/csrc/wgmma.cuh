// Hopper's warpgroup matrix multiply (wgmma) and what feeds it: the pieces
// the wgmma kernels (flash_attention.cu, and sbgemm.cu through
// sbgemm_bf16.cuh) share.
//
// - Tiles in shared memory are stored as rows of 128 bytes (64 bf16) with
//   the 128-byte swizzle: 16-byte chunk j of row r sits at chunk j ^ (r %
//   8) of that row, so the 8 rows a wgmma core matrix reads lie in 8
//   distinct bank groups.  A tile wider than 64 bf16 is a sequence of such
//   64-wide "atoms", each rows x 128 bytes; every atom starts on a
//   1024-byte boundary (the swizzle reads address bits 4-9).
// - The shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor
//   Format"): start address >> 4 in bits 0-13, leading byte offset >> 4 in
//   16-29, stride byte offset >> 4 in 32-45, layout (1 = 128-byte swizzle)
//   in 62-63.  K-major operand (K contiguous, the usual A and B): a k16
//   step is 32 bytes inside an atom's rows, the stride byte offset (1024)
//   steps 8 rows, the leading offset is unused.  MN-major B (N contiguous,
//   read with the transpose bit): one atom holds 64 columns of N; the
//   stride byte offset (1024) steps 8 rows of K, and a k16 step is 16 rows
//   (2048 bytes).  Every wgmma here is at most 64 wide along an MN-major
//   N, so the leading offset is never read.
// - wgmma.fence before a wgmma that reads registers written since the last
//   one; commit_group and wait_group<N> around each batch.  The compiler
//   sees a wgmma's accumulators as written when the instruction issues,
//   not when it completes, so after a wait the kernels pass the registers
//   through fence_regs(), which keeps every later read after the wait.
// - mbarrier rings between a producer warp and the consumer warpgroups.
//   Where rows are 16-byte aligned the producer's one elected thread feeds
//   a stage with TMA (cp.async.bulk.tensor, a tensor map made on the host
//   by make_tensor_map below, 128-byte swizzle, out-of-bounds elements
//   zero), which completes the stage's full barrier by its byte count.
//   Otherwise the producer warp copies element by element (copy_rows),
//   makes its stores visible to the async proxy that wgmma reads through
//   (fence.proxy.async) and only then arrives.
//   Consumers arrive on a stage's empty barrier once their wgmmas have
//   read it.
//
// Measurement builds: WGMMA_NO_MMA compiles the products out (the kernels'
// bound probe, which no wrapper loads).
#pragma once

#include <cstdint>
#include <cuda.h>            // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wg {

constexpr int kAtomBytes = 128;            // a swizzled row: 64 bf16
constexpr int kSwizzleBytes = 1024;        // 8 rows: the swizzle's period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk j (0 .. 7) of row r in an atom.
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return (uint32_t)(r * kAtomBytes + ((j ^ (r & 7)) << 4));
}

// Descriptor of a 128-byte-swizzled operand at shared address `addr`
// (1024-byte aligned atom; a k16 step adds to the address).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(kSwizzleBytes >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads of these registers above the last
// wait (and from reusing a register-sourced operand before it).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// ---------------------------------------------------------------------------
// The products (bf16 in, f32 accumulate).  `accumulate` = 0 overwrites d.
// ---------------------------------------------------------------------------

// d (+)= (SCALE_A a) b, m64n40k16, A and B from shared memory (K-major).
template <int SCALE_A = 1>
__device__ __forceinline__ void mma_ss_n40(float (&d)[20], uint64_t da, uint64_t db,
                                            int accumulate) {
#ifndef WGMMA_NO_MMA
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "%20, %21, p, %23, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(accumulate), "n"(SCALE_A));
#endif
}

// d (+)= (SCALE_A a) b, m64n64k16, A and B from shared memory (K-major).
template <int SCALE_A = 1>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
#ifndef WGMMA_NO_MMA
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, %35, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(SCALE_A));
#endif
}

// d (+)= (SCALE_A a) b, m64n104k16, A and B from shared memory (K-major).
template <int SCALE_A = 1>
__device__ __forceinline__ void mma_ss_n104(float (&d)[52], uint64_t da, uint64_t db,
                                            int accumulate) {
#ifndef WGMMA_NO_MMA
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51}, "
      "%52, %53, p, %55, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(da), "l"(db), "r"(accumulate), "n"(SCALE_A));
#endif
}

// d (+)= (SCALE_A a) b, m64n128k16, A and B from shared memory (K-major).
template <int SCALE_A = 1>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
#ifndef WGMMA_NO_MMA
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, %67, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(SCALE_A));
#endif
}

// d += a b, m64n64k16, A (four registers a thread, the mma.m16n8k16 A
// fragment of the warp's 16 rows) from registers, B from shared memory
// stored MN-major (N contiguous: the transpose bit).
__device__ __forceinline__ void mma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
#ifndef WGMMA_NO_MMA
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
#endif
}

// The SS product of width N (the widths the kernels use).
template <int N, int SCALE_A = 1>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                       int accumulate) {
  static_assert(N == 40 || N == 64 || N == 104 || N == 128, "no wgmma form of this width");
  if constexpr (N == 40) mma_ss_n40<SCALE_A>(d, da, db, accumulate);
  else if constexpr (N == 64) mma_ss_n64<SCALE_A>(d, da, db, accumulate);
  else if constexpr (N == 104) mma_ss_n104<SCALE_A>(d, da, db, accumulate);
  else mma_ss_n128<SCALE_A>(d, da, db, accumulate);
}

// ---------------------------------------------------------------------------
// mbarrier rings and the producer's copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// After every barrier of the block is initialised, before any is used.
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// Make this thread's shared-memory writes (its completed cp.async copies
// and plain stores) visible to the async proxy, which wgmma reads through.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrive on a barrier and add `bytes` to the transactions its phase waits
// for (the TMA copies issued against it complete them).
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// TMA: the box of tensor map `map` at coordinates c (innermost first) into
// shared memory at dst, completing its bytes on `bar`.  Out-of-bounds
// elements are written as zeros and count as transferred bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%3, %4, %5}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
                  "r"(c0), "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
                  "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// Copy rows r < rv of a 64-column bf16 tile into one swizzled atom at
// shared address dst, element by element (rows that are not 16-byte
// aligned, which TMA cannot read): column c < cv from src + r ld + c, zero
// past cv.  The warp's 32 lanes share the tile; the caller makes the
// stores visible to wgmma (proxy_fence) before it arrives.
__device__ __forceinline__ void copy_rows(uint32_t dst, const __nv_bfloat16* src, int64_t ld,
                                          int rv, int cv, int lane) {
  for (int e = lane; e < rv * 64; e += 32) {
    const int r = e >> 6, c = e & 63;
    const __nv_bfloat16 v = c < cv ? src[r * ld + c] : __float2bfloat16_rn(0.f);
    asm volatile("st.shared.b16 [%0], %1;\n"
                 :: "r"(dst + swz(r, c >> 3) + 2 * (c & 7)), "h"(__bfloat16_as_ushort(v))
                 : "memory");
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps for TMA
// ---------------------------------------------------------------------------

// A bf16 tensor of `rank` dims (dims and byte strides innermost first; the
// innermost is contiguous) cut into boxes of `box` elements, rows of 64
// (128 bytes) with the 128-byte swizzle, out-of-bounds elements zero.  The
// encoder is libcuda's cuTensorMapEncodeTiled, found through the
// runtime (the libraries link no libcuda).  Returns a cudaError code.
inline int make_tensor_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                           const uint64_t* strides, const uint32_t* box) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  cuuint64_t d[5], st[4];
  cuuint32_t b[5], one[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    one[i] = 1;
    if (i) st[i - 1] = strides[i];
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                            const_cast<void*>(base), d, st, b, one,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace wg
