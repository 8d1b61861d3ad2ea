// bf16 planes on Hopper's tensor cores: the complex N, T/H and Gram blocks
// of sbgemm.cu, for bf16 A with f32 sums.
//
// Replaces, for bf16 planes, the TPU kernels
// src/repro/kernels/sbgemv.py:sbgemm_n_complex (Y = A X as four
// f32-accumulated real dots, Yr = rr - ii, Yi = ir + ri),
// :sbgemm_th_complex (Y = A^T X, or A^H X with conj: Yr = rr + ii, Yi = ir
// - ri, the contraction over the short m) and :sbgemm_gram_complex (G =
// A^H A from four f32-accumulated real products, Gr = Ar^T Ar + Ai^T Ai, Gi
// = Ar^T Ai - Ai^T Ar; the data-space A A^H read from A as stored).  A bf16
// x bf16 product is exact in f32, so mma.sync.m16n8k16 (bf16 in, f32
// accumulate) computes the TPU kernels' function up to the order of the
// sums.  zgemm_bf16_kernel with REAL also takes the real products
// :sbgemm_n_real and :sbgemm_th_real.  At a bf16 carrier every cell's
// rounding is the identity, so the tiled builds :sbgemm_n_real_tiled,
// :sbgemm_th_real_tiled, :sbgemm_n_complex_tiled and :sbgemm_gram_tiled run
// these kernels as their untiled builds do (sbgemm.cu's launch_n, launch_th
// and launch_gram).  The tiled complex T/H stays on sbgemm.cu's vector
// kernel.
//
// Included by sbgemm.cu inside its anonymous namespace, after the f64
// section, whose smem_addr, min64 / aligned16 and launch_persistent it
// uses, with common.cuh's cp_async, cp_async_commit and cp_async_wait.
// Measurement builds of sbgemm.cu and sbgemm_real.cu (chip_smoke.py's
// bound probe; no wrapper loads them) compile one side of both kernels
// out: SBGEMM_BF16_NO_MMA the products, leaving the copy pipeline and the
// fragment loads, SBGEMM_BF16_NO_COPY the operand copies, leaving the
// products on whatever shared memory holds.
//
// Both kernels are persistent (blocks take items blockIdx.x, + gridDim.x,
// ...) and run one cp.async ring of k-chunks across their items, as
// zgemm_f64_kernel does: a block of 7 warps stages each chunk of its
// operand panels once, 16-byte copies where a row is 16-byte aligned
// (n % 8 == 0, and S % 8 == 0 for X), else each element loaded and stored
// by a thread (odd n, n % 8 != 0).  k past the end is zero-filled, so the
// products need no k mask; rows and columns past the end of the other axes
// are not written, and what they hold reaches only outputs that are not
// stored.  Staged rows are odd multiples of 16 bytes long, so the 8 rows an
// ldmatrix reads hit distinct banks.  Every output sums its k products in
// one warp, in k order, on every run: no atomics, no split across warps or
// blocks.
//
//   N (Y = A X, X (B, n, S), columns last) and T/H (Y = A^T X or A^H X, X
//     (B, m, S)): zgemm_bf16_kernel, the TRANS flag choosing T/H.
//     Bytes-bound (at S = 32 its tensor-core work, the 100 rows or k padded
//     to 112, is ~0.14 TFLOP, far under the time its 2.66 GB take at the
//     HBM rate), so its job is to stream A at that rate.  Items are (bin,
//     112 output rows, a pass of SP = 8, 16 or 32 columns), in a ring 3
//     deep, one block an SM; warp w owns the m16 output tile w and all SP
//     columns: each A fragment (ldmatrix) feeds SP / 8 n8 tiles x 4 real
//     products, Re Re and -Im Im (+Im Im with conj) into Re, then Re Im and
//     Im Re (-Im Re with conj) into Im (a negated fragment: its sign bits
//     flipped, exact); X's fragments come from the [k][s] panel through
//     ldmatrix.trans.
//     N: a bin's m = 100 rows are one item, its X read once a pass; k runs
//     over n in 128-wide chunks (96 at S > 16) of both A planes (51 KB at
//     m = 100; A's rows are read in 256-byte runs, which stream faster than
//     128-byte ones) and of X.
//     T/H: the output rows are A's columns (45 items a bin at n = 5000, the
//     last of 72 rows) and k is A's short m, in 112-wide chunks, so at the
//     paper shape one chunk is a whole item and the ring streams items.
//     The A panel is staged [k][r], A's rows as stored (224-byte runs
//     along n), and its fragments are read through ldmatrix.trans, as the
//     parameter-space Gram reads U; a bin's X panel is read from L2 once an
//     item.  As an item can be a single chunk, the cursor steps through the
//     items without a division.
//     REAL (one A, X and Y plane; one product where the complex build does
//     four): a stage holds the complex build's bytes of A in one plane, so
//     N takes 256-wide k-chunks (192 at S > 16) and T items of 224 output
//     rows (warp w owns row tiles w and w + 7; 448-byte runs along n).  A
//     real bf16 A element carries 2 S flops for 2 bytes: bytes-bound at
//     every S on the tensor cores (on FFMA, 0.48 ms of flops at S = 32
//     against 0.40 of bytes at the paper shape, it could not be).
//   Gram, G = U U^H per bin with U's rows the P indices (data space: A's
//     rows, k over n; parameter space: A's columns, k over m, read through
//     ldmatrix.trans): zgram_bf16_kernel, except the data space with P <=
//     128, which zgram_wgmma_kernel (at the end of this file) takes alone
//     (launch_gram refuses it).  Items are (bin, a 112 x 112 output tile
//     on the diagonal or half of one above it); at P <= 112 (parameter
//     space) a bin is one tile, read from HBM once.  k-chunks: 64-wide in
//     data space, 32-wide in parameter space, where K = m is short; 3 deep
//     with two panels a stage, 4 with one.  The
//     fragment of a 16-row tile of U serves as the A operand and, in
//     halves, as the B operands of two n8 column tiles, so a warp loads
//     each of its row tiles once a k-step.
//     Diagonal tile: warp w loads the tiles of line w of the Fano plane,
//     {w, w + 1, w + 3} mod 7; each pair of the 7 tiles lies on exactly one
//     line, so the 21 pairs x != y and the 7 pairs (w, w) split 4 to a warp
//     (3 tiles loaded for 8 n8 sub-tiles; a pair x > y yields the lower
//     block, stored with its conjugate mirror like any other).
//     Off-diagonal tile (P > 112): two items, each the 112 p rows against
//     64 or 48 of the q rows; warp w takes row tile w of the p rows against
//     the q item's 4 or 3 tiles, so every warp holds at most 4 pairs of
//     accumulators (with 7, ptxas spilled).  Sub-tiles past P are skipped.
//     The busiest SM sub-partition carries 2 warps x 32 mma a k-step (7
//     warps on 4 sub-partitions): at the paper shape's one-tile data space
//     this kernel was bound by its tensor-core side (PERF.md), which is
//     why zgram_wgmma_kernel took that space over.  Each entry on or above
//     the diagonal is written, and its conjugate below it; the diagonal's
//     imaginary parts are not zeroed (ops.sbgemm_gram symmetrizes).

namespace bf16tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 7;                 // a block: one warp an m16 row tile
constexpr int kRows = 16 * kWarps;        // rows of an item (N) or tile (Gram)
constexpr int kThreads = 32 * kWarps;
constexpr int kPadE = 8;                  // bf16 of padding a staged row
constexpr int kHalf = 64;                 // Gram: q rows of an off-diagonal item
constexpr int kWgmmaGramMaxP = 128;       // the data-space Gram's P on wgmma

// Flip the sign bits of both bf16 halves: exact negation.
__device__ __forceinline__ uint32_t neg2(uint32_t v) { return v ^ 0x80008000u; }

// d += a b for one m16n8k16 tile pair (PTX ISA, mma.m16n8k16 .bf16): lane
// l, g = l / 4, t = l % 4, holds a = {A[g][2t..], A[g + 8][2t..], A[g][2t +
// 8..], A[g + 8][2t + 8..]}, b = {B[2t..][g], B[2t + 8..][g]} (two bf16 a
// register, the lower k in the low half) and d = {D[g][2t], D[g][2t + 1],
// D[g + 8][2t], D[g + 8][2t + 1]}.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
#ifndef SBGEMM_BF16_NO_MMA
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#endif
}

// Four 8 x 8 bf16 matrices from shared memory, lanes 8 j .. 8 j + 7 giving
// the row addresses of matrix j; lane l receives row l / 4, columns 2 (l %
// 4) and + 1 of each (TRANS: column l / 4, rows 2 (l % 4) and + 1).
template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// Two transposed 8 x 8 matrices (lanes 0 .. 15 give the row addresses).
__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// Stage a ROWS x COLS bf16 tile whose rows start at src + r ld (contiguous
// along c) into shared memory at dst + r DLD + c, as stage() does for f64
// planes: rows r < rv and columns c < cv are copied; the k axis is the rows
// (KROWS) or the columns, and past its end the tile is zero-filled; past
// the end of the other axis nothing is written.  vec: 16-byte copies of 8
// elements (ld, the tile's start and cv multiples of 8, the plane 16-byte
// aligned); otherwise a thread loads and stores each element.
template <int ROWS, int COLS, int DLD, bool KROWS>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int64_t ld, int rv,
                                      int cv, bool vec) {
  static_assert(COLS % 8 == 0 && DLD % 8 == 0, "rows of whole 16-byte runs");
#ifdef SBGEMM_BF16_NO_COPY
  return;
#endif
  const int rows = KROWS ? ROWS : rv;        // rows written
  if (vec) {
    constexpr int CV = COLS / 8;
    const uint32_t d0 = smem_addr(dst);
    for (int e = threadIdx.x; e < rows * CV; e += kThreads) {
      const int r = e / CV, c = 8 * (e % CV);
      if (KROWS && c >= cv) continue;        // past the other axis
      const bool ok = r < rv && c < cv;
      cp_async<16>(d0 + 2u * (r * DLD + c), ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * COLS; e += kThreads) {
      const int r = e / COLS, c = e % COLS;
      if (KROWS && c >= cv) continue;
      dst[r * DLD + c] = r < rv && c < cv ? src[r * ld + c] : __ushort_as_bfloat16(0);
    }
  }
}

// Shared-memory layout of a GEMM stage for NT column tiles of 8: the A
// panel of each of its PL planes (N: kRows x KC, A's rows as stored; T/H:
// KC x ROWS, A's rows k along the output rows) and the X panel of each
// plane (KC x SP).  A warp owns RT row tiles of 16, w + 7 u (u < RT), of
// an item's ROWS output rows.  STEP and TILE: the element offsets in an A
// panel of k-step j (16 k) and of row tile w (16 output rows).  Staged rows
// are odd multiples of 16 bytes: ALD 240 / 464 bytes (T/H / real T); 272,
// 208 (N); 528, 400 (real N); XLD 48, 80.
template <int NT, bool TRANS, bool REAL>
struct ZLayout {
  static constexpr int SP = 8 * NT, NS = 3, PL = REAL ? 1 : 2;
  static constexpr int RT = REAL && TRANS ? 2 : 1;
  static constexpr int ROWS = RT * kRows;
  static constexpr int KC = TRANS ? 112 : (NT == 4 ? 96 : 128) * (REAL ? 2 : 1);
  static constexpr int ALD = TRANS ? ROWS + kPadE : KC + kPadE;
  static constexpr int XLD = SP % 16 ? SP + 2 * kPadE : SP + kPadE;
  static constexpr int A_TILE = (TRANS ? KC : ROWS) * ALD, X_TILE = KC * XLD;
  static constexpr int STAGE = PL * (A_TILE + X_TILE);         // elements
  static constexpr int BYTES = 2 * NS * STAGE;
  static constexpr int STEP = TRANS ? 16 * ALD : 16, TILE = TRANS ? 16 : 16 * ALD;
  static_assert((ALD / 8) % 2 == 1 && (XLD / 8) % 2 == 1,
                "the 8 rows an ldmatrix reads lie in distinct banks");
};

// Y = op(A) X per bin: N (Y (B, m, S) = A X, k over n) or TRANS (Y (B, n,
// S) = A^T X, A^H X with conj, k over m); REAL: the planes Ar, Xr, Yr only
// (conj 0).
template <typename O, int NT, bool TRANS, bool REAL>
__global__ void __launch_bounds__(kThreads, 1)
zgemm_bf16_kernel(const bf16* __restrict__ Ar, const bf16* __restrict__ Ai,
                  const bf16* __restrict__ Xr, const bf16* __restrict__ Xi,
                  O* __restrict__ Yr, O* __restrict__ Yi, int64_t B, int64_t m,
                  int64_t n, int64_t S, int conj, int vec_a, int vec_x) {
  using L = ZLayout<NT, TRANS, REAL>;
  constexpr int KC = L::KC, NS = L::NS, SP = L::SP, PL = L::PL, RT = L::RT;
  constexpr int ROWS = L::ROWS;
  extern __shared__ __align__(16) bf16 sbf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t M = TRANS ? n : m, K = TRANS ? m : n;
  const int64_t KCH = (K + KC - 1) / KC;
  // A position in this block's chunk stream: item (b, rt, sp) of the B x
  // RTS x SPS items (bin, ROWS output rows, SP columns), taken blockIdx.x,
  // + gridDim.x, ..., its chunk c and the ring stage it goes to.  gridDim.x
  // is added to the item digit by digit, with carries, so no division runs
  // past the first item (an item can be a single chunk).
  const int RTS = (int)((M + ROWS - 1) / ROWS), SPS = (int)((S + SP - 1) / SP);
  const int64_t step_b = gridDim.x / ((int64_t)RTS * SPS);
  const int step_rt = (int)(gridDim.x / SPS % RTS), step_sp = (int)(gridDim.x % SPS);
  struct Cursor {
    int64_t b, c, r0, s0;
    int rt, sp, rv, sv, slot;
  };
  auto at_item = [&](Cursor& q) {     // past the last item, q.b >= B
    q.c = 0;
    q.r0 = (int64_t)q.rt * ROWS;
    q.s0 = (int64_t)q.sp * SP;
    q.rv = (int)min64(ROWS, M - q.r0);
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
  // one copy group a chunk (empty past the last), so the wait counts chunks
  auto load = [&](const Cursor& w) {
    if (w.b < B) {
      const int64_t k0 = w.c * KC;
      const int kv = (int)min64(KC, K - k0);
      bf16* st = sbf + w.slot * L::STAGE;
#pragma unroll
      for (int pl = 0; pl < PL; ++pl) {
        const bf16* a = (pl ? Ai : Ar) + w.b * m * n;
        if (TRANS)   // A's rows k0.. (k), its columns r0.. (output rows)
          stage<KC, ROWS, L::ALD, true>(st + pl * L::A_TILE, a + k0 * n + w.r0, n, kv,
                                        w.rv, vec_a);
        else         // A's rows r0.., its columns k0..
          stage<ROWS, KC, L::ALD, false>(st + pl * L::A_TILE, a + w.r0 * n + k0, n, w.rv,
                                         kv, vec_a);
        const bf16* x = (pl ? Xi : Xr) + (w.b * K + k0) * S + w.s0;
        stage<KC, SP, L::XLD, true>(st + PL * L::A_TILE + pl * L::X_TILE, x, S, kv, w.sv,
                                    vec_x);
      }
    }
    cp_async_commit();
  };
  // this lane's ldmatrix row: A (row tile `warp`, matrices in fragment
  // order: rows +0 / +8, k +0 / +8; T/H reads [k][r] transposed); X ([k][s]:
  // k +0 / +8, columns +0 / +8)
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);
  const int a_row = TRANS ? (lane & 7) + 8 * (lane >> 4) : lr;
  const int a_col = TRANS ? 8 * ((lane >> 3) & 1) : lc;
  const uint32_t a_off = 2u * (warp * L::TILE + a_row * L::ALD + a_col);
  const uint32_t x_off = 2u * (PL * L::A_TILE + lr * L::XLD + lc);
  // the sign bits the Im A fragments take into the Re sum (-Im Im; +Im Im
  // with conj) and into the Im sum (+Im Re; -Im Re with conj)
  const uint32_t flip_ii = conj ? 0u : 0x80008000u, flip_ri = flip_ii ^ 0x80008000u;
  // complex: [Re, Im][column tile]; REAL: [row tile u][column tile]
  constexpr int AC = REAL ? RT : 2;
  float acc[AC][NT][4];
#pragma unroll
  for (int p = 0; p < AC; ++p)
#pragma unroll
    for (int v = 0; v < NT; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][v][e] = 0.f;
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
    cp_async_wait<NS - 2>();         // this thread's copies of chunk w landed
    __syncthreads();                 // everyone's; the chunk before is consumed
    load(ld);
    advance(ld);
    // whole warp: its row tiles that hold rows of this item (tile warp +
    // 7 u for u < tiles <= RT)
    const int tiles =
        (int)min64(RT, (w.rv - 16 * warp + 16 * kWarps - 1) / (16 * kWarps));
    if (tiles > 0) {
      const uint32_t st = smem_addr(sbf + w.slot * L::STAGE);
#pragma unroll
      for (int j = 0; j < KC / 16; ++j) {
        uint32_t x[PL][NT][2];                 // X's fragments a plane
        const uint32_t xa = st + x_off + 2u * 16 * j * L::XLD;
#pragma unroll
        for (int pl = 0; pl < PL; ++pl) {
          if constexpr (NT == 1) {
            ldsm2t(x[pl][0], xa + 2u * pl * L::X_TILE);
          } else {
#pragma unroll
            for (int v = 0; v < NT; v += 2) {  // two n8 tiles an ldmatrix
              uint32_t r[4];
              ldsm4<true>(r, xa + 2u * pl * L::X_TILE + 16u * v);
              x[pl][v][0] = r[0], x[pl][v][1] = r[1];
              x[pl][v + 1][0] = r[2], x[pl][v + 1][1] = r[3];
            }
          }
        }
        if constexpr (REAL) {
#pragma unroll
          for (int u = 0; u < RT; ++u) {
            if (u >= tiles) break;
            uint32_t a[4];
            ldsm4<TRANS>(a, st + a_off + 2u * (kWarps * u * L::TILE + L::STEP * j));
#pragma unroll
            for (int v = 0; v < NT; ++v) mma16816(acc[u][v], a, x[0][v][0], x[0][v][1]);
          }
        } else {
          uint32_t ar[4], ai[4], aii[4], ari[4];
          ldsm4<TRANS>(ar, st + a_off + 2u * L::STEP * j);
          ldsm4<TRANS>(ai, st + a_off + 2u * (L::A_TILE + L::STEP * j));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            aii[e] = ai[e] ^ flip_ii;
            ari[e] = ai[e] ^ flip_ri;
          }
#pragma unroll
          for (int v = 0; v < NT; ++v) {
            mma16816(acc[0][v], ar, x[0][v][0], x[0][v][1]);
            mma16816(acc[0][v], aii, x[1][v][0], x[1][v][1]);
            mma16816(acc[1][v], ar, x[1][v][0], x[1][v][1]);
            mma16816(acc[1][v], ari, x[0][v][0], x[0][v][1]);
          }
        }
      }
    }
    if (w.c == KCH - 1 && tiles > 0) {       // the item's last chunk: store
#pragma unroll
      for (int p = 0; p < AC; ++p)
#pragma unroll
        for (int v = 0; v < NT; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // complex: plane p of row tile `warp`; REAL: row tile warp + 7 p
            const int row = 16 * (warp + (REAL ? kWarps * p : 0)) + g + 8 * (e >> 1);
            const int col = 8 * v + 2 * t + (e & 1);
            if (row < w.rv && col < w.sv)
              (!REAL && p ? Yi : Yr)[(w.b * M + w.r0 + row) * S + w.s0 + col] =
                  Store<O>::from(acc[p][v][e]);
            acc[p][v][e] = 0.f;
          }
    }
  }
}

// Shared-memory layout of a Gram stage: PANELS panels (the p rows, and on
// an off-diagonal item the q rows) of both planes, each kRows rows of U x
// KC k (data space: rows of A along n) or KC k x kRows (parameter space:
// rows of A along n = p).  One panel when a bin is one tile (parameter
// space, P <= 112); data space is always two (P > 128).
template <bool DATA, int PANELS>
struct GLayout {
  static_assert(!DATA || PANELS == 2, "zgram_wgmma_kernel takes the data space at P <= 128");
  static constexpr int KC = DATA ? 64 : 32;
  static constexpr int NS = PANELS == 2 ? 3 : 4;
  static constexpr int LD = DATA ? KC + kPadE : kRows + kPadE;   // 272, 144 / 240 bytes
  static constexpr int PANEL = DATA ? kRows * LD : KC * LD;
  static constexpr int STAGE = PANELS * 2 * PANEL;
  static constexpr int BYTES = 2 * NS * STAGE;
  // element offsets of row tile x's fragment and of k-step j in a panel
  static constexpr int TILE = DATA ? 16 * LD : 16, STEP = DATA ? 16 : 16 * LD;
};

template <typename O, bool DATA, int PANELS>
__global__ void __launch_bounds__(kThreads, 1)
zgram_bf16_kernel(const bf16* __restrict__ Ar, const bf16* __restrict__ Ai,
                  O* __restrict__ Gr, O* __restrict__ Gi, int64_t B, int64_t m,
                  int64_t n, int vec) {
  using L = GLayout<DATA, PANELS>;
  constexpr int KC = L::KC, NS = L::NS;
  extern __shared__ __align__(16) bf16 sbf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t P = DATA ? m : n, K = DATA ? n : m;
  // a bin's items: row pt of tiles holds its diagonal tile and two items
  // of each tile right of it, 2 (T - pt) - 1, so T^2 in all
  const int T = (int)((P + kRows - 1) / kRows);
  const int64_t tiles = (int64_t)T * T, items = B * tiles;
  const int64_t KCH = (K + KC - 1) / KC;
  struct Cursor {
    int64_t it, c, b, p0, q0;
    int pv, qv, slot;
    bool diag;
  };
  auto at_item = [&](Cursor& q) {
    q.c = 0;
    if (q.it >= items) return;
    q.b = q.it / tiles;
    // item x of row pt: the diagonal tile (x = 0), else half (x + 1) % 2 of
    // tile pt + (x + 1) / 2 (a half past P is empty)
    int pt = 0, x = (int)(q.it % tiles);
    while (x >= 2 * (T - pt) - 1) {
      x -= 2 * (T - pt) - 1;
      ++pt;
    }
    const int half = (x + 1) % 2;
    q.diag = x == 0;
    q.p0 = (int64_t)pt * kRows;
    q.q0 = (int64_t)(pt + (x + 1) / 2) * kRows + (q.diag ? 0 : half * kHalf);
    q.pv = (int)min64(kRows, P - q.p0);
    q.qv = (int)min64(q.diag ? kRows : half ? kRows - kHalf : kHalf, P - q.q0);
  };
  auto advance = [&](Cursor& q) {
    q.slot = q.slot + 1 == NS ? 0 : q.slot + 1;
    if (++q.c == KCH) {
      q.it += gridDim.x;
      at_item(q);
    }
  };
  auto load = [&](const Cursor& w) {
    if (w.it < items) {
      const int64_t k0 = w.c * KC;
      const int kv = (int)min64(KC, K - k0);
      bf16* st = sbf + w.slot * L::STAGE;
#pragma unroll
      for (int panel = 0; panel < PANELS; ++panel) {
        if (panel && w.diag) break;          // one panel serves both sides
        const int64_t r0 = panel ? w.q0 : w.p0;
        const int rv = panel ? w.qv : w.pv;
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
          bf16* dst = st + (2 * panel + pl) * L::PANEL;
          const bf16* src = (pl ? Ai : Ar) + w.b * m * n;
          if (DATA)
            stage<kRows, KC, L::LD, false>(dst, src + r0 * n + k0, n, rv, kv, vec);
          else
            stage<KC, kRows, L::LD, true>(dst, src + k0 * n + r0, n, kv, rv, vec);
        }
      }
    }
    cp_async_commit();
  };
  // this lane's ldmatrix row in a panel: matrices in fragment order (rows
  // of U +0 / +8, k +0 / +8), read transposed in parameter space
  const int lo = DATA ? ((lane & 7) + 8 * ((lane >> 3) & 1)) * L::LD + 8 * (lane >> 4)
                      : ((lane & 7) + 8 * (lane >> 4)) * L::LD + 8 * ((lane >> 3) & 1);
  // diagonal tile: this warp's three row tiles (Fano line `warp`) and its
  // pairs q = 0 .. 3 of them, (0, 0), (0, 1), (0, 2), (1, 2): (q / 3, q - q / 3)
  const int fano[3] = {warp, (warp + 1) % 7, (warp + 3) % 7};
  float acc[4][2][2][4];                     // [pair][n8 half][re, im][e]
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][h][c][e] = 0.f;
  // the four real products of row tile x (fr, fi) against an n8 half of
  // row tile y (its registers (r0, r1) of each plane) into a pair's
  // accumulators
  auto products = [&](float (&cr)[4], float (&ci)[4], const uint32_t (&fr)[4],
                      const uint32_t (&fi)[4], uint32_t yr0, uint32_t yr1, uint32_t yi0,
                      uint32_t yi1) {
    mma16816(cr, fr, yr0, yr1);
    mma16816(cr, fi, yi0, yi1);
    if (DATA) {   // Gi = Ui Ur^T - Ur Ui^T
      mma16816(ci, fi, yr0, yr1);
      mma16816(ci, fr, neg2(yi0), neg2(yi1));
    } else {      // Gi = Ur^T Ui - Ui^T Ur
      mma16816(ci, fr, yi0, yi1);
      const uint32_t fn[4] = {neg2(fi[0]), neg2(fi[1]), neg2(fi[2]), neg2(fi[3])};
      mma16816(ci, fn, yr0, yr1);
    }
  };
  // the store of an item's outputs, (r, c) of its tile: G[p0 + r][q0 + c]
  // and its conjugate mirror
  auto put = [&](const Cursor& w, float (&cr)[4], float (&ci)[4], int x, int y, int h) {
    const int Pi = (int)P;                   // P^2 < 2^31, checked at launch
    O* gr = Gr + w.b * P * P;
    O* gi = Gi + w.b * P * P;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * x + g + 8 * (e >> 1), c = 16 * y + 8 * h + 2 * t + (e & 1);
      if (r >= w.pv || c >= w.qv || (w.diag && x == y && r > c)) continue;
      const int p = (int)w.p0 + r, q = (int)w.q0 + c;
      gr[p * Pi + q] = Store<O>::from(cr[e]);
      gi[p * Pi + q] = Store<O>::from(ci[e]);
      if (p != q) {
        gr[q * Pi + p] = Store<O>::from(cr[e]);
        gi[q * Pi + p] = Store<O>::from(-ci[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) cr[e] = ci[e] = 0.f;
  };
  Cursor w, ld;
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
    cp_async_wait<NS - 2>();
    __syncthreads();
    load(ld);
    advance(ld);
    const uint32_t pp = smem_addr(sbf + w.slot * L::STAGE) + 2u * lo;   // p rows
    const bool last = w.c == KCH - 1;
    if (PANELS == 1 || w.diag) {
      // a pair is needed when both its tiles hold rows of G, an n8 half
      // when its columns do
      bool need[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int x = fano[q / 3], y = fano[q - q / 3];
#pragma unroll
        for (int h = 0; h < 2; ++h) need[q][h] = 16 * x < w.pv && 16 * y + 8 * h < w.pv;
      }
#pragma unroll
      for (int j = 0; j < KC / 16; ++j) {
        uint32_t fr[3][4], fi[3][4];
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const uint32_t a = pp + 2u * (fano[u] * L::TILE + j * L::STEP);
          ldsm4<!DATA>(fr[u], a);
          ldsm4<!DATA>(fi[u], a + 2u * L::PANEL);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int a = q / 3, b = q - q / 3;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (need[q][h])
              products(acc[q][h][0], acc[q][h][1], fr[a], fi[a], fr[b][h], fr[b][h + 2],
                       fi[b][h], fi[b][h + 2]);
        }
      }
      if (last)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            put(w, acc[q][h][0], acc[q][h][1], fano[q / 3], fano[q - q / 3], h);
    } else if constexpr (PANELS == 2) {
      if (16 * warp < w.pv) {
        // off-diagonal item: row tile `warp` of the p rows against the q rows
        const uint32_t qq = pp + 2u * 2 * L::PANEL;
#pragma unroll
        for (int j = 0; j < KC / 16; ++j) {
          uint32_t fr[4], fi[4];
          const uint32_t a = pp + 2u * (warp * L::TILE + j * L::STEP);
          ldsm4<!DATA>(fr, a);
          ldsm4<!DATA>(fi, a + 2u * L::PANEL);
#pragma unroll
          for (int y = 0; y < kHalf / 16; ++y) {
            if (16 * y >= w.qv) continue;
            uint32_t yr[4], yi[4];
            const uint32_t b = qq + 2u * (y * L::TILE + j * L::STEP);
            ldsm4<!DATA>(yr, b);
            ldsm4<!DATA>(yi, b + 2u * L::PANEL);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (16 * y + 8 * h < w.qv)
                products(acc[y][h][0], acc[y][h][1], fr, fi, yr[h], yr[h + 2], yi[h],
                         yi[h + 2]);
          }
        }
        if (last)
#pragma unroll
          for (int y = 0; y < kHalf / 16; ++y)
#pragma unroll
            for (int h = 0; h < 2; ++h) put(w, acc[y][h][0], acc[y][h][1], warp, y, h);
      }
    }
  }
}

// Y (B, m, S) = A (B, m, n) X (B, n, S), or TRANS: Y (B, n, S) = A^T X
// (A^H X with conj), X (B, m, S), on bf16 planes, passes of 8, 16 or 32
// columns; REAL: the planes Ar, Xr, Yr only (Ai, Xi, Yi null).
template <typename O, bool TRANS, bool REAL>
int launch_gemm(const void* Ar, const void* Ai, const void* Xr, const void* Xi,
                void* Yr, void* Yi, int64_t B, int64_t m, int64_t n, int64_t S, int conj,
                int device, cudaStream_t s) {
  const int64_t M = TRANS ? n : m;
  if ((TRANS ? m : n) == 0) {                // an empty sum: Y = 0
    const size_t bytes = (size_t)(B * M * S) * sizeof(O);
    cudaError_t e = cudaMemsetAsync(Yr, 0, bytes, s);
    if (e == cudaSuccess && !REAL) e = cudaMemsetAsync(Yi, 0, bytes, s);
    return (int)e;
  }
  const int vec_a = n % 8 == 0 && aligned16(Ar) && aligned16(Ai);
  const int vec_x = S % 8 == 0 && aligned16(Xr) && aligned16(Xi);
  constexpr int rows = ZLayout<1, TRANS, REAL>::ROWS;   // an item's output rows
  const int64_t rts = (M + rows - 1) / rows;
  auto go = [&](auto kernel, int nt, int bytes) {
    return launch_persistent(kernel, kThreads, bytes,
                             B * rts * ((S + 8 * nt - 1) / (8 * nt)), device, s,
                             static_cast<const bf16*>(Ar), static_cast<const bf16*>(Ai),
                             static_cast<const bf16*>(Xr), static_cast<const bf16*>(Xi),
                             static_cast<O*>(Yr), static_cast<O*>(Yi), B, m, n, S, conj,
                             vec_a, vec_x);
  };
  if (S <= 8)
    return go(zgemm_bf16_kernel<O, 1, TRANS, REAL>, 1, ZLayout<1, TRANS, REAL>::BYTES);
  if (S <= 16)
    return go(zgemm_bf16_kernel<O, 2, TRANS, REAL>, 2, ZLayout<2, TRANS, REAL>::BYTES);
  return go(zgemm_bf16_kernel<O, 4, TRANS, REAL>, 4, ZLayout<4, TRANS, REAL>::BYTES);
}

// G = A^H A, (B, n, n), or with data != 0 G = A A^H, (B, m, m), on bf16
// planes: one panel a stage when a bin is one tile (P <= 112).  The data
// space at P <= kWgmmaGramMaxP is launch_gram_wgmma's and refused here.
template <typename O>
int launch_gram(const void* Ar, const void* Ai, void* Gr, void* Gi, int64_t B, int64_t m,
                int64_t n, int data, int device, cudaStream_t s) {
  const int64_t P = data ? m : n;
  if (P * P > 0x7fffffff) return (int)cudaErrorInvalidValue;   // a bin's G: int offsets
  if (data && P <= kWgmmaGramMaxP) return (int)cudaErrorInvalidValue;
  if ((data ? n : m) == 0) {                 // an empty sum: G = 0
    const size_t bytes = (size_t)(B * P * P) * sizeof(O);
    cudaError_t e = cudaMemsetAsync(Gr, 0, bytes, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(Gi, 0, bytes, s);
    return (int)e;
  }
  const int vec = n % 8 == 0 && aligned16(Ar) && aligned16(Ai);
  const int64_t T = (P + kRows - 1) / kRows;
  auto go = [&](auto kernel, int bytes) {
    return launch_persistent(kernel, kThreads, bytes, B * T * T, device, s,
                             static_cast<const bf16*>(Ar), static_cast<const bf16*>(Ai),
                             static_cast<O*>(Gr), static_cast<O*>(Gi), B, m, n, vec);
  };
  if (T == 1) return go(zgram_bf16_kernel<O, false, 1>, GLayout<false, 1>::BYTES);
  return data ? go(zgram_bf16_kernel<O, true, 2>, GLayout<true, 2>::BYTES)
              : go(zgram_bf16_kernel<O, false, 2>, GLayout<false, 2>::BYTES);
}

// ---------------------------------------------------------------------------
// zgram_wgmma_kernel: the data-space Gram of bf16 planes for P <= 128 (a
// bin one tile), on wgmma (wgmma.cuh).  G = U U^H with U = A's P rows,
// k over n: Gr = [Ur Ui] [Ur Ui]^T and Gi = [Ui -Ur] [Ur Ui]^T over K =
// 2n, two real wgmma chains that share their B operands; the sign is the
// instruction's scale on A (exact).  Rows of U past P are zero.
// Bytes-bound on paper (the paper shape moves 2.04 GB for ~0.37 TFLOP of
// trimmed tiles), so the design streams A through a deep ring and keeps
// the products' shared-memory reads under the copies.  Blocks are
// persistent over bins, one an SM.  A producer warp feeds each 64-wide
// k-chunk of both planes (rows of 128 bytes, 128-byte swizzle) into a ring
// 4 deep: with rows 16-byte aligned (n % 8 == 0) one thread
// issues two TMA copies a chunk (rows past P and k past n zero-filled by
// the tensor map); otherwise the warp copies element by element (rows
// past P stay zero from the start).
// Consumer warpgroup 0 takes rows 0-63 against columns 0 .. N0 - 1;
// warpgroup 1 (when P > 64) takes rows 64-127 against columns 64 .. 63 +
// N1 only (Hermitian symmetry).  N0 and N1 cover P in multiples of 8: 104
// and 40 up to P = 104 (the paper's P = 100), 128 and 64 above, N0 = 64
// alone up to P = 64.  Each chunk's 16 wgmmas are issued behind the last
// chunk's, whose stage is released once they complete (wait_group 1).
// Every output sums its k in chunk order and each chunk in the tensor
// cores' fixed order: the same on every run.  Entries on and above the
// diagonal are written with their conjugates below, so Gr is symmetric
// and Gi antisymmetric bit for bit off the diagonal; the diagonal's
// imaginary parts are not zeroed (ops.sbgemm_gram symmetrizes).
// Measured (PERF.md): bound by its copies, the tensor-core side well
// under them; 128-wide chunks (64 KB stages) or a ring 3, 5 or 6 deep
// were no faster.  Measurement builds: SBGEMM_BF16_NO_MMA (via
// WGMMA_NO_MMA) drops the products, SBGEMM_BF16_NO_COPY the producer's
// copies.

constexpr int kGwChunk = 64;               // k a stage: one swizzled atom
constexpr int kGwStages = 4;

template <int WGS>
struct GwLayout {
  static constexpr int ROWS = 64 * WGS;                     // U's rows staged
  static constexpr int PLANE = ROWS * wg::kAtomBytes;
  static constexpr int STAGE = 2 * PLANE;                   // Ur, Ui
  static constexpr int BARS = kGwStages * STAGE;            // full, empty
  static constexpr int BYTES = BARS + 8 * 2 * kGwStages + wg::kSwizzleBytes;
  static constexpr int THREADS = 128 * WGS + 32;
};

// One consumer warpgroup's chain: rows r0 .. r0 + 63 of U against the N
// rows from c0, over every chunk of its block's bins.
template <typename O, int WGS, int N>
__device__ __forceinline__ void gw_consume(uint32_t base, uint64_t* full, uint64_t* empty,
                                           O* __restrict__ Gr, O* __restrict__ Gi,
                                           int64_t B, int P, int64_t nch, int r0, int c0) {
  using L = GwLayout<WGS>;
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  float cr[N / 2], ci[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) cr[e] = ci[e] = 0.f;
  int64_t i = 0;                           // the block's chunk stream
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    for (int64_t c = 0; c < nch; ++c, ++i) {
      const int st = (int)(i % kGwStages);
      wg::bar_wait(&full[st], (uint32_t)((i / kGwStages) & 1));
      const uint32_t ur = base + st * L::STAGE, ui = ur + L::PLANE;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kGwChunk / 16; ++kk) {
        const uint32_t a = r0 * wg::kAtomBytes + 32 * kk, bo = c0 * wg::kAtomBytes + 32 * kk;
        const uint64_t ar = wg::desc(ur + a), ai = wg::desc(ui + a);
        const uint64_t br = wg::desc(ur + bo), bi = wg::desc(ui + bo);
        const int acc = c > 0 || kk > 0;
        wg::mma_ss<N>(cr, ar, br, acc);          // Ur Ur^T
        wg::mma_ss<N>(cr, ai, bi, 1);            // + Ui Ui^T
        wg::mma_ss<N>(ci, ai, br, acc);          // Ui Ur^T
        wg::mma_ss<N, -1>(ci, ar, bi, 1);        // - Ur Ui^T
      }
      wg::commit();
      wg::wait<1>();                       // the last chunk's products are done
      if (i > 0) {
        __syncwarp();
        if (lane == 0) wg::bar_arrive(&empty[(i - 1) % kGwStages]);
      }
    }
    wg::wait<0>();
    wg::fence_regs(cr);
    wg::fence_regs(ci);
    O* gr = Gr + b * P * P;
    O* gi = Gi + b * P * P;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 16 * wq + g + 8 * (e >> 1), q = c0 + 8 * j + 2 * t + (e & 1);
        if (r >= P || q >= P || r > q) continue;
        const float vr = cr[4 * j + e], vi = ci[4 * j + e];
        gr[r * P + q] = Store<O>::from(vr);
        gi[r * P + q] = Store<O>::from(vi);
        if (r != q) {
          gr[q * P + r] = Store<O>::from(vr);
          gi[q * P + r] = Store<O>::from(-vi);
        }
      }
  }
}

// tr, ti: tensor maps of the planes as (n, m, B) in boxes of 64 x ROWS x 1
// (read only when tma; element copies otherwise).
template <typename O, int WGS, int N0, int N1>
__global__ void __launch_bounds__(GwLayout<WGS>::THREADS, 1)
zgram_wgmma_kernel(const __grid_constant__ CUtensorMap tr, const __grid_constant__ CUtensorMap ti,
                   const bf16* __restrict__ Ar, const bf16* __restrict__ Ai,
                   O* __restrict__ Gr, O* __restrict__ Gi, int64_t B, int64_t m, int64_t n,
                   int tma) {
  using L = GwLayout<WGS>;
  extern __shared__ __align__(16) unsigned char gw_raw[];
  unsigned char* smem = gw_raw + ((wg::kSwizzleBytes - wg::smem_u32(gw_raw) %
                                   wg::kSwizzleBytes) % wg::kSwizzleBytes);
  const uint32_t base = wg::smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + kGwStages;
  const int P = (int)m;
  const int64_t nch = (n + kGwChunk - 1) / kGwChunk;
  if (!tma) {
    // element copies never write the rows of U past P: zero them once
    for (int e = threadIdx.x; e < L::BARS / 16; e += blockDim.x)
      reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
    wg::proxy_fence();
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGwStages; ++s) {
      wg::bar_init(&full[s], tma ? 1 : 32);    // TMA: the thread that expects the bytes
      wg::bar_init(&empty[s], 4 * WGS);        // the consumers' warps
    }
    wg::bar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4 * WGS) {                   // producer
    if (tma && lane != 0) return;
    int64_t i = 0;
    for (int64_t b = blockIdx.x; b < B; b += gridDim.x)
      for (int64_t c = 0; c < nch; ++c, ++i) {
        const int st = (int)(i % kGwStages);
        if (i >= kGwStages) wg::bar_wait(&empty[st], (uint32_t)((i / kGwStages - 1) & 1));
        const uint32_t dst = base + st * L::STAGE;
        if (tma) {
#ifndef SBGEMM_BF16_NO_COPY
          const int64_t k0 = c * kGwChunk;
          wg::bar_arrive_tx(&full[st], L::STAGE);
          wg::tma_load_3d(dst, &tr, &full[st], (int)k0, 0, (int)b);
          wg::tma_load_3d(dst + L::PLANE, &ti, &full[st], (int)k0, 0, (int)b);
#else
          wg::bar_arrive(&full[st]);
#endif
          continue;
        }
#ifndef SBGEMM_BF16_NO_COPY
        const int64_t k0 = c * kGwChunk;
        const int kv = (int)min64(kGwChunk, n - k0);
        wg::copy_rows(dst, Ar + b * m * n + k0, n, P, kv, lane);
        wg::copy_rows(dst + L::PLANE, Ai + b * m * n + k0, n, P, kv, lane);
#endif
        wg::proxy_fence();
        wg::bar_arrive(&full[st]);
      }
    return;
  }
  if (warp < 4)
    gw_consume<O, WGS, N0>(base, full, empty, Gr, Gi, B, P, nch, 0, 0);
  else if constexpr (WGS == 2)
    gw_consume<O, WGS, N1>(base, full, empty, Gr, Gi, B, P, nch, 64, 64);
}

// The data-space G = A A^H of bf16 planes with P = m <= 128 on
// zgram_wgmma_kernel: one consumer warpgroup for P <= 64, two above; TMA
// where A's rows are 16-byte aligned (n % 8 == 0 and aligned planes).
template <typename O>
int launch_gram_wgmma(const void* Ar, const void* Ai, void* Gr, void* Gi, int64_t B,
                      int64_t m, int64_t n, int device, cudaStream_t s) {
  if (m < 1 || m > kWgmmaGramMaxP || n >= INT32_MAX || B >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) {                              // an empty sum: G = 0
    const size_t bytes = (size_t)(B * m * m) * sizeof(O);
    cudaError_t e = cudaMemsetAsync(Gr, 0, bytes, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(Gi, 0, bytes, s);
    return (int)e;
  }
  const int wgs = m <= 64 ? 1 : 2;
  const int tma = n % 8 == 0 && aligned16(Ar) && aligned16(Ai);
  CUtensorMap tr{}, ti{};
  if (tma) {
    const uint64_t dims[3] = {(uint64_t)n, (uint64_t)m, (uint64_t)B};
    const uint64_t strides[3] = {2, 2 * (uint64_t)n, 2 * (uint64_t)(m * n)};
    const uint32_t box[3] = {(uint32_t)kGwChunk, (uint32_t)(64 * wgs), 1};
    int e = wg::make_tensor_map(&tr, Ar, 3, dims, strides, box);
    if (e == 0) e = wg::make_tensor_map(&ti, Ai, 3, dims, strides, box);
    if (e != 0) return e;
  }
  auto go = [&](auto kernel, int threads, int bytes) {
    return launch_persistent(kernel, threads, bytes, B, device, s, tr, ti,
                             static_cast<const bf16*>(Ar), static_cast<const bf16*>(Ai),
                             static_cast<O*>(Gr), static_cast<O*>(Gi), B, m, n, tma);
  };
  if (m <= 64)
    return go(zgram_wgmma_kernel<O, 1, 64, 64>, GwLayout<1>::THREADS, GwLayout<1>::BYTES);
  if (m <= 104)
    return go(zgram_wgmma_kernel<O, 2, 104, 40>, GwLayout<2>::THREADS, GwLayout<2>::BYTES);
  return go(zgram_wgmma_kernel<O, 2, 128, 64>, GwLayout<2>::THREADS, GwLayout<2>::BYTES);
}

}  // namespace bf16tc
