// Fused two-sided eigenbasis preconditioning for stacked K-FAC layers,
// on Hopper's tensor cores.
//
// Replaces the TPU kernel `_kernel`/`_call` of
// kfac_pytorch_tpu/ops/pallas_precond.py.  For every layer slot l of a
// bucket stack, with g, dgda [L, gp, ap], qa [L, ap, ap], qg [L, gp, gp]:
//
//     v1 = qg^T g qa ;  v2 = v1 * dgda ;  pg = qg v2 qa^T
//     clip[l] = sum(v1 * v2)            (== <pg, g>, orthogonal invariance)
//
// What bounds it on an H100.  One ResNet-32 step (six bucket calls) is
// ~1.07 GFLOP over ~24 MB of f32 operands.  On the f32 CUDA cores that
// is ~16 us of arithmetic; with f32-exact products on the tensor cores
// (3xTF32, below: three TF32 products per f32 product at 495 TFLOP/s)
// ~6.5 us, so the bytes (~7.2 us at 3.35 TB/s) set the bound.  Every
// bucket but a576g64 is so small that two dependent launches (~5 us)
// take longer than its bytes: at these sizes the launches and the
// length of each block's K loop are what cost.
//
// Design: two launches per call.  The Pallas kernel holds a whole slot
// in VMEM; a Hopper block has 227 KB of shared memory.  For gp <= 64
// (every ResNet-32 bucket) a column stripe of the [gp, ap]
// intermediate fits, so the chain is reassociated as
//
//     forward, one block per (slot l, column tile n of BN columns):
//         W = g[l] qa[l][:, n]          (gp x BN, K = ap, streamed)
//         v1 = qg[l]^T W                (K = gp, qg[l] whole in smem)
//         v2 = v1 * dgda -> scratch plane [L, gp, ap] (stays in L2),
//         and the tile's clip partial sum(v1 * v2)
//     back, one block per (slot l, column tile m of pg):
//         Y = v2[l] qa[l][m, :]^T       (gp x BN, K = ap, streamed)
//         pg tile = qg[l] Y             (K = gp, qg[l] whole in smem)
//         block m = 0 of slot l sums the slot's clip partials in tile
//         order (stream order has every partial written by then).
//
// qg^T (g qa) and qg (v2 qa^T) are within f32 rounding of the Pallas
// kernel's (qg^T g) qa and (qg v2) qa^T, and need one scratch plane
// instead of three.  Row tiles are 32 (gp <= 32) or 64 (gp <= 64) rows
// by BN = 32 columns, so a576g64 puts 18 x 9 = 162 blocks on 132 SMs.
// Larger gp (ResNet-50's a4608g512) does not fit a stripe: four
// launches of one 128x128-tile tensor-core GEMM, W and Y spilled to
// scratch (W into pg's own buffer), the clip sum folded into the last.
//
// The K loops stream their operand tiles through a three-stage ring of
// 16-byte `cp.async` copies in dynamic shared memory, so the next
// slices load while the tensor cores work on this one; qg's copy rides
// in the first group.  Slices are 64 deep for the fused kernels (fewer
// ring turns for their short K loops) and 32 for the wide tiles, whose
// stages are four times larger.  Shapes whose rows are not 16-byte
// multiples (or unaligned pointers) take a masked element-by-element
// copy in the same kernels.  Edges and padding are zero-filled, so
// every (gp, ap) runs.
//
// Numerics.  f32 operands: 3xTF32.  x = hi + lo with hi = x rounded to
// TF32 (nearest, ties away: the cvt.rna.tf32.f32 rule, done with two
// integer ops instead of the cvt) and lo = x - hi, exact in f32, of
// which the MMA reads the TF32 part; a b is formed as a_lo b_hi +
// a_hi b_lo + a_hi b_hi with f32 accumulation, within f32 rounding of
// an f32 product (plain 1xTF32 would miss the 1e-4 gate).
// The tensor cores' accumulation does not round to nearest, so each
// 32-deep chunk of K sums into fresh accumulators that are added in
// f32.  bf16 operands are exact in TF32, so a bf16 x bf16 product takes
// one TF32 product and a bf16 x f32 one two; as in the TPU kernel, v2
// is rounded to bf16 before the back-rotation.
//
// Why `mma.sync` (m16n8k8 TF32) and not `wgmma`: TF32 `wgmma` reads A
// and B from shared memory only K-major, and the forward products
// contract qa and qg over their row index; `mma.sync` fragments are
// gathered by each thread in any order from padded rows (row strides
// of 4 or 8 words mod 32, no bank conflicts; K-contiguous f32 tiles by
// `ldmatrix`).  Its 16-row tiles also suit gp = 32, where a 64-row
// `wgmma` tile would be half masked.  At ResNet-32's sizes the calls
// are bound by launches and by each block's K-loop latency, not by the
// MMA rate.
//
// Sums use no atomics: each block reduces its tile in a fixed order and
// the clip partials are summed in tile order, so two runs give the same
// bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStages = 3;   // ring depth
constexpr int kChunk = 32;   // K depth of one accumulation chunk

// A block's output tile: MT x BN from K slices of BK, warps laid out
// WARPS_M x WARPS_N, each warp WM m16 tiles by WN n8 tiles.
template <int MT_, int BN_, int WARPS_M_, int WARPS_N_, int BK_>
struct Tile {
  static constexpr int MT = MT_;
  static constexpr int BN = BN_;
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = WARPS_N_;
  static constexpr int BK = BK_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = MT / (16 * WARPS_M);
  static constexpr int WN = BN / (8 * WARPS_N);
  static_assert(WM >= 1 && WN >= 1, "tile too small for its warps");
  static_assert(BK % kChunk == 0, "ring slices are whole chunks");
};
using Tile32 = Tile<32, 32, 2, 2, 64>;      // gp <= 32
using Tile64 = Tile<64, 32, 4, 1, 64>;      // gp <= 64
using TileWide = Tile<128, 128, 2, 4, 32>;  // larger gp, four launches

template <typename T>
constexpr bool kExact = sizeof(T) == 2;  // bf16 is exact in TF32

// Row stride (elements) of a shared tile whose contiguous extent is
// `width`: 16 bytes of padding for K-contiguous tiles, 32 for the rest,
// which keeps 16-byte rows and conflict-free fragment gathers.
template <typename T>
constexpr int ld_k(int width) {
  return width + 16 / static_cast<int>(sizeof(T));
}
template <typename T>
constexpr int ld_mn(int width) {
  return width + 32 / static_cast<int>(sizeof(T));
}
constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

__device__ __forceinline__ float load_f(float x) { return x; }
__device__ __forceinline__ float load_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0.0f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// x rounded to TF32 by the cvt.rna.tf32.f32 rule (nearest, ties away
// from zero): add half of the 13 dropped bits to the magnitude, drop
// them.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo: hi is x rounded to TF32, lo = x - hi exactly in f32, of
// which the MMA reads the TF32 part (its top 19 bits).  Where x is
// exact in TF32 (a bf16 value), hi = x and lo is unused.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = EXACT ? __float_as_uint(x) : to_tf32(x);
  lo = EXACT ? 0u : __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x4 f32 tiles of shared memory into registers, one row address
// per lane (lanes 8q..8q+7 give tile q's rows); lane i receives element
// (i / 4, i % 4) of each tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Copy the ROWS x COLS tile at (r0, c0) of a row-major global matrix
// (row stride ldg, extent rmax x cmax) into shared memory (row stride
// LDS), zero outside the extent.  `aligned`: every row and the base are
// 16-byte aligned and cmax is a multiple of 16 bytes, so the copy goes
// as 16-byte cp.async chunks (zero-filled off the edge); otherwise it
// is a masked element-by-element copy.
template <typename T, int ROWS, int COLS, int LDS, int NT>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long ldg,
                                          int r0, int c0, int rmax, int cmax,
                                          bool aligned, int tid) {
  if (aligned) {
    // Thread tid copies the chunks of column c in rows rr, rr + RSTEP, ...
    constexpr int V = 16 / sizeof(T);
    constexpr int PER_ROW = COLS / V;
    static_assert(COLS % V == 0, "tile width must be a 16-byte multiple");
    static_assert(NT % PER_ROW == 0, "threads cover whole rows");
    constexpr int RSTEP = NT / PER_ROW;
    const int c = (tid % PER_ROW) * V;
    const int rr = tid / PER_ROW;
    const bool col_in = c0 + c < cmax;
    const T* src = g + static_cast<long long>(r0 + rr) * ldg + c0 + c;
    T* dst = s + rr * LDS + c;
#pragma unroll
    for (int it = 0; it < (ROWS + RSTEP - 1) / RSTEP; ++it) {
      if (ROWS % RSTEP != 0 && rr + it * RSTEP >= ROWS) break;
      const bool in = col_in && r0 + rr + it * RSTEP < rmax;
      cp_async16(dst + it * RSTEP * LDS,
                 in ? src + static_cast<long long>(it) * RSTEP * ldg : g,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * COLS; i += NT) {
      const int r = i / COLS;
      const int c = i % COLS;
      const int gr = r0 + r;
      const int gc = c0 + c;
      s[r * LDS + c] = (gr < rmax && gc < cmax)
                           ? g[static_cast<long long>(gr) * ldg + gc]
                           : zero_of<T>();
    }
  }
}

// One warp's share of C += A B over KS (a multiple of 32) from shared
// tiles.  A(m, k) is As[m * lda + k] when A_KM (K-contiguous), else
// As[k * lda + m]; B(k, n) is Bs[n * ldb + k] when B_KM, else
// Bs[k * ldb + n].  The warp's tiles start at row wr, column wc.  Each
// 32-deep chunk sums into fresh accumulators that are then added to C
// in f32, and each term is issued over every (i, j) before the next,
// so that consecutive MMAs do not wait on each other; a warp with few
// tiles (every fused kernel) also keeps the cross terms apart from
// hi x hi, for more independent chains: with one set, the fused
// kernels took ~16% longer on an H100 (PERF.md).
template <typename TA, typename TB, bool A_KM, bool B_KM, int WM, int WN,
          bool A_EX, bool B_EX, int KS>
__device__ __forceinline__ void warp_mma(const TA* As, int lda, const TB* Bs,
                                         int ldb, int wr, int wc, int lane,
                                         float (&acc)[WM][WN][4]) {
  static_assert(KS % kChunk == 0, "K chunks are 32 deep");
  const int gq = lane >> 2;
  const int tq = lane & 3;
  auto a_at = [&](int m, int k) {
    return load_f(A_KM ? As[m * lda + k] : As[k * lda + m]);
  };
  auto b_at = [&](int k, int n) {
    return load_f(B_KM ? Bs[n * ldb + k] : Bs[k * ldb + n]);
  };
  // K-contiguous f32 tiles are gathered by ldmatrix: each fragment
  // register is one 8x4 tile's (row, column) = (lane / 4, lane % 4).
  constexpr bool A_LDM = A_KM && sizeof(TA) == 4;
  constexpr bool B_LDM = B_KM && sizeof(TB) == 4;
  static_assert(!B_LDM || WN % 2 == 0, "ldmatrix takes n tiles in pairs");
  const int lq = lane >> 3;  // which of the four tiles this lane addresses
  const int lr = lane & 7;   // which row of it
  constexpr bool SPLIT = WM * WN < 8;
#pragma unroll 1
  for (int kc = 0; kc < KS; kc += kChunk) {
    float part[WM][WN][4] = {};
    float xs[SPLIT ? WM : 1][SPLIT ? WN : 1][4] = {};
    auto x = [&](int i, int j) -> float(&)[4] {
      if constexpr (SPLIT) return xs[i][j];
      else return part[i][j];
    };
#pragma unroll
    for (int k = kc; k < kc + kChunk; k += 8) {
      uint32_t ah[WM][4], al[WM][4], bh[WN][2], bl[WN][2];
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        float v[4];
        if constexpr (A_LDM) {
          // tiles: rows +0 / +8 (q & 1), columns k / k + 4 (q >> 1)
          uint32_t raw[4];
          ldmatrix_x4(raw, As + (wr + i * 16 + lr + (lq & 1) * 8) * lda + k +
                               (lq >> 1) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = __uint_as_float(raw[e]);
        } else {
          const int r = wr + i * 16 + gq;
          v[0] = a_at(r, k + tq);
          v[1] = a_at(r + 8, k + tq);
          v[2] = a_at(r, k + tq + 4);
          v[3] = a_at(r + 8, k + tq + 4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split<A_EX>(v[e], ah[i][e], al[i][e]);
      }
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        if constexpr (B_LDM) {
          if (j % 2) continue;
          // tiles: columns k / k + 4 (q & 1), n tiles j / j + 1 (q >> 1)
          uint32_t raw[4];
          ldmatrix_x4(raw, Bs + (wc + (j + (lq >> 1)) * 8 + lr) * ldb + k +
                               (lq & 1) * 4);
          split<B_EX>(__uint_as_float(raw[0]), bh[j][0], bl[j][0]);
          split<B_EX>(__uint_as_float(raw[1]), bh[j][1], bl[j][1]);
          split<B_EX>(__uint_as_float(raw[2]), bh[j + 1][0], bl[j + 1][0]);
          split<B_EX>(__uint_as_float(raw[3]), bh[j + 1][1], bl[j + 1][1]);
        } else {
          const int n = wc + j * 8 + gq;
          split<B_EX>(b_at(k + tq, n), bh[j][0], bl[j][0]);
          split<B_EX>(b_at(k + tq + 4, n), bh[j][1], bl[j][1]);
        }
      }
      if (!A_EX)
#pragma unroll
        for (int i = 0; i < WM; ++i)
#pragma unroll
          for (int j = 0; j < WN; ++j) mma_tf32(x(i, j), al[i], bh[j]);
      if (!B_EX)
#pragma unroll
        for (int i = 0; i < WM; ++i)
#pragma unroll
          for (int j = 0; j < WN; ++j) mma_tf32(x(i, j), ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < WM; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j) mma_tf32(part[i][j], ah[i], bh[j]);
    }
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] += SPLIT ? xs[i][j][e] + part[i][j][e] : part[i][j][e];
  }
}

// f(row, col, value) for every accumulator element of the warp.
template <int WM, int WN, typename F>
__device__ __forceinline__ void for_each_acc(float (&acc)[WM][WN][4], int wr,
                                             int wc, int lane, F f) {
  const int gq = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(wr + i * 16 + gq + (e >> 1) * 8, wc + j * 8 + 2 * tq + (e & 1),
          acc[i][j][e]);
}

// Where a warp's tiles start in its block's tile.
struct Warp {
  int wr, wc, lane;
};

template <class Cfg>
__device__ __forceinline__ Warp warp_of(int tid) {
  const int warp = tid >> 5;
  return {(warp / Cfg::WARPS_N) * Cfg::WM * 16,
          (warp % Cfg::WARPS_N) * Cfg::WN * 8, tid & 31};
}

template <class Cfg>
using Acc = float[Cfg::WM][Cfg::WN][4];

// The K-streamed product C tile (m0, n0) = A B through the cp.async
// ring: A is M x K, B is K x N, in the layouts A_KM / B_KM name.
template <class Cfg, typename TA, typename TB, bool A_KM, bool B_KM,
          bool A_EX, bool B_EX>
struct Mainloop {
  static constexpr int BK = Cfg::BK;
  static constexpr int LDA = A_KM ? ld_k<TA>(BK) : ld_mn<TA>(Cfg::MT);
  static constexpr int LDB = B_KM ? ld_k<TB>(BK) : ld_mn<TB>(Cfg::BN);
  static constexpr int A_BYTES = round128(
      (A_KM ? Cfg::MT : BK) * LDA * static_cast<int>(sizeof(TA)));
  static constexpr int B_BYTES = round128(
      (B_KM ? Cfg::BN : BK) * LDB * static_cast<int>(sizeof(TB)));
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BYTES = kStages * STAGE_BYTES;

  __device__ static void load_stage(unsigned char* ring, int slot,
                                    const TA* A, long long lda, const TB* B,
                                    long long ldb, int M, int N, int K,
                                    int m0, int n0, int k0, bool aligned,
                                    int tid) {
    TA* As = reinterpret_cast<TA*>(ring + slot * STAGE_BYTES);
    TB* Bs = reinterpret_cast<TB*>(ring + slot * STAGE_BYTES + A_BYTES);
    if constexpr (A_KM)
      load_tile<TA, Cfg::MT, BK, LDA, Cfg::THREADS>(As, A, lda, m0, k0, M, K,
                                                    aligned, tid);
    else
      load_tile<TA, BK, Cfg::MT, LDA, Cfg::THREADS>(As, A, lda, k0, m0, K, M,
                                                    aligned, tid);
    if constexpr (B_KM)
      load_tile<TB, Cfg::BN, BK, LDB, Cfg::THREADS>(Bs, B, ldb, n0, k0, N, K,
                                                    aligned, tid);
    else
      load_tile<TB, BK, Cfg::BN, LDB, Cfg::THREADS>(Bs, B, ldb, k0, n0, K, N,
                                                    aligned, tid);
  }

  // Accumulates the block's tile into `acc`; the ring is free again on
  // return.
  __device__ static void run(unsigned char* ring, const TA* A, long long lda,
                             const TB* B, long long ldb, int M, int N, int K,
                             int m0, int n0, bool aligned, int tid,
                             const Warp& w, Acc<Cfg>& acc) {
    const int nk = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk)
        load_stage(ring, s, A, lda, B, ldb, M, N, K, m0, n0, s * BK, aligned,
                   tid);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      // The slot refilled here was read in iteration kt - 1, which
      // every thread has finished (the barrier above).
      const int next = kt + kStages - 1;
      if (next < nk)
        load_stage(ring, next % kStages, A, lda, B, ldb, M, N, K, m0, n0,
                   next * BK, aligned, tid);
      cp_async_commit();
      const unsigned char* stage = ring + (kt % kStages) * STAGE_BYTES;
      warp_mma<TA, TB, A_KM, B_KM, Cfg::WM, Cfg::WN, A_EX, B_EX, BK>(
          reinterpret_cast<const TA*>(stage), LDA,
          reinterpret_cast<const TB*>(stage + A_BYTES), LDB, w.wr, w.wc,
          w.lane, acc);
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

// Sum of every thread's `part` in a fixed order (warp tree, then warps
// in order); the result is valid in thread 0.
template <int THREADS>
__device__ __forceinline__ float block_sum(float part, int tid) {
  __shared__ float red[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, o);
  if ((tid & 31) == 0) red[tid >> 5] = part;
  __syncthreads();
  float s = 0.0f;
  if (tid == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

template <typename T, class Cfg>
struct FusedSmem {
  using Fwd = Mainloop<Cfg, T, T, true, false, kExact<T>, kExact<T>>;
  using Back = Mainloop<Cfg, float, T, true, true, kExact<T>, kExact<T>>;
  static constexpr int LDQ_F = ld_mn<T>(Cfg::MT);  // qg as [k][m]
  static constexpr int LDQ_B = ld_k<T>(Cfg::MT);   // qg as [m][k]
  static constexpr int LDI = ld_mn<float>(Cfg::BN);  // W / Y as [k][n]
  static constexpr int QG_F = round128(Cfg::MT * LDQ_F * sizeof(T));
  static constexpr int QG_B = round128(Cfg::MT * LDQ_B * sizeof(T));
  static constexpr int INTER = round128(Cfg::MT * LDI * sizeof(float));
  static constexpr int FWD_BYTES = Fwd::BYTES + QG_F + INTER;
  static constexpr int BACK_BYTES = Back::BYTES + QG_B + INTER;
};

// Forward: v2 = (qg^T (g qa[:, n])) * dgda, and the tile's clip partial.
template <typename T, class Cfg>
__global__ void __launch_bounds__(Cfg::THREADS)
    precond_forward(const T* __restrict__ g, const T* __restrict__ qa,
                    const T* __restrict__ qg, const T* __restrict__ dgda,
                    float* __restrict__ v2, float* __restrict__ partials,
                    int gp, int ap, int aligned) {
  using S = FusedSmem<T, Cfg>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qg_s = reinterpret_cast<T*>(smem + S::Fwd::BYTES);
  float* w_s = reinterpret_cast<float*>(smem + S::Fwd::BYTES + S::QG_F);
  const int tid = threadIdx.x;
  const Warp w = warp_of<Cfg>(tid);
  const int l = blockIdx.y;
  const int n0 = blockIdx.x * Cfg::BN;
  const long long plane = static_cast<long long>(gp) * ap;

  // qg[l] whole, stored [k][m], read as A = qg^T; first copy group.
  load_tile<T, Cfg::MT, Cfg::MT, S::LDQ_F, Cfg::THREADS>(
      qg_s, qg + static_cast<long long>(l) * gp * gp, gp, 0, 0, gp, gp,
      aligned, tid);
  cp_async_commit();

  Acc<Cfg> acc = {};
  S::Fwd::run(smem, g + l * plane, ap, qa + static_cast<long long>(l) * ap * ap,
              ap, gp, ap, ap, 0, n0, aligned, tid, w, acc);
  for_each_acc(acc, w.wr, w.wc, w.lane, [&](int r, int c, float& v) {
    w_s[r * S::LDI + c] = v;
    v = 0.0f;
  });
  __syncthreads();
  warp_mma<T, float, false, false, Cfg::WM, Cfg::WN, kExact<T>, false,
           Cfg::MT>(qg_s, S::LDQ_F, w_s, S::LDI, w.wr, w.wc, w.lane, acc);

  float part = 0.0f;
  for_each_acc(acc, w.wr, w.wc, w.lane, [&](int r, int c, float& v1) {
    const int col = n0 + c;
    if (r < gp && col < ap) {
      const long long off = l * plane + static_cast<long long>(r) * ap + col;
      const float x = v1 * load_f(dgda[off]);
      part = fmaf(v1, x, part);
      v2[off] = round_to<T>(x);
    }
  });
  const float s = block_sum<Cfg::THREADS>(part, tid);
  if (tid == 0) partials[static_cast<long long>(l) * gridDim.x + blockIdx.x] = s;
}

// Back: pg[:, m] = qg (v2 qa[m, :]^T); block 0 of each slot sums its
// clip partials in tile order.
template <typename T, class Cfg>
__global__ void __launch_bounds__(Cfg::THREADS)
    precond_back(const float* __restrict__ v2, const T* __restrict__ qa,
                 const T* __restrict__ qg, const float* __restrict__ partials,
                 float* __restrict__ pg, float* __restrict__ clip, int gp,
                 int ap, int aligned) {
  using S = FusedSmem<T, Cfg>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qg_s = reinterpret_cast<T*>(smem + S::Back::BYTES);
  float* y_s = reinterpret_cast<float*>(smem + S::Back::BYTES + S::QG_B);
  const int tid = threadIdx.x;
  const Warp w = warp_of<Cfg>(tid);
  const int l = blockIdx.y;
  const int n0 = blockIdx.x * Cfg::BN;
  const long long plane = static_cast<long long>(gp) * ap;

  load_tile<T, Cfg::MT, Cfg::MT, S::LDQ_B, Cfg::THREADS>(
      qg_s, qg + static_cast<long long>(l) * gp * gp, gp, 0, 0, gp, gp,
      aligned, tid);
  cp_async_commit();

  Acc<Cfg> acc = {};
  S::Back::run(smem, v2 + l * plane, ap,
               qa + static_cast<long long>(l) * ap * ap, ap, gp, ap, ap, 0,
               n0, aligned, tid, w, acc);
  for_each_acc(acc, w.wr, w.wc, w.lane, [&](int r, int c, float& v) {
    y_s[r * S::LDI + c] = v;
    v = 0.0f;
  });
  __syncthreads();
  warp_mma<T, float, true, false, Cfg::WM, Cfg::WN, kExact<T>, false,
           Cfg::MT>(qg_s, S::LDQ_B, y_s, S::LDI, w.wr, w.wc, w.lane, acc);

  for_each_acc(acc, w.wr, w.wc, w.lane, [&](int r, int c, float& v) {
    const int col = n0 + c;
    if (r < gp && col < ap)
      pg[l * plane + static_cast<long long>(r) * ap + col] = v;
  });
  if (blockIdx.x == 0 && tid == 0) {
    float s = 0.0f;
    for (int t = 0; t < gridDim.x; ++t)
      s += partials[static_cast<long long>(l) * gridDim.x + t];
    clip[l] = s;
  }
}

enum Epilogue { kStore = 0, kScale = 1, kClip = 2 };

// One K-streamed product per slot for gp > 64: C[l] (M x N) = A[l] B[l]
// on 128x128 tiles.  kScale: C = v2 = (A B) * D rounded to TD, plus the
// tile's clip partial.  kClip: store, and block (0, 0) of each slot
// sums the slot's partials (the kScale pass's tiles, same grid) in
// order.
template <typename TA, typename TB, bool A_KM, bool B_KM, bool A_EX,
          bool B_EX, int EPI, typename TD>
__global__ void __launch_bounds__(TileWide::THREADS)
    wide_pass(const TA* __restrict__ A, const TB* __restrict__ B,
              float* __restrict__ C, const TD* __restrict__ D,
              float* __restrict__ partials, float* __restrict__ clip, int M,
              int N, int K, long long a_slot, long long b_slot, int aligned) {
  using Cfg = TileWide;
  using ML = Mainloop<Cfg, TA, TB, A_KM, B_KM, A_EX, B_EX>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const Warp w = warp_of<Cfg>(tid);
  const int l = blockIdx.z;
  const int m0 = blockIdx.y * Cfg::MT;
  const int n0 = blockIdx.x * Cfg::BN;
  const long long plane = static_cast<long long>(M) * N;

  Acc<Cfg> acc = {};
  ML::run(smem, A + l * a_slot, A_KM ? K : M, B + l * b_slot, B_KM ? K : N,
          M, N, K, m0, n0, aligned, tid, w, acc);

  const int tiles = gridDim.x * gridDim.y;
  float part = 0.0f;
  for_each_acc(acc, w.wr, w.wc, w.lane, [&](int r, int c, float& v) {
    const int row = m0 + r;
    const int col = n0 + c;
    if (row < M && col < N) {
      const long long off = l * plane + static_cast<long long>(row) * N + col;
      if (EPI == kScale) {
        const float x = v * load_f(D[off]);
        part = fmaf(v, x, part);
        C[off] = round_to<TD>(x);
      } else {
        C[off] = v;
      }
    }
  });
  if (EPI == kScale) {
    const float s = block_sum<Cfg::THREADS>(part, tid);
    if (tid == 0)
      partials[static_cast<long long>(l) * tiles + blockIdx.y * gridDim.x +
               blockIdx.x] = s;
  }
  if (EPI == kClip && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t)
      s += partials[static_cast<long long>(l) * tiles + t];
    clip[l] = s;
  }
}

// Raises the kernel's dynamic shared-memory limit to `bytes`, once per
// device (the first launch on each device pays the call).
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static unsigned long long done = 0;  // bit d: set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (!err) done |= bit;
  return err;
}

template <typename T, class Cfg>
int launch_fused(const T* g, const T* qa, const T* qg, const T* dgda,
                 float* pg, float* clip, float* v2, float* partials, int L,
                 int gp, int ap, int aligned, cudaStream_t stream) {
  using S = FusedSmem<T, Cfg>;
  const dim3 grid((ap + Cfg::BN - 1) / Cfg::BN, L);
  cudaError_t err;
  if ((err = allow_smem<precond_forward<T, Cfg>>(S::FWD_BYTES))) return err;
  precond_forward<T, Cfg><<<grid, Cfg::THREADS, S::FWD_BYTES, stream>>>(
      g, qa, qg, dgda, v2, partials, gp, ap, aligned);
  if ((err = cudaGetLastError())) return err;
  if ((err = allow_smem<precond_back<T, Cfg>>(S::BACK_BYTES))) return err;
  precond_back<T, Cfg><<<grid, Cfg::THREADS, S::BACK_BYTES, stream>>>(
      v2, qa, qg, partials, pg, clip, gp, ap, aligned);
  return cudaGetLastError();
}

template <typename TA, typename TB, bool A_KM, bool B_KM, bool A_EX,
          bool B_EX, int EPI, typename TD>
cudaError_t launch_wide(const TA* A, const TB* B, float* C, const TD* D,
                        float* partials, float* clip, int L, int M, int N,
                        int K, long long a_slot, long long b_slot,
                        int aligned, cudaStream_t stream) {
  using ML = Mainloop<TileWide, TA, TB, A_KM, B_KM, A_EX, B_EX>;
  constexpr auto kernel = wide_pass<TA, TB, A_KM, B_KM, A_EX, B_EX, EPI, TD>;
  cudaError_t err;
  if ((err = allow_smem<kernel>(ML::BYTES))) return err;
  const dim3 grid((N + TileWide::BN - 1) / TileWide::BN,
                  (M + TileWide::MT - 1) / TileWide::MT, L);
  kernel<<<grid, TileWide::THREADS, ML::BYTES, stream>>>(
      A, B, C, D, partials, clip, M, N, K, a_slot, b_slot, aligned);
  return cudaGetLastError();
}

template <typename T>
int launch_wide_chain(const T* g, const T* qa, const T* qg, const T* dgda,
                      float* pg, float* clip, float* v2, float* y,
                      float* partials, int L, int gp, int ap, int aligned,
                      cudaStream_t stream) {
  constexpr bool EX = kExact<T>;
  const long long plane = static_cast<long long>(gp) * ap;
  const long long qa_slot = static_cast<long long>(ap) * ap;
  const long long qg_slot = static_cast<long long>(gp) * gp;
  cudaError_t err;
  // W = g qa, into pg's buffer.
  err = launch_wide<T, T, true, false, EX, EX, kStore, T>(
      g, qa, pg, nullptr, nullptr, nullptr, L, gp, ap, ap, plane, qa_slot,
      aligned, stream);
  if (err) return err;
  // v2 = (qg^T W) * dgda, plus clip partials.
  err = launch_wide<T, float, false, false, EX, false, kScale, T>(
      qg, pg, v2, dgda, partials, nullptr, L, gp, ap, gp, qg_slot, plane,
      aligned, stream);
  if (err) return err;
  // Y = v2 qa^T.
  err = launch_wide<float, T, true, true, EX, EX, kStore, T>(
      v2, qa, y, nullptr, nullptr, nullptr, L, gp, ap, ap, plane, qa_slot,
      aligned, stream);
  if (err) return err;
  // pg = qg Y, and the clip sums.
  return launch_wide<T, float, true, false, EX, false, kClip, T>(
      qg, y, pg, nullptr, partials, clip, L, gp, ap, gp, qg_slot, plane,
      aligned, stream);
}

// Tiling of a call: rows x cols of a block's output tile, launches.
void tiling(int gp, int* rows, int* cols, int* kernels) {
  if (gp <= 32) {
    *rows = Tile32::MT; *cols = Tile32::BN; *kernels = 2;
  } else if (gp <= 64) {
    *rows = Tile64::MT; *cols = Tile64::BN; *kernels = 2;
  } else {
    *rows = TileWide::MT; *cols = TileWide::BN; *kernels = 4;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const T* g, const T* qa, const T* qg, const T* dgda, float* pg,
           float* clip, float* ws, int L, int gp, int ap,
           cudaStream_t stream) {
  int rows, cols, kernels;
  tiling(gp, &rows, &cols, &kernels);
  const long long plane = static_cast<long long>(L) * gp * ap;
  float* v2 = ws;
  float* y = ws + plane;  // wide tiling only
  float* partials = ws + (kernels == 2 ? 1 : 2) * plane;
  const int aligned = gp % 8 == 0 && ap % 8 == 0 && aligned16(g) &&
                      aligned16(qa) && aligned16(qg) && aligned16(dgda) &&
                      aligned16(pg) && aligned16(ws);
  if (gp <= 32)
    return launch_fused<T, Tile32>(g, qa, qg, dgda, pg, clip, v2, partials,
                                   L, gp, ap, aligned, stream);
  if (gp <= 64)
    return launch_fused<T, Tile64>(g, qa, qg, dgda, pg, clip, v2, partials,
                                   L, gp, ap, aligned, stream);
  return launch_wide_chain<T>(g, qa, qg, dgda, pg, clip, v2, y, partials, L,
                              gp, ap, aligned, stream);
}

}  // namespace

extern "C" {

// f32 elements of the workspace a call needs: the v2 plane [L, gp, ap]
// (plus the Y plane when gp > 64), then the clip partials, one per
// block of the pass that writes them.
long long kfac_fused_eigen_precond_workspace(int L, int gp, int ap) {
  int rows, cols, kernels;
  tiling(gp, &rows, &cols, &kernels);
  const long long plane = static_cast<long long>(L) * gp * ap;
  const long long tiles = static_cast<long long>((ap + cols - 1) / cols) *
                          (kernels == 2 ? 1 : (gp + rows - 1) / rows);
  return (kernels == 2 ? 1 : 2) * plane + L * tiles;
}

// dtype: 0 = float32 operands, 1 = bfloat16 operands.  pg [L, gp, ap] and
// clip [L] are f32 outputs; workspace holds
// kfac_fused_eigen_precond_workspace(L, gp, ap) f32 elements.  Launches
// on `stream` without synchronising; returns the first failing
// cudaError_t of the launches (0 = ok).
int kfac_fused_eigen_precond(const void* g, const void* qa, const void* qg,
                             const void* dgda, float* pg, float* clip,
                             float* workspace, int L, int gp, int ap,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0 || gp <= 0 || ap <= 0 || L > 65535) return cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch<float>(static_cast<const float*>(g),
                         static_cast<const float*>(qa),
                         static_cast<const float*>(qg),
                         static_cast<const float*>(dgda), pg, clip,
                         workspace, L, gp, ap, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(g),
                                 static_cast<const __nv_bfloat16*>(qa),
                                 static_cast<const __nv_bfloat16*>(qg),
                                 static_cast<const __nv_bfloat16*>(dgda), pg,
                                 clip, workspace, L, gp, ap, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
