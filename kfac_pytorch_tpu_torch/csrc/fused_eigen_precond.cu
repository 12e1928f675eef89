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
// Three routes, chosen by shape before any launch (route_of):
//
// 1. gp <= 64 (every ResNet-32 bucket): the fused pair, two launches.
//    The Pallas kernel holds a whole slot in VMEM; a Hopper block has
//    227 KB of shared memory, and for gp <= 64 a column stripe of the
//    [gp, ap] intermediate fits, so the chain is reassociated as
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
//    Row tiles are 32 (gp <= 32) or 64 rows by BN = 32 columns.  One
//    ResNet-32 step (six calls, ~1.07 GFLOP over ~24 MB) is bound by its
//    bytes (~7.2 us at 3.35 TB/s), and every bucket but a576g64 is so
//    small that two dependent launches (~5 us) and each block's K-loop
//    latency are what cost.  So this pair runs `mma.sync` (m16n8k8
//    TF32): its 16-row fragments suit gp = 32, where a 64-row `wgmma`
//    tile would be half masked, and each thread gathers them in any
//    order from padded rows (row strides of 4 or 8 words mod 32;
//    K-contiguous f32 tiles by `ldmatrix`).  Operands stream through a
//    three-stage ring of 16-byte `cp.async` copies, 64 deep.
//
// 2. gp > 64 on rows of 16-byte multiples (f32 gp, ap multiples of 4,
//    bf16 of 8) from 16-byte aligned bases: four passes, each one
//    persistent kernel of TMA-fed `wgmma`.  f32 operands (namespace wg):
//
//     P1  W^T = qa^T g^T     M = ap, N = gp, K = ap  -> pg's buffer
//     P2  v2 = (qg^T W) * dgda, clip partials    M = gp, N = ap, K = gp
//     P3  Y = v2 qa^T, stored transposed         M = gp, N = ap, K = ap
//     P4  pg = qg Y, and the clip sums           M = gp, N = ap, K = gp
//
//    BERT-large's fc_out call is ~2.2 TFLOP of f32 products: at three
//    TF32 products each (3xTF32, below) 13 ms of the tensor cores'
//    495 TFLOP/s against <1 ms of its bytes, so the passes are bound by
//    the tensor cores' rate, which only `wgmma` reaches.  TF32 `wgmma`
//    reads B, and A from shared memory, only K-major.  Each pass is
//    arranged so that its B is K-major in device memory (g, W^T, qa, Y^T
//    rows), and A goes through registers: each consumer thread reads its
//    A fragments from the landed tile in whatever order device memory
//    holds it (qa and qg are contracted over their row index in P1 and
//    P2), so no transposed copy of a basis is ever made.
//
//    A block of three warpgroups sits on each SM and walks a fixed order
//    of (slot, m tile, n tile, K part) items.  Warpgroup 2 produces: one
//    lane keeps three stages of TMA loads in flight in a four-stage ring
//    (mbarrier-completed), and three warps split each landed B tile once,
//    as soon as it lands, into its TF32 lo part (a tile beside it; the
//    MMA reads hi from the landed tile itself, see Numerics).  Two
//    consumer warpgroups take 64 rows each of a 128 x BN tile (BN = 128,
//    or 32 where N = ap <= 64, so ap = 32 runs unmasked tiles) and issue
//    m64nBNk8 `wgmma`s from registers (A) and descriptors (B); setmaxnreg
//    moves the producers' registers to the consumers' accumulators.  On
//    an H100 a split made by the producer's single TMA lane one stage
//    ahead took half of BERT-large's fc_out time; three splitter warps
//    running ahead of the consumers took it from 27.4 to 21.4 ms
//    (PERF.md).  Where a pass has few tiles, K is split in a fixed
//    number of parts (plan_pass); the launch is then cooperative, the
//    parts are stored, the grid synchronises, and each tile's parts are
//    summed in part order before its epilogue.
//
//    bf16 operands (namespace wgb) run on bf16 `wgmma` at twice TF32's
//    rate, both operands read from shared memory by descriptor in either
//    major order, so no pass has a register path or a split.  The
//    association is chosen by shape: where ap >= gp, X = g qa first and
//    X = v2 qa^T in the back rotation; where gp > ap, the TPU kernel's
//    X = qg^T g and X = qg v2.  So the larger contraction of each half
//    is bf16 x bf16 (P1, P3); the other (P2, P4) multiplies a bf16 basis
//    by the f32 X, which P1 and P3 write as three bf16 planes that sum
//    to it exactly, three bf16 products.  v2 is a bf16 plane.
//
// 3. gp > 64 on other rows (e.g. ap = 769, 3073 of the unpadded GPipe
//    and MoE stacks): TMA cannot address them, so the same four products
//    run as launches of one 128x128-tile `mma.sync` GEMM through the
//    `cp.async` ring with masked edges (wide_pass), W and Y spilled to
//    scratch, the clip sum folded into the last.  Every (gp, ap) runs.
//
// Numerics.  f32 operands: 3xTF32, a b ~ a_lo b_hi + a_hi b_lo + a_hi
// b_hi with f32 accumulation, within f32 rounding of an f32 product
// (plain 1xTF32 would miss the 1e-4 gate).  The pair and route 3 round
// hi to TF32 by the cvt.rna.tf32.f32 rule (nearest, ties away; two
// integer ops) and leave the MMA to read lo's TF32 part; route 2
// truncates both: hi = x's top 19 bits, lo = (x - hi)'s, written as
// exact TF32 values, except B's hi, which the MMA reads from the raw f32
// tile by the same truncation (an H100 gives the same results to the
// 1e-5 gate with hi written out, and rounding there would miss it).  The tensor cores' sum does
// not round to nearest, so K is summed in chunks into fresh
// accumulators that are added in f32: 32 deep in the pair and route 3,
// 128 (four ring stages, scale-d = 0 at each chunk's first product) in
// route 2's f32 passes.  bf16 operands: the pair and route 3 take them
// as TF32 (exact), one TF32 product for bf16 x bf16 and two for bf16 x
// f32; route 2's bf16 passes as above, each K part summed in one
// accumulator.  As in the TPU kernel, v2 is rounded to bf16 before the
// back-rotation.
//
// Sums use no atomics: each block reduces its tile in a fixed order, the
// clip partials are summed in tile order and split-K parts in part order,
// so two runs give the same bits.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
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

// One K-streamed product per slot for gp > 64 on rows TMA cannot take
// (route 3): C[l] (M x N) = A[l] B[l] on 128x128 tiles.  kScale: C = v2 = (A B) * D rounded to TD, plus the
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


// ---------------------------------------------------------------------
// The gp > 64 route for f32 operands: four persistent passes of TMA-fed
// TF32 `wgmma` (the bf16 operands' route is namespace wgb, below).
//
// Each pass is C[l] (M x N) = A[l] B[l] over every slot, A M x K and B
// K x N.  B is always K-major in device memory (its rows are K-
// contiguous), so TMA lands it in the 128-byte swizzle `wgmma` reads; A
// goes through registers, read from its landed tile in whichever order
// device memory holds it (TF32 `wgmma` takes A from shared memory only
// K-major, and P1 and P2 contract qa and qg over their row index).
namespace wg {

constexpr int BM = 128;           // tile rows: two consumer warpgroups of 64
constexpr int BK = 32;            // K of one ring stage (one 128-byte f32 row)
constexpr int kRing = 4;          // ring stages
constexpr int kChunkSlices = 4;   // stages per accumulation chunk (K = 128)
constexpr int kConsumers = 256;   // warpgroups 0 and 1
constexpr int kProducers = 128;   // warpgroup 2
constexpr int kThreads = kConsumers + kProducers;
// Registers a thread of each role holds after setmaxnreg: the launch
// gives every thread 65536 / 384 = 168 (rounded to 8); the producers
// hand theirs over to the consumers' accumulators.
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;
constexpr int kSplitters = kProducers - 32;  // warps 1-3 of warpgroup 2
static_assert(kProducers * kProducerRegs + kConsumers * kConsumerRegs <=
                  kThreads * 168,
              "setmaxnreg moves registers, it makes none");
constexpr int kMaxSplit = 8;

enum Epi { kStore = 0, kStoreT = 1, kScale = 2, kClip = 3 };

struct Args {
  float* C;            // the pass's output
  const void* D;       // kScale: dgda
  float* partials;     // clip partials, [L][clip_tiles]
  float* clip;         // kClip: the per-slot sums
  float* split_ws;     // split > 1: [split][L][M][N] partial products
  int L, M, N, K;
  int tiles_m, tiles_n, split;
  int clip_tiles;      // tiles per slot of the kScale pass
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(saddr(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = saddr(b);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(saddr(b)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(saddr(b)), "r"(bytes) : "memory");
}
// One box of a rank-3 tensor map at (c0, c1, c2), innermost first, into
// shared memory; completes `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(saddr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The two consumer warpgroups' own barrier (the producers run on).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
// Registers an asynchronous `wgmma` reads or writes are pinned here, after
// its wait: the compiler neither reads them earlier nor reuses them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// Byte offset of `byte` in row `row` of a tile of 128-byte rows in the
// 128-byte swizzle TMA writes and `wgmma` reads: 16-byte chunk c of row
// r sits at chunk c ^ (r % 8).
__device__ __forceinline__ int sw128(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// `wgmma` descriptor of a K-major tile in the 128-byte swizzle: 8-row
// groups 1024 bytes apart; a k8 step is +32 bytes (+2 in the field).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((saddr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t tf32_trunc(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}
// The rest of x below its TF32 truncation (exact in f32), truncated.
__device__ __forceinline__ uint32_t tf32_lo(float x) {
  return tf32_trunc(x - __uint_as_float(tf32_trunc(x)));
}
// x ~ hi + lo, both TF32 values: hi is x truncated to TF32, lo is the
// rest (exact in f32) truncated to TF32.  Where x is exact in TF32 (a
// bf16 value), hi = x and lo is unused.
template <bool EXACT>
__device__ __forceinline__ void split_tr(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = EXACT ? __float_as_uint(x) : tf32_trunc(x);
  lo = EXACT ? 0u : tf32_lo(x);
}

// d (m64 x n32, f32) += a (m64 x k8 TF32, registers) * b (k8 x n32 TF32,
// shared memory by descriptor); scale_d = 0 starts the sum afresh.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (m64 x n128, f32) += a (m64 x k8 TF32, registers) * b (k8 x n128 TF32,
// shared memory by descriptor); scale_d = 0 starts the sum afresh.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Shared memory of a pass: kRing stages of (A tile, B tile, D tile),
// then the barriers and the consumers' reduction scratch.  The A and B
// tiles are as TMA lands them (B is read as its TF32 hi part by the
// MMA's truncation); the D tile holds B's TF32 lo part.  Every tile
// starts on a 1024-byte boundary.
template <int BN>
struct Smem {
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int D_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES + D_BYTES;
  static constexpr int BAR = kRing * STAGE;
  static constexpr int RED = BAR + 3 * kRing * 8;
  static constexpr int BYTES = RED + 8 * 4 + 1024;  // + alignment slack
  static_assert(STAGE % 1024 == 0, "tiles on 1024-byte boundaries");
};

// Element (i, k) of the landed A tile (M x K = 128 x 32).  K-major: one
// 128-byte-swizzled [i][k] box; M-major: four [k][32 i] boxes, each
// 128-byte-swizzled.
template <bool A_KM>
__device__ __forceinline__ float a_elem(const unsigned char* t, int i, int k) {
  const int off = A_KM ? sw128(i, k * 4)
                       : (i >> 5) * 4096 + sw128(k, (i & 31) * 4);
  return *reinterpret_cast<const float*>(t + off);
}

// A splitter thread's share of one landed B tile (BN x 32, K-major): its
// lo part, trunc(x - trunc(x)), to D.  D and the B tile share the
// swizzle.
template <int BN>
__device__ __forceinline__ void split_b(unsigned char* b, unsigned char* d,
                                        int idx) {
#pragma unroll 4
  for (int q = idx; q < BN * 8; q += kSplitters) {
    const int row = q >> 3;
    const int off = sw128(row, (q & 7) * 16);
    const float4 x = *reinterpret_cast<const float4*>(b + off);
    float4 lo;
    lo.x = __uint_as_float(tf32_lo(x.x));
    lo.y = __uint_as_float(tf32_lo(x.y));
    lo.z = __uint_as_float(tf32_lo(x.z));
    lo.w = __uint_as_float(tf32_lo(x.w));
    *reinterpret_cast<float4*>(d + off) = lo;
  }
}

// A work item: one K part of one output tile.  Items run tile by tile,
// n fastest, the parts of a tile next to each other; part s of split S
// takes K stages [s nk / S, (s + 1) nk / S).
struct Item {
  int l, m0, n0, part, k0, k1, tile;
};
template <int BN>
__device__ __forceinline__ Item item_of(int w, const Args& p, int nk) {
  Item it;
  it.part = w % p.split;
  it.tile = w / p.split;
  const int nt = it.tile % p.tiles_n;
  const int mt = (it.tile / p.tiles_n) % p.tiles_m;
  it.l = it.tile / (p.tiles_n * p.tiles_m);
  it.m0 = mt * BM;
  it.n0 = nt * BN;
  it.k0 = it.part * nk / p.split;
  it.k1 = (it.part + 1) * nk / p.split;
  return it;
}

// Two neighbouring outputs (r, c), (r, c + 1) of slot l: the epilogue.
template <int EPI>
__device__ __forceinline__ void emit2(const Args& p, int l, int r, int c,
                                      float v0, float v1, float& cp) {
  const long long plane = static_cast<long long>(p.M) * p.N;
  float* C = p.C + l * plane;
  if constexpr (EPI == kStoreT) {
    C[static_cast<long long>(c) * p.M + r] = v0;
    C[static_cast<long long>(c + 1) * p.M + r] = v1;
  } else {
    const long long off = static_cast<long long>(r) * p.N + c;
    if constexpr (EPI == kScale) {
      const float* D = static_cast<const float*>(p.D) + l * plane;
      const float x0 = v0 * D[off];
      const float x1 = v1 * D[off + 1];
      cp = fmaf(v0, x0, cp);
      cp = fmaf(v1, x1, cp);
      v0 = x0;
      v1 = x1;
    }
    *reinterpret_cast<float2*>(C + off) = make_float2(v0, v1);
  }
}

// Sum of the 256 consumer threads' `v` in a fixed order; valid in thread 0.
__device__ __forceinline__ float consumers_sum(float v, float* red, int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  consumers_sync();
  float s = 0.0f;
  if (tid == 0)
    for (int w = 0; w < kConsumers / 32; ++w) s += red[w];
  consumers_sync();
  return s;
}

// One pass.  Warpgroup 2 produces: lane 0 of its first warp keeps the
// ring's TMA loads in flight, and its other three warps split each
// landed B tile once, as soon as it lands.  Warpgroups 0 and 1 consume,
// each taking 64 rows of the 128 x BN tile: A fragments into registers
// (split into TF32 hi and lo there), then per k8 step lo*hi + hi*lo +
// hi*hi on `wgmma`.  Every kChunkSlices
// stages the chunk's fresh accumulators are added to the tile's in f32.
// With split > 1 (a launch that is cooperative), the K parts are
// stored, the grid synchronises, and each tile's parts are summed in
// part order before the epilogue.
template <bool A_KM, int BN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_pass(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, const Args p) {
  using S = Smem<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* ready = full + kRing;
  uint64_t* empty = ready + kRing;
  float* red = reinterpret_cast<float*>(smem + S::RED);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSplitters);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = p.L * p.tiles_m * p.tiles_n;
  const int items = tiles * p.split;
  const int nk = (p.K + BK - 1) / BK;

  if (tid >= kConsumers) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    const int ptid = tid - kConsumers;
    if (ptid < 32) {
      if constexpr (EPI == kClip) {
        // The kScale pass's clip partials, summed per slot in tile order.
        for (int l = blockIdx.x * 32 + ptid; l < p.L; l += gridDim.x * 32) {
          float s = 0.0f;
          for (int t = 0; t < p.clip_tiles; ++t)
            s += p.partials[static_cast<long long>(l) * p.clip_tiles + t];
          p.clip[l] = s;
        }
      }
      if (ptid == 0) {
        int loads = 0;
        for (int w = blockIdx.x; w < items; w += gridDim.x) {
          const Item it = item_of<BN>(w, p, nk);
          for (int kk = it.k0; kk < it.k1; ++kk, ++loads) {
            const int st = loads % kRing;
            mbar_wait(&empty[st], ((loads / kRing) & 1) ^ 1);
            mbar_expect_tx(&full[st], S::A_BYTES + S::B_BYTES);
            unsigned char* a = smem + st * S::STAGE;
            const int k = kk * BK;
            if constexpr (A_KM) {
              tma_load(a, &map_a, &full[st], k, it.m0, it.l);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q)
                tma_load(a + q * 4096, &map_a, &full[st], it.m0 + 32 * q, k,
                         it.l);
            }
            tma_load(a + S::A_BYTES, &map_b, &full[st], k, it.n0, it.l);
          }
        }
      }
      __syncwarp();
    } else {
      int splits = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Item it = item_of<BN>(w, p, nk);
        for (int k = it.k0; k < it.k1; ++k, ++splits) {
          const int st = splits % kRing;
          mbar_wait(&full[st], (splits / kRing) & 1);
          unsigned char* b = smem + st * S::STAGE + S::A_BYTES;
          split_b<BN>(b, b + S::B_BYTES, ptid - 32);
          fence_proxy_async();
          mbar_arrive(&ready[st]);
        }
      }
    }
    if (p.split > 1) cooperative_groups::this_grid().sync();
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int g = lane >> 2;
  const int t = lane & 3;
  // This thread's fragment rows row and row + 8 of the 128-row tile;
  // element e of k8 step j is (row + 8 (e & 1), 8 j + t + 4 (e >> 1)).
  const int row = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + g;
  int slices = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item it = item_of<BN>(w, p, nk);
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = part[e] = 0.0f;
    const int ns = it.k1 - it.k0;
    for (int s = 0; s < ns; ++s, ++slices) {
      const int st = slices % kRing;
      mbar_wait(&ready[st], (slices / kRing) & 1);
      const unsigned char* a = smem + st * S::STAGE;
      const unsigned char* b = a + S::A_BYTES;
      const unsigned char* d = b + S::B_BYTES;
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = a_elem<A_KM>(a, row + 8 * (e & 1),
                                       8 * j + t + 4 * (e >> 1));
          split_tr<false>(x, ah[j][e], al[j][e]);
        }
      const uint64_t hi = sw128_desc(b);
      const uint64_t lo = sw128_desc(d);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int keep = (s % kChunkSlices != 0 || j != 0) ? 1 : 0;
        wgmma_tf32(part, al[j], hi + 2 * j, keep);
        wgmma_tf32(part, ah[j], lo + 2 * j, 1);
        wgmma_tf32(part, ah[j], hi + 2 * j, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(part);
      pin(ah);
      pin(al);
      if (lane == 0) mbar_arrive(&empty[st]);
      if (s % kChunkSlices == kChunkSlices - 1 || s == ns - 1) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) acc[e] += part[e];
      }
    }
    // Fragment (row, col) of acc[4 j + 2 h + e]: row + 8 h, 8 j + 2 t + e.
    float cp = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = it.m0 + row + 8 * h;
        const int c = it.n0 + 8 * j + 2 * t;
        if (r >= p.M || c >= p.N) continue;
        const float v0 = acc[4 * j + 2 * h];
        const float v1 = acc[4 * j + 2 * h + 1];
        if (p.split > 1) {
          // The part as the epilogue will write it: [N][M] for kStoreT.
          float* ws = p.split_ws +
                      (static_cast<long long>(it.part) * p.L + it.l) * p.M *
                          p.N;
          if constexpr (EPI == kStoreT) {
            ws[static_cast<long long>(c) * p.M + r] = v0;
            ws[static_cast<long long>(c + 1) * p.M + r] = v1;
          } else {
            *reinterpret_cast<float2*>(ws + static_cast<long long>(r) * p.N +
                                       c) = make_float2(v0, v1);
          }
        } else {
          emit2<EPI>(p, it.l, r, c, v0, v1, cp);
        }
      }
    }
    if (EPI == kScale && p.split == 1) {
      const float s = consumers_sum(cp, red, tid);
      if (tid == 0) {
        const int per = p.tiles_m * p.tiles_n;
        p.partials[static_cast<long long>(it.l) * per + it.tile % per] = s;
      }
    }
  }

  if (p.split > 1) {
    cooperative_groups::this_grid().sync();
    // Each tile's parts summed in part order, four neighbours a thread
    // (along the output's contiguous axis: Y^T's rows for kStoreT).
    const long long part_stride = static_cast<long long>(p.L) * p.M * p.N;
    for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
      const Item it = item_of<BN>(tl * p.split, p, nk);
      const long long slot = static_cast<long long>(it.l) * p.M * p.N;
      float cp = 0.0f;
      for (int q = tid; q < BM * BN / 4; q += kConsumers) {
        const int r = EPI == kStoreT ? it.m0 + 4 * (q % (BM / 4))
                                     : it.m0 + q / (BN / 4);
        const int c = EPI == kStoreT ? it.n0 + q / (BM / 4)
                                     : it.n0 + 4 * (q % (BN / 4));
        if (r >= p.M || c >= p.N) continue;
        const long long off = EPI == kStoreT
                                  ? static_cast<long long>(c) * p.M + r
                                  : static_cast<long long>(r) * p.N + c;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int s = 0; s < kMaxSplit; ++s) {
          if (s >= p.split) break;
          const float4 x = *reinterpret_cast<const float4*>(
              p.split_ws + s * part_stride + slot + off);
          v.x += x.x;
          v.y += x.y;
          v.z += x.z;
          v.w += x.w;
        }
        if constexpr (EPI == kStoreT) {
          *reinterpret_cast<float4*>(p.C + slot + off) = v;
        } else {
          emit2<EPI>(p, it.l, r, c, v.x, v.y, cp);
          emit2<EPI>(p, it.l, r, c + 2, v.z, v.w, cp);
        }
      }
      if (EPI == kScale) {
        const float s = consumers_sum(cp, red, tid);
        if (tid == 0) {
          const int per = p.tiles_m * p.tiles_n;
          p.partials[static_cast<long long>(it.l) * per + it.tile % per] = s;
        }
      }
    }
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (the
// library links no libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A rank-3 map of [L][rows][inner] (elements of `eb` bytes: f32 or
// bf16), boxes of box_inner x box_rows x 1 in the 128-byte swizzle.
// Out-of-range box elements land as zeros.
cudaError_t make_map(CUtensorMap* m, int eb, const void* base, int inner,
                     int rows, int L, int box_inner, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t strides[2] = {dims[0] * static_cast<cuuint64_t>(eb),
                                 dims[0] * dims[1] * static_cast<cuuint64_t>(eb)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(
      m, eb == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// SMs of the current device (asked once per device).
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 64 && counts[dev]) return counts[dev];
  int n = 132;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) counts[dev] = n;
  return n;
}

// The tiling of one pass (BM x bn tiles, K in ring stages of bk): BN,
// the tile grid, the K split and the persistent grid.  K is split only
// where the tiles fill at most half the SMs, into the S parts (each at
// least 128 deep, at most kMaxSplit) that minimise waves(S) * stages
// per part +
// kSplitCost, waves(S) = ceil(tiles S / SMs), and only if that is under
// three quarters of the unsplit cost.  kSplitCost prices the
// cooperative launch, grid barrier and part sums in stages of products;
// on an H100 splits into parts of a few stages lost to the whole pass
// (PERF.md).
constexpr int kSplitCost = 13;
struct Plan {
  int bn, tiles_m, tiles_n, split, grid;
};
Plan plan_pass(int L, int M, int N, int K, int bm, int bn, int bk, int sms) {
  Plan pl{};
  pl.bn = bn;
  pl.tiles_m = (M + bm - 1) / bm;
  pl.tiles_n = (N + bn - 1) / bn;
  const long long tiles = static_cast<long long>(L) * pl.tiles_m * pl.tiles_n;
  const int nk = (K + bk - 1) / bk;
  const int most = 2 * tiles <= sms
                       ? std::max(1, std::min(kMaxSplit, nk / (128 / bk)))
                       : 1;
  long long best = nk;  // one wave, unsplit
  pl.split = 1;
  for (int s = 2; s <= most; ++s) {
    const long long waves = (tiles * s + sms - 1) / sms;
    const long long cost = waves * ((nk + s - 1) / s) + kSplitCost;
    if (cost < best) {
      best = cost;
      pl.split = s;
    }
  }
  if (4 * best > 3 * nk) pl.split = 1;
  pl.grid = static_cast<int>(std::min<long long>(tiles * pl.split, sms));
  return pl;
}

// The four passes of a call and where each lives in the workspace.
struct Chain {
  Plan p1, p2, p3, p4;
  long long split_at, partials_at, floats;
};
Chain chain_of(int L, int gp, int ap) {
  const int sms = sm_count();
  const int bn = ap <= 64 ? 32 : 128;
  Chain c{};
  c.p1 = plan_pass(L, ap, gp, ap, BM, 128, BK, sms);
  c.p2 = plan_pass(L, gp, ap, gp, BM, bn, BK, sms);
  c.p3 = plan_pass(L, gp, ap, ap, BM, bn, BK, sms);
  c.p4 = plan_pass(L, gp, ap, gp, BM, bn, BK, sms);
  const int most = std::max(std::max(c.p1.split, c.p2.split),
                            std::max(c.p3.split, c.p4.split));
  const long long plane = static_cast<long long>(L) * gp * ap;
  c.split_at = 2 * plane;
  c.partials_at = c.split_at + (most > 1 ? most * plane : 0);
  c.floats = c.partials_at +
             static_cast<long long>(L) * c.p2.tiles_m * c.p2.tiles_n;
  return c;
}

template <bool A_KM, int EPI, int BN>
cudaError_t run_pass_bn(const float* A, int a_inner, int a_rows,
                        const float* B, int b_inner, int b_rows, Args args,
                        const Plan& pl, cudaStream_t stream) {
  using S = Smem<BN>;
  constexpr auto kernel = wgmma_pass<A_KM, BN, EPI>;
  CUtensorMap ma, mb;
  cudaError_t err;
  if ((err = make_map(&ma, 4, A, a_inner, a_rows, args.L, 32,
                      A_KM ? BM : BK)))
    return err;
  if ((err = make_map(&mb, 4, B, b_inner, b_rows, args.L, BK, BN)))
    return err;
  if ((err = allow_smem<kernel>(S::BYTES))) return err;
  args.tiles_m = pl.tiles_m;
  args.tiles_n = pl.tiles_n;
  args.split = pl.split;
  if (pl.split == 1) {
    kernel<<<pl.grid, kThreads, S::BYTES, stream>>>(ma, mb, args);
    return cudaGetLastError();
  }
  void* params[] = {&ma, &mb, &args};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(pl.grid), dim3(kThreads), params,
                                     S::BYTES, stream);
}

template <bool A_KM, int EPI>
cudaError_t run_pass(const float* A, int a_inner, int a_rows, const float* B,
                     int b_inner, int b_rows, const Args& args,
                     const Plan& pl, cudaStream_t stream) {
  if (pl.bn == 32)
    return run_pass_bn<A_KM, EPI, 32>(A, a_inner, a_rows, B, b_inner, b_rows,
                                      args, pl, stream);
  return run_pass_bn<A_KM, EPI, 128>(A, a_inner, a_rows, B, b_inner, b_rows,
                                     args, pl, stream);
}

// The f32 chain for gp > 64 on shapes TMA takes:
//   P1  W^T = qa^T g^T   (M = ap, N = gp, K = ap; A = qa M-major)
//   P2  v2 = (qg^T W) * dgda, clip partials   (A = qg M-major, B = W^T)
//   P3  Y = v2 qa^T, stored as Y^T            (A = v2, B = qa, K-major)
//   P4  pg = qg Y, and the clip sums          (A = qg K-major, B = Y^T)
// W^T lives in pg's buffer until P4 overwrites it.
int launch_chain(const float* g, const float* qa, const float* qg,
                 const float* dgda, float* pg, float* clip, float* ws, int L,
                 int gp, int ap, cudaStream_t stream) {
  const Chain c = chain_of(L, gp, ap);
  const long long plane = static_cast<long long>(L) * gp * ap;
  float* v2 = ws;
  float* yt = ws + plane;
  Args a{};
  a.split_ws = ws + c.split_at;
  a.partials = ws + c.partials_at;
  a.clip = clip;
  a.L = L;
  a.clip_tiles = c.p2.tiles_m * c.p2.tiles_n;
  cudaError_t err;
  a.C = pg;
  a.M = ap; a.N = gp; a.K = ap;
  if ((err = run_pass<false, kStore>(qa, ap, ap, g, ap, gp, a, c.p1,
                                    stream)))
    return err;
  a.C = v2;
  a.D = dgda;
  a.M = gp; a.N = ap; a.K = gp;
  if ((err = run_pass<false, kScale>(qg, gp, gp, pg, gp, ap, a, c.p2,
                                    stream)))
    return err;
  a.C = yt;
  a.M = gp; a.N = ap; a.K = ap;
  if ((err = run_pass<true, kStoreT>(v2, ap, gp, qa, ap, ap, a, c.p3,
                                    stream)))
    return err;
  a.C = pg;
  a.M = gp; a.N = ap; a.K = gp;
  return run_pass<true, kClip>(qg, gp, gp, yt, gp, ap, a, c.p4, stream);
}

// TMA takes rows of 16-byte multiples from 16-byte aligned bases.
template <typename T>
bool takes(int gp, int ap) {
  const int per = 16 / static_cast<int>(sizeof(T));
  return gp > 64 && gp % per == 0 && ap % per == 0;
}

}  // namespace wg

// ---------------------------------------------------------------------
// The gp > 64 route for bf16 operands: four persistent passes of bf16
// `wgmma` (m64n128k16, or m64n64k16 where ap <= 64; f32 sums), both
// operands read from shared memory by descriptor.  bf16 `wgmma` takes A and B in either major order, so
// every tile is read as TMA lands it (128-byte swizzle, 64 bf16 a row),
// whichever index the pass contracts: no registers, no widening, no
// split on the consumers' path.
//
// Every pass computes an [L][gp][ap] output C = A B.  The products of
// two bf16 operands run once; a bf16 basis times an f32 intermediate X
// runs as three, X = hi + mid + lo, three bf16 planes that sum to X
// exactly, written by the epilogue of the pass that produces X.  The
// association is chosen by shape so that the larger contraction of
// each half of the chain is the bf16 x bf16 one:
//
//   order 0 (ap >= gp)                 order 1 (gp > ap, the TPU's)
//   P1  X = g qa          (K = ap)     X = qg^T g        (K = gp)
//   P2  v2 = (qg^T X) dgda (K = gp)    v2 = (X qa) dgda  (K = ap)
//   P3  X = v2 qa^T       (K = ap)     X = qg v2         (K = gp)
//   P4  pg = qg X         (K = gp)     pg = X qa^T       (K = ap)
//
// P1 and P3 are single-plane passes on 256 x 128 tiles (two consumer
// warpgroups of 128 rows, two m64 products each) where those fill a
// wave of the SMs, else 128 x 128; P2 and P4 read three planes of one
// operand and take 128 x 128 tiles; all are 64 columns wide where
// ap <= 64.  On an H100 the passes are bound by their TMA loads: at
// BERT-large's fc_out a build without the products took as long as the
// whole (PERF.md).  v2 is stored as a bf16 plane (the TPU kernel rounds
// it to the operand type before the back rotation).  Sums run over the
// whole K part in one accumulator:
// at bf16's gate (1e-3) the tensor cores' truncating sum is far inside
// (~K/16 truncations of 2^-24 each).  The persistent items, the
// producer's TMA ring, the fixed-order sums and the split-K rule are
// wg's.
namespace wgb {

using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::saddr;
using wg::tma_load;
using wg::wgmma_commit;
using wg::wgmma_fence;
using bf16 = __nv_bfloat16;

constexpr int BK = 64;     // K of one ring stage: one 128-byte bf16 row
constexpr int kRingBytes = 196608;
constexpr int kConsumers = wg::kConsumers;
constexpr int kThreads = wg::kThreads;
// The producer warpgroup only issues TMA (one lane); its registers go
// to the consumers' accumulators.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(wg::kProducers * kProducerRegs + kConsumers * kConsumerRegs <=
                  kThreads * 168,
              "setmaxnreg moves registers, it makes none");

enum Epi { kSplit3 = 0, kScale = 1, kClip = 2 };

struct Args {
  void* C;             // kSplit3: planes [3][L][M][N] bf16; kScale: v2
                       // [L][M][N] bf16; kClip: pg [L][M][N] f32
  const bf16* D;       // kScale: dgda
  float* partials;     // clip partials, [L][clip_tiles]
  float* clip;         // kClip: the per-slot sums
  float* split_ws;     // split > 1: [split][L][M][N] partial products
  int L, M, N, K;
  int tiles_m, tiles_n, split;
  int clip_tiles;      // tiles per slot of the kScale pass
};

// Shared memory of a pass: kRing stages of (A planes, B planes), then
// the barriers and the consumers' reduction scratch.  A plane of A is
// BM x 64 bf16: K-major one [BM][64] box, M-major BM / 64 boxes of
// [64 k][64 m]; a plane of B is BN x 64: K-major one [BN][64] box,
// N-major BN / 64 [64 k][64 n] boxes.  Every box lands 128-byte
// swizzled on a 1024-byte boundary.
template <int MSUB, int BN, int A_PL, int B_PL>
struct Smem {
  static constexpr int BM = 128 * MSUB;
  static constexpr int A_PLANE = BM * 128;
  static constexpr int B_PLANE = BN * 128;
  static constexpr int STAGE = A_PL * A_PLANE + B_PL * B_PLANE;
  static constexpr int kRing = std::min(6, kRingBytes / STAGE);
  static constexpr int BAR = kRing * STAGE;
  static constexpr int RED = BAR + 2 * kRing * 8;
  static constexpr int BYTES = RED + 8 * 4 + 1024;  // + alignment slack
  static_assert(kRing >= 2, "a ring of at least two stages");
};

// `wgmma` descriptor of a 128-byte-swizzled tile: `lbo` the byte stride
// between 64-wide MN blocks (MN-major only), `sbo` between 8-row groups.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d (m64 x n64, f32) += a (m64 x k16) * b (k16 x n64), bf16 from shared
// memory (the tiles of ap <= 64).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %34, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "n"(TA), "n"(TB), "r"(1));
}

// d (m64 x n128, f32) += a (m64 x k16) * b (k16 x n128), bf16 from
// shared memory; TA / TB = 1 for an M- / N-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %66, %67;\n}\n"
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
      : "l"(a), "l"(b), "n"(TA), "n"(TB), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// A work item: as wg::Item, on this pass's tiles.
struct Item {
  int l, m0, n0, part, k0, k1, tile;
};
template <int BM, int BN>
__device__ __forceinline__ Item item_of(int w, const Args& p, int nk) {
  Item it;
  it.part = w % p.split;
  it.tile = w / p.split;
  const int nt = it.tile % p.tiles_n;
  const int mt = (it.tile / p.tiles_n) % p.tiles_m;
  it.l = it.tile / (p.tiles_n * p.tiles_m);
  it.m0 = mt * BM;
  it.n0 = nt * BN;
  it.k0 = it.part * nk / p.split;
  it.k1 = (it.part + 1) * nk / p.split;
  return it;
}

// Two neighbouring outputs (r, c), (r, c + 1) of slot l: the epilogue.
template <int EPI>
__device__ __forceinline__ void emit2(const Args& p, int l, int r, int c,
                                      float v0, float v1, float& cp) {
  const long long plane = static_cast<long long>(p.M) * p.N;
  const long long off = l * plane + static_cast<long long>(r) * p.N + c;
  if constexpr (EPI == kSplit3) {
    // v = hi + mid + lo exactly: each part is the rest of the one
    // before it (exact in f32) rounded to bf16.
    bf16* C = static_cast<bf16*>(p.C);
    const long long stride = static_cast<long long>(p.L) * plane;
    float x0 = v0, x1 = v1;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      *reinterpret_cast<__nv_bfloat162*>(C + q * stride + off) = h;
      x0 -= __low2float(h);
      x1 -= __high2float(h);
    }
  } else if constexpr (EPI == kScale) {
    const __nv_bfloat162 d =
        *reinterpret_cast<const __nv_bfloat162*>(p.D + off);
    const float x0 = v0 * __low2float(d);
    const float x1 = v1 * __high2float(d);
    cp = fmaf(v0, x0, cp);
    cp = fmaf(v1, x1, cp);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.C) + off) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(p.C) + off) =
        make_float2(v0, v1);
  }
}

// One pass, C = A B over A_PL planes of A and B_PL of B (one side has
// one).  A_MN: A is M-major in device memory (A(m, k) at [k][m]); B_MN:
// B is N-major (B(k, n) at [k][n]).  Lane 0 of warpgroup 2 keeps the
// ring's TMA loads in flight; warpgroups 0 and 1 each take MSUB 64-row
// slices of the BM x BN tile and issue, per k16 step, one `wgmma` a
// slice and plane pair, keeping one stage's group in flight.  With
// split > 1 (a cooperative launch) the K parts are stored, the grid
// synchronises, and each tile's parts are summed in part order before
// the epilogue.
template <bool A_MN, int A_PL, bool B_MN, int B_PL, int MSUB, int BN,
          int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    bf16_pass(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, const Args p) {
  using S = Smem<MSUB, BN, A_PL, B_PL>;
  constexpr int BM = S::BM;
  constexpr int kRing = S::kRing;
  constexpr int PL = A_PL > B_PL ? A_PL : B_PL;
  static_assert(A_PL == 1 || B_PL == 1, "one side has one plane");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR);
  uint64_t* empty = full + kRing;
  float* red = reinterpret_cast<float*>(smem + S::RED);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = p.L * p.tiles_m * p.tiles_n;
  const int items = tiles * p.split;
  const int nk = (p.K + BK - 1) / BK;

  if (tid >= kConsumers) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    const int ptid = tid - kConsumers;
    if (ptid < 32) {
      if constexpr (EPI == kClip) {
        // The kScale pass's clip partials, summed per slot in tile order.
        for (int l = blockIdx.x * 32 + ptid; l < p.L; l += gridDim.x * 32) {
          float s = 0.0f;
          for (int t = 0; t < p.clip_tiles; ++t)
            s += p.partials[static_cast<long long>(l) * p.clip_tiles + t];
          p.clip[l] = s;
        }
      }
      if (ptid == 0) {
        int loads = 0;
        for (int w = blockIdx.x; w < items; w += gridDim.x) {
          const Item it = item_of<BM, BN>(w, p, nk);
          for (int kk = it.k0; kk < it.k1; ++kk, ++loads) {
            const int st = loads % kRing;
            mbar_wait(&empty[st], ((loads / kRing) & 1) ^ 1);
            mbar_expect_tx(&full[st], S::STAGE);
            unsigned char* a = smem + st * S::STAGE;
            unsigned char* b = a + A_PL * S::A_PLANE;
            const int k = kk * BK;
            // Plane q of slot l is slot q L + l of the planes' map.
#pragma unroll
            for (int q = 0; q < A_PL; ++q) {
              unsigned char* dst = a + q * S::A_PLANE;
              if constexpr (A_MN) {
#pragma unroll
                for (int h = 0; h < BM / 64; ++h)
                  tma_load(dst + h * 8192, &map_a, &full[st], it.m0 + 64 * h,
                           k, q * p.L + it.l);
              } else {
                tma_load(dst, &map_a, &full[st], k, it.m0, q * p.L + it.l);
              }
            }
#pragma unroll
            for (int q = 0; q < B_PL; ++q) {
              unsigned char* dst = b + q * S::B_PLANE;
              if constexpr (B_MN) {
#pragma unroll
                for (int h = 0; h < BN / 64; ++h)
                  tma_load(dst + h * 8192, &map_b, &full[st], it.n0 + 64 * h,
                           k, q * p.L + it.l);
              } else {
                tma_load(dst, &map_b, &full[st], k, it.n0, q * p.L + it.l);
              }
            }
          }
        }
      }
      __syncwarp();
    }
    if (p.split > 1) cooperative_groups::this_grid().sync();
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int wgi = tid >> 7;
  const int g = lane >> 2;
  const int t = lane & 3;
  // This thread's fragment row of slice i: row(i) and row(i) + 8.
  const int row = ((tid >> 5) & 3) * 16 + g;
  int slices = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const Item it = item_of<BM, BN>(w, p, nk);
    float acc[MSUB][BN / 2];
#pragma unroll
    for (int i = 0; i < MSUB; ++i)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[i][e] = 0.0f;
    const int ns = it.k1 - it.k0;
    for (int s = 0; s < ns; ++s, ++slices) {
      const int st = slices % kRing;
      mbar_wait(&full[st], (slices / kRing) & 1);
      const uint32_t a = saddr(smem + st * S::STAGE);
      const uint32_t b = a + A_PL * S::A_PLANE;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int i = 0; i < MSUB; ++i) {
          const int slice = wgi * MSUB + i;  // 64-row slice of the tile
#pragma unroll
          for (int q = 0; q < PL; ++q) {
            const uint32_t ap = a + (A_PL > 1 ? q : 0) * S::A_PLANE;
            const uint32_t bp = b + (B_PL > 1 ? q : 0) * S::B_PLANE;
            // K-major: a k16 step is 32 bytes along the swizzled row;
            // MN-major: 16 rows of 128 bytes.
            const uint64_t da =
                A_MN ? desc(ap + slice * 8192 + j * 2048, 8192, 1024)
                     : desc(ap + slice * 8192 + j * 32, 16, 1024);
            const uint64_t db = B_MN ? desc(bp + j * 2048, 8192, 1024)
                                     : desc(bp + j * 32, 16, 1024);
            wgmma_bf16<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc[i], da, db);
          }
        }
      }
      wgmma_commit();
      // The stage before this one is read once its group is done.
      if (s > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(slices + kRing - 1) % kRing]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MSUB; ++i) wg::pin(acc[i]);
    if (ns > 0 && lane == 0) mbar_arrive(&empty[(slices + kRing - 1) % kRing]);
    // Fragment (row, col) of acc[i][4 j + 2 h + e]: slice i's row + 8 h,
    // 8 j + 2 t + e.
    float cp = 0.0f;
#pragma unroll
    for (int i = 0; i < MSUB; ++i) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = it.m0 + (wgi * MSUB + i) * 64 + row + 8 * h;
          const int c = it.n0 + 8 * j + 2 * t;
          if (r >= p.M || c >= p.N) continue;
          const float v0 = acc[i][4 * j + 2 * h];
          const float v1 = acc[i][4 * j + 2 * h + 1];
          if (p.split > 1) {
            float* ws = p.split_ws +
                        (static_cast<long long>(it.part) * p.L + it.l) *
                            p.M * p.N;
            *reinterpret_cast<float2*>(ws + static_cast<long long>(r) * p.N +
                                       c) = make_float2(v0, v1);
          } else {
            emit2<EPI>(p, it.l, r, c, v0, v1, cp);
          }
        }
      }
    }
    if (EPI == kScale && p.split == 1) {
      const float s = wg::consumers_sum(cp, red, tid);
      if (tid == 0) {
        const int per = p.tiles_m * p.tiles_n;
        p.partials[static_cast<long long>(it.l) * per + it.tile % per] = s;
      }
    }
  }

  if (p.split > 1) {
    cooperative_groups::this_grid().sync();
    // Each tile's parts summed in part order, four neighbours a thread.
    const long long part_stride = static_cast<long long>(p.L) * p.M * p.N;
    for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
      const Item it = item_of<BM, BN>(tl * p.split, p, nk);
      const long long slot = static_cast<long long>(it.l) * p.M * p.N;
      float cp = 0.0f;
      for (int q = tid; q < BM * BN / 4; q += kConsumers) {
        const int r = it.m0 + q / (BN / 4);
        const int c = it.n0 + 4 * (q % (BN / 4));
        if (r >= p.M || c >= p.N) continue;
        const long long off = static_cast<long long>(r) * p.N + c;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int s = 0; s < wg::kMaxSplit; ++s) {
          if (s >= p.split) break;
          const float4 x = *reinterpret_cast<const float4*>(
              p.split_ws + s * part_stride + slot + off);
          v.x += x.x;
          v.y += x.y;
          v.z += x.z;
          v.w += x.w;
        }
        emit2<EPI>(p, it.l, r, c, v.x, v.y, cp);
        emit2<EPI>(p, it.l, r, c + 2, v.z, v.w, cp);
      }
      if (EPI == kScale) {
        const float s = wg::consumers_sum(cp, red, tid);
        if (tid == 0) {
          const int per = p.tiles_m * p.tiles_n;
          p.partials[static_cast<long long>(it.l) * per + it.tile % per] = s;
        }
      }
    }
  }
}

// The four passes of a call, their order and where each lives in the
// workspace: the X planes (3 L gp ap bf16) and the v2 plane (L gp ap
// bf16) fill two f32 planes, then the split-K parts and the clip
// partials.
struct Chain {
  int order;  // 0: X = g qa first; 1: X = qg^T g first
  int msub;   // 64-row slices a warpgroup takes in P1 and P3
  int bn;     // tile columns: 64 where ap <= 64, else 128
  wg::Plan p1, p2, p3, p4;
  long long split_at, partials_at, floats;
};
Chain chain_of(int L, int gp, int ap) {
  const int sms = wg::sm_count();
  Chain c{};
  c.order = gp > ap ? 1 : 0;
  const int k13 = c.order ? gp : ap;  // P1 and P3 contract this
  const int k24 = c.order ? ap : gp;
  // 256-row tiles in P1 and P3 where 256 x 128 tiles fill a wave of the
  // SMs, else 128 rows (on an H100, 128 x 128 and 128 x 256 tiles were
  // slower there, PERF.md); 64 columns where ap <= 64, which 128-wide
  // tiles would half waste.
  const long long tiles256 =
      static_cast<long long>(L) * ((gp + 255) / 256) * ((ap + 127) / 128);
  c.msub = tiles256 >= sms ? 2 : 1;
  c.bn = ap <= 64 ? 64 : 128;
  c.p1 = wg::plan_pass(L, gp, ap, k13, 128 * c.msub, c.bn, BK, sms);
  c.p2 = wg::plan_pass(L, gp, ap, k24, 128, c.bn, BK, sms);
  c.p3 = wg::plan_pass(L, gp, ap, k13, 128 * c.msub, c.bn, BK, sms);
  c.p4 = wg::plan_pass(L, gp, ap, k24, 128, c.bn, BK, sms);
  const int most = std::max(std::max(c.p1.split, c.p2.split),
                            std::max(c.p3.split, c.p4.split));
  const long long plane = static_cast<long long>(L) * gp * ap;
  c.split_at = 2 * plane;
  c.partials_at = c.split_at + (most > 1 ? most * plane : 0);
  c.floats = c.partials_at +
             static_cast<long long>(L) * c.p2.tiles_m * c.p2.tiles_n;
  return c;
}

// One pass on operands A (a_rows x a_inner a slot, as device memory
// holds them) and B: their tensor maps (A_PL L or B_PL L slots of 64-wide
// boxes), then the launch, cooperative where K is split.
template <bool A_MN, int A_PL, bool B_MN, int B_PL, int MSUB, int BN,
          int EPI>
cudaError_t run_pass(const bf16* A, int a_inner, int a_rows, const bf16* B,
                     int b_inner, int b_rows, Args args, const wg::Plan& pl,
                     cudaStream_t stream) {
  using S = Smem<MSUB, BN, A_PL, B_PL>;
  constexpr auto kernel = bf16_pass<A_MN, A_PL, B_MN, B_PL, MSUB, BN, EPI>;
  CUtensorMap ma, mb;
  cudaError_t err;
  if ((err = wg::make_map(&ma, 2, A, a_inner, a_rows, A_PL * args.L, 64,
                          A_MN ? 64 : S::BM)))
    return err;
  if ((err = wg::make_map(&mb, 2, B, b_inner, b_rows, B_PL * args.L, 64,
                          B_MN ? 64 : BN)))
    return err;
  if ((err = allow_smem<kernel>(S::BYTES))) return err;
  args.tiles_m = pl.tiles_m;
  args.tiles_n = pl.tiles_n;
  args.split = pl.split;
  if (pl.split == 1) {
    kernel<<<pl.grid, kThreads, S::BYTES, stream>>>(ma, mb, args);
    return cudaGetLastError();
  }
  void* params[] = {&ma, &mb, &args};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(pl.grid), dim3(kThreads), params,
                                     S::BYTES, stream);
}

// The chain with MSUB-slice tiles in P1 and P3, BN columns in all four.
// Operands by (pointer, inner extent, rows) as device memory holds them:
// g, dgda, v2 and the X planes [gp][ap], qa [ap][ap], qg [gp][gp].
template <int MSUB, int BN>
int run_chain(const Chain& c, const bf16* g, const bf16* qa, const bf16* qg,
              const bf16* dgda, float* pg, bf16* x, bf16* v2, Args a,
              int gp, int ap, cudaStream_t stream) {
  cudaError_t err;
  if (c.order == 0) {
    a.C = x;
    a.K = ap;
    if ((err = run_pass<false, 1, true, 1, MSUB, BN, kSplit3>(
             g, ap, gp, qa, ap, ap, a, c.p1, stream)))
      return err;
    a.C = v2;
    a.D = dgda;
    a.K = gp;
    if ((err = run_pass<true, 1, true, 3, 1, BN, kScale>(
             qg, gp, gp, x, ap, gp, a, c.p2, stream)))
      return err;
    a.C = x;
    a.K = ap;
    if ((err = run_pass<false, 1, false, 1, MSUB, BN, kSplit3>(
             v2, ap, gp, qa, ap, ap, a, c.p3, stream)))
      return err;
    a.C = pg;
    a.K = gp;
    return run_pass<false, 1, true, 3, 1, BN, kClip>(qg, gp, gp, x, ap, gp,
                                                     a, c.p4, stream);
  }
  a.C = x;
  a.K = gp;
  if ((err = run_pass<true, 1, true, 1, MSUB, BN, kSplit3>(
           qg, gp, gp, g, ap, gp, a, c.p1, stream)))
    return err;
  a.C = v2;
  a.D = dgda;
  a.K = ap;
  if ((err = run_pass<false, 3, true, 1, 1, BN, kScale>(
           x, ap, gp, qa, ap, ap, a, c.p2, stream)))
    return err;
  a.C = x;
  a.K = gp;
  if ((err = run_pass<false, 1, true, 1, MSUB, BN, kSplit3>(
           qg, gp, gp, v2, ap, gp, a, c.p3, stream)))
    return err;
  a.C = pg;
  a.K = ap;
  return run_pass<false, 3, false, 1, 1, BN, kClip>(x, ap, gp, qa, ap, ap,
                                                    a, c.p4, stream);
}

int launch_chain(const bf16* g, const bf16* qa, const bf16* qg,
                 const bf16* dgda, float* pg, float* clip, float* ws, int L,
                 int gp, int ap, cudaStream_t stream) {
  const Chain c = chain_of(L, gp, ap);
  const long long plane = static_cast<long long>(L) * gp * ap;
  bf16* x = reinterpret_cast<bf16*>(ws);  // hi, mid, lo planes
  bf16* v2 = x + 3 * plane;
  Args a{};
  a.split_ws = ws + c.split_at;
  a.partials = ws + c.partials_at;
  a.clip = clip;
  a.L = L;
  a.M = gp;
  a.N = ap;
  a.clip_tiles = c.p2.tiles_m * c.p2.tiles_n;
  if (c.bn == 64)
    return c.msub == 2
               ? run_chain<2, 64>(c, g, qa, qg, dgda, pg, x, v2, a, gp, ap,
                                  stream)
               : run_chain<1, 64>(c, g, qa, qg, dgda, pg, x, v2, a, gp, ap,
                                  stream);
  if (c.msub == 2)
    return run_chain<2, 128>(c, g, qa, qg, dgda, pg, x, v2, a, gp, ap,
                             stream);
  return run_chain<1, 128>(c, g, qa, qg, dgda, pg, x, v2, a, gp, ap, stream);
}

}  // namespace wgb

// The route a call takes: 0 the fused pair (gp <= 64), 1 the wgmma chain,
// 2 the cp.async chain (gp > 64 on rows TMA cannot take).  Chosen by
// shape and alignment before any launch.
template <typename T>
int route_of(int gp, int ap, bool ptrs_aligned) {
  if (gp <= 64) return 0;
  return wg::takes<T>(gp, ap) && ptrs_aligned ? 1 : 2;
}

template <typename T>
int launch(const T* g, const T* qa, const T* qg, const T* dgda, float* pg,
           float* clip, float* ws, int L, int gp, int ap,
           cudaStream_t stream) {
  const bool ptrs = aligned16(g) && aligned16(qa) && aligned16(qg) &&
                    aligned16(dgda) && aligned16(pg) && aligned16(ws);
  const int route = route_of<T>(gp, ap, ptrs);
  if (route == 1) {
    if constexpr (sizeof(T) == 2)
      return wgb::launch_chain(g, qa, qg, dgda, pg, clip, ws, L, gp, ap,
                               stream);
    else
      return wg::launch_chain(g, qa, qg, dgda, pg, clip, ws, L, gp, ap,
                              stream);
  }
  int rows, cols, kernels;
  tiling(gp, &rows, &cols, &kernels);
  const long long plane = static_cast<long long>(L) * gp * ap;
  float* v2 = ws;
  float* y = ws + plane;  // the cp.async chain only
  float* partials = ws + (kernels == 2 ? 1 : 2) * plane;
  const int aligned = gp % 8 == 0 && ap % 8 == 0 && ptrs;
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

// f32 elements of the workspace a call needs.  gp <= 64: the v2 plane
// [L, gp, ap], then one clip partial per block of the forward kernel.
// gp > 64: the larger of the two chains' needs: the v2 and Y planes,
// then (wgmma chain) the split-K partial products of the pass that
// splits K most, or (cp.async chain) nothing, then the clip partials.
long long kfac_fused_eigen_precond_workspace(int L, int gp, int ap) {
  int rows, cols, kernels;
  tiling(gp, &rows, &cols, &kernels);
  const long long plane = static_cast<long long>(L) * gp * ap;
  const long long tiles = static_cast<long long>((ap + cols - 1) / cols) *
                          (kernels == 2 ? 1 : (gp + rows - 1) / rows);
  const long long need = (kernels == 2 ? 1 : 2) * plane + L * tiles;
  if (gp <= 64) return need;
  return std::max(need, std::max(wg::chain_of(L, gp, ap).floats,
                                 wgb::chain_of(L, gp, ap).floats));
}

// The route of a call with 16-byte aligned operands (route_of above).
int kfac_fused_eigen_precond_route(int gp, int ap, int dtype) {
  return dtype == 1 ? route_of<__nv_bfloat16>(gp, ap, true)
                    : route_of<float>(gp, ap, true);
}

// Which product a call with 16-byte aligned operands forms first: 0 the
// gradient times qa (W = g qa), 1 qg^T times the gradient (the bf16
// wgmma route where gp > ap: wgb::chain_of).
int kfac_fused_eigen_precond_order(int gp, int ap, int dtype) {
  return dtype == 1 && route_of<__nv_bfloat16>(gp, ap, true) == 1 && gp > ap
             ? 1
             : 0;
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
