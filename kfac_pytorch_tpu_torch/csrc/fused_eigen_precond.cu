// Fused two-sided eigenbasis preconditioning for stacked K-FAC layers.
//
// Replaces the TPU kernel `_kernel`/`_call` of
// kfac_pytorch_tpu/ops/pallas_precond.py.  For every layer slot l of a
// bucket stack, with g, dgda [L, gp, ap], qa [L, ap, ap], qg [L, gp, gp]:
//
//     v1 = qg^T g qa ;  v2 = v1 * dgda ;  pg = qg v2 qa^T
//     clip[l] = sum(v1 * v2)            (== <pg, g>, orthogonal invariance)
//
// What bounds it on an H100.  One ResNet-32 step is ~1.07 GFLOP over
// ~24 MB of f32 operands: ~45 FLOP per byte, above the ~20 FLOP/byte
// ridge of the f32 CUDA-core roofline (67 TFLOP/s over 3.35 TB/s), so
// the chain is bound by f32 operations (~16 us at the peak rate, against
// ~7 us for the bytes).  At these sizes launch latency is of the same
// order, which is why the passes are few and each grid covers every slot.
//
// Design.  The Pallas kernel holds one whole slot (operands plus the
// [gp, ap] intermediates) in VMEM and walks the slots in order.  A
// Hopper block has 227 KB of shared memory, which holds neither qa of
// the larger buckets (576^2 f32 is 1.3 MB) nor ResNet-50's 9.4 MB
// intermediates, and one block per slot would leave most of the 132 SMs
// idle.  So the chain runs as four tiled products, each over a grid of
// (column tile, row tile, slot) blocks, with the [gp, ap] intermediates
// in a scratch buffer the caller allocates (they stay in the 50 MB L2
// for every bucket of the models in this repository):
//
//     pass 1  T  = qg^T g            (pg's buffer holds T)
//     pass 2  V  = (T qa) * dgda     + per-tile partial clip sums
//     pass 3  U  = qg V
//     pass 4  pg = U qa^T
//     pass 5  clip[l] = sum of slot l's partial sums, in tile order
//
// Every product is a 64x64 output tile per 256-thread block, 4x4
// outputs per thread, operands streamed through shared memory in
// 16-deep slices.  Accumulation is fmaf in f32 on the CUDA cores (no
// TF32).  bf16 operands are widened on load; as in the TPU kernel, V is
// rounded to the operand type before pass 3.  The clip sums use no
// atomics: each block reduces its tile in a fixed order and pass 5 sums
// the tiles in a fixed order, so two runs give the same bits.
// wgmma/TMA tiles are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

enum Epilogue { kStore = 0, kDgda = 1 };

// C[l] (M x N, row-major) = opA(A[l]) (M x K) . opB(B[l]) (K x N).
// TRANS_A: A[l] is stored K x M.  TRANS_B: B[l] is stored N x K.
// kDgda epilogue: C = acc * D[l] rounded to TR, and the tile's
// sum(acc * acc * D) goes to partials[l * tiles + tile].
template <typename TA, typename TB, bool TRANS_A, bool TRANS_B, int EPI,
          typename TD, typename TR>
__global__ void __launch_bounds__(kThreads) batched_gemm(
    const TA* __restrict__ A, const TB* __restrict__ B,
    float* __restrict__ C, const TD* __restrict__ D,
    float* __restrict__ partials, int M, int N, int K) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN + 4];
  __shared__ float red[kThreads];

  const int l = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const TA* Al = A + static_cast<long long>(l) * M * K;
  const TB* Bl = B + static_cast<long long>(l) * K * N;
  float* Cl = C + static_cast<long long>(l) * M * N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      int mm, kk;
      if (TRANS_A) {  // stored K x M: neighbours along m
        kk = idx / kBM;
        mm = idx % kBM;
      } else {        // stored M x K: neighbours along k
        mm = idx / kBK;
        kk = idx % kBK;
      }
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      float v = 0.0f;
      if (gm < M && gk < K) {
        v = TRANS_A ? load_f(Al + static_cast<long long>(gk) * M + gm)
                    : load_f(Al + static_cast<long long>(gm) * K + gk);
      }
      As[kk][mm] = v;
    }
#pragma unroll
    for (int r = 0; r < (kBN * kBK) / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      int nn, kk;
      if (TRANS_B) {  // stored N x K: neighbours along k
        nn = idx / kBK;
        kk = idx % kBK;
      } else {        // stored K x N: neighbours along n
        kk = idx / kBN;
        nn = idx % kBN;
      }
      const int gn = n0 + nn;
      const int gk = k0 + kk;
      float v = 0.0f;
      if (gn < N && gk < K) {
        v = TRANS_B ? load_f(Bl + static_cast<long long>(gn) * K + gk)
                    : load_f(Bl + static_cast<long long>(gk) * N + gn);
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        const long long off = static_cast<long long>(gm) * N + gn;
        if (EPI == kDgda) {
          const float v1 = acc[i][j];
          const float v2 =
              v1 * load_f(D + static_cast<long long>(l) * M * N + off);
          part = fmaf(v1, v2, part);
          Cl[off] = round_to<TR>(v2);
        } else {
          Cl[off] = acc[i][j];
        }
      }
    }
  }
  if (EPI == kDgda) {
    red[tid] = part;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) {
      const int tiles = gridDim.x * gridDim.y;
      partials[static_cast<long long>(l) * tiles +
               blockIdx.y * gridDim.x + blockIdx.x] = red[0];
    }
  }
}

__global__ void reduce_clip(const float* __restrict__ partials,
                            float* __restrict__ clip, int L, int tiles) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float s = 0.0f;
  for (int t = 0; t < tiles; ++t)
    s += partials[static_cast<long long>(l) * tiles + t];
  clip[l] = s;
}

template <typename T>
int launch(const T* g, const T* qa, const T* qg, const T* dgda, float* pg,
           float* clip, float* scratch, float* partials, int L, int gp,
           int ap, cudaStream_t stream) {
  const long long plane = static_cast<long long>(L) * gp * ap;
  float* tbuf = pg;             // pass 1 output, read by pass 2
  float* vbuf = scratch;        // pass 2 output, read by pass 3
  float* ubuf = scratch + plane;  // pass 3 output, read by pass 4
  const dim3 block(kThreads);
  const dim3 grid((ap + kBN - 1) / kBN, (gp + kBM - 1) / kBM, L);
  const int tiles = grid.x * grid.y;
  cudaError_t err;

  // pass 1: T = qg^T g   (M=gp, N=ap, K=gp)
  batched_gemm<T, T, true, false, kStore, float, float>
      <<<grid, block, 0, stream>>>(qg, g, tbuf, nullptr, nullptr, gp, ap,
                                   gp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // pass 2: V = (T qa) * dgda, partial clip sums   (K=ap)
  batched_gemm<float, T, false, false, kDgda, T, T>
      <<<grid, block, 0, stream>>>(tbuf, qa, vbuf, dgda, partials, gp, ap,
                                   ap);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // pass 3: U = qg V   (K=gp)
  batched_gemm<T, float, false, false, kStore, float, float>
      <<<grid, block, 0, stream>>>(qg, vbuf, ubuf, nullptr, nullptr, gp, ap,
                                   gp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // pass 4: pg = U qa^T   (K=ap)
  batched_gemm<float, T, false, true, kStore, float, float>
      <<<grid, block, 0, stream>>>(ubuf, qa, pg, nullptr, nullptr, gp, ap,
                                   ap);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // pass 5: clip[l] = sum of slot l's tile partials, in tile order
  reduce_clip<<<(L + 127) / 128, 128, 0, stream>>>(partials, clip, L, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of partial clip sums per slot; the caller sizes `partials` as
// [L, kfac_fused_eigen_precond_tiles(gp, ap)] f32.
int kfac_fused_eigen_precond_tiles(int gp, int ap) {
  return ((ap + kBN - 1) / kBN) * ((gp + kBM - 1) / kBM);
}

// dtype: 0 = float32 operands, 1 = bfloat16 operands.  pg [L, gp, ap] and
// clip [L] are f32 outputs; scratch is [2, L, gp, ap] f32.  Launches on
// `stream` without synchronising; returns cudaGetLastError() (0 = ok).
int kfac_fused_eigen_precond(const void* g, const void* qa, const void* qg,
                             const void* dgda, float* pg, float* clip,
                             float* scratch, float* partials, int L, int gp,
                             int ap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0 || gp <= 0 || ap <= 0 || L > 65535) return cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch<float>(static_cast<const float*>(g),
                         static_cast<const float*>(qa),
                         static_cast<const float*>(qg),
                         static_cast<const float*>(dgda), pg, clip, scratch,
                         partials, L, gp, ap, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(g),
                                 static_cast<const __nv_bfloat16*>(qa),
                                 static_cast<const __nv_bfloat16*>(qg),
                                 static_cast<const __nv_bfloat16*>(dgda), pg,
                                 clip, scratch, partials, L, gp, ap, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
