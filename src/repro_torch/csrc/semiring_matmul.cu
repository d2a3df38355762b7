// B2 — dense semiring matrix product C = A ⊕.⊗ B, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/semiring_matmul.py:35
// (`_dot_kernel`, (+,×) and (∨,∧) on the MXU) and :52 (`_trop_kernel`,
// (min,+)/(max,+) as a broadcast-reduce on the VPU), both launched by
// `semiring_matmul_pallas` :81.  These are the dense rule-body joins of
// the engine (Π₁'s dense_gsn/dense_naive strata) and the vector_dense
// runner's rounds.
//
// Design: a shared-memory tiled SIMT kernel templated on (⊕, ⊗).  A block
// of 256 threads owns a 64×64 tile of C; each K-slab of 16 is staged in
// shared memory (A transposed so a thread's four rows are one broadcast
// read) and every thread folds a 4×4 register tile.  Out-of-range
// elements of a slab are padded with 0̄ of the semiring (0 for the dot
// family, +inf for min-plus, -inf for max-plus), so a padded k never
// wins the ⊕, exactly as the reference pads (:96-99).
//
// No tensor cores and no TF32: the dot family runs f32 FMA, so integer
// counts stay exact to 2^24 (counting fixpoints pass 2^11, where TF32
// stops being exact).  bool runs as the f32 dot of 0/1 and is
// thresholded > 0.5 by the wrapper.  min-plus and max-plus have no
// tensor-core form at all.
//
// Bound on the card: operations.  2·m·n·k FP32 SIMT operations (FMA, or
// add + min/max) against 67 TFLOP/s; the 64×64 register tile keeps the
// shared-memory traffic at 1/8 load per operation.  wgmma/TMA pipelines
// are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

enum Mode { kDot = 0, kMinPlus = 1, kMaxPlus = 2 };

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, THREADS = 256;

template <int MODE>
__device__ __forceinline__ float pad_value() {
  return MODE == kMinPlus ? INFINITY : (MODE == kMaxPlus ? -INFINITY : 0.0f);
}

template <int MODE>
__device__ __forceinline__ float combine(float acc, float a, float b) {
  if (MODE == kMinPlus) return fminf(acc, a + b);
  if (MODE == kMaxPlus) return fmaxf(acc, a + b);
  return fmaf(a, b, acc);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
semiring_mm(const float* __restrict__ A, const float* __restrict__ B,
            float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  const float pad = pad_value<MODE>();
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = pad;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      int r = i / BK, c = i % BK;
      int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? A[(long long)gr * K + gc] : pad;
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      int r = i / BN, c = i % BN;
      int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? B[(long long)gr * N + gc] : pad;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = combine<MODE>(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int c = col0 + tx * TN + j;
      if (c < N) C[(long long)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// A (m, k), B (k, n), C (m, n): contiguous row-major float32; C is
// written completely.  Returns cudaGetLastError().
extern "C" int semiring_matmul(int mode, const void* a, const void* b,
                               void* c, int m, int n, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  if (mode == kMinPlus)
    semiring_mm<kMinPlus><<<grid, THREADS, 0, st>>>(A, B, C, m, n, k);
  else if (mode == kMaxPlus)
    semiring_mm<kMaxPlus><<<grid, THREADS, 0, st>>>(A, B, C, m, n, k);
  else
    semiring_mm<kDot><<<grid, THREADS, 0, st>>>(A, B, C, m, n, k);
  return (int)cudaGetLastError();
}
