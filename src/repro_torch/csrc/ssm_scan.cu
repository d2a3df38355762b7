// B4 — diagonal linear recurrence (SSM scan), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py:29
// (`_scan_kernel`, launched by `ssm_scan_pallas` :51):
//     h[b, t, d] = a[b, t, d] * h[b, t-1, d] + b[b, t, d],   h[b, -1, d] = 0
// over a, b, h of shape (B, T, D), f32, row-major.
//
// Bound on the card: bytes.  Each element of a and b is read once and h
// written once (12 B an element, a few FLOP), so the kernel's job is to
// keep enough bytes in flight to fill HBM at every B·D the models give
// it: 40,960 channels (Zamba2), 12,288 (xLSTM, B = 8) and 1,536 (one
// long prompt at xLSTM's width).
//
// Design: one pass, one launch.  A block owns W consecutive channels of
// one batch row and walks T inside itself in time tiles of L = 128 rows;
// the carry between tiles stays in the block (the TPU kernel's
// cross-grid-step VMEM carry, legitimate here because it never leaves the
// block).  Within a tile, the block's W·S threads (S = 8 a channel) each
// scan a sub-chunk of C = L/S = 16 rows serially, keeping every running
// value h_local and running product ∏a in registers; the S sub-chunk
// aggregates of a channel, which share a warp, are combined with the
// monoid (a₁,b₁)∘(a₂,b₂) = (a₁a₂, a₂b₁+b₂) in log₂ S shuffle rounds; each
// thread then injects its carry-in, h = h_local + (∏a)·carry, and the
// tile's carry-out moves on in a register.  So B·D·S threads work, not
// B·D.  Tiles arrive by cp.async (16 B a thread when D % 4 == 0 and the
// pointers are 16-byte aligned, else 4 B) in a ring of NST stages, NST−1
// tiles ahead of the one being scanned; h goes back into the tile's b
// slot and leaves by stores coalesced along D.  Rows past T and columns
// past D arrive as zeros and are not stored, so any B, T and D work.
//
// Why these numbers.  L = 128 and S = 8 are fixed, so the order of the
// arithmetic (ref.ssm_scan_blocked(tile=128, groups=8)) does not depend
// on the width chosen; C = 16 keeps the 32 per-row values in registers
// (60–64 of them a thread, no spills).  A sub-chunk is C·W + 4 floats
// apart in shared memory, so the 8 groups of a warp's 4 channels fall on
// 32 distinct banks.  W is 32 where that still gives every SM two blocks
// (B·⌈D/32⌉ ≥ 2·SMs), else 16.  Measured on an H100 (tools/b4_sweep.py,
// every W, NST and C below): rows of 128 or 64 bytes keep HBM
// efficient, while W = 8 and 4 (rows of 32 and 16 bytes) ran at 33–66% of
// the bound at every shape, and at 1,536 channels W = 16's 96 blocks beat
// W = 32's 48 (71% against 54%) because one block a SM cannot pull its
// share.  NST = 3 stages of 32 KB at W = 32 (2 blocks a SM) and 4 of
// 16 KB at W = 16 (3 blocks a SM): only C = 8 with 2 stages was faster by
// more than 2% (2.2% at xLSTM's 12,288 channels, 1% slower at Zamba2's).
//
// The old design (one thread a channel walking all of T, 96 blocks of
// 128 threads at xLSTM) ran at 77% of its bound at Zamba2's width and
// 40% at xLSTM's (0.0566 ms against 0.0225, NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int S = 8;        // thread groups a channel
constexpr int C_ROWS = 16;  // rows a group scans serially (C)
constexpr int PAD = 32 / S; // floats between sub-chunks: bank spread
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// async copies; src-size 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One time tile of one array in shared memory: S sub-chunks of C rows of
// W floats, SUB floats apart.
template <int W, int C>
struct Tile {
  static constexpr int L = S * C;  // rows a time tile
  static constexpr int SUB = C * W + PAD;
  static constexpr int FLOATS = S * SUB;
  // shared-memory offset of row r, column col of a tile
  __device__ static int at(int r, int col) {
    return (r / C) * SUB + (r % C) * W + col;
  }
};

// Calls f(tile row r, column, global offset, in range) for the tile's
// elements a thread moves: VEC = 4 floats at a time (D % 4 == 0, so a
// vector is wholly in or out of range), else one.
template <int W, int C, int VEC, class F>
__device__ __forceinline__ void for_tile(int t0, long long row0, int t_len,
                                         int d, int d0, F f) {
  constexpr int L = S * C;
  constexpr int Q = W / VEC;   // vectors a row
  for (int e = threadIdx.x; e < L * Q; e += W * S) {
    const int r = e / Q, col = (e % Q) * VEC;
    const int t = t0 + r, dd = d0 + col;
    const bool ok = t < t_len && dd < d;
    f(r, col, ok ? (row0 + t) * (long long)d + dd : 0LL, ok);
  }
}

template <int W, int NST, int VEC, int C>
__global__ void __launch_bounds__(W * S)
ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ h, int t_len, int d, int d_tiles) {
  using T = Tile<W, C>;
  constexpr int L = T::L;
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                    // [NST][T::FLOATS]
  float* sb = smem + NST * T::FLOATS;  // b in, h out
  const int bi = blockIdx.x / d_tiles;
  const int d0 = (blockIdx.x - bi * d_tiles) * W;
  const long long row0 = (long long)bi * t_len;  // row of (B·T, D)
  const int n_tiles = (t_len + L - 1) / L;

  auto load = [&](int k) {
    if (k < n_tiles) {
      float* da = sa + (k % NST) * T::FLOATS;
      float* db = sb + (k % NST) * T::FLOATS;
      for_tile<W, C, VEC>(k * L, row0, t_len, d, d0,
                          [&](int r, int col, long long off, bool ok) {
                            const int o = T::at(r, col);
                            if constexpr (VEC == 4) {
                              cp_async16(da + o, a + off, ok);
                              cp_async16(db + o, b + off, ok);
                            } else {
                              cp_async4(da + o, a + off, ok);
                              cp_async4(db + o, b + off, ok);
                            }
                          });
    }
    cp_async_commit();  // one group a tile, empty past the end
  };

  const int w = threadIdx.x / S, s = threadIdx.x % S;
  for (int k = 0; k < NST - 1; ++k) load(k);
  float carry = 0.0f;
  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<NST - 2>();  // tile k has landed
    __syncthreads();           // ... for every thread; slot k-1 is free
    load(k + NST - 1);
    const float* ta = sa + (k % NST) * T::FLOATS + s * T::SUB + w;
    float* tb = sb + (k % NST) * T::FLOATS + s * T::SUB + w;
    // the sub-chunk's own scan from 0, and its running products
    float hl[C], pa[C];
    float x = 0.0f, p = 1.0f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const float av = ta[i * W];
      x = fmaf(av, x, tb[i * W]);
      p *= av;
      hl[i] = x;
      pa[i] = p;
    }
    // inclusive scan of the S aggregates (p, x) of this channel
#pragma unroll
    for (int off = 1; off < S; off <<= 1) {
      const float pn = __shfl_up_sync(FULL, p, off, S);
      const float xn = __shfl_up_sync(FULL, x, off, S);
      if (s >= off) {
        x = fmaf(p, xn, x);
        p *= pn;
      }
    }
    float pe = __shfl_up_sync(FULL, p, 1, S);
    float xe = __shfl_up_sync(FULL, x, 1, S);
    if (s == 0) {
      pe = 1.0f;
      xe = 0.0f;
    }
    const float h_in = fmaf(pe, carry, xe);  // this sub-chunk's carry-in
    carry = fmaf(__shfl_sync(FULL, p, S - 1, S), carry,
                 __shfl_sync(FULL, x, S - 1, S));
#pragma unroll
    for (int i = 0; i < C; ++i) tb[i * W] = fmaf(pa[i], h_in, hl[i]);
    __syncthreads();
    const float* th = sb + (k % NST) * T::FLOATS;
    for_tile<W, C, VEC>(k * L, row0, t_len, d, d0,
                        [&](int r, int col, long long off, bool ok) {
                          if (!ok) return;
                          const int o = T::at(r, col);
                          if constexpr (VEC == 4)
                            *reinterpret_cast<float4*>(h + off) =
                                *reinterpret_cast<const float4*>(th + o);
                          else
                            h[off] = th[o];
                        });
  }
  cp_async_wait<0>();
}

// C is a parameter so that tools/b4_sweep.py can time other row counts;
// the library takes C_ROWS only.
template <int W, int NST, int VEC, int C = C_ROWS>
int launch(const float* a, const float* b, float* h, int bsz, int t_len,
           int d, cudaStream_t st) {
  constexpr int smem = 2 * NST * Tile<W, C>::FLOATS * (int)sizeof(float);
  // per call: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_kernel<W, NST, VEC, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int d_tiles = (d + W - 1) / W;
  const long long blocks = (long long)bsz * d_tiles;
  ssm_scan_kernel<W, NST, VEC, C><<<(unsigned)blocks, W * S, smem, st>>>(
      a, b, h, t_len, d, d_tiles);
  return (int)cudaGetLastError();
}

// W and NST from the grid (see "Why these numbers" above).
template <int VEC>
int launch_for(int sms, const float* a, const float* b, float* h, int bsz,
               int t_len, int d, cudaStream_t st) {
  if ((long long)bsz * ((d + 31) / 32) >= 2LL * sms)
    return launch<32, 3, VEC>(a, b, h, bsz, t_len, d, st);
  return launch<16, 4, VEC>(a, b, h, bsz, t_len, d, st);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return sms;
}

}  // namespace

// a, b, h: (bsz, t_len, d) contiguous f32.  Returns cudaGetLastError().
extern "C" int ssm_scan(const void* a, const void* b, void* h, int bsz,
                        int t_len, int d, void* stream) {
  if ((long long)bsz * d <= 0 || t_len <= 0) return (int)cudaGetLastError();
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  auto* fh = static_cast<float*>(h);
  auto* st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(h)) & 15) == 0;
  const int sms = sm_count();
  return vec ? launch_for<4>(sms, fa, fb, fh, bsz, t_len, d, st)
             : launch_for<1>(sms, fa, fb, fh, bsz, t_len, d, st);
}

// The blocking that fixes the order of the arithmetic: the time tile's
// rows (L) and the thread groups a channel (S).  kernels/ssm_scan.py's
// TILE and GROUPS must equal them (tests/test_torch_gpu.py checks).
extern "C" int ssm_scan_tile() { return S * C_ROWS; }
extern "C" int ssm_scan_groups() { return S; }
