// B4 — diagonal linear recurrence (SSM scan), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py:29
// (`_scan_kernel`, launched by `ssm_scan_pallas` :51):
//     h[b, t, d] = a[b, t, d] * h[b, t-1, d] + b[b, t, d],   h[b, -1, d] = 0
// over a, b, h of shape (B, T, D), f32, row-major.
//
// The TPU kernel runs a blocked associative scan inside a time block and
// carries the block's last state to the next grid step in VMEM scratch,
// which works because a TPU walks its grid in order.  Blocks on the card
// run in no order, so the carry lives in a register instead: one thread
// owns one (b, d) channel and walks T itself.  The channels are
// independent, so no block ever waits on another, and any T works (the
// TPU wrapper needs T divisible by its time block; this kernel does not).
//
// Bound on the card: bytes.  Each element of a and b is read once and h
// written once (12 B per element, 2 FLOP), far below the FP32 rate.
// Design response: threads of a warp own neighbouring d, so every load
// and store along D is coalesced; the loop over T is unrolled by UNROLL
// steps whose a/b loads all start before the dependent FMAs, which
// keeps UNROLL loads in flight per thread.  At the serving shape
// (B·D = 40,960 channels) that is enough memory parallelism to fill the
// 132 SMs; a chunked two-pass scan over T would be the next step when
// B·D is small.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ h, int bsz, int t_len, int d) {
  const long long ch = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (ch >= (long long)bsz * d) return;
  const long long bi = ch / d;
  const long long di = ch - bi * d;
  const long long base = bi * (long long)t_len * d + di;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float carry = 0.0f;
  int t0 = 0;
  for (; t0 + UNROLL <= t_len; t0 += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = (long long)(t0 + u) * d;
      av[u] = __ldg(ap + off);
      bv[u] = __ldg(bp + off);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      carry = fmaf(av[u], carry, bv[u]);
      hp[(long long)(t0 + u) * d] = carry;
    }
  }
  for (; t0 < t_len; ++t0) {  // the ragged tail of T
    const long long off = (long long)t0 * d;
    carry = fmaf(__ldg(ap + off), carry, __ldg(bp + off));
    hp[off] = carry;
  }
}

}  // namespace

// a, b, h: (bsz, t_len, d) contiguous f32.  Returns cudaGetLastError().
extern "C" int ssm_scan(const void* a, const void* b, void* h, int bsz,
                        int t_len, int d, void* stream) {
  const long long channels = (long long)bsz * d;
  if (channels > 0 && t_len > 0) {
    const long long blocks = (channels + THREADS - 1) / THREADS;
    ssm_scan_kernel<<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(h), bsz, t_len, d);
  }
  return (int)cudaGetLastError();
}
