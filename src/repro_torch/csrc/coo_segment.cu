// B3 — semiring segment ⊕-reduce over COO ids, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/coo_segment.py:38
// (`_kernel`, launched by `segment_reduce_pallas` :64):
//     out[s, b] = ⊕_{i : ids[i] = s} vals[i, b]
// with ids outside [0, n) (the COO padding sentinels) dropped.  ⊕ is
// `or` for bool, min for trop, max for maxplus and + for nat/real.
//
// The TPU kernel sorts the edges into output blocks because a TPU has
// no efficient scatter.  Hopper has fast global atomics, so this kernel
// is the plain scatter: one thread per (edge, lane), no sort, no
// scratch.  Payloads are (m,) or (m, B) row-major (the batched SpMM
// rows of contract.spmm reach the kernel too).
//
//   bool      a plain store of 1 — every racing writer stores the same
//             byte, so no atomic is needed;
//   trop      float atomicMin through the ordered-int trick: with the
//             sign bit clear the IEEE bits order like signed ints
//             (atomicMin on int), with it set they order reversed as
//             unsigned (atomicMax on unsigned); ±inf and -0.0 fall out
//             of the same orderings;
//   maxplus   float atomicMax, mirror image;
//   nat/real  atomicAdd (real sums therefore vary in order run to run).
//
// Bound on the card: bytes.  Each element reads 4 B of id (shared by
// the B lanes) and 1–4 B of value and issues at most one store or
// atomic; there is no arithmetic to speak of.  Design response: lanes
// of one edge are adjacent threads, so value loads and the output row
// update are coalesced; identity values (0̄) are skipped before the
// atomic, which removes most traffic on sparse frontiers.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

enum Mode { kBool = 0, kTrop = 1, kMaxPlus = 2, kSum = 3 };

// Sign bit clear: IEEE bits order like signed ints; set (including -0.0
// and -inf): they order reversed as unsigned ints.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

template <typename T>
__global__ void fill_kernel(T* out, long long count, T value) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < count; i += stride) out[i] = value;
}

__global__ void scatter_bool(const uint8_t* __restrict__ vals,
                             const int* __restrict__ ids,
                             uint8_t* __restrict__ out, long long total,
                             int lanes, int n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < total; i += stride) {
    if (!vals[i]) continue;
    long long e = i / lanes;
    int s = ids[e];
    if (s < 0 || s >= n) continue;
    out[(long long)s * lanes + (i - e * lanes)] = 1;
  }
}

template <int MODE>
__global__ void scatter_float(const float* __restrict__ vals,
                              const int* __restrict__ ids,
                              float* __restrict__ out, long long total,
                              int lanes, int n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < total; i += stride) {
    float v = vals[i];
    if (MODE == kTrop && v == INFINITY) continue;
    if (MODE == kMaxPlus && v == -INFINITY) continue;
    if (MODE == kSum && v == 0.0f) continue;
    long long e = i / lanes;
    int s = ids[e];
    if (s < 0 || s >= n) continue;
    float* dst = out + (long long)s * lanes + (i - e * lanes);
    if (MODE == kTrop) {
      atomic_min_float(dst, v);
    } else if (MODE == kMaxPlus) {
      atomic_max_float(dst, v);
    } else {
      atomicAdd(dst, v);
    }
  }
}

int grid_for(long long count, int threads) {
  long long blocks = (count + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  const long long cap = 132LL * 32;  // a few waves of the 132 SMs
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace

// vals (m, lanes) contiguous, ids (m,) int32, out (n, lanes) — written
// completely (0̄ first, then the scatter).  Returns cudaGetLastError().
extern "C" int coo_segment_reduce(int mode, const void* vals, const void* ids,
                                  void* out, long long m, int lanes, int n,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  long long out_count = (long long)n * lanes;
  long long total = m * lanes;
  const int* id = static_cast<const int*>(ids);
  if (mode == kBool) {
    uint8_t* o = static_cast<uint8_t*>(out);
    if (out_count > 0)
      fill_kernel<uint8_t><<<grid_for(out_count, threads), threads, 0, st>>>(
          o, out_count, (uint8_t)0);
    if (total > 0)
      scatter_bool<<<grid_for(total, threads), threads, 0, st>>>(
          static_cast<const uint8_t*>(vals), id, o, total, lanes, n);
    return (int)cudaGetLastError();
  }
  float* o = static_cast<float*>(out);
  const float* v = static_cast<const float*>(vals);
  float zero = mode == kTrop ? INFINITY : (mode == kMaxPlus ? -INFINITY : 0.0f);
  if (out_count > 0)
    fill_kernel<float><<<grid_for(out_count, threads), threads, 0, st>>>(
        o, out_count, zero);
  if (total > 0) {
    int g = grid_for(total, threads);
    if (mode == kTrop)
      scatter_float<kTrop><<<g, threads, 0, st>>>(v, id, o, total, lanes, n);
    else if (mode == kMaxPlus)
      scatter_float<kMaxPlus><<<g, threads, 0, st>>>(v, id, o, total, lanes, n);
    else
      scatter_float<kSum><<<g, threads, 0, st>>>(v, id, o, total, lanes, n);
  }
  return (int)cudaGetLastError();
}
