// The f32 SIMT pieces of B5's wide_simt route (128 < D ≤ 256), shared by
// its forward (flash_attention.cu, flash_wide_simt) and its backward
// (flash_attention_bwd.cu, flash_bwd_dq_wide and flash_bwd_dkdv_wide):
// the tile geometry, the float4 dot and axpy, and the staging of row
// tiles into shared memory.
//
// A block is 4 warps; warp w owns RW rows of the block's OWN (queries, or
// keys in dkdv).  The streamed operand comes in tiles of TILE rows, one a
// lane for the scores; for the products a lane holds the float4 columns
// lane, lane + 32 of a row, NV of them up to DMAX.
#pragma once

namespace wide_simt {

constexpr int THREADS = 128;             // 4 warps
constexpr int DMAX = 256;                // most head channels
constexpr int RW = 4;                    // a warp's own rows
constexpr int OWN = THREADS / 32 * RW;   // a block's own rows
constexpr int TILE = 32;                 // streamed rows a tile, one a lane
constexpr int NV = DMAX / 128;           // float4 columns a lane

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// s + a · b over the four lanes of the vectors, in order x, y, z, w
__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// acc += a · x
__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// acc *= a
__device__ __forceinline__ void scale4(float4& acc, float a) {
  acc.x *= a;
  acc.y *= a;
  acc.z *= a;
  acc.w *= a;
}

// rows [r0, r0 + n) of a row-major matrix (rows rs floats apart, those
// below `end` real) into shared rows sd floats apart, times `mul`;
// columns past d and rows past end are 0.  16-byte loads when vec (the
// rows' starts and d are multiples of 4 floats, dp of 4 too)
__device__ __forceinline__ void stage(float* dst, int sd, const float* src,
                                      long long rs, int r0, int n, int end,
                                      int d, int dp, int vec, float mul) {
  if (vec) {
    const int dp4 = dp / 4;
    for (int i = threadIdx.x; i < n * dp4; i += THREADS) {
      const int r = i / dp4, c = 4 * (i - r * dp4);
      float4 x = zero4();
      if (r0 + r < end && c < d) {
        x = *reinterpret_cast<const float4*>(src + (r0 + r) * rs + c);
        scale4(x, mul);
      }
      *reinterpret_cast<float4*>(dst + r * sd + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < n * dp; i += THREADS) {
      const int r = i / dp, c = i - r * dp;
      dst[r * sd + c] =
          r0 + r < end && c < d ? src[(r0 + r) * rs + c] * mul : 0.0f;
    }
  }
}

}  // namespace wide_simt
