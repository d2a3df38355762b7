// Tensor-core and async-copy pieces shared by B5's forward
// (flash_attention.cu, prefill_tc and decode_split) and its backward
// (flash_attention_bwd.cu, dkdv and dq): the 3xTF32 split, the
// `mma.sync.m16n8k8` TF32 product, `cp.async` copies and the staging of
// two row tiles a few copies at a time (RowCopy).
//
// Fragment layout used with mma_tf32 (g = lane / 4, t = lane % 4): the k
// index of each product is permuted (column t ↔ 2t, t + 4 ↔ 2t + 1, in
// both operands), so that an A fragment pair (a0, a2) or a B fragment
// (b0, b1) is one 8-byte load of columns 2t, 2t + 1 of a row, and an f32
// accumulator (c0 c1 / c2 c3: rows g / g + 8, columns 2t, 2t + 1) is
// already the A fragment {c0, c2, c1, c3} of a product that sums over its
// columns.
#pragma once

#include <stdint.h>

namespace tf32_mma {

// x as a TF32 pair: hi = x with its low 13 mantissa bits cleared (TF32
// rounded toward zero) and lo = x − hi, exact in f32, of which the tensor
// core reads the top 19 bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row stride (floats) of a tile read as 8-byte fragment pairs, row g (or
// a permutation of g within 8) and columns 2t, 2t + 1: 8·m floats, m the
// least odd number above NT, so that the loads of a half-warp,
// (g·stride/2 + t) mod 16, hit 16 distinct bank pairs; a tile that is
// also read as one float at row 2t-ish and column g needs the rows it
// reads in one load to differ mod 4 (flash_attention_bwd.cu's π)
template <int NT>
__host__ __device__ constexpr int frag_stride() {
  return 8 * (NT % 2 ? NT + 2 : NT + 1);
}

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

// The async copies of two tiles of ROWS rows each (rows [k0, k0 + ROWS)
// of two matrices that share their row index — K and V, or Q and dO —
// `sk` / `sv` floats apart in shared memory; rows at or past `end` and
// columns at or past d zero-filled up to dp), made by a block of NTHREADS
// threads and issued a few at a time so that they interleave with the
// MMAs of the tile before (issued all at once they fill the load queue
// and stall every warp of the block).  vec: 16-byte copies (bases,
// strides and d multiples of 4 floats), else 4-byte ones.
template <int ROWS, int NTHREADS>
struct RowCopy {
  const float* kg;
  const float* vg;
  long long krs, vrs;  // row strides
  int sk, sv, d, w;    // w: copies a row
  bool vec;
  int r0, c0, sr, sc;  // this thread's first copy; the step to its next
  float* kd;
  float* vd;
  int k0, end, r, c;   // the tile being copied; this thread's next copy

  __device__ RowCopy(const float* kg_, long long krs_, const float* vg_,
                     long long vrs_, int sk_, int sv_, int d_, int dp,
                     bool vec_)
      : kg(kg_), vg(vg_), krs(krs_), vrs(vrs_), sk(sk_), sv(sv_), d(d_),
        w(vec_ ? dp / 4 : dp), vec(vec_), kd(nullptr), vd(nullptr), k0(0),
        end(0), r(ROWS), c(0) {
    r0 = threadIdx.x / w;
    c0 = threadIdx.x % w;
    sr = NTHREADS / w;
    sc = NTHREADS % w;
  }
  // copies a thread issues for one tile, at most
  __device__ int steps() const {
    return (ROWS * w + NTHREADS - 1) / NTHREADS;
  }
  __device__ void start(float* kd_, float* vd_, int k0_, int end_) {
    kd = kd_;
    vd = vd_;
    k0 = k0_;
    end = end_;
    r = r0;
    c = c0;
  }
  __device__ void issue(int n) {
    for (; n > 0 && r < ROWS; --n) {
      const int key = k0 + r;
      if (vec) {
        const bool ok = key < end && 4 * c < d;
        cp_async16(kd + r * sk + 4 * c, ok ? kg + key * krs + 4 * c : kg,
                   ok);
        cp_async16(vd + r * sv + 4 * c, ok ? vg + key * vrs + 4 * c : vg,
                   ok);
      } else {
        const bool ok = key < end && c < d;
        cp_async4(kd + r * sk + c, ok ? kg + key * krs + c : kg, ok);
        cp_async4(vd + r * sv + c, ok ? vg + key * vrs + c : vg, ok);
      }
      r += sr;
      c += sc;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
  }
  __device__ void finish() { issue(ROWS * w); }
};

}  // namespace tf32_mma
