// B2 — dense semiring matrix product C = A ⊕.⊗ B, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/semiring_matmul.py:35
// (`_dot_kernel`, (+,×) and (∨,∧) on the MXU) and :52 (`_trop_kernel`,
// (min,+)/(max,+) as a broadcast-reduce on the VPU), both launched by
// `semiring_matmul_pallas` :81.  These are the dense rule-body joins of
// the engine (Π₁'s dense_gsn/dense_naive strata) and the vector_dense
// runner's rounds (Π₂, one row per source).
//
// Three paths under one dispatch (`plan_matmul` in
// kernels/semiring_matmul.py picks the path and its grid):
//
// * tc_bool — 𝔹 at m > M_STREAM, on tensor cores.  Bound: operations,
//   2·m·n·k over the int8 tensor-core rate (1,979 TOP/s; 0.069 ms at
//   4096³).  The torch.bool storage is read in place as 0/1 bytes and
//   multiplied exactly with `mma.sync.m16n8k32` u8·u8→s32 (counts stay
//   exact for any k < 2³¹); the epilogue writes `count > 0` as bool
//   bytes, so there is no f32 copy, no f32 C and no threshold pass.
//   The u8 MMA wants B K-major and sm_90's `ldmatrix.trans` moves only
//   16-bit elements, so the kernel reads Bᵀ: A and Bᵀ are then both
//   "rows of K bytes", staged by the same 16-byte `cp.async` code into a
//   4-stage ring (128×64-byte slabs, XOR-swizzled 16-byte chunks so
//   `ldmatrix` is conflict-free) and read with non-transposed
//   `ldmatrix.x4`.  When B arrives as a `.t()` view, Bᵀ is B's own
//   storage; otherwise a 64×64-tile byte transpose writes it to scratch
//   first (2·k·n bytes: 0.010 ms at 4096² at the HBM rate, against
//   ≈0.12 ms for PyTorch's strided copy).  128×128 block tile, 8 warps
//   of 64×32, two blocks per SM.
// * stream — any semiring at m ≤ M_STREAM (Π₂'s m = 1 rounds).  Bound:
//   bytes, B read once (𝔹 1×4096×4096: 16.8 MB, 0.005 ms).  Each thread
//   owns adjacent columns (16 𝔹 bytes or 4 floats: one 16-byte load per
//   B row) and folds all ≤ M_STREAM rows of A, kept in shared memory,
//   in registers (𝔹 as an AND-mask/OR on whole words); 8 B rows are
//   loaded before they are folded.  The grid is column strips × K
//   splits, at least two waves of 132 SMs; partials (splits, m, width)
//   go to scratch and a second kernel folds the splits in a fixed order
//   (a warp per output chunk: lane l takes splits l, l+32, …, then a
//   fixed xor tree), so `real` sums are the same from run to run.
// * tile_f32 — nat, real, trop, maxplus at m > M_STREAM.  Bound:
//   operations, 2·m·n·k over 67 TFLOP/s FP32 SIMT (2.05 ms at 4096³);
//   min/max-plus issue two instructions per (i,j,k) (add, then min/max),
//   so their SIMT issue floor is twice that.  128×128 block tile, 256
//   threads each holding an 8×8 register tile (two 4-wide row and
//   column groups 64 apart, so shared loads are conflict-free float4s),
//   A staged transposed, `cp.async` double-buffering the next 16-deep K
//   slab.  Still f32 FMA without TF32: nat counts stay exact to 2²⁴.
//
// Padding follows the reference (:96-99): an element beyond k is 0̄ in
// both operands (0 for the dot family, +inf for min-plus, -inf for
// max-plus), so a padded k never wins the ⊕.  min/max propagate NaN
// (`min.NaN`), as the reference's reductions do.
//
// Every entry point returns cudaGetLastError(); the wrapper raises on
// anything but 0.  Nothing here allocates: scratch comes from the
// wrapper.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Mode { kDot = 0, kMinPlus = 1, kMaxPlus = 2, kOr = 3 };

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// small device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src-size 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int MODE>
__device__ __forceinline__ float pad_value() {
  return MODE == kMinPlus ? INFINITY : (MODE == kMaxPlus ? -INFINITY : 0.0f);
}

// acc ⊕ (a ⊗ b)
template <int MODE>
__device__ __forceinline__ float combine(float acc, float a, float b) {
  if (MODE == kMinPlus) return min_nan(acc, a + b);
  if (MODE == kMaxPlus) return max_nan(acc, a + b);
  return fmaf(a, b, acc);
}

// a ⊕ b
template <int MODE>
__device__ __forceinline__ float oplus(float a, float b) {
  if (MODE == kMinPlus) return min_nan(a, b);
  if (MODE == kMaxPlus) return max_nan(a, b);
  return a + b;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// tc_bool: 𝔹 on tensor cores (mma.sync m16n8k32 u8·u8 → s32)
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64, TC_STAGES = 4;
constexpr int TC_TILE = TC_BM * TC_BK;            // bytes of one A or B slab
constexpr int TC_SMEM = TC_STAGES * 2 * TC_TILE;  // 64 KB
constexpr int TC_CPITCH = TC_BN + 16;             // epilogue row pitch

// byte offset of 16-byte chunk c (0..3) of slab row r: chunks XOR-swizzled
// by (r/2)%4, so the 8 rows one ldmatrix phase reads hit 8 bank groups
__device__ __forceinline__ int tc_swz(int r, int c) {
  return r * TC_BK + ((c ^ ((r >> 1) & 3)) << 4);
}

// Stage rows [row0, row0+128) × bytes [k0, k0+64) of a row-major
// (rows, K) byte matrix.  vec: K % 16 == 0 and the base is 16-byte
// aligned, so every chunk is wholly inside or outside and goes by
// cp.async (zero-filled outside); otherwise masked byte loads.
__device__ __forceinline__ void tc_stage(uint8_t* s, const uint8_t* g,
                                         int rows, int K, int row0, int k0,
                                         bool vec) {
#pragma unroll
  for (int i = threadIdx.x; i < TC_BM * 4; i += THREADS) {
    const int r = i >> 2, c = i & 3;
    const int gr = row0 + r, gk = k0 + c * 16;
    uint8_t* dst = s + tc_swz(r, c);
    if (vec) {
      const bool in = gr < rows && gk < K;
      cp_async16(dst, in ? g + (size_t)gr * K + gk : g, in);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (gr < rows) {
        const uint8_t* src = g + (size_t)gr * K;
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (gk + b < K) w[b >> 2] |= (uint32_t)src[gk + b] << ((b & 3) * 8);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A (M, K) and Bt (N, K) row-major 0/1 bytes; C (M, N) bool bytes.
__global__ void __launch_bounds__(THREADS, 2)
semiring_mm_tc_bool(const uint8_t* __restrict__ A,
                    const uint8_t* __restrict__ Bt, uint8_t* __restrict__ C,
                    int M, int N, int K, int vec_in, int vec_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* As = smem;
  uint8_t* Bs = smem + TC_STAGES * TC_TILE;
  const int row0 = blockIdx.y * TC_BM, col0 = blockIdx.x * TC_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2;  // 64-row half of the tile
  const int wn = warp & 3;   // 32-column quarter
  const int q = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix, row

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = (K + TC_BK - 1) / TC_BK;
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < KT) {
      tc_stage(As + s * TC_TILE, A, M, K, row0, s * TC_BK, vec_in);
      tc_stage(Bs + s * TC_TILE, Bt, N, K, col0, s * TC_BK, vec_in);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // slab kt landed; slab kt-1's readers are done
    const int nk = kt + TC_STAGES - 1;
    if (nk < KT) {
      const int st = nk % TC_STAGES;
      tc_stage(As + st * TC_TILE, A, M, K, row0, nk * TC_BK, vec_in);
      tc_stage(Bs + st * TC_TILE, Bt, N, K, col0, nk * TC_BK, vec_in);
    }
    cp_async_commit();
    const uint8_t* as = As + (kt % TC_STAGES) * TC_TILE;
    const uint8_t* bs = Bs + (kt % TC_STAGES) * TC_TILE;
#pragma unroll
    for (int ks = 0; ks < TC_BK / 32; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // matrices: (rows 0-7, k 0-15) (rows 8-15, k 0-15)
        //           (rows 0-7, k 16-31) (rows 8-15, k 16-31)
        const int r = wm * 64 + mi * 16 + r8 + (q & 1) * 8;
        ldmatrix_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                    as + tc_swz(r, ks * 2 + (q >> 1)));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: (n 0-7, k 0-15) (n 0-7, k 16-31)
        //           (n 8-15, k 0-15) (n 8-15, k 16-31)
        const int r = wn * 32 + nj * 16 + r8 + (q >> 1) * 8;
        ldmatrix_x4(bf[2 * nj][0], bf[2 * nj][1], bf[2 * nj + 1][0],
                    bf[2 * nj + 1][1], bs + tc_swz(r, ks * 2 + (q & 1)));
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_u8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: count > 0 as bytes into shared memory, then 16-byte rows out
  uint8_t* Cs = smem;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm * 64 + mi * 16 + g, c = wn * 32 + ni * 8 + t * 2;
      Cs[r * TC_CPITCH + c] = acc[mi][ni][0] > 0;
      Cs[r * TC_CPITCH + c + 1] = acc[mi][ni][1] > 0;
      Cs[(r + 8) * TC_CPITCH + c] = acc[mi][ni][2] > 0;
      Cs[(r + 8) * TC_CPITCH + c + 1] = acc[mi][ni][3] > 0;
    }
  __syncthreads();
  for (int i = threadIdx.x; i < TC_BM * (TC_BN / 16); i += THREADS) {
    const int r = i / (TC_BN / 16), c = (i % (TC_BN / 16)) * 16;
    const int gr = row0 + r, gc = col0 + c;
    if (gr >= M) continue;
    const uint8_t* src = Cs + r * TC_CPITCH + c;
    uint8_t* dst = C + (size_t)gr * N + gc;
    if (vec_out && gc + 16 <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int b = 0; b < 16 && gc + b < N; ++b) dst[b] = src[b];
    }
  }
}

// Bᵀ for tc_bool: (K, N) row-major bytes → (N, K), through a 64×64 tile
// in shared memory (byte loads and stores, each warp's 32 adjacent).
constexpr int TR = 64;

__global__ void __launch_bounds__(THREADS)
semiring_mm_transpose_bytes(const uint8_t* __restrict__ B,
                            uint8_t* __restrict__ Bt, int K, int N) {
  __shared__ uint8_t tile[TR][TR + 1];
  const int x = threadIdx.x % TR, y = threadIdx.x / TR;  // 64 × 4 threads
  const int k0 = blockIdx.y * TR, n0 = blockIdx.x * TR;
#pragma unroll
  for (int r = y; r < TR; r += THREADS / TR)
    if (k0 + r < K && n0 + x < N)
      tile[r][x] = B[(size_t)(k0 + r) * N + n0 + x];
  __syncthreads();
#pragma unroll
  for (int r = y; r < TR; r += THREADS / TR)
    if (n0 + r < N && k0 + x < K)
      Bt[(size_t)(n0 + r) * K + k0 + x] = tile[x][r];
}

// ---------------------------------------------------------------------------
// tile_f32: 128×128 SIMT tile for the f32 semirings
// ---------------------------------------------------------------------------

constexpr int F_BM = 128, F_BN = 128, F_BK = 16;

// A slab [k0, k0+16) of rows row0..+127 into registers: thread owns row
// tid % 128 and two 4-wide K quads, read as float4 where whole and
// aligned (vec_a), else element by element; 0̄ outside the matrix.
template <int MODE>
__device__ __forceinline__ void f_load_a(float4 (&ra)[2],
                                         const float* __restrict__ A, int M,
                                         int K, int row0, int k0,
                                         bool vec_a) {
  const float pad = pad_value<MODE>();
  const int gr = row0 + (threadIdx.x & (F_BM - 1));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gk = k0 + ((threadIdx.x >> 7) * 2 + h) * 4;
    const float* src = A + (size_t)gr * K + gk;
    if (gr < M && vec_a && gk + 4 <= K) {
      ra[h] = __ldg(reinterpret_cast<const float4*>(src));
    } else {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = gr < M && gk + j < K ? __ldg(src + j) : pad;
      ra[h] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// the registers of f_load_a, transposed into As[k][r] (32 consecutive
// rows a warp: conflict-free)
__device__ __forceinline__ void f_store_a(float (*As)[F_BM],
                                          const float4 (&ra)[2]) {
  const int r = threadIdx.x & (F_BM - 1), q = (threadIdx.x >> 7) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    As[(q + h) * 4 + 0][r] = ra[h].x;
    As[(q + h) * 4 + 1][r] = ra[h].y;
    As[(q + h) * 4 + 2][r] = ra[h].z;
    As[(q + h) * 4 + 3][r] = ra[h].w;
  }
}

// B slab [k0, k0+16) of columns col0..+127 into Bs by 16-byte cp.async
// where whole and aligned (vec_b), else 4-byte copies; 0̄ outside.
template <int MODE>
__device__ __forceinline__ void f_stage_b(float (*Bs)[F_BN],
                                          const float* __restrict__ B, int N,
                                          int K, int col0, int k0,
                                          bool vec_b) {
  const float pad = pad_value<MODE>();
#pragma unroll
  for (int i = threadIdx.x; i < F_BK * F_BN / 4; i += THREADS) {
    const int kk = i / (F_BN / 4), c = (i % (F_BN / 4)) * 4;
    const int gk = k0 + kk, gc = col0 + c;
    float* dst = &Bs[kk][c];
    if (vec_b && gk < K && gc + 4 <= N) {
      cp_async16(dst, B + (size_t)gk * N + gc, true);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gk < K && gc + j < N)
          cp_async4(dst + j, B + (size_t)gk * N + gc + j);
        else
          dst[j] = pad;
      }
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
semiring_mm_tile_f32(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ C, int M, int N, int K, int vec_a,
                     int vec_b, int vec_c) {
  __shared__ __align__(16) float As[2][F_BK][F_BM];
  __shared__ __align__(16) float Bs[2][F_BK][F_BN];
  const float pad = pad_value<MODE>();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.y * F_BM, col0 = blockIdx.x * F_BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = pad;

  // slab kt+1 is in flight (A in registers, B by cp.async) while slab
  // kt is folded; one barrier a slab
  const int KT = (K + F_BK - 1) / F_BK;
  float4 ra[2];
  if (KT > 0) {
    f_load_a<MODE>(ra, A, M, K, row0, 0, vec_a);
    f_stage_b<MODE>(Bs[0], B, N, K, col0, 0, vec_b);
    cp_async_commit();
    f_store_a(As[0], ra);
  }
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    cp_async_wait<0>();
    __syncthreads();  // slab kt landed; slab kt-1's readers are done
    const bool more = kt + 1 < KT;
    if (more) {
      f_load_a<MODE>(ra, A, M, K, row0, (kt + 1) * F_BK, vec_a);
      f_stage_b<MODE>(Bs[buf ^ 1], B, N, K, col0, (kt + 1) * F_BK, vec_b);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = combine<MODE>(acc[i][j], a[i], b[j]);
    }
    if (more) f_store_a(As[buf ^ 1], ra);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gr >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = col0 + h * 64 + tx * 4;
      float* dst = C + (size_t)gr * N + gc;
      if (vec_c && gc + 4 <= N) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                        acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < N) dst[j] = acc[i][h * 4 + j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// stream: m ≤ M_STREAM rows, B read once
// ---------------------------------------------------------------------------

constexpr int S_KCH = 256;  // K rows of A staged in shared memory at a time
constexpr int S_U = 8;      // B rows loaded before they are folded
constexpr int S_MAX_ROWS = 16;

// 16 𝔹 bytes of B row `row` at `col` (0 outside the matrix)
__device__ __forceinline__ uint4 load_b_bool(const uint8_t* __restrict__ B,
                                             int row, int col, int N,
                                             bool in_k, bool vec) {
  if (!in_k) return make_uint4(0u, 0u, 0u, 0u);
  const uint8_t* src = B + (size_t)row * N + col;
  if (vec && col + 16 <= N) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (col + b < N) w[b >> 2] |= (uint32_t)__ldg(src + b) << ((b & 3) * 8);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 4 floats of B row `row` at `col` (0̄ outside the matrix)
__device__ __forceinline__ float4 load_b_f32(const float* __restrict__ B,
                                             int row, int col, int N,
                                             bool in_k, bool vec, float pad) {
  if (!in_k) return make_float4(pad, pad, pad, pad);
  const float* src = B + (size_t)row * N + col;
  if (vec && col + 4 <= N) return __ldg(reinterpret_cast<const float4*>(src));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = col + j < N ? __ldg(src + j) : pad;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Block (strip, split): columns [strip·256·16 + 16·tid, +16) over K rows
// [split·kc, +kc); partial (split, i, ·) of width `width` written whole.
template <int MT>
__global__ void __launch_bounds__(THREADS)
semiring_mm_stream_bool(const uint8_t* __restrict__ A,
                        const uint8_t* __restrict__ B,
                        uint8_t* __restrict__ P, int M, int N, int K, int kc,
                        int width, int vec) {
  __shared__ uint8_t As[MT][S_KCH];
  const int col = (blockIdx.x * THREADS + threadIdx.x) * 16;
  const int kb0 = blockIdx.y * kc, kb1 = min(K, kb0 + kc);
  uint4 acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);

  for (int k0 = kb0; k0 < kb1; k0 += S_KCH) {
    const int kn = min(S_KCH, kb1 - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < MT * S_KCH; i += THREADS) {
      const int r = i / S_KCH, c = i % S_KCH;
      As[r][c] = (r < M && c < kn) ? A[(size_t)r * K + k0 + c] : 0;
    }
    __syncthreads();
    for (int kk = 0; kk < kn; kk += S_U) {
      uint4 bv[S_U];
#pragma unroll
      for (int u = 0; u < S_U; ++u)
        bv[u] = load_b_bool(B, k0 + kk + u, col, N, kk + u < kn, vec);
#pragma unroll
      for (int u = 0; u < S_U; ++u)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint32_t m = As[i][kk + u] ? 0xffffffffu : 0u;
          acc[i].x |= bv[u].x & m;
          acc[i].y |= bv[u].y & m;
          acc[i].z |= bv[u].z & m;
          acc[i].w |= bv[u].w & m;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (i < M)
      *reinterpret_cast<uint4*>(P + ((size_t)blockIdx.y * M + i) * width +
                                col) = acc[i];
}

template <int MODE, int MT>
__global__ void __launch_bounds__(THREADS)
semiring_mm_stream_f32(const float* __restrict__ A,
                       const float* __restrict__ B, float* __restrict__ P,
                       int M, int N, int K, int kc, int width, int vec) {
  __shared__ float As[MT][S_KCH];
  const float pad = pad_value<MODE>();
  const int col = (blockIdx.x * THREADS + threadIdx.x) * 4;
  const int kb0 = blockIdx.y * kc, kb1 = min(K, kb0 + kc);
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = pad;

  for (int k0 = kb0; k0 < kb1; k0 += S_KCH) {
    const int kn = min(S_KCH, kb1 - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < MT * S_KCH; i += THREADS) {
      const int r = i / S_KCH, c = i % S_KCH;
      As[r][c] = (r < M && c < kn) ? A[(size_t)r * K + k0 + c] : pad;
    }
    __syncthreads();
    for (int kk = 0; kk < kn; kk += S_U) {
      float4 bv[S_U];
#pragma unroll
      for (int u = 0; u < S_U; ++u)
        bv[u] = load_b_f32(B, k0 + kk + u, col, N, kk + u < kn, vec, pad);
#pragma unroll
      for (int u = 0; u < S_U; ++u)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float a = As[i][kk + u];
          acc[i][0] = combine<MODE>(acc[i][0], a, bv[u].x);
          acc[i][1] = combine<MODE>(acc[i][1], a, bv[u].y);
          acc[i][2] = combine<MODE>(acc[i][2], a, bv[u].z);
          acc[i][3] = combine<MODE>(acc[i][3], a, bv[u].w);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (i < M)
      *reinterpret_cast<float4*>(P + ((size_t)blockIdx.y * M + i) * width +
                                 col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

constexpr int FOLD_WARPS = THREADS / 32;

// One warp per 16-byte chunk of C: lane l ORs splits l, l+32, … in order,
// then a fixed xor tree; lane 0 writes.
__global__ void __launch_bounds__(THREADS)
semiring_mm_stream_fold_bool(const uint8_t* __restrict__ P,
                             uint8_t* __restrict__ C, int M, int N,
                             int splits, int width, int vec) {
  const int chunk = blockIdx.x * FOLD_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, per_row = width / 16;
  if (chunk >= M * per_row) return;
  const int i = chunk / per_row, col = (chunk % per_row) * 16;
  if (col >= N) return;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  for (int s = lane; s < splits; s += 32) {
    const uint4 p = *reinterpret_cast<const uint4*>(
        P + ((size_t)s * M + i) * width + col);
    v.x |= p.x;
    v.y |= p.y;
    v.z |= p.z;
    v.w |= p.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x |= __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y |= __shfl_xor_sync(0xffffffffu, v.y, off);
    v.z |= __shfl_xor_sync(0xffffffffu, v.z, off);
    v.w |= __shfl_xor_sync(0xffffffffu, v.w, off);
  }
  if (lane != 0) return;
  uint8_t* dst = C + (size_t)i * N + col;
  if (vec && col + 16 <= N) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    for (int b = 0; b < 16 && col + b < N; ++b)
      dst[b] = (uint8_t)(w[b >> 2] >> ((b & 3) * 8));
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
semiring_mm_stream_fold_f32(const float* __restrict__ P, float* __restrict__ C,
                            int M, int N, int splits, int width, int vec) {
  const int chunk = blockIdx.x * FOLD_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, per_row = width / 4;
  if (chunk >= M * per_row) return;
  const int i = chunk / per_row, col = (chunk % per_row) * 4;
  if (col >= N) return;
  const float pad = pad_value<MODE>();
  float v[4] = {pad, pad, pad, pad};
  for (int s = lane; s < splits; s += 32) {
    const float4 p = *reinterpret_cast<const float4*>(
        P + ((size_t)s * M + i) * width + col);
    v[0] = oplus<MODE>(v[0], p.x);
    v[1] = oplus<MODE>(v[1], p.y);
    v[2] = oplus<MODE>(v[2], p.z);
    v[3] = oplus<MODE>(v[3], p.w);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = oplus<MODE>(v[j], __shfl_xor_sync(0xffffffffu, v[j], off));
  if (lane != 0) return;
  float* dst = C + (size_t)i * N + col;
  if (vec && col + 4 <= N) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < 4 && col + j < N; ++j) dst[j] = v[j];
  }
}

template <int MT>
void launch_stream_bool(const void* a, const void* b, void* part, void* c,
                        int m, int n, int k, int kc, int splits, int width,
                        cudaStream_t st) {
  const bool vec_b = n % 16 == 0 && aligned16(b);
  const bool vec_c = n % 16 == 0 && aligned16(c);
  dim3 grid(width / (THREADS * 16), splits);
  semiring_mm_stream_bool<MT><<<grid, THREADS, 0, st>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<uint8_t*>(part), m, n, k, kc, width, vec_b);
  const int chunks = m * (width / 16);
  semiring_mm_stream_fold_bool<<<(chunks + FOLD_WARPS - 1) / FOLD_WARPS,
                                 THREADS, 0, st>>>(
      static_cast<const uint8_t*>(part), static_cast<uint8_t*>(c), m, n,
      splits, width, vec_c);
}

template <int MODE, int MT>
void launch_stream_f32(const void* a, const void* b, void* part, void* c,
                       int m, int n, int k, int kc, int splits, int width,
                       cudaStream_t st) {
  const bool vec_b = n % 4 == 0 && aligned16(b);
  const bool vec_c = n % 4 == 0 && aligned16(c);
  dim3 grid(width / (THREADS * 4), splits);
  semiring_mm_stream_f32<MODE, MT><<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(part), m, n, k, kc, width, vec_b);
  const int chunks = m * (width / 4);
  semiring_mm_stream_fold_f32<MODE><<<(chunks + FOLD_WARPS - 1) / FOLD_WARPS,
                                      THREADS, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(c), m, n, splits,
      width, vec_c);
}

template <int MT>
void launch_stream(int mode, const void* a, const void* b, void* part,
                   void* c, int m, int n, int k, int kc, int splits,
                   int width, cudaStream_t st) {
  if (mode == kOr)
    launch_stream_bool<MT>(a, b, part, c, m, n, k, kc, splits, width, st);
  else if (mode == kMinPlus)
    launch_stream_f32<kMinPlus, MT>(a, b, part, c, m, n, k, kc, splits, width,
                                    st);
  else if (mode == kMaxPlus)
    launch_stream_f32<kMaxPlus, MT>(a, b, part, c, m, n, k, kc, splits, width,
                                    st);
  else
    launch_stream_f32<kDot, MT>(a, b, part, c, m, n, k, kc, splits, width,
                                st);
}

}  // namespace

// 𝔹 on tensor cores.  a (m, k): contiguous 0/1 bytes; bt (n, k): Bᵀ,
// contiguous bytes — as given when transpose == 0, else first written
// here from b (k, n, contiguous).  c (m, n) bool bytes, written
// completely.  The wrapper's plan gives the block tile and grid; a tile
// other than this kernel's, or a grid that does not cover c, is refused
// (cudaErrorInvalidValue) rather than leaving part of c unwritten.
extern "C" int semiring_matmul_tc_bool(const void* a, const void* b, void* bt,
                                       void* c, int m, int n, int k,
                                       int transpose, int tile_m, int tile_n,
                                       int grid_x, int grid_y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (tile_m != TC_BM || tile_n != TC_BN || (long long)grid_x * TC_BN < n ||
      (long long)grid_y * TC_BM < m)
    return (int)cudaErrorInvalidValue;
  // per call: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(
      semiring_mm_tc_bool, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TC_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (transpose && k > 0)
    semiring_mm_transpose_bytes<<<dim3((n + TR - 1) / TR, (k + TR - 1) / TR),
                                  THREADS, 0, st>>>(
        static_cast<const uint8_t*>(b), static_cast<uint8_t*>(bt), k, n);
  const int vec_in = k % 16 == 0 && aligned16(a) && aligned16(bt);
  const int vec_out = n % 16 == 0 && aligned16(c);
  semiring_mm_tc_bool<<<dim3(grid_x, grid_y), THREADS, TC_SMEM, st>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(bt),
      static_cast<uint8_t*>(c), m, n, k, vec_in, vec_out);
  return (int)cudaGetLastError();
}

// f32 semirings (mode 0 dot, 1 min-plus, 2 max-plus).  a (m, k), b (k, n),
// c (m, n): contiguous row-major float32; c written completely.  Tile
// and grid as for semiring_matmul_tc_bool.
extern "C" int semiring_matmul_tile_f32(int mode, const void* a,
                                        const void* b, void* c, int m, int n,
                                        int k, int tile_m, int tile_n,
                                        int grid_x, int grid_y,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  if (tile_m != F_BM || tile_n != F_BN || (long long)grid_x * F_BN < n ||
      (long long)grid_y * F_BM < m)
    return (int)cudaErrorInvalidValue;
  const int vec_a = k % 4 == 0 && aligned16(a);
  const int vec_b = n % 4 == 0 && aligned16(b);
  const int vec_c = n % 4 == 0 && aligned16(c);
  dim3 grid(grid_x, grid_y);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  if (mode == kMinPlus)
    semiring_mm_tile_f32<kMinPlus>
        <<<grid, THREADS, 0, st>>>(A, B, C, m, n, k, vec_a, vec_b, vec_c);
  else if (mode == kMaxPlus)
    semiring_mm_tile_f32<kMaxPlus>
        <<<grid, THREADS, 0, st>>>(A, B, C, m, n, k, vec_a, vec_b, vec_c);
  else
    semiring_mm_tile_f32<kDot>
        <<<grid, THREADS, 0, st>>>(A, B, C, m, n, k, vec_a, vec_b, vec_c);
  return (int)cudaGetLastError();
}

// m ≤ 16 rows, any semiring (mode 0 dot, 1 min-plus, 2 max-plus, 3 𝔹).
// a (m, k), b (k, n) contiguous (𝔹: bytes, else float32); part: scratch
// of (splits, m, width) elements of the operands' type, width a multiple
// of 256 · (16 𝔹 | 4 f32) covering n; c (m, n) written completely.
// Launches the partial kernel on grid (width / (256 · vec), splits), then
// the fold.  A width that is no such multiple or does not cover n, or
// splits that do not cover k, are refused (cudaErrorInvalidValue).
extern "C" int semiring_matmul_stream(int mode, const void* a, const void* b,
                                      void* part, void* c, int m, int n,
                                      int k, int k_per_split, int splits,
                                      int width, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return (int)cudaGetLastError();
  const int strip = THREADS * (mode == kOr ? 16 : 4);
  if (m > S_MAX_ROWS || splits <= 0 || splits > 65535 || k_per_split <= 0 ||
      (long long)splits * k_per_split < k || width < n || width % strip)
    return (int)cudaErrorInvalidValue;
  if (m == 1)
    launch_stream<1>(mode, a, b, part, c, m, n, k, k_per_split, splits, width,
                     st);
  else if (m <= 2)
    launch_stream<2>(mode, a, b, part, c, m, n, k, k_per_split, splits, width,
                     st);
  else if (m <= 4)
    launch_stream<4>(mode, a, b, part, c, m, n, k, k_per_split, splits, width,
                     st);
  else if (m <= 8)
    launch_stream<8>(mode, a, b, part, c, m, n, k, k_per_split, splits, width,
                     st);
  else
    launch_stream<16>(mode, a, b, part, c, m, n, k, k_per_split, splits,
                      width, st);
  return (int)cudaGetLastError();
}
