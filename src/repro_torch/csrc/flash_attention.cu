// B5 — GQA flash attention (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:32
// (`_flash_kernel`, launched by `flash_attention_pallas` :82):
//     o[b,i,h,:] = softmax_j(q[b,i,h]·k[b,j,h/g] / sqrt(D) + mask)·v[b,j,h/g]
// for q (B, Tq, Hq, D) and k, v (B, Tk, Hkv, D), f32, g = Hq / Hkv.
// Query i sits at position q_offset + i, key j at j; the mask keeps
// j <= pos (causal), j > pos - window (sliding window) and
// j / chunk == pos / chunk (chunked attention).  A row with no visible
// key is 0, as in the reference: the running max starts at -1e30 and a
// masked entry gives p = 0 by a test, never by exp of anything.  D is any
// value up to 256 at run time; k and v may be strided views (the serving
// path hands in the written prefix of a (B, Tmax, Hkv, D) KV cache), with
// only D contiguous.
//
// The TPU kernel walks KV blocks as its innermost, sequential grid axis
// and carries the running max, sum and accumulator in VMEM scratch.
// Blocks on the card run in no order, so the KV walk is a loop inside a
// block.  Three paths, picked with their launch geometry by
// `plan_attention` (kernels/flash_attention.py); the entries below
// launch what they are given and refuse (cudaErrorInvalidValue) a tile
// they were not compiled for, a grid that does not cover the queries, or
// splits that do not cover the visible keys.
//
// * prefill_tc — tq·g > 16.  Bound: operations.  4·Tq·Tk_visible·D per
//   head (QKᵀ and PV) at three tensor-core passes each: at the serving
//   prefill (8 × 512 queries, 32 heads of 80, causal) 3 × 1.076e10 at
//   495 TFLOP/s TF32 is 0.065 ms (bytes: 0.050 ms; FP32 SIMT: 0.161).
//   FlashAttention-2's shape: a block is 4 warps of 16 query rows (a
//   64-row q tile).  QKᵀ and PV are `mma.sync.m16n8k8` TF32 products with
//   f32 accumulators; scores, softmax statistics and output stay in
//   registers, Q too (raw, pre-scaled).  K and V tiles of 64 keys (32 for
//   D > 80, to stay in registers) arrive by 16-byte `cp.async` into a
//   two-stage ring; the copies of the next tile are issued a few per
//   k step during this tile's QKᵀ, because issued at once they fill the
//   load queue and stall the warps (a 4-byte branch in the kernel stages
//   views whose base, strides or D are not 16-byte multiples).  Rows past
//   the visible keys and columns past D are zero-filled, D padded to
//   8·NT.  Blocks start heaviest q tile first (the causal diagonal's
//   last), so the short tiles fill the grid's tail.  Tiles that the masks
//   hide from a whole block are never loaded, tiles hidden from a whole
//   warp are skipped by it, and only tiles that straddle a mask edge test
//   each entry, against the row's visible interval of keys.
//   Precision: "3xTF32", as CUTLASS's OpMultiplyAddFastF32 that PyTorch's
//   f32 SDPA runs: each f32 operand x is split into hi, x with its low
//   13 mantissa bits cleared (TF32 toward zero), and lo = x − hi, exact
//   in f32, read by the tensor core to its top 19 bits; a product is
//   hi·hi + hi·lo + lo·hi.  One pass keeps ~11 bits: on a 512-key causal
//   prefill at D = 80 its error is 3–4× the 1e-4 · max|plain| that this
//   repo holds B5 to; three passes come in ~300× under it.  Clearing the
//   bits rather than `cvt.rna.tf32.f32` (round to nearest): lo carries
//   exactly what hi drops, so the split loses only lo's own rounding and
//   the omitted lo·lo (each below 2^-20 of the product), as rna would
//   lose 2^-22; and cvt.rna costs an isfinite test and a select besides
//   its rounding, twice an element.  tests/test_torch_kernels.py emulates
//   both splits and one pass on the CPU.  The split happens as a
//   fragment leaves shared memory, not once when a tile is staged: hi/lo
//   tiles would double the ring (176 KB at D = 80, one block an SM) and
//   the shared-memory bytes of every fragment load, for two ALU
//   instructions an element saved.
//   The three passes go out pass by pass over all of a k step's
//   accumulators, so the MMAs that update one accumulator are never
//   back to back.  Layout: the k index of each MMA is permuted (column t
//   ↔ 2t, t+4 ↔ 2t+1, in both operands), so a Q or K fragment pair is one
//   8-byte load and the score accumulator is already P's A fragment (no
//   shuffles).  Shared rows are padded against bank conflicts: K rows
//   8·m floats apart (m the least odd number > NT: 88 at D = 80) so the
//   8-byte loads of a half-warp, (g·SK/2 + t) mod 16, hit 16 distinct
//   bank pairs; V rows D + 4 apart (84) so the B fragment, (2t·SV + g)
//   mod 32, hits 32 distinct banks, for every NT.
// * decode_split — tq·g ≤ 16 (every decode step).  Bound: bytes, K and V
//   read once: at the serving decode (8 × 1 query over 544 keys, 32 kv
//   heads of 80) 89.1 MB at 3.35 TB/s, 0.027 ms; its 4·D FLOP a key a
//   row are far below the card's FLOP/byte ratio, so plain f32 FMA.
//   A block serves one (split, kv head, batch) and holds all tq·g query
//   rows of that kv head, so each K/V byte is read once, not once per q
//   head.  The visible keys are cut into splits so that the grid has
//   about four blocks per SM (3 splits of 184 keys: 768 blocks at the
//   serving shape).  32-key tiles arrive by 16-byte `cp.async` in a
//   three-stage ring; each warp takes 8 keys of a tile, 4 lanes a key,
//   each lane summing a quarter of D's float4 columns (shared rows D + 4
//   apart: conflict free), keeps its own online softmax, and the 4 warps
//   merge in shared memory at the end.  Each split writes (m, l, acc[D])
//   to scratch the wrapper allocates; a second kernel folds the splits in
//   a fixed order, so a decode repeats bit for bit.  A split a row sees
//   no key of has m = -1e30, l = 0 and adds nothing; a row that sees no
//   key is 0.
// * wide_simt — 128 < D ≤ 256 (Gemma 2's 256-channel heads), prefill and
//   decode alike.  prefill_tc and decode_split hold a row's D columns in
//   registers sized for D ≤ 128; this path is the plain design that is
//   right first: f32 FMA (bound: operations at the FP32 SIMT rate, e.g.
//   0.26 ms for a 2 × 1,024 causal prefill of 16 heads of 256), one warp
//   a query row (4 rows a warp, 16 a block, the rows of one kv head's
//   group so that a K/V tile serves every q head of it), a lane a key of
//   each 32-key tile for the scores and a float4 column pair for P·V.
//   K and V tiles are staged by plain loads, no ring: the kernel waits on
//   every tile.  Its own comment below (flash_wide_simt) has the layout;
//   the tile geometry, the float4 dot and axpy and the staging are
//   wide_simt.cuh's, shared with the backward.
// * wide_chunk — D > 256, any D: wide_simt's rows and lanes, nothing
//   staged in shared memory (K and V read from global memory, through
//   L1 and L2) and D walked for the scores, while a block holds only a
//   256-column chunk of its rows' outputs (a grid over the chunks, each
//   recomputing the scores).  Right first, slow (the same FP32 SIMT
//   bound): no configuration in either package has a head past 256.
//
// Scores are kept in log2 units (q scaled by log2(e)/sqrt(D), exp2).
// On request (a non-null lse pointer) each path also writes every row's
// log-sum-exp for the backward (flash_attention_bwd.cu): in natural-log
// units, lse = ln Σ_j exp(q·k_j / sqrt(D)) over the visible keys, that is
// ln(2) · (m + log2 l) of the row's running max m and sum l; a row with
// no visible key stores -inf.  The writing kernels (prefill_tc and the
// decode fold) are instantiated with and without it (LSE), so a call
// without lse, as serving makes, runs the code it ran before.
// The mask is attention_mask.cuh's, and the TF32 split, the MMA and the
// staged copies are tf32_mma.cuh's, both shared with the backward.
// Every entry point returns cudaGetLastError(); nothing here allocates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mask.cuh"
#include "tf32_mma.cuh"
#include "wide_simt.cuh"

namespace {

using attn_mask::Range;
using tf32_mma::cp_async_commit;
using tf32_mma::cp_async_wait;
using tf32_mma::mma_tf32;
using tf32_mma::split;

constexpr int THREADS = 128;  // 4 warps, every kernel here
constexpr int WARPS = THREADS / 32;
namespace wd = wide_simt;
static_assert(THREADS == wd::THREADS, "wide_simt's block is this file's");
constexpr int DMAX = 128;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

constexpr int PF_BQ = 64;  // prefill_tc: query rows a block, 16 a warp
constexpr int DC_ROWS = 16;   // decode_split: most query rows a block
constexpr int DC_BK = 32;     // decode_split: keys a tile, 8 a warp
constexpr int DC_STAGES = 3;  // decode_split: tiles in the ring

template <int ROWS>
using RowCopy = tf32_mma::RowCopy<ROWS, THREADS>;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int bsz, tq, tk, hq, hkv, d;
  long long kb, kt, kh;  // k strides in elements: batch, seq, head
  long long vb, vt, vh;
  int causal, window, chunk, q_offset;  // window, chunk: 0 = off
  float scale;                          // log2(e) / sqrt(D)
};

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// keys that some query at a position in [pos_lo, pos_hi] can see; for
// pos_lo = pos_hi, the keys that query sees (one interval, whatever the
// masks)
__host__ __device__ __forceinline__ Range seen_by_any(int pos_lo, int pos_hi,
                                                      const Params& p) {
  return attn_mask::keys_seen(pos_lo, pos_hi, p.tk, p.causal, p.window,
                              p.chunk);
}

// keys that every query at a position in [pos_lo, pos_hi] can see
__device__ __forceinline__ Range seen_by_all(int pos_lo, int pos_hi,
                                             const Params& p) {
  return attn_mask::keys_seen_by_all(pos_lo, pos_hi, p.tk, p.causal,
                                     p.window, p.chunk);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// a row's log-sum-exp in natural-log units from its running max m (log2
// units) and sum l; -inf for a row that saw no key
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.0f ? (m + log2f(l)) * LN2 : -INFINITY;
}

// ---------------------------------------------------------------------------
// prefill_tc: 3xTF32 on tensor cores
// ---------------------------------------------------------------------------

// prefill_tc's keys a tile: 64, or 32 for D > 80, where the scores of
// 64 keys and a 128-column output would not fit in registers beside Q
template <int NT>
__host__ __device__ constexpr int pf_bk() {
  return NT <= 10 ? 64 : 32;
}

template <int NT>
constexpr size_t prefill_smem() {
  return sizeof(float) * 2 * pf_bk<NT>() *
         (tf32_mma::frag_stride<NT>() + 8 * NT + 4);
}

// lse: (B, Hq, Tq), written when LSE
template <int NT, bool LSE>
__global__ void __launch_bounds__(THREADS)
    flash_prefill_tc(Params p, int vec, float* lse) {
  constexpr int BK = pf_bk<NT>();
  constexpr int NJ = BK / 8;
  constexpr int DP = 8 * NT;
  constexpr int SK = tf32_mma::frag_stride<NT>();
  constexpr int SV = DP + 4;
  constexpr int G = NT <= 10 ? NT : 4;  // PV column tiles a pass group
  extern __shared__ __align__(16) float smem[];
  float* const ks = smem;                   // [2][BK][SK]
  float* const vs = smem + 2 * BK * SK;  // [2][BK][SV]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // heaviest q tiles first: the last q tile (most keys under a causal
  // mask) of every (head, batch), then the one before, …, so the short
  // tiles fill the tail of the grid
  const int nyz = gridDim.y * gridDim.z;
  const long long lin =
      blockIdx.x + (long long)gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int q0 = (gridDim.x - 1 - (int)(lin / nyz)) * PF_BQ;
  const int h = (int)(lin % nyz) % gridDim.y;
  const int bi = (int)(lin % nyz) / gridDim.y;
  if (q0 >= p.tq) return;
  const int hk = h / (p.hq / p.hkv);
  const int rows_end = imin(q0 + PF_BQ, p.tq);
  const Range kv = seen_by_any(p.q_offset + q0, p.q_offset + rows_end - 1, p);
  const int ntiles = (kv.hi - kv.lo + BK - 1) / BK;

  RowCopy<BK> copy(p.k + bi * p.kb + hk * p.kh, p.kt,
                     p.v + bi * p.vb + hk * p.vh, p.vt, SK, SV, p.d, DP,
                     vec);
  // the next tile's copies go out over the first half of the QKᵀ k steps
  constexpr int HALF = NT / 2;
  const int per_step = (copy.steps() + HALF - 1) / HALF;
  if (ntiles > 0) {
    copy.start(ks, vs, kv.lo, kv.hi);
    copy.finish();
  }
  cp_async_commit();

  // this warp's rows w0 .. w0+15; this thread's are r0 and r0 + 8
  const int w0 = q0 + 16 * warp;
  const bool active = w0 < rows_end;
  const int wpos_lo = p.q_offset + w0;
  const int wpos_hi = p.q_offset + imin(w0 + 16, rows_end) - 1;
  const Range wkv = seen_by_any(wpos_lo, wpos_hi, p);
  const Range wall = seen_by_all(wpos_lo, wpos_hi, p);
  const int r0 = w0 + g, r1 = r0 + 8;
  const Range v0 = seen_by_any(p.q_offset + r0, p.q_offset + r0, p);
  const Range v1 = seen_by_any(p.q_offset + r1, p.q_offset + r1, p);

  // Q as raw A fragments, pre-scaled: a0 (r0, 2t), a1 (r1, 2t),
  // a2 (r0, 2t+1), a3 (r1, 2t+1) of each 8-column k step
  const long long q_row = (long long)p.hq * p.d;
  const float* qb = p.q + (long long)bi * p.tq * q_row + (long long)h * p.d;
  float qf[NT][4];
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1 ? r1 : r0;
      const int c = 8 * kk + 2 * t + (e >> 1);
      qf[kk][e] = r < p.tq && c < p.d ? qb[r * q_row + c] * p.scale : 0.0f;
    }
  }

  float o[NT][4];
#pragma unroll
  for (int nd = 0; nd < NT; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    // tile it has landed, and every warp is done with tile it − 1, whose
    // stage the copies of tile it + 1 now fill
    cp_async_wait<0>();
    __syncthreads();
    const int k0 = kv.lo + it * BK;
    if (it + 1 < ntiles) {
      const int nx = (it + 1) & 1;
      copy.start(ks + nx * BK * SK, vs + nx * BK * SV, k0 + BK,
                 kv.hi);
    }
    if (active && wkv.lo < k0 + BK && k0 < wkv.hi) {
      // every row of the warp sees every key of the tile: no mask
      const bool full = wall.lo <= k0 && k0 + BK <= wall.hi;
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const float* kt = ks + (it & 1) * BK * SK + g * SK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t ah[4], al[4], bh[NJ][2], bl[NJ][2];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(qf[kk][e], ah[e], al[e]);
        if (kk < HALF) copy.issue(per_step);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {  // keys 8j + g, columns 2t, 2t+1
          const float2 b =
              *reinterpret_cast<const float2*>(kt + 8 * j * SK + 8 * kk);
          split(b.x, bh[j][0], bl[j][0]);
          split(b.y, bh[j][1], bl[j][1]);
        }
        // three TF32 passes (lo·hi, hi·lo, hi·hi), pass by pass: the MMAs
        // that update one accumulator are NJ apart, so none waits on the
        // one before it
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(s[j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(s[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_tf32(s[j], ah, bh[j][0], bh[j][1]);
      }
      copy.finish();

      // mask, then the online softmax; s[j][e] is the score of row
      // (e < 2 ? r0 : r1), key k0 + 8j + 2t + (e & 1)
      uint32_t live = 0xffffffffu;
      if (!full) {
        live = 0;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const Range& vr = e < 2 ? v0 : v1;
            live |= (key >= vr.lo && key < vr.hi ? 1u : 0u) << (4 * j + e);
          }
      }
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (live >> (4 * j + e)) & 1u;
          if (e < 2)
            mx0 = ok ? fmaxf(mx0, s[j][e]) : mx0;
          else
            mx1 = ok ? fmaxf(mx1, s[j][e]) : mx1;
        }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (live >> (4 * j + e)) & 1u;
          const float pe = ok ? exp2f(s[j][e] - (e < 2 ? mn0 : mn1)) : 0.0f;
          s[j][e] = pe;
          if (e < 2)
            rs0 += pe;
          else
            rs1 += pe;
        }
      l0 = l0 * a0 + rs0;  // this thread's columns; the quad sums at the end
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int nd = 0; nd < NT; ++nd) {
        o[nd][0] *= a0;
        o[nd][1] *= a0;
        o[nd][2] *= a1;
        o[nd][3] *= a1;
      }

      // O += P·V: P's A fragment is s[j] (a0 c0, a1 c2, a2 c1, a3 c3);
      // V's B fragment holds keys 8j + 2t and 8j + 2t + 1 of column g
      const float* vt = vs + (it & 1) * BK * SV + 2 * t * SV + g;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);
        split(s[j][2], ph[1], pl[1]);
        split(s[j][1], ph[2], pl[2]);
        split(s[j][3], ph[3], pl[3]);
        const float* vr = vt + 8 * j * SV;
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += G) {
          uint32_t bh[G][2], bl[G][2];
#pragma unroll
          for (int n = 0; n < G; ++n) {
            split(vr[8 * (n0 + n)], bh[n][0], bl[n][0]);
            split(vr[SV + 8 * (n0 + n)], bh[n][1], bl[n][1]);
          }
          // the same three passes, G accumulators each
#pragma unroll
          for (int n = 0; n < G; ++n)
            mma_tf32(o[n0 + n], pl, bh[n][0], bh[n][1]);
#pragma unroll
          for (int n = 0; n < G; ++n)
            mma_tf32(o[n0 + n], ph, bl[n][0], bl[n][1]);
#pragma unroll
          for (int n = 0; n < G; ++n)
            mma_tf32(o[n0 + n], ph, bh[n][0], bh[n][1]);
        }
      }
    } else {
      copy.finish();
    }
    cp_async_commit();
  }

  if (!active) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float i1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  float* ob = p.o + (long long)bi * p.tq * q_row + (long long)h * p.d;
#pragma unroll
  for (int nd = 0; nd < NT; ++nd) {
    const int c = 8 * nd + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1;
      if (r < p.tq && c + (e & 1) < p.d)
        ob[r * q_row + c + (e & 1)] = o[nd][e] * (e < 2 ? i0 : i1);
    }
  }
  if constexpr (LSE) {
    if (t == 0) {
      float* lb = lse + ((long long)bi * p.hq + h) * p.tq;
      if (r0 < p.tq) lb[r0] = row_lse(m0, l0);
      if (r1 < p.tq) lb[r1] = row_lse(m1, l1);
    }
  }
}

// ---------------------------------------------------------------------------
// decode_split: split-KV, f32 FMA, K/V bytes read once
// ---------------------------------------------------------------------------

// Block (split s, kv head hk, batch bi): query rows r = i·g + gi (query i,
// q head hk·g + gi), r < rows ≤ R; keys [kv.lo + s·kps, + kps) ∩ kv.
// Writes part_ml[prow] = (m, l) and part_acc[prow][0..d) for
// prow = ((s·B + bi)·Hkv + hk)·rows + r.
template <int R>
__global__ void __launch_bounds__(THREADS)
    flash_decode_split(Params p, Range kv, int rows, int kps, int dp,
                       int vec, float* part_ml, float* part_acc) {
  const int sd = dp + 4;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;             // [R][dp], pre-scaled
  float* const ring = smem + R * dp;  // [DC_STAGES][K, V][DC_BK][sd]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kq = lane & 7, qd = lane >> 3;
  const int s = blockIdx.x, hk = blockIdx.y, bi = blockIdx.z;
  const int grp = p.hq / p.hkv;
  const int k_lo = kv.lo + s * kps;
  const int k_hi = imin(k_lo + kps, kv.hi);
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + DC_BK - 1) / DC_BK : 0;

  RowCopy<DC_BK> copy(p.k + bi * p.kb + hk * p.kh, p.kt,
                     p.v + bi * p.vb + hk * p.vh, p.vt, sd, sd, p.d, dp, vec);
  auto stage = [&](int it) {
    float* kd = ring + (it % DC_STAGES) * 2 * DC_BK * sd;
    copy.start(kd, kd + DC_BK * sd, k_lo + it * DC_BK, k_hi);
    copy.finish();
  };
#pragma unroll
  for (int it = 0; it < DC_STAGES - 1; ++it) {
    if (it < ntiles) stage(it);
    cp_async_commit();
  }

  const long long q_row = (long long)p.hq * p.d;
  for (int i = threadIdx.x; i < R * dp; i += THREADS) {
    const int r = i / dp, c = i - r * dp;
    float x = 0.0f;
    if (r < rows && c < p.d) {
      const int qi = r / grp, h = hk * grp + r % grp;
      x = p.q[((long long)bi * p.tq + qi) * q_row + (long long)h * p.d + c] *
          p.scale;
    }
    qs[i] = x;
  }

  float m[R], l[R], acc[R][DMAX / 32];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) acc[r][i] = 0.0f;
  }

  for (int it = 0; it < ntiles; ++it) {
    if (it + DC_STAGES - 1 < ntiles) stage(it + DC_STAGES - 1);
    cp_async_commit();
    cp_async_wait<DC_STAGES - 1>();
    __syncthreads();

    const int k0 = k_lo + it * DC_BK + 8 * warp;  // this warp's 8 keys
    if (k0 < k_hi) {
      const float* kt =
          ring + (it % DC_STAGES) * 2 * DC_BK * sd + 8 * warp * sd;
      const float* vt = kt + DC_BK * sd;
      // score of key k0 + kq: each lane of the quarter qd sums the float4
      // columns qd, qd + 4, …, then the quarters add up
      float sc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r] = 0.0f;
      const float* kr = kt + kq * sd;
      for (int c4 = qd; c4 < dp / 4; c4 += 4) {
        const float4 kv4 = *reinterpret_cast<const float4*>(kr + 4 * c4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 q4 =
              *reinterpret_cast<const float4*>(qs + r * dp + 4 * c4);
          sc[r] = fmaf(q4.x, kv4.x, sc[r]);
          sc[r] = fmaf(q4.y, kv4.y, sc[r]);
          sc[r] = fmaf(q4.z, kv4.z, sc[r]);
          sc[r] = fmaf(q4.w, kv4.w, sc[r]);
        }
      }
      const int key = k0 + kq;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sc[r] += __shfl_xor_sync(FULL, sc[r], 8);
        sc[r] += __shfl_xor_sync(FULL, sc[r], 16);
        const int pos = p.q_offset + r / grp;
        const Range vr = seen_by_any(pos, pos, p);
        const bool ok = r < rows && key < k_hi && key >= vr.lo && key < vr.hi;
        float mx = ok ? sc[r] : NEG;
#pragma unroll
        for (int off = 1; off < 8; off *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float mn = fmaxf(m[r], mx);
        const float alpha = exp2f(m[r] - mn);
        const float pr = ok ? exp2f(sc[r] - mn) : 0.0f;
        float ps = pr;
#pragma unroll
        for (int off = 1; off < 8; off *= 2)
          ps += __shfl_xor_sync(FULL, ps, off);
        l[r] = l[r] * alpha + ps;
        m[r] = mn;
#pragma unroll
        for (int i = 0; i < DMAX / 32; ++i) acc[r][i] *= alpha;
        sc[r] = pr;
      }
      // acc[r][i] += Σ_j p(r, key k0 + j) · v[k0 + j][lane + 32 i]
      const int nk = imin(8, k_hi - k0);
      for (int j = 0; j < nk; ++j) {
        float vv[DMAX / 32];
#pragma unroll
        for (int i = 0; i < DMAX / 32; ++i) {
          const int c = lane + 32 * i;
          vv[i] = c < dp ? vt[j * sd + c] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pj = __shfl_sync(FULL, sc[r], j);
#pragma unroll
          for (int i = 0; i < DMAX / 32; ++i)
            acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
        }
      }
    }
    __syncthreads();  // the stage this tile used is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the four warps' (m, l, acc) in shared memory (over the ring)
  float* const mw = ring;             // [WARPS][R]
  float* const lw = mw + WARPS * R;   // [WARPS][R]
  float* const aw = lw + WARPS * R;   // [WARPS][R][dp]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      mw[warp * R + r] = m[r];
      lw[warp * R + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < dp) aw[(warp * R + r) * dp + c] = acc[r][i];
    }
  }
  __syncthreads();
  const long long prow0 =
      (((long long)s * p.bsz + bi) * p.hkv + hk) * (long long)rows;
  for (int i = threadIdx.x; i < rows * p.d; i += THREADS) {
    const int r = i / p.d, c = i - r * p.d;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, mw[w * R + r]);
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      a += aw[(w * R + r) * dp + c] * exp2f(mw[w * R + r] - mx);
    part_acc[(prow0 + r) * p.d + c] = a;
  }
  if ((int)threadIdx.x < rows) {
    const int r = threadIdx.x;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, mw[w * R + r]);
    float ls = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      ls += lw[w * R + r] * exp2f(mw[w * R + r] - mx);
    part_ml[2 * (prow0 + r)] = mx;
    part_ml[2 * (prow0 + r) + 1] = ls;
  }
}

// One warp per output row (bi, i, h): folds the splits in order 0, 1, …;
// lse as prefill_tc's
template <bool LSE>
__global__ void __launch_bounds__(THREADS)
    flash_decode_combine(Params p, int rows, int splits,
                         const float* part_ml, const float* part_acc,
                         float* lse) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= (long long)p.bsz * p.tq * p.hq) return;
  const int h = (int)(row % p.hq);
  const long long bt = row / p.hq;
  const int qi = (int)(bt % p.tq), bi = (int)(bt / p.tq);
  const int grp = p.hq / p.hkv, hk = h / grp;
  const long long per_split = (long long)p.bsz * p.hkv * rows;
  const long long prow =
      ((long long)bi * p.hkv + hk) * rows + qi * grp + (h - hk * grp);
  float mx = NEG;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, part_ml[2 * (s * per_split + prow)]);
  float ls = 0.0f, a[DMAX / 32] = {};
  for (int s = 0; s < splits; ++s) {
    const long long pr = s * per_split + prow;
    const float w = exp2f(part_ml[2 * pr] - mx);
    ls += w * part_ml[2 * pr + 1];
#pragma unroll
    for (int i = 0; i < DMAX / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < p.d) a[i] += w * part_acc[pr * p.d + c];
    }
  }
  const float inv = ls > 0.0f ? 1.0f / ls : 0.0f;
  float* ob = p.o + row * p.d;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < p.d) ob[c] = a[i] * inv;
  }
  if constexpr (LSE) {
    if (lane == 0)
      lse[((long long)bi * p.hq + h) * p.tq + qi] = row_lse(mx, ls);
  }
}

// ---------------------------------------------------------------------------
// wide_simt: 128 < D ≤ 256, f32 SIMT
// ---------------------------------------------------------------------------

// Block (row tile, kv head hk, batch bi) over the rows r = i·g + gi of
// (bi, hk) (query i, q head hk·g + gi), wd::OWN of them from
// blockIdx.x · wd::OWN; warp w owns rows w, w + 4, w + 8, w + 12 of the
// tile.  The block walks the keys its queries can see in tiles of 32,
// staged in shared memory (K and V rows D + 4 apart, Q pre-scaled).  A
// lane scores one key of the tile against each of its warp's rows (Q
// read as a broadcast, K as 16-byte rows whose starts hit distinct banks),
// the warp takes each row's online softmax, and each lane then adds
// p·v into its float4 columns lane, lane + 32 of the row's output, p
// handed round by a shuffle.  lse as prefill_tc's.
template <bool LSE>
__global__ void __launch_bounds__(THREADS)
    flash_wide_simt(Params p, int dp, int vec, float* lse) {
  extern __shared__ __align__(16) float smem[];
  const int sd = dp + 4;
  float* const qs = smem;                   // [wd::OWN][dp], pre-scaled
  float* const ks = qs + wd::OWN * dp;      // [wd::TILE][sd]
  float* const vs = ks + wd::TILE * sd;     // [wd::TILE][sd]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int grp = p.hq / p.hkv;
  const int n_rows = p.tq * grp;
  const int r0 = blockIdx.x * wd::OWN;
  if (r0 >= n_rows) return;
  const int r_end = imin(r0 + wd::OWN, n_rows);
  const Range kv = seen_by_any(p.q_offset + r0 / grp,
                               p.q_offset + (r_end - 1) / grp, p);

  const long long q_row = (long long)p.hq * p.d;
  for (int i = threadIdx.x; i < wd::OWN * dp; i += THREADS) {
    const int r = i / dp, c = i - r * dp, row = r0 + r;
    float x = 0.0f;
    if (row < r_end && c < p.d) {
      const int qi = row / grp, h = hk * grp + row % grp;
      x = p.q[((long long)bi * p.tq + qi) * q_row + (long long)h * p.d + c] *
          p.scale;
    }
    qs[i] = x;
  }

  // this warp's rows: the keys each sees, and their hull
  Range vr[wd::RW];
  int wlo = 0, whi = 0;  // empty until a row sees a key
#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    const int row = r0 + warp + WARPS * e;
    vr[e] = row < r_end
                ? seen_by_any(p.q_offset + row / grp,
                              p.q_offset + row / grp, p)
                : Range{0, 0};
    if (vr[e].lo < vr[e].hi) {
      const bool first = wlo >= whi;
      wlo = first ? vr[e].lo : imin(wlo, vr[e].lo);
      whi = first ? vr[e].hi : imax(whi, vr[e].hi);
    }
  }

  float m[wd::RW], l[wd::RW];
  float4 acc[wd::RW][wd::NV];
#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    m[e] = NEG;
    l[e] = 0.0f;  // this lane's keys; the warp sums at the end
#pragma unroll
    for (int n = 0; n < wd::NV; ++n) acc[e][n] = wd::zero4();
  }

  const float* kg = p.k + bi * p.kb + hk * p.kh;
  const float* vg = p.v + bi * p.vb + hk * p.vh;
  const int dp4 = dp / 4;
  for (int k0 = kv.lo; k0 < kv.hi; k0 += wd::TILE) {
    __syncthreads();  // every warp is done with the last tile
    wd::stage(ks, sd, kg, p.kt, k0, wd::TILE, kv.hi, p.d, dp, vec, 1.0f);
    wd::stage(vs, sd, vg, p.vt, k0, wd::TILE, kv.hi, p.d, dp, vec, 1.0f);
    __syncthreads();
    if (!(wlo < k0 + wd::TILE && k0 < whi)) continue;  // warp-uniform

    float s[wd::RW];
#pragma unroll
    for (int e = 0; e < wd::RW; ++e) s[e] = 0.0f;
    const float* kr = ks + lane * sd;
    for (int c4 = 0; c4 < dp4; ++c4) {
      const float4 kx = *reinterpret_cast<const float4*>(kr + 4 * c4);
#pragma unroll
      for (int e = 0; e < wd::RW; ++e)
        s[e] = wd::dot4(*reinterpret_cast<const float4*>(
                            qs + (warp + WARPS * e) * dp + 4 * c4),
                        kx, s[e]);
    }
    const int key = k0 + lane;
#pragma unroll
    for (int e = 0; e < wd::RW; ++e) {
      const bool ok = key >= vr[e].lo && key < vr[e].hi;
      float mx = ok ? s[e] : NEG;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m[e], mx);
      const float alpha = exp2f(m[e] - mn);
      const float pe = ok ? exp2f(s[e] - mn) : 0.0f;
      l[e] = l[e] * alpha + pe;
      m[e] = mn;
#pragma unroll
      for (int n = 0; n < wd::NV; ++n) wd::scale4(acc[e][n], alpha);
      s[e] = pe;
    }
    const int nk = imin(wd::TILE, kv.hi - k0);
    for (int j = 0; j < nk; ++j) {
      float4 vx[wd::NV];
#pragma unroll
      for (int n = 0; n < wd::NV; ++n) {
        const int c4 = lane + 32 * n;
        vx[n] = c4 < dp4 ? *reinterpret_cast<const float4*>(vs + j * sd +
                                                              4 * c4)
                         : wd::zero4();
      }
#pragma unroll
      for (int e = 0; e < wd::RW; ++e) {
        const float pj = __shfl_sync(FULL, s[e], j);
#pragma unroll
        for (int n = 0; n < wd::NV; ++n) wd::axpy4(acc[e][n], pj, vx[n]);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    const int row = r0 + warp + WARPS * e;
    float ls = l[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(FULL, ls, off);
    if (row >= r_end) continue;
    const int qi = row / grp, h = hk * grp + row % grp;
    const float inv = ls > 0.0f ? 1.0f / ls : 0.0f;
    float* ob = p.o + ((long long)bi * p.tq + qi) * q_row + (long long)h * p.d;
#pragma unroll
    for (int n = 0; n < wd::NV; ++n) {
      const int c = 4 * (lane + 32 * n);
      const float x[4] = {acc[e][n].x, acc[e][n].y, acc[e][n].z, acc[e][n].w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < p.d) ob[c + u] = x[u] * inv;
    }
    if constexpr (LSE) {
      if (lane == 0)
        lse[((long long)bi * p.hq + h) * p.tq + qi] = row_lse(m[e], ls);
    }
  }
}

// ---------------------------------------------------------------------------
// wide_chunk: D > 256, f32 SIMT, D walked in chunks
// ---------------------------------------------------------------------------

// The output columns a wide_chunk block writes, and a lane's share of them
constexpr int CW = 256;
constexpr int CU = CW / 32;

// Block (row tile t and column chunk c, kv head hk, batch bi), blockIdx.x =
// t · chunks + c, over flash_wide_simt's rows: wd::OWN of (bi, hk) from
// t · wd::OWN, warp w rows w, w + 4, w + 8, w + 12.  Nothing is staged and
// no row's columns are held whole, so any D runs: a lane scores one key of
// each 32-key tile of its warp's hull against each of the warp's rows
// over all of D, read from global memory (q as a broadcast), the warp
// takes each row's online softmax as flash_wide_simt does, and each lane
// adds p·v into its columns c·CW + lane + 32u (u < CU) of the row's
// output.  Every chunk's block recomputes the scores.  Warps run apart (no
// barrier); lse from chunk 0.
template <bool LSE>
__global__ void __launch_bounds__(THREADS)
    flash_wide_chunk(Params p, int chunks, float* lse) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int tile = blockIdx.x / chunks, c0 = (blockIdx.x % chunks) * CW;
  const int grp = p.hq / p.hkv;
  const int n_rows = p.tq * grp;
  const int r0 = tile * wd::OWN;
  if (r0 >= n_rows) return;
  const int r_end = imin(r0 + wd::OWN, n_rows);
  const long long q_row = (long long)p.hq * p.d;

  const float* qr[wd::RW];
  Range vr[wd::RW];
  int wlo = 0, whi = 0;  // empty until a row sees a key
#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    const int row = r0 + warp + WARPS * e;
    qr[e] = p.q;
    vr[e] = Range{0, 0};
    if (row < r_end) {
      const int qi = row / grp, h = hk * grp + row % grp;
      qr[e] = p.q + ((long long)bi * p.tq + qi) * q_row + (long long)h * p.d;
      vr[e] = seen_by_any(p.q_offset + qi, p.q_offset + qi, p);
    }
    if (vr[e].lo < vr[e].hi) {
      const bool first = wlo >= whi;
      wlo = first ? vr[e].lo : imin(wlo, vr[e].lo);
      whi = first ? vr[e].hi : imax(whi, vr[e].hi);
    }
  }

  float m[wd::RW], l[wd::RW], acc[wd::RW][CU];
#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    m[e] = NEG;
    l[e] = 0.0f;  // this lane's keys; the warp sums at the end
#pragma unroll
    for (int u = 0; u < CU; ++u) acc[e][u] = 0.0f;
  }

  const float* kg = p.k + bi * p.kb + hk * p.kh;
  const float* vg = p.v + bi * p.vb + hk * p.vh;
  for (int k0 = wlo; k0 < whi; k0 += wd::TILE) {
    const int key = k0 + lane;
    float s[wd::RW];
#pragma unroll
    for (int e = 0; e < wd::RW; ++e) s[e] = 0.0f;
    if (key < whi) {
      const float* kr = kg + key * p.kt;
      for (int c = 0; c < p.d; ++c) {
        const float kx = kr[c];
#pragma unroll
        for (int e = 0; e < wd::RW; ++e) s[e] = fmaf(qr[e][c], kx, s[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < wd::RW; ++e) {
      const bool ok = key >= vr[e].lo && key < vr[e].hi;
      const float se = s[e] * p.scale;
      float mx = ok ? se : NEG;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m[e], mx);
      const float alpha = exp2f(m[e] - mn);
      const float pe = ok ? exp2f(se - mn) : 0.0f;
      l[e] = l[e] * alpha + pe;
      m[e] = mn;
#pragma unroll
      for (int u = 0; u < CU; ++u) acc[e][u] *= alpha;
      s[e] = pe;
    }
    const int nk = imin(wd::TILE, whi - k0);
    for (int j = 0; j < nk; ++j) {
      const float* vj = vg + (k0 + j) * p.vt;
      float vx[CU];
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const int c = c0 + lane + 32 * u;
        vx[u] = c < p.d ? vj[c] : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < wd::RW; ++e) {
        const float pj = __shfl_sync(FULL, s[e], j);
#pragma unroll
        for (int u = 0; u < CU; ++u) acc[e][u] = fmaf(pj, vx[u], acc[e][u]);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    const int row = r0 + warp + WARPS * e;
    float ls = l[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(FULL, ls, off);
    if (row >= r_end) continue;
    const int qi = row / grp, h = hk * grp + row % grp;
    const float inv = ls > 0.0f ? 1.0f / ls : 0.0f;
    float* ob = p.o + ((long long)bi * p.tq + qi) * q_row + (long long)h * p.d;
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int c = c0 + lane + 32 * u;
      if (c < p.d) ob[c] = acc[e][u] * inv;
    }
    if constexpr (LSE) {
      if (c0 == 0 && lane == 0)
        lse[((long long)bi * p.hq + h) * p.tq + qi] = row_lse(m[e], ls);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// 16-byte staging: the base and every stride (in floats) multiples of 4
bool vec16(const float* base, long long b, long long t, long long h, int d) {
  return aligned16(base) && b % 4 == 0 && t % 4 == 0 && h % 4 == 0 &&
         d % 4 == 0;
}

// prefill_tc's instantiation for d: 8-column tiles of D, padded
int prefill_nt(int d) { return d <= 32 ? 4 : d <= 64 ? 8 : d <= 80 ? 10 : 16; }

bool bad_shape(int bsz, int tq, int tk, int hq, int hkv, int d) {
  return bsz < 0 || tq < 0 || tk < 0 || d <= 0 || d > DMAX || hkv <= 0 ||
         hq <= 0 || hq % hkv != 0;
}

template <int NT, bool LSE>
int launch_prefill(const Params& p, dim3 grid, int vec, float* lse,
                   cudaStream_t st) {
  constexpr size_t smem = prefill_smem<NT>();
  // per call: the attribute belongs to the current device
  cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_tc<NT, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_prefill_tc<NT, LSE><<<grid, THREADS, smem, st>>>(p, vec, lse);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_prefill(const Params& p, dim3 grid, int vec, float* lse,
                   cudaStream_t st) {
  return lse != nullptr ? launch_prefill<NT, true>(p, grid, vec, lse, st)
                        : launch_prefill<NT, false>(p, grid, vec, lse, st);
}

template <int R>
int launch_decode(const Params& p, Range kv, int rows, int splits, int kps,
                  float* ml, float* acc, float* lse, cudaStream_t st) {
  const int dp = (p.d + 7) / 8 * 8;
  const size_t smem =
      sizeof(float) *
      ((size_t)R * dp + (size_t)DC_STAGES * 2 * DC_BK * (dp + 4));
  cudaError_t e = cudaFuncSetAttribute(
      flash_decode_split<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = vec16(p.k, p.kb, p.kt, p.kh, p.d) &&
                  vec16(p.v, p.vb, p.vt, p.vh, p.d);
  flash_decode_split<R><<<dim3(splits, p.hkv, p.bsz), THREADS, smem, st>>>(
      p, kv, rows, kps, dp, vec, ml, acc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long out_rows = (long long)p.bsz * p.tq * p.hq;
  const unsigned blocks = (unsigned)((out_rows + WARPS - 1) / WARPS);
  if (lse != nullptr)
    flash_decode_combine<true><<<blocks, THREADS, 0, st>>>(p, rows, splits,
                                                           ml, acc, lse);
  else
    flash_decode_combine<false><<<blocks, THREADS, 0, st>>>(p, rows, splits,
                                                            ml, acc, lse);
  return (int)cudaGetLastError();
}

template <bool LSE>
int launch_wide(const Params& p, dim3 grid, float* lse, cudaStream_t st) {
  const int dp = (p.d + 7) / 8 * 8;
  const size_t smem =
      sizeof(float) * ((size_t)wd::OWN * dp + (size_t)2 * wd::TILE *
                                                   (dp + 4));
  cudaError_t e = cudaFuncSetAttribute(
      flash_wide_simt<LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = vec16(p.k, p.kb, p.kt, p.kh, p.d) &&
                  vec16(p.v, p.vb, p.vt, p.vh, p.d);
  flash_wide_simt<LSE><<<grid, THREADS, smem, st>>>(p, dp, vec, lse);
  return (int)cudaGetLastError();
}

// the column chunks of a wide_chunk call
int wide_chunks(int d) { return (d + CW - 1) / CW; }

template <bool LSE>
int launch_wide_chunk(const Params& p, dim3 grid, float* lse,
                      cudaStream_t st) {
  flash_wide_chunk<LSE><<<grid, THREADS, 0, st>>>(p, wide_chunks(p.d), lse);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   int bsz, int tq, int tk, int hq, int hkv, int d,
                   long long kb, long long kt, long long kh, long long vb,
                   long long vt, long long vh, int causal, int window,
                   int chunk, int q_offset, float scale) {
  return Params{static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o),
                bsz, tq, tk, hq, hkv, d, kb, kt, kh, vb, vt, vh,
                causal, window, chunk, q_offset, scale * LOG2E};
}

}  // namespace

// q, o: (bsz, tq, hq, d) contiguous f32; k, v: (bsz, tk, hkv, d) f32 with
// unit stride along d and the given batch/seq/head strides; lse: null, or
// (bsz, hq, tq) contiguous f32 to receive each row's log-sum-exp.  window,
// chunk: 0 = no such mask; scale: 1/sqrt(d).  Both entries return a
// cudaError_t.
//
// prefill_tc: q_tile must be 64 (PF_BQ) and the grid (grid_x ≥ tq / 64,
// hq, bsz).
extern "C" int flash_attention_prefill(
    const void* q, const void* k, const void* v, void* o, void* lse, int bsz,
    int tq, int tk, int hq, int hkv, int d, long long kb, long long kt,
    long long kh, long long vb, long long vt, long long vh, int causal,
    int window, int chunk, int q_offset, float scale, int q_tile, int grid_x,
    int grid_y, int grid_z, void* stream) {
  if (bad_shape(bsz, tq, tk, hq, hkv, d) || q_tile != PF_BQ ||
      (long long)grid_x * PF_BQ < tq || grid_y != hq || grid_z != bsz)
    return (int)cudaErrorInvalidValue;
  const int nt = prefill_nt(d);
  if (bsz == 0 || tq == 0) return (int)cudaGetLastError();
  const Params p = make_params(q, k, v, o, bsz, tq, tk, hq, hkv, d, kb, kt,
                               kh, vb, vt, vh, causal, window, chunk,
                               q_offset, scale);
  const int vec = vec16(p.k, kb, kt, kh, d) && vec16(p.v, vb, vt, vh, d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y, grid_z);
  float* lse_out = static_cast<float*>(lse);
  if (nt == 4) return launch_prefill<4>(p, grid, vec, lse_out, st);
  if (nt == 8) return launch_prefill<8>(p, grid, vec, lse_out, st);
  if (nt == 10) return launch_prefill<10>(p, grid, vec, lse_out, st);
  return launch_prefill<16>(p, grid, vec, lse_out, st);
}

// decode_split: rows = tq · (hq / hkv) ≤ 16 query rows a block, the grid
// (splits, hkv, bsz), splits · keys_per_split covering the keys the
// queries can see; part: scratch of splits · bsz · hkv · rows · (2 + d)
// floats (`scratch` of them), the (m, l) pairs first.
extern "C" int flash_attention_decode(
    const void* q, const void* k, const void* v, void* o, void* lse,
    void* part, int bsz, int tq, int tk, int hq, int hkv, int d, long long kb,
    long long kt, long long kh, long long vb, long long vt, long long vh,
    int causal, int window, int chunk, int q_offset, float scale, int rows,
    int splits, int keys_per_split, int grid_x, int grid_y, int grid_z,
    long long scratch, void* stream) {
  if (bad_shape(bsz, tq, tk, hq, hkv, d)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, bsz, tq, tk, hq, hkv, d, kb, kt,
                               kh, vb, vt, vh, causal, window, chunk,
                               q_offset, scale);
  const Range kv = seen_by_any(q_offset, q_offset + tq - 1, p);
  const long long n_part = (long long)splits * bsz * hkv * rows;
  if (rows != tq * (hq / hkv) || rows > DC_ROWS || splits <= 0 ||
      splits > 65535 || keys_per_split <= 0 ||
      (long long)splits * keys_per_split < kv.hi - kv.lo ||
      grid_x != splits || grid_y != hkv || grid_z != bsz ||
      scratch < n_part * (2 + d))
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || tq == 0) return (int)cudaGetLastError();
  float* ml = static_cast<float*>(part);
  float* acc = ml + 2 * n_part;
  float* lse_out = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 1)
    return launch_decode<1>(p, kv, rows, splits, keys_per_split, ml, acc,
                            lse_out, st);
  if (rows <= 4)
    return launch_decode<4>(p, kv, rows, splits, keys_per_split, ml, acc,
                            lse_out, st);
  return launch_decode<DC_ROWS>(p, kv, rows, splits, keys_per_split, ml, acc,
                                lse_out, st);
}

// wide_simt: 128 < d ≤ 256 (any d ≥ 1 runs; the plan sends only these
// here); q_tile must be wd::OWN (16) query rows of one kv head's group a
// block and the grid (grid_x ≥ tq · (hq / hkv) / 16, hkv, bsz).
extern "C" int flash_attention_wide(
    const void* q, const void* k, const void* v, void* o, void* lse, int bsz,
    int tq, int tk, int hq, int hkv, int d, long long kb, long long kt,
    long long kh, long long vb, long long vt, long long vh, int causal,
    int window, int chunk, int q_offset, float scale, int q_tile, int grid_x,
    int grid_y, int grid_z, void* stream) {
  if (bsz < 0 || tq < 0 || tk < 0 || d <= 0 || d > wd::DMAX || hkv <= 0 ||
      hq <= 0 || hq % hkv != 0 || q_tile != wd::OWN ||
      (long long)grid_x * wd::OWN < (long long)tq * (hq / hkv) ||
      grid_y != hkv || grid_z != bsz)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || tq == 0) return (int)cudaGetLastError();
  const Params p = make_params(q, k, v, o, bsz, tq, tk, hq, hkv, d, kb, kt,
                               kh, vb, vt, vh, causal, window, chunk,
                               q_offset, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y, grid_z);
  float* lse_out = static_cast<float*>(lse);
  return lse_out != nullptr ? launch_wide<true>(p, grid, lse_out, st)
                            : launch_wide<false>(p, grid, lse_out, st);
}

// wide_chunk: d > 256 (any d ≥ 1 runs; the plan sends only these here);
// as flash_attention_wide, but grid_x covers every row tile times
// ceil(d / 256) column chunks.
extern "C" int flash_attention_wide_chunk(
    const void* q, const void* k, const void* v, void* o, void* lse, int bsz,
    int tq, int tk, int hq, int hkv, int d, long long kb, long long kt,
    long long kh, long long vb, long long vt, long long vh, int causal,
    int window, int chunk, int q_offset, float scale, int q_tile, int grid_x,
    int grid_y, int grid_z, void* stream) {
  if (bsz < 0 || tq < 0 || tk < 0 || d <= 0 || hkv <= 0 || hq <= 0 ||
      hq % hkv != 0 || q_tile != wd::OWN ||
      (long long)grid_x <
          ((long long)tq * (hq / hkv) + wd::OWN - 1) / wd::OWN *
              wide_chunks(d) ||
      grid_y != hkv || grid_z != bsz)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || tq == 0) return (int)cudaGetLastError();
  const Params p = make_params(q, k, v, o, bsz, tq, tk, hq, hkv, d, kb, kt,
                               kh, vb, vt, vh, causal, window, chunk,
                               q_offset, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y, grid_z);
  float* lse_out = static_cast<float*>(lse);
  return lse_out != nullptr ? launch_wide_chunk<true>(p, grid, lse_out, st)
                            : launch_wide_chunk<false>(p, grid, lse_out, st);
}
