// B5's backward — the gradient of GQA flash attention, for Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/flash_attention.py:32 (`_flash_kernel`)
// has no backward: JAX cannot transpose a `pallas_call`, and the JAX
// package trains through XLA's einsums (src/repro/models/attention.py:69,
// `_sdpa`).  The port sends every attention through B5's forward
// (flash_attention.cu), so its gradient is these kernels, under the
// `AttnFn` autograd function of kernels/flash_attention.py.
//
// For o = softmax(q·kᵀ/√D + mask)·v with q, o, dO (B, Tq, Hq, D) and k, v
// (B, Tk, Hkv, D), f32, group g = Hq / Hkv (q head h reads kv head h / g),
// and the forward's log-sum-exp lse (B, Hq, Tq) in natural-log units
// (flash_attention.cu; -inf for a row with no visible key):
//     P_ij  = exp(q_i·k_j/√D − lse_i) on visible (i, j), else 0
//     D_i   = Σ_d dO_id · O_id                          (rowdot)
//     dV_j  = Σ_i P_ij dO_i,  dK_j = Σ_i dS_ij q_i / √D   (dkdv)
//     dQ_i  = Σ_j dS_ij k_j / √D                          (dq)
// with dS_ij = P_ij (dO_i·v_j − D_i); the sums over i run over every q
// head of the kv head (GQA).  The mask is attention_mask.cuh's, the one the
// forward uses.  A row whose lse is -inf sees no key, so every P of it is
// 0 by the mask test (exp is never used of it): zero gradients, no NaN.
//
// Three kernels, launched in this order by the wrapper (D ≤ 128; past
// it, up to 256, the wide_simt route below replaces dkdv and dq):
// * rowdot — one warp a (b, i, h) row; lanes stride over D, a fixed
//   shuffle tree sums them.
// * dkdv — one block a (key tile of 64 keys, kv head, batch), 4 warps of
//   16 keys.  The K and V tiles are staged once; the block walks the g q
//   heads of its kv head and, in each, the q tiles (BB rows) of the mask's
//   hull that meet its keys (an interval of tiles: both ends of a query's
//   visible keys grow with its position).  On each tile a warp computes
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (16 keys × BB queries), then
//   Pᵀ = exp2(Sᵀ·log2(e)/√D − lse·log2(e)) and dSᵀ = Pᵀ ∘ (dPᵀ − D), and
//   accumulates dV += Pᵀ·dO and dK += dSᵀ·Q in registers.  dK and dV are
//   written once (dK scaled by 1/√D), so the sum over a kv head's q heads
//   happens inside the block, with no atomics.
// * dq — prefill_tc's shape: one block a (64-row q tile, q head, batch),
//   heaviest q tile first, 4 warps of 16 queries, walking the visible
//   keys in tiles of BB keys: S = Q·Kᵀ, dP = dO·Vᵀ, P, dS as above, and
//   dQ += dS·K.  dQ stays a kernel of its own, so S and dP are computed
//   twice, seven T²·D products in all: FlashAttention-2 adds dQ from dkdv
//   with atomics (five products) and would lose the bit-for-bit repeat.
// Every sum runs in a fixed order and nothing is added atomically, so a
// backward repeats bit for bit.
//
// Bound: operations, the five T²·D products over the visible pairs at
// three TF32 tensor-core passes each (bytes are far below: at Zamba2's
// training shape, 8 × 1,024 tokens, 32 heads of 80, causal, 3 × 107
// GFLOP at 495 TFLOP/s is 0.65 ms, the bytes 0.08 ms).  Design, for that:
// * Every product is a 3xTF32 `mma.sync.m16n8k8` (tf32_mma.cuh: hi·hi +
//   hi·lo + lo·hi, hi the f32 value with its low 13 mantissa bits
//   cleared), as prefill_tc's, because one TF32 pass misses this repo's
//   1e-4 · max |plain| (tests/test_torch_attention_grad.py emulates both);
//   the three passes go out pass by pass over a step's accumulators.
//   The tensor core truncates each sum it writes, so an accumulator
//   chained through every tile drifts toward 0 by ≈2^-24 of itself per
//   MMA (dK at StarCoder2's window, 9 heads × 4,096 queries, missed the
//   tolerance 2.5×): dK, dV and dQ take each tile's sum in fresh
//   registers, added to the running sum by a rounded f32 add.
// * The block's own rows (K, V in dkdv; Q, dO in dq) are staged once by
//   `cp.async`; the streamed tiles (Q, dO with their lse and D in dkdv;
//   K, V in dq) pass through a two-stage `cp.async` ring, the next tile's
//   copies issued a few per k step during this tile's score products.
// * The score accumulators are the next product's A fragments
//   (tf32_mma.cuh's k-index permutation): P and dS go from registers to
//   the tensor cores and never touch shared memory.
// * Shared rows are frag_stride<NT>() = 8·m floats apart (m odd): the
//   8-byte fragment loads (row, columns 2t, 2t + 1) of a half-warp hit 16
//   bank pairs.  A streamed tile is also read one float at a time as the
//   B operand of dV, dK or dQ, at rows 8j + π(2t) (b0) or 8j + π(2t + 1)
//   (b1) and column g, where π(n) = n ^ ((n >> 2) & 1) permutes the 8
//   rows of each n-tile of the score products (π(g) is the row a lane
//   reads for column g, and accumulator column 2t + e is row π(2t + e)):
//   with π the four rows of one load differ mod 4, so the 32 lanes hit 32
//   banks, as the 8-byte loads still do (π(0..3) and π(4..7) differ mod 4).
// * Tiles are tested against the mask only where they straddle an edge;
//   a warp skips a tile its rows see none of; a block stages only tiles
//   of the hull.
// * Shared memory: 2 · 64 · S + 2 · 2 · BB · S floats (+ 2 · 2 · BB of
//   lse and D in dkdv), BB = 32, or 16 at D > 80: 90.6 KB at D = 80,
//   74.2 KB at D = 64, 104.7 KB at D = 128, two blocks an SM at each
//   (with BB = 32 at D = 128, 139.8 KB and one block, DeepSeekMoE's
//   training-shape backward took 3.97 ms on an H100 against 3.13).  D is padded to 8·NT = 32, 64,
//   80 or 128 with zero columns.  dK and dV hold D registers a thread
//   between them; dkdv takes 255 registers at D = 80 and 128, no spills.
// * wide_simt, 128 < D ≤ 256: the register tiles above hold D ≤ 128, so
//   wider heads take two plain f32 SIMT kernels, right first (bound:
//   operations at the FP32 SIMT rate).  dq has the forward's wide_simt
//   shape (16 query rows of one kv head's group a block, 4 a warp, a lane
//   a key of each 32-key K/V tile, then a float4 column pair of dQ);
//   dkdv holds 16 keys a block (4 a warp) and walks 32-query tiles of Q,
//   dO, lse and D over the group's q heads, a lane a query for the scores
//   and a column pair for dK and dV.  Sums in a fixed order, no atomics.
//   The tile geometry, the float4 dot and axpy and the staging are
//   wide_simt.cuh's, shared with the forward.
// * wide_chunk, D > 256 (any D): dq and dkdv in wide_simt's rows and
//   lanes with nothing staged (Q, K, V and dO read from global memory)
//   and D walked for the scores, a block holding only a 256-column chunk
//   of its rows' gradients (a grid over the chunks, each recomputing S
//   and dP).  Right first, slow.
// Every entry point returns a cudaError_t; nothing here allocates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mask.cuh"
#include "tf32_mma.cuh"
#include "wide_simt.cuh"

namespace {

using attn_mask::Range;
using tf32_mma::cp_async4;
using tf32_mma::cp_async_commit;
using tf32_mma::cp_async_wait;
using tf32_mma::mma_tf32;
using tf32_mma::split;
using wide_simt::axpy4;
using wide_simt::dot4;
using wide_simt::zero4;
namespace wd = wide_simt;

constexpr int THREADS = 128;         // dkdv, dq: 4 warps of 16 rows
static_assert(THREADS == wd::THREADS, "wide_simt's block is this file's");
constexpr int ROWDOT_THREADS = 256;  // rowdot: 8 rows a block
constexpr int BA = 64;  // a block's own rows: keys (dkdv), queries (dq)

// rows a streamed tile (queries in dkdv, keys in dq): 32, or 16 at D > 80,
// so that two blocks fit an SM's shared memory
template <int NT>
__host__ __device__ constexpr int rows_bb() {
  return NT <= 10 ? 32 : 16;
}
constexpr int DMAX = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

template <int ROWS>
using RowCopy = tf32_mma::RowCopy<ROWS, THREADS>;

struct Bwd {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;   // dO, as q
  const float* lse;    // (B, Hq, Tq)
  const float* delta;  // D = rowdot(dO, O), (B, Hq, Tq)
  float* grad;         // dq (dq kernel) or dk (dkdv kernel)
  float* dv;           // dkdv kernel
  int bsz, tq, tk, hq, hkv, d;
  int causal, window, chunk, q_offset;
  float scale;  // 1 / sqrt(D)
  int vec;      // 16-byte staging: d % 4 == 0 and 16-byte aligned bases
};

__device__ __forceinline__ Range keys_of(const Bwd& p, int pos_lo,
                                         int pos_hi) {
  return attn_mask::keys_seen(pos_lo, pos_hi, p.tk, p.causal, p.window,
                              p.chunk);
}

// the row of an 8-row n-tile that accumulator column (or lane group) n
// stands for
__device__ __forceinline__ int perm8(int n) { return n ^ ((n >> 2) & 1); }

// rowdot: D[b, h, i] = Σ_d dO[b, i, h, d] · O[b, i, h, d], a warp a row
__global__ void __launch_bounds__(ROWDOT_THREADS)
    flash_bwd_rowdot(const float* o, const float* dout, float* delta,
                     long long rows, int tq, int hq, int d) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (ROWDOT_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* ob = o + row * d;
  const float* gb = dout + row * d;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) s = fmaf(ob[c], gb[c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) {
    // row = (bi · tq + i) · hq + h
    const int h = (int)(row % hq);
    const long long bt = row / hq;
    const int i = (int)(bt % tq);
    const long long bi = bt / tq;
    delta[(bi * hq + h) * tq + i] = s;
  }
}

// shared memory of dkdv / dq at D padded to 8·NT
template <int NT, bool DKDV>
constexpr size_t bwd_smem() {
  constexpr int BB = rows_bb<NT>();
  return sizeof(float) * ((size_t)2 * BA * tf32_mma::frag_stride<NT>() +
                          (size_t)2 * 2 * BB * tf32_mma::frag_stride<NT>() +
                          (DKDV ? 2 * 2 * BB : 0));
}

// dkdv (DKDV) and dq.  The block's own rows X1, X2 (K, V or Q, dO) and
// the streamed tiles Y1, Y2 (Q, dO or K, V): C1 = X1·Y1ᵀ (Sᵀ or S),
// C2 = X2·Y2ᵀ (dPᵀ or dP), then acc0 += dS·Y1 (dK or dQ) and, in dkdv,
// acc1 += P·Y2 (dV).  A warp's accumulators: rows 16·warp + g (c0, c1)
// and + 8 (c2, c3); score column 2t + e of n-tile j is streamed row
// 8j + π(2t + e), output column 8n + 2t + e.
template <int NT, bool DKDV>
__device__ __forceinline__ void bwd_tc(const Bwd& p, float* smem) {
  constexpr int DP = 8 * NT;
  constexpr int S = tf32_mma::frag_stride<NT>();
  constexpr int BB = rows_bb<NT>(), NJ = BB / 8;
  constexpr int NACC = DKDV ? 2 : 1;
  // output column tiles a group: dq 4 (5 at NT = 10), dkdv 2 (two sums)
  constexpr int G = DKDV ? 2 : NT % 4 ? NT / 2 : 4;
  constexpr int HALF = NT / 2;  // k steps that issue the next tile's copies
  float* const xs1 = smem;               // [BA][S]: K (dkdv), Q (dq)
  float* const xs2 = xs1 + BA * S;       // [BA][S]: V, dO
  float* const ring = xs2 + BA * S;      // [2][Y1, Y2][BB][S]
  float* const lsd = ring + 4 * BB * S;  // dkdv: [2][lse, D][BB]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pg = perm8(g), u0 = perm8(2 * t), u1 = perm8(2 * t + 1);
  const int nyz = gridDim.y * gridDim.z;
  const long long lin =
      blockIdx.x + (long long)gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int hy = (int)(lin % nyz) % gridDim.y;  // kv head (dkdv), q head
  const int bi = (int)(lin % nyz) / gridDim.y;
  const int grp = p.hq / p.hkv;
  const int hk = DKDV ? hy : hy / grp;
  // dkdv: key tiles lowest first (under a causal mask the lowest sees the
  // most queries); dq: q tiles heaviest (last) first, as prefill_tc
  const int a0 = DKDV ? (int)(lin / nyz) * BA
                      : (gridDim.x - 1 - (int)(lin / nyz)) * BA;
  const int a_end = DKDV ? p.tk : p.tq;
  const long long kv_row = (long long)p.hkv * p.d;
  const long long q_row = (long long)p.hq * p.d;
  const long long kv_base = (long long)bi * p.tk * kv_row + (long long)hk * p.d;
  const long long q_bat = (long long)bi * p.tq * q_row;
  const float scale2 = p.scale * LOG2E;

  {  // the block's own rows, staged once
    const long long q_base = q_bat + (long long)hy * p.d;
    RowCopy<BA> xc(DKDV ? p.k + kv_base : p.q + q_base,
                   DKDV ? kv_row : q_row,
                   DKDV ? p.v + kv_base : p.dout + q_base,
                   DKDV ? kv_row : q_row, S, S, p.d, DP, p.vec);
    xc.start(xs1, xs2, a0, a_end);
    xc.finish();
  }

  // the streamed tiles: dkdv walks (q head gi of the group, q tile tt of
  // the interval [t0, t0 + per_head)); dq the keys [kv.lo, kv.hi)
  int t0 = 0, per_head = 0;
  Range kv{0, 0};
  if constexpr (DKDV) {
    const int nq = (p.tq + BB - 1) / BB;
    auto meets = [&](int tt) {
      const int q0 = tt * BB, qe = min(q0 + BB, p.tq);
      const Range kr = keys_of(p, p.q_offset + q0, p.q_offset + qe - 1);
      return kr.lo < kr.hi && kr.hi > a0 && kr.lo < a0 + BA;
    };
    while (t0 < nq && !meets(t0)) ++t0;
    int t1 = t0;
    while (t1 < nq && meets(t1)) ++t1;
    per_head = t1 - t0;
  } else {
    const int qe = min(a0 + BA, p.tq);
    kv = keys_of(p, p.q_offset + a0, p.q_offset + qe - 1);
  }
  const int ntiles = DKDV ? grp * per_head : (kv.hi - kv.lo + BB - 1) / BB;

  RowCopy<BB> yc(p.k + kv_base, DKDV ? q_row : kv_row, p.v + kv_base,
                 DKDV ? q_row : kv_row, S, S, p.d, DP, p.vec);
  const int per_step = (yc.steps() + HALF - 1) / HALF;
  // first row of tile it (dkdv: of its q head's rows), and its q head
  auto tile_row = [&](int it) {
    return DKDV ? (t0 + it % per_head) * BB : kv.lo + it * BB;
  };
  auto tile_head = [&](int it) { return hk * grp + it / per_head; };
  // start the copies of tile it into ring stage it & 1
  auto stage = [&](int it) {
    float* const y = ring + (it & 1) * 2 * BB * S;
    const int r0 = tile_row(it);
    if constexpr (DKDV) {
      const int h = tile_head(it);
      yc.kg = p.q + q_bat + (long long)h * p.d;
      yc.vg = p.dout + q_bat + (long long)h * p.d;
      yc.start(y, y + BB * S, r0, p.tq);
      if ((int)threadIdx.x < 2 * BB) {  // lse, then D, of the tile's rows
        const int r = threadIdx.x % BB;
        const float* src = threadIdx.x < BB ? p.lse : p.delta;
        const bool ok = r0 + r < p.tq;
        cp_async4(lsd + (it & 1) * 2 * BB + threadIdx.x,
                  ok ? src + ((long long)bi * p.hq + h) * p.tq + r0 + r
                     : p.lse,
                  ok);
      }
    } else {
      yc.start(y, y + BB * S, r0, kv.hi);
    }
  };
  if (ntiles > 0) {
    stage(0);
    yc.finish();
  }
  cp_async_commit();

  // this thread's two rows, a0 + 16·warp + g and + 8
  const int w0 = a0 + 16 * warp;
  const int ra = w0 + g, rb = ra + 8;
  // dkdv: the positions of the queries that see each of its keys (none
  // for a key past Tk); dq: the keys each of its queries sees, and lse
  // (log2 units) and D of the two rows (0 past Tq)
  Range va{0, 0}, vb{0, 0};
  float la = 0.0f, lb = 0.0f, da = 0.0f, db = 0.0f;
  if constexpr (DKDV) {
    if (ra < p.tk) va = attn_mask::queries_seeing(ra, p.causal, p.window,
                                                  p.chunk);
    if (rb < p.tk) vb = attn_mask::queries_seeing(rb, p.causal, p.window,
                                                  p.chunk);
  } else {
    va = keys_of(p, p.q_offset + ra, p.q_offset + ra);
    vb = keys_of(p, p.q_offset + rb, p.q_offset + rb);
    const long long hr = ((long long)bi * p.hq + hy) * p.tq;
    if (ra < p.tq) {
      la = p.lse[hr + ra] * LOG2E;
      da = p.delta[hr + ra];
    }
    if (rb < p.tq) {
      lb = p.lse[hr + rb] * LOG2E;
      db = p.delta[hr + rb];
    }
  }
  // dq: the keys some / every query of this warp sees
  const int w_end = min(w0 + 16, a_end);
  Range wkv{0, 0}, wall{0, 0};
  if (!DKDV && w0 < a_end) {
    wkv = keys_of(p, p.q_offset + w0, p.q_offset + w_end - 1);
    wall = attn_mask::keys_seen_by_all(p.q_offset + w0,
                                       p.q_offset + w_end - 1, p.tk,
                                       p.causal, p.window, p.chunk);
  }

  float acc[NACC][NT][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[a][n][0] = acc[a][n][1] = acc[a][n][2] = acc[a][n][3] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    // tile it has landed, and every warp is done with tile it − 1, whose
    // stage the copies of tile it + 1 now fill
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) stage(it + 1);
    const float* const y1 = ring + (it & 1) * 2 * BB * S;
    const float* const y2 = y1 + BB * S;
    const float* const ls = lsd + (it & 1) * 2 * BB;  // dkdv
    const int r0 = tile_row(it);
    // does this warp's 16 rows see any of the tile, all of it?
    bool work, full;
    if constexpr (DKDV) {
      const int qe = min(r0 + BB, p.tq);
      const Range kr = keys_of(p, p.q_offset + r0, p.q_offset + qe - 1);
      work = w0 < p.tk && kr.lo < kr.hi && kr.lo < w0 + 16 && kr.hi > w0;
      const Range all = attn_mask::keys_seen_by_all(
          p.q_offset + r0, p.q_offset + r0 + BB - 1, p.tk, p.causal,
          p.window, p.chunk);
      full = r0 + BB <= p.tq && all.lo <= w0 && w0 + 16 <= all.hi;
    } else {
      work = w0 < a_end && wkv.lo < r0 + BB && r0 < wkv.hi;
      full = wall.lo <= r0 && r0 + BB <= wall.hi;
    }
    if (work) {
      // C1 = X1·Y1ᵀ and C2 = X2·Y2ᵀ, 3xTF32
      float c1[NJ][4], c2[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.0f;
      const float* const xa = xs1 + (16 * warp + g) * S + 2 * t;
      const float* const xb = xs2 + (16 * warp + g) * S + 2 * t;
      const float* const ya = y1 + pg * S + 2 * t;
      const float* const yb = y2 + pg * S + 2 * t;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        // A fragments: a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1),
        // a3 (g + 8, 2t + 1) of this k step's 8 columns
        uint32_t ah[4], al[4], bh[4], bl[4];
        {
          const float2 x0 = *reinterpret_cast<const float2*>(xa + 8 * kk);
          const float2 x8 =
              *reinterpret_cast<const float2*>(xa + 8 * S + 8 * kk);
          split(x0.x, ah[0], al[0]);
          split(x8.x, ah[1], al[1]);
          split(x0.y, ah[2], al[2]);
          split(x8.y, ah[3], al[3]);
        }
        {
          const float2 x0 = *reinterpret_cast<const float2*>(xb + 8 * kk);
          const float2 x8 =
              *reinterpret_cast<const float2*>(xb + 8 * S + 8 * kk);
          split(x0.x, bh[0], bl[0]);
          split(x8.x, bh[1], bl[1]);
          split(x0.y, bh[2], bl[2]);
          split(x8.y, bh[3], bl[3]);
        }
        if (kk < HALF) yc.issue(per_step);
        uint32_t sh[NJ][2], sl[NJ][2], th[NJ][2], tl[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {  // rows 8j + π(g), columns 2t, 2t+1
          const float2 s = *reinterpret_cast<const float2*>(
              ya + 8 * j * S + 8 * kk);
          const float2 u = *reinterpret_cast<const float2*>(
              yb + 8 * j * S + 8 * kk);
          split(s.x, sh[j][0], sl[j][0]);
          split(s.y, sh[j][1], sl[j][1]);
          split(u.x, th[j][0], tl[j][0]);
          split(u.y, th[j][1], tl[j][1]);
        }
        // lo·hi, hi·lo, hi·hi, pass by pass: the MMAs that update one
        // accumulator are 2·NJ apart
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma_tf32(c1[j], al, sh[j][0], sh[j][1]);
          mma_tf32(c2[j], bl, th[j][0], th[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma_tf32(c1[j], ah, sl[j][0], sl[j][1]);
          mma_tf32(c2[j], bh, tl[j][0], tl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma_tf32(c1[j], ah, sh[j][0], sh[j][1]);
          mma_tf32(c2[j], bh, th[j][0], th[j][1]);
        }
      }
      yc.finish();

      // P into c1, dS into c2; entry e of n-tile j: own row (e < 2 ? ra :
      // rb), streamed row r0 + 8j + (e & 1 ? u1 : u0).  The mask is
      // tested only on a tile that straddles an edge; a hidden entry is
      // 0 by a select, never by exp of anything
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float l2[2], dd[2];
        if constexpr (DKDV) {
          l2[0] = ls[8 * j + u0] * LOG2E;
          l2[1] = ls[8 * j + u1] * LOG2E;
          dd[0] = ls[BB + 8 * j + u0];
          dd[1] = ls[BB + 8 * j + u1];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int other = r0 + 8 * j + (e & 1 ? u1 : u0);
          const Range& vr = e < 2 ? va : vb;
          bool ok = true;
          float l, dl;
          if constexpr (DKDV) {
            const int pos = p.q_offset + other;
            if (!full) ok = other < p.tq && pos >= vr.lo && pos < vr.hi;
            l = l2[e & 1];
            dl = dd[e & 1];
          } else {
            if (!full) ok = other >= vr.lo && other < vr.hi;
            l = e < 2 ? la : lb;
            dl = e < 2 ? da : db;
          }
          const float pe = ok ? exp2f(fmaf(c1[j][e], scale2, -l)) : 0.0f;
          c2[j][e] = pe * (c2[j][e] - dl);
          c1[j][e] = pe;
        }
      }

      // acc0 += dS·Y1 and (dkdv) acc1 += P·Y2 over the tile's rows, G
      // output column tiles at a time: the A fragment of n-tile j is
      // {c0, c2, c1, c3}; the B fragment holds rows 8j + u0 (b0), 8j + u1
      // (b1) of column 8n + g.  A tile's sum goes into fresh accumulators
      // and is added to acc by an f32 add: the tensor core truncates
      // each sum it writes, so MMAs chained over every tile of a long
      // sequence (dK and dV sum up to g · Tq rows) would drift toward 0
      // by ≈2^-24 of the sum per MMA
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += G) {
        float part[NACC][G][4];
#pragma unroll
        for (int a = 0; a < NACC; ++a)
#pragma unroll
          for (int n = 0; n < G; ++n)
            part[a][n][0] = part[a][n][1] = part[a][n][2] = part[a][n][3] =
                0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t sh[4], sl[4], ph[4], pl[4];
          split(c2[j][0], sh[0], sl[0]);
          split(c2[j][2], sh[1], sl[1]);
          split(c2[j][1], sh[2], sl[2]);
          split(c2[j][3], sh[3], sl[3]);
          if constexpr (DKDV) {
            split(c1[j][0], ph[0], pl[0]);
            split(c1[j][2], ph[1], pl[1]);
            split(c1[j][1], ph[2], pl[2]);
            split(c1[j][3], ph[3], pl[3]);
          }
          const float* const ra0 = y1 + (8 * j + u0) * S + g + 8 * n0;
          const float* const ra1 = y1 + (8 * j + u1) * S + g + 8 * n0;
          const float* const rb0 = y2 + (8 * j + u0) * S + g + 8 * n0;
          const float* const rb1 = y2 + (8 * j + u1) * S + g + 8 * n0;
          uint32_t yh[G][2], yl[G][2], zh[G][2], zl[G][2];
#pragma unroll
          for (int n = 0; n < G; ++n) {
            split(ra0[8 * n], yh[n][0], yl[n][0]);
            split(ra1[8 * n], yh[n][1], yl[n][1]);
            if constexpr (DKDV) {
              split(rb0[8 * n], zh[n][0], zl[n][0]);
              split(rb1[8 * n], zh[n][1], zl[n][1]);
            }
          }
#pragma unroll
          for (int n = 0; n < G; ++n) {
            mma_tf32(part[0][n], sl, yh[n][0], yh[n][1]);
            if constexpr (DKDV)
              mma_tf32(part[NACC - 1][n], pl, zh[n][0], zh[n][1]);
          }
#pragma unroll
          for (int n = 0; n < G; ++n) {
            mma_tf32(part[0][n], sh, yl[n][0], yl[n][1]);
            if constexpr (DKDV)
              mma_tf32(part[NACC - 1][n], ph, zl[n][0], zl[n][1]);
          }
#pragma unroll
          for (int n = 0; n < G; ++n) {
            mma_tf32(part[0][n], sh, yh[n][0], yh[n][1]);
            if constexpr (DKDV)
              mma_tf32(part[NACC - 1][n], ph, zh[n][0], zh[n][1]);
          }
        }
#pragma unroll
        for (int a = 0; a < NACC; ++a)
#pragma unroll
          for (int n = 0; n < G; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][n0 + n][e] += part[a][n][e];
      }
    } else {
      yc.finish();
    }
    cp_async_commit();
  }
  cp_async_wait<0>();  // nothing in flight when the block ends

  // rows ra, rb; columns 8n + 2t, + 1
  const long long rs = DKDV ? kv_row : q_row;
  float* const o0 =
      p.grad + (DKDV ? kv_base : q_bat + (long long)hy * p.d);
  float* const o1 = p.dv + kv_base;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? ra : rb, c = 8 * n + 2 * t + (e & 1);
      if (r < a_end && c < p.d) {
        o0[r * rs + c] = acc[0][n][e] * p.scale;
        if constexpr (DKDV) o1[r * rs + c] = acc[NACC - 1][n][e];
      }
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv(Bwd p) {
  extern __shared__ __align__(16) float smem[];
  bwd_tc<NT, true>(p, smem);
}

template <int NT>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq(Bwd p) {
  extern __shared__ __align__(16) float smem[];
  bwd_tc<NT, false>(p, smem);
}

// ---------------------------------------------------------------------------
// wide_simt: 128 < D ≤ 256, f32 SIMT
// ---------------------------------------------------------------------------

// dq, the forward's shape (flash_attention.cu, flash_wide_simt): a block
// holds wd::OWN query rows r = i·g + gi of (bi, hk), warp w rows w, w + 4,
// …; a lane takes a key of each streamed 32-key tile for S = Q·Kᵀ and
// dP = dO·Vᵀ (Q and dO read as broadcasts), and its float4 columns
// lane, lane + 32 for dQ += dS·K, dS handed round by a shuffle.
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_wide(Bwd p, int dp) {
  extern __shared__ __align__(16) float smem[];
  const int sd = dp + 4;
  float* const qs = smem;               // [wd::OWN][dp], Q · log2(e)/√D
  float* const gs = qs + wd::OWN * dp;   // [wd::OWN][dp], dO
  float* const ks = gs + wd::OWN * dp;   // [wd::TILE][sd]
  float* const vs = ks + wd::TILE * sd;    // [wd::TILE][sd]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int grp = p.hq / p.hkv;
  const int n_rows = p.tq * grp;
  const int r0 = blockIdx.x * wd::OWN;
  if (r0 >= n_rows) return;
  const int r_end = min(r0 + wd::OWN, n_rows);
  const Range kv = keys_of(p, p.q_offset + r0 / grp,
                           p.q_offset + (r_end - 1) / grp);
  const float scale2 = p.scale * LOG2E;
  const long long q_row = (long long)p.hq * p.d;
  const long long kv_row = (long long)p.hkv * p.d;

  for (int i = threadIdx.x; i < wd::OWN * dp; i += THREADS) {
    const int r = i / dp, c = i - r * dp, row = r0 + r;
    float x = 0.0f, y = 0.0f;
    if (row < r_end && c < p.d) {
      const long long at = ((long long)bi * p.tq + row / grp) * q_row +
                           (long long)(hk * grp + row % grp) * p.d + c;
      x = p.q[at] * scale2;
      y = p.dout[at];
    }
    qs[i] = x;
    gs[i] = y;
  }

  Range vr[wd::RW];
  float l2[wd::RW], dl[wd::RW];
  int wlo = 0, whi = 0;  // empty until a row sees a key
#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    const int row = r0 + warp + 4 * e;
    vr[e] = Range{0, 0};
    l2[e] = dl[e] = 0.0f;
    if (row < r_end) {
      const int qi = row / grp, h = hk * grp + row % grp;
      vr[e] = keys_of(p, p.q_offset + qi, p.q_offset + qi);
      const long long at = ((long long)bi * p.hq + h) * p.tq + qi;
      l2[e] = p.lse[at] * LOG2E;
      dl[e] = p.delta[at];
    }
    if (vr[e].lo < vr[e].hi) {
      const bool first = wlo >= whi;
      wlo = first ? vr[e].lo : min(wlo, vr[e].lo);
      whi = first ? vr[e].hi : max(whi, vr[e].hi);
    }
  }

  float4 acc[wd::RW][wd::NV];
#pragma unroll
  for (int e = 0; e < wd::RW; ++e)
#pragma unroll
    for (int n = 0; n < wd::NV; ++n) acc[e][n] = zero4();

  const float* kg = p.k + (long long)bi * p.tk * kv_row + (long long)hk * p.d;
  const float* vg = p.v + (long long)bi * p.tk * kv_row + (long long)hk * p.d;
  const int dp4 = dp / 4;
  for (int k0 = kv.lo; k0 < kv.hi; k0 += wd::TILE) {
    __syncthreads();  // every warp is done with the last tile
    wd::stage(ks, sd, kg, kv_row, k0, wd::TILE, kv.hi, p.d, dp, p.vec,
              1.0f);
    wd::stage(vs, sd, vg, kv_row, k0, wd::TILE, kv.hi, p.d, dp, p.vec,
              1.0f);
    __syncthreads();
    if (!(wlo < k0 + wd::TILE && k0 < whi)) continue;  // warp-uniform

    float sc[wd::RW], dpv[wd::RW];
#pragma unroll
    for (int e = 0; e < wd::RW; ++e) sc[e] = dpv[e] = 0.0f;
    const float* kr = ks + lane * sd;
    const float* vr_ = vs + lane * sd;
    for (int c4 = 0; c4 < dp4; ++c4) {
      const float4 kx = *reinterpret_cast<const float4*>(kr + 4 * c4);
      const float4 vx = *reinterpret_cast<const float4*>(vr_ + 4 * c4);
#pragma unroll
      for (int e = 0; e < wd::RW; ++e) {
        const int o = (warp + 4 * e) * dp + 4 * c4;
        sc[e] = dot4(*reinterpret_cast<const float4*>(qs + o), kx, sc[e]);
        dpv[e] = dot4(*reinterpret_cast<const float4*>(gs + o), vx, dpv[e]);
      }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int e = 0; e < wd::RW; ++e) {
      const bool ok = key >= vr[e].lo && key < vr[e].hi;
      const float pe = ok ? exp2f(sc[e] - l2[e]) : 0.0f;
      sc[e] = pe * (dpv[e] - dl[e]);  // dS
    }
    const int nk = min(wd::TILE, kv.hi - k0);
    for (int j = 0; j < nk; ++j) {
      float4 kx[wd::NV];
#pragma unroll
      for (int n = 0; n < wd::NV; ++n) {
        const int c4 = lane + 32 * n;
        kx[n] = c4 < dp4
                    ? *reinterpret_cast<const float4*>(ks + j * sd + 4 * c4)
                    : zero4();
      }
#pragma unroll
      for (int e = 0; e < wd::RW; ++e) {
        const float dsj = __shfl_sync(FULL, sc[e], j);
#pragma unroll
        for (int n = 0; n < wd::NV; ++n) axpy4(acc[e][n], dsj, kx[n]);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    const int row = r0 + warp + 4 * e;
    if (row >= r_end) continue;
    float* out = p.grad + ((long long)bi * p.tq + row / grp) * q_row +
                 (long long)(hk * grp + row % grp) * p.d;
#pragma unroll
    for (int n = 0; n < wd::NV; ++n) {
      const int c = 4 * (lane + 32 * n);
      const float x[4] = {acc[e][n].x, acc[e][n].y, acc[e][n].z,
                          acc[e][n].w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < p.d) out[c + u] = x[u] * p.scale;
    }
  }
}

// dkdv: a block holds wd::OWN keys of (bi, hk), warp w keys 4w … 4w + 3,
// and walks the g q heads of the kv head and, in each, the queries that
// see any of its keys (queries_seeing of its first and last key bound
// them), in 32-row tiles of Q, dO, lse and D.  A lane takes a query of
// the tile for Sᵀ and dPᵀ against the warp's keys (K and V read as
// broadcasts), then its float4 columns for dV += P·dO and dK += dS·Q,
// P and dS handed round by shuffles; the sum over the group's q heads
// stays in registers, no atomics.
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_wide(Bwd p,
                                                               int dp) {
  extern __shared__ __align__(16) float smem[];
  const int sd = dp + 4;
  float* const ks = smem;               // [wd::OWN][dp]
  float* const vs = ks + wd::OWN * dp;   // [wd::OWN][dp]
  float* const qt = vs + wd::OWN * dp;   // [wd::TILE][sd], Q
  float* const gt = qt + wd::TILE * sd;    // [wd::TILE][sd], dO
  float* const ld = gt + wd::TILE * sd;    // [lse · log2(e), D][wd::TILE]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int grp = p.hq / p.hkv;
  const int a0 = blockIdx.x * wd::OWN;
  if (a0 >= p.tk) return;
  const int a_end = min(a0 + wd::OWN, p.tk);
  const float scale2 = p.scale * LOG2E;
  const long long q_row = (long long)p.hq * p.d;
  const long long kv_row = (long long)p.hkv * p.d;
  const long long kv_base =
      (long long)bi * p.tk * kv_row + (long long)hk * p.d;
  wd::stage(ks, dp, p.k + kv_base, kv_row, a0, wd::OWN, a_end, p.d, dp,
            p.vec, 1.0f);
  wd::stage(vs, dp, p.v + kv_base, kv_row, a0, wd::OWN, a_end, p.d, dp,
            p.vec, 1.0f);

  // the queries [lo, hi) that see some key of [k_first, k_last]
  auto queries = [&](int k_first, int k_last) {
    const Range a = attn_mask::queries_seeing(k_first, p.causal, p.window,
                                              p.chunk);
    const Range b = attn_mask::queries_seeing(k_last, p.causal, p.window,
                                              p.chunk);
    const int lo = max(0, a.lo - p.q_offset);
    const int hi = min(p.tq, b.hi - p.q_offset);
    return Range{lo, hi > lo ? hi : lo};
  };
  const Range qb = queries(a0, a_end - 1);
  const int w0 = a0 + 4 * warp;
  const Range qw = w0 < a_end ? queries(w0, min(w0 + 4, a_end) - 1)
                              : Range{0, 0};

  float4 dk[wd::RW][wd::NV], dv[wd::RW][wd::NV];
#pragma unroll
  for (int e = 0; e < wd::RW; ++e)
#pragma unroll
    for (int n = 0; n < wd::NV; ++n) dk[e][n] = dv[e][n] = zero4();

  const int dp4 = dp / 4;
  for (int gi = 0; gi < grp; ++gi) {
    const int h = hk * grp + gi;
    const long long q_base = (long long)bi * p.tq * q_row + (long long)h * p.d;
    const long long hr = ((long long)bi * p.hq + h) * p.tq;
    for (int i0 = qb.lo; i0 < qb.hi; i0 += wd::TILE) {
      __syncthreads();  // every warp is done with the last tile
      wd::stage(qt, sd, p.q + q_base, q_row, i0, wd::TILE, qb.hi, p.d, dp,
                p.vec, 1.0f);
      wd::stage(gt, sd, p.dout + q_base, q_row, i0, wd::TILE, qb.hi, p.d,
                dp, p.vec, 1.0f);
      if ((int)threadIdx.x < 2 * wd::TILE) {
        const int r = threadIdx.x % wd::TILE;
        const bool in = i0 + r < qb.hi;
        ld[threadIdx.x] = threadIdx.x < wd::TILE
                              ? (in ? p.lse[hr + i0 + r] * LOG2E : 0.0f)
                              : (in ? p.delta[hr + i0 + r] : 0.0f);
      }
      __syncthreads();
      if (!(qw.lo < i0 + wd::TILE && i0 < qw.hi)) continue;  // warp-uniform

      const int qi = i0 + lane;
      const Range vq = qi < qb.hi ? keys_of(p, p.q_offset + qi,
                                            p.q_offset + qi)
                                  : Range{0, 0};
      float sc[wd::RW], dpv[wd::RW];
#pragma unroll
      for (int e = 0; e < wd::RW; ++e) sc[e] = dpv[e] = 0.0f;
      const float* qr = qt + lane * sd;
      const float* gr = gt + lane * sd;
      for (int c4 = 0; c4 < dp4; ++c4) {
        const float4 qx = *reinterpret_cast<const float4*>(qr + 4 * c4);
        const float4 gx = *reinterpret_cast<const float4*>(gr + 4 * c4);
#pragma unroll
        for (int e = 0; e < wd::RW; ++e) {
          const int o = (4 * warp + e) * dp + 4 * c4;
          sc[e] = dot4(qx, *reinterpret_cast<const float4*>(ks + o), sc[e]);
          dpv[e] = dot4(gx, *reinterpret_cast<const float4*>(vs + o), dpv[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < wd::RW; ++e) {
        const int key = w0 + e;
        const bool ok = key < a_end && key >= vq.lo && key < vq.hi;
        const float pe = ok ? exp2f(fmaf(sc[e], scale2, -ld[lane])) : 0.0f;
        sc[e] = pe;                               // P
        dpv[e] = pe * (dpv[e] - ld[wd::TILE + lane]);  // dS
      }
      const int nq = min(wd::TILE, qb.hi - i0);
      for (int j = 0; j < nq; ++j) {
        float4 qx[wd::NV], gx[wd::NV];
#pragma unroll
        for (int n = 0; n < wd::NV; ++n) {
          const int c4 = lane + 32 * n;
          const bool in = c4 < dp4;
          qx[n] = in ? *reinterpret_cast<const float4*>(qt + j * sd + 4 * c4)
                     : zero4();
          gx[n] = in ? *reinterpret_cast<const float4*>(gt + j * sd + 4 * c4)
                     : zero4();
        }
#pragma unroll
        for (int e = 0; e < wd::RW; ++e) {
          const float pj = __shfl_sync(FULL, sc[e], j);
          const float dsj = __shfl_sync(FULL, dpv[e], j);
#pragma unroll
          for (int n = 0; n < wd::NV; ++n) {
            axpy4(dv[e][n], pj, gx[n]);
            axpy4(dk[e][n], dsj, qx[n]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    const int key = w0 + e;
    if (key >= a_end) continue;
    float* odk = p.grad + kv_base + (long long)key * kv_row;
    float* odv = p.dv + kv_base + (long long)key * kv_row;
#pragma unroll
    for (int n = 0; n < wd::NV; ++n) {
      const int c = 4 * (lane + 32 * n);
      const float xk[4] = {dk[e][n].x, dk[e][n].y, dk[e][n].z, dk[e][n].w};
      const float xv[4] = {dv[e][n].x, dv[e][n].y, dv[e][n].z, dv[e][n].w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < p.d) {
          odk[c + u] = xk[u] * p.scale;
          odv[c + u] = xv[u];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// wide_chunk: D > 256, f32 SIMT, D walked in chunks
// ---------------------------------------------------------------------------

// The gradient columns a wide_chunk block writes, and a lane's share
constexpr int CW = 256;
constexpr int CU = CW / 32;

// the column chunks of a wide_chunk call
__host__ __device__ __forceinline__ int wide_chunks(int d) {
  return (d + CW - 1) / CW;
}

// dq, flash_bwd_dq_wide's rows (blockIdx.x = row tile · chunks + chunk c),
// nothing staged: a lane takes a key of each 32-key tile of its warp's
// hull for S = Q·Kᵀ and dP = dO·Vᵀ over all of D from global memory (Q
// and dO as broadcasts), then its columns c·CW + lane + 32u of
// dQ += dS·K, dS handed round by a shuffle.  Warps run apart.
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_chunk(Bwd p,
                                                              int chunks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int tile = blockIdx.x / chunks, c0 = (blockIdx.x % chunks) * CW;
  const int grp = p.hq / p.hkv;
  const int n_rows = p.tq * grp;
  const int r0 = tile * wd::OWN;
  if (r0 >= n_rows) return;
  const int r_end = min(r0 + wd::OWN, n_rows);
  const float scale2 = p.scale * LOG2E;
  const long long q_row = (long long)p.hq * p.d;
  const long long kv_row = (long long)p.hkv * p.d;

  const float* qr[wd::RW];
  const float* gr[wd::RW];
  Range vr[wd::RW];
  float l2[wd::RW], dl[wd::RW];
  int wlo = 0, whi = 0;  // empty until a row sees a key
#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    const int row = r0 + warp + 4 * e;
    qr[e] = p.q;
    gr[e] = p.dout;
    vr[e] = Range{0, 0};
    l2[e] = dl[e] = 0.0f;
    if (row < r_end) {
      const int qi = row / grp, h = hk * grp + row % grp;
      const long long at =
          ((long long)bi * p.tq + qi) * q_row + (long long)h * p.d;
      qr[e] = p.q + at;
      gr[e] = p.dout + at;
      vr[e] = keys_of(p, p.q_offset + qi, p.q_offset + qi);
      const long long hr = ((long long)bi * p.hq + h) * p.tq + qi;
      l2[e] = p.lse[hr] * LOG2E;
      dl[e] = p.delta[hr];
    }
    if (vr[e].lo < vr[e].hi) {
      const bool first = wlo >= whi;
      wlo = first ? vr[e].lo : min(wlo, vr[e].lo);
      whi = first ? vr[e].hi : max(whi, vr[e].hi);
    }
  }

  float acc[wd::RW][CU];
#pragma unroll
  for (int e = 0; e < wd::RW; ++e)
#pragma unroll
    for (int u = 0; u < CU; ++u) acc[e][u] = 0.0f;

  const float* kg = p.k + (long long)bi * p.tk * kv_row + (long long)hk * p.d;
  const float* vg = p.v + (long long)bi * p.tk * kv_row + (long long)hk * p.d;
  for (int k0 = wlo; k0 < whi; k0 += wd::TILE) {
    const int key = k0 + lane;
    float sc[wd::RW], dpv[wd::RW];
#pragma unroll
    for (int e = 0; e < wd::RW; ++e) sc[e] = dpv[e] = 0.0f;
    if (key < whi) {
      const float* kr = kg + key * kv_row;
      const float* vr_ = vg + key * kv_row;
      for (int c = 0; c < p.d; ++c) {
        const float kx = kr[c], vx = vr_[c];
#pragma unroll
        for (int e = 0; e < wd::RW; ++e) {
          sc[e] = fmaf(qr[e][c], kx, sc[e]);
          dpv[e] = fmaf(gr[e][c], vx, dpv[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < wd::RW; ++e) {
      const bool ok = key >= vr[e].lo && key < vr[e].hi;
      const float pe = ok ? exp2f(fmaf(sc[e], scale2, -l2[e])) : 0.0f;
      sc[e] = pe * (dpv[e] - dl[e]);  // dS
    }
    const int nk = min(wd::TILE, whi - k0);
    for (int j = 0; j < nk; ++j) {
      const float* kj = kg + (k0 + j) * kv_row;
      float kx[CU];
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const int c = c0 + lane + 32 * u;
        kx[u] = c < p.d ? kj[c] : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < wd::RW; ++e) {
        const float dsj = __shfl_sync(FULL, sc[e], j);
#pragma unroll
        for (int u = 0; u < CU; ++u) acc[e][u] = fmaf(dsj, kx[u], acc[e][u]);
      }
    }
  }

#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    const int row = r0 + warp + 4 * e;
    if (row >= r_end) continue;
    float* out = p.grad + ((long long)bi * p.tq + row / grp) * q_row +
                 (long long)(hk * grp + row % grp) * p.d;
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int c = c0 + lane + 32 * u;
      if (c < p.d) out[c] = acc[e][u] * p.scale;
    }
  }
}

// dkdv, flash_bwd_dkdv_wide's keys (blockIdx.x = key tile · chunks + chunk
// c; warp w keys 4w … 4w + 3), nothing staged: the warp walks the g q heads
// of the kv head and, in each, 32-query tiles of the queries that see any
// of its keys, a lane a query for Sᵀ and dPᵀ over all of D from global
// memory (K and V as broadcasts), then its columns c·CW + lane + 32u of
// dV += P·dO and dK += dS·Q, P and dS handed round by shuffles; the sum
// over the group stays in registers, no atomics.
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_chunk(Bwd p,
                                                                int chunks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int tile = blockIdx.x / chunks, c0 = (blockIdx.x % chunks) * CW;
  const int grp = p.hq / p.hkv;
  const int a0 = tile * wd::OWN;
  if (a0 >= p.tk) return;
  const int a_end = min(a0 + wd::OWN, p.tk);
  const float scale2 = p.scale * LOG2E;
  const long long q_row = (long long)p.hq * p.d;
  const long long kv_row = (long long)p.hkv * p.d;
  const long long kv_base =
      (long long)bi * p.tk * kv_row + (long long)hk * p.d;
  const int w0 = a0 + 4 * warp;

  const float* kr[wd::RW];
  const float* vr_[wd::RW];
#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    const int key = min(w0 + e, a_end - 1);  // a real row; masked below
    kr[e] = p.k + kv_base + key * kv_row;
    vr_[e] = p.v + kv_base + key * kv_row;
  }
  // the queries [lo, hi) that see some key of the warp's
  Range qw{0, 0};
  if (w0 < a_end) {
    const Range a = attn_mask::queries_seeing(w0, p.causal, p.window,
                                              p.chunk);
    const Range b = attn_mask::queries_seeing(min(w0 + 4, a_end) - 1,
                                              p.causal, p.window, p.chunk);
    qw.lo = max(0, a.lo - p.q_offset);
    qw.hi = max(qw.lo, min(p.tq, b.hi - p.q_offset));
  }

  float dk[wd::RW][CU], dv[wd::RW][CU];
#pragma unroll
  for (int e = 0; e < wd::RW; ++e)
#pragma unroll
    for (int u = 0; u < CU; ++u) dk[e][u] = dv[e][u] = 0.0f;

  for (int gi = 0; gi < grp; ++gi) {
    const int h = hk * grp + gi;
    const long long q_base = (long long)bi * p.tq * q_row + (long long)h * p.d;
    const long long hr = ((long long)bi * p.hq + h) * p.tq;
    for (int i0 = qw.lo; i0 < qw.hi; i0 += wd::TILE) {
      const int qi = i0 + lane;
      const bool inq = qi < qw.hi;
      const Range vq = inq ? keys_of(p, p.q_offset + qi, p.q_offset + qi)
                           : Range{0, 0};
      const float l2 = inq ? p.lse[hr + qi] * LOG2E : 0.0f;
      const float dl = inq ? p.delta[hr + qi] : 0.0f;
      float sc[wd::RW], dpv[wd::RW];
#pragma unroll
      for (int e = 0; e < wd::RW; ++e) sc[e] = dpv[e] = 0.0f;
      if (inq) {
        const float* qrow = p.q + q_base + qi * q_row;
        const float* grow = p.dout + q_base + qi * q_row;
        for (int c = 0; c < p.d; ++c) {
          const float qx = qrow[c], gx = grow[c];
#pragma unroll
          for (int e = 0; e < wd::RW; ++e) {
            sc[e] = fmaf(qx, kr[e][c], sc[e]);
            dpv[e] = fmaf(gx, vr_[e][c], dpv[e]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < wd::RW; ++e) {
        const int key = w0 + e;
        const bool ok = key < a_end && key >= vq.lo && key < vq.hi;
        const float pe = ok ? exp2f(fmaf(sc[e], scale2, -l2)) : 0.0f;
        sc[e] = pe;                     // P
        dpv[e] = pe * (dpv[e] - dl);    // dS
      }
      const int nq = min(wd::TILE, qw.hi - i0);
      for (int j = 0; j < nq; ++j) {
        const float* qj = p.q + q_base + (i0 + j) * q_row;
        const float* gj = p.dout + q_base + (i0 + j) * q_row;
        float qx[CU], gx[CU];
#pragma unroll
        for (int u = 0; u < CU; ++u) {
          const int c = c0 + lane + 32 * u;
          const bool in = c < p.d;
          qx[u] = in ? qj[c] : 0.0f;
          gx[u] = in ? gj[c] : 0.0f;
        }
#pragma unroll
        for (int e = 0; e < wd::RW; ++e) {
          const float pj = __shfl_sync(FULL, sc[e], j);
          const float dsj = __shfl_sync(FULL, dpv[e], j);
#pragma unroll
          for (int u = 0; u < CU; ++u) {
            dv[e][u] = fmaf(pj, gx[u], dv[e][u]);
            dk[e][u] = fmaf(dsj, qx[u], dk[e][u]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int e = 0; e < wd::RW; ++e) {
    const int key = w0 + e;
    if (key >= a_end) continue;
    float* odk = p.grad + kv_base + (long long)key * kv_row;
    float* odv = p.dv + kv_base + (long long)key * kv_row;
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int c = c0 + lane + 32 * u;
      if (c < p.d) {
        odk[c] = dk[e][u] * p.scale;
        odv[c] = dv[e][u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// 8-column tiles of D, padded: prefill_tc's instantiations
int padded_nt(int d) { return d <= 32 ? 4 : d <= 64 ? 8 : d <= 80 ? 10 : 16; }

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

bool bad_shape(int bsz, int tq, int tk, int hq, int hkv, int d) {
  return bsz < 0 || tq < 0 || tk < 0 || d <= 0 || d > DMAX || hkv <= 0 ||
         hq <= 0 || hq % hkv != 0 || bsz > 65535 || hq > 65535;
}

template <int NT, bool DKDV>
int launch(const Bwd& p, cudaStream_t st) {
  constexpr size_t smem = bwd_smem<NT, DKDV>();
  auto kernel = DKDV ? flash_bwd_dkdv<NT> : flash_bwd_dq<NT>;
  // per call: the attribute belongs to the current device; a size the card
  // cannot give fails here, and the wrapper raises
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((DKDV ? p.tk : p.tq) + BA - 1) / BA, DKDV ? p.hkv : p.hq,
                  p.bsz);
  kernel<<<grid, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <bool DKDV>
int launch_padded(const Bwd& p, cudaStream_t st) {
  switch (padded_nt(p.d)) {
    case 4: return launch<4, DKDV>(p, st);
    case 8: return launch<8, DKDV>(p, st);
    case 10: return launch<10, DKDV>(p, st);
    default: return launch<16, DKDV>(p, st);
  }
}

// dkdv (DKDV) or dq of the wide_simt route
template <bool DKDV>
int launch_wide(const Bwd& p, cudaStream_t st) {
  const int dp = (p.d + 7) / 8 * 8;
  const size_t smem =
      sizeof(float) * ((size_t)2 * wd::OWN * dp + (size_t)2 * wd::TILE *
                       (dp + 4) + (DKDV ? 2 * wd::TILE : 0));
  auto kernel = DKDV ? flash_bwd_dkdv_wide : flash_bwd_dq_wide;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows =
      DKDV ? (long long)p.tk : (long long)p.tq * (p.hq / p.hkv);
  const dim3 grid((unsigned)((rows + wd::OWN - 1) / wd::OWN), p.hkv, p.bsz);
  kernel<<<grid, THREADS, smem, st>>>(p, dp);
  return (int)cudaGetLastError();
}

// dkdv (DKDV) or dq of the wide_chunk route
template <bool DKDV>
int launch_chunk(const Bwd& p, cudaStream_t st) {
  const long long rows =
      DKDV ? (long long)p.tk : (long long)p.tq * (p.hq / p.hkv);
  const int chunks = wide_chunks(p.d);
  const dim3 grid((unsigned)((rows + wd::OWN - 1) / wd::OWN * chunks), p.hkv,
                  p.bsz);
  auto kernel = DKDV ? flash_bwd_dkdv_chunk : flash_bwd_dq_chunk;
  kernel<<<grid, THREADS, 0, st>>>(p, chunks);
  return (int)cudaGetLastError();
}

bool bad_wide_shape(int bsz, int tq, int tk, int hq, int hkv, int d) {
  return bsz < 0 || tq < 0 || tk < 0 || d <= 0 || d > wd::DMAX || hkv <= 0 ||
         hq <= 0 || hq % hkv != 0 || bsz > 65535 || hkv > 65535;
}

bool bad_chunk_shape(int bsz, int tq, int tk, int hq, int hkv, int d) {
  return bsz < 0 || tq < 0 || tk < 0 || d <= 0 || hkv <= 0 || hq <= 0 ||
         hq % hkv != 0 || bsz > 65535 || hkv > 65535;
}

Bwd make_bwd(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* grad, void* dv,
             int bsz, int tq, int tk, int hq, int hkv, int d, int causal,
             int window, int chunk, int q_offset, float scale) {
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout);
  return Bwd{static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<const float*>(dout),
             static_cast<const float*>(lse), static_cast<const float*>(delta),
             static_cast<float*>(grad), static_cast<float*>(dv), bsz, tq, tk,
             hq, hkv, d, causal, window, chunk, q_offset, scale, vec};
}

}  // namespace

// All tensors contiguous f32: q, o, dout (bsz, tq, hq, d); k, v, dk, dv
// (bsz, tk, hkv, d); lse, delta (bsz, hq, tq).  window, chunk: 0 = no such
// mask; scale: 1/sqrt(d).  Each entry returns a cudaError_t.

// delta = rowdot(dout, o), every route (any d)
extern "C" int flash_attention_bwd_rowdot(const void* o, const void* dout,
                                          void* delta, int bsz, int tq,
                                          int hq, int d, void* stream) {
  if (bsz < 0 || tq < 0 || hq <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)bsz * tq * hq;
  if (rows == 0) return (int)cudaGetLastError();
  const int per = ROWDOT_THREADS / 32;
  flash_bwd_rowdot<<<(unsigned)((rows + per - 1) / per), ROWDOT_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<float*>(delta), rows, tq, hq, d);
  return (int)cudaGetLastError();
}

// dk, dv (every entry written; 0 for keys no query sees)
extern "C" int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bsz, int tq,
    int tk, int hq, int hkv, int d, int causal, int window, int chunk,
    int q_offset, float scale, void* stream) {
  if (bad_shape(bsz, tq, tk, hq, hkv, d) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || tk == 0) return (int)cudaGetLastError();
  const Bwd p = make_bwd(q, k, v, dout, lse, delta, dk, dv, bsz, tq, tk, hq,
                         hkv, d, causal, window, chunk, q_offset, scale);
  return launch_padded<true>(p, static_cast<cudaStream_t>(stream));
}

// dq (every entry written; 0 for rows that see no key)
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bsz, int tq, int tk,
    int hq, int hkv, int d, int causal, int window, int chunk, int q_offset,
    float scale, void* stream) {
  if (bad_shape(bsz, tq, tk, hq, hkv, d) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || tq == 0) return (int)cudaGetLastError();
  const Bwd p = make_bwd(q, k, v, dout, lse, delta, dq, nullptr, bsz, tq, tk,
                         hq, hkv, d, causal, window, chunk, q_offset, scale);
  return launch_padded<false>(p, static_cast<cudaStream_t>(stream));
}

// the wide_simt route, 128 < d ≤ 256 (any d up to 256 runs): as
// flash_attention_bwd_dkdv and flash_attention_bwd_dq, f32 SIMT
extern "C" int flash_attention_bwd_dkdv_wide(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bsz, int tq,
    int tk, int hq, int hkv, int d, int causal, int window, int chunk,
    int q_offset, float scale, void* stream) {
  if (bad_wide_shape(bsz, tq, tk, hq, hkv, d) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || tk == 0) return (int)cudaGetLastError();
  const Bwd p = make_bwd(q, k, v, dout, lse, delta, dk, dv, bsz, tq, tk, hq,
                         hkv, d, causal, window, chunk, q_offset, scale);
  return launch_wide<true>(p, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dq_wide(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bsz, int tq, int tk,
    int hq, int hkv, int d, int causal, int window, int chunk, int q_offset,
    float scale, void* stream) {
  if (bad_wide_shape(bsz, tq, tk, hq, hkv, d) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || tq == 0) return (int)cudaGetLastError();
  const Bwd p = make_bwd(q, k, v, dout, lse, delta, dq, nullptr, bsz, tq, tk,
                         hq, hkv, d, causal, window, chunk, q_offset, scale);
  return launch_wide<false>(p, static_cast<cudaStream_t>(stream));
}

// the wide_chunk route, d > 256 (any d runs): as the wide_simt entries
extern "C" int flash_attention_bwd_dkdv_chunk(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bsz, int tq,
    int tk, int hq, int hkv, int d, int causal, int window, int chunk,
    int q_offset, float scale, void* stream) {
  if (bad_chunk_shape(bsz, tq, tk, hq, hkv, d) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || tk == 0) return (int)cudaGetLastError();
  const Bwd p = make_bwd(q, k, v, dout, lse, delta, dk, dv, bsz, tq, tk, hq,
                         hkv, d, causal, window, chunk, q_offset, scale);
  return launch_chunk<true>(p, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dq_chunk(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bsz, int tq, int tk,
    int hq, int hkv, int d, int causal, int window, int chunk, int q_offset,
    float scale, void* stream) {
  if (bad_chunk_shape(bsz, tq, tk, hq, hkv, d) || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || tq == 0) return (int)cudaGetLastError();
  const Bwd p = make_bwd(q, k, v, dout, lse, delta, dq, nullptr, bsz, tq, tk,
                         hq, hkv, d, causal, window, chunk, q_offset, scale);
  return launch_chunk<false>(p, static_cast<cudaStream_t>(stream));
}
