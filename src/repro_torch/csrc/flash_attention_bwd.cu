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
// 0 by the mask test (exp is never taken of it): zero gradients, no NaN.
//
// Three kernels, launched in this order by the wrapper:
// * rowdot — one warp a (b, i, h) row; lanes stride over D, a fixed
//   shuffle tree sums them.
// * dkdv — one block a (key tile of BK keys, kv head, batch): the K and V
//   tiles stay in shared memory while the block walks the g q heads of its
//   kv head and, in each, the q tiles of BQ rows whose hull of visible keys
//   meets the key tile.  On each it recomputes S = QKᵀ and dP = dO·Vᵀ, then
//   P and dS, and accumulates dV += Pᵀ dO and dK += dSᵀ Q in registers; dK
//   and dV are written once, so the sum over a kv head's q heads happens
//   inside the block, with no atomics.
// * dq — one block a (q tile, q head, batch), walking the key tiles its
//   rows can see (the forward's walk): S, dP, dS again, and dQ += dS·K.
// Every sum runs in a fixed order and nothing is added atomically, so a
// backward repeats bit for bit.
//
// Arithmetic: f32 FMA on the SIMT cores (7 products of the visible T²·D
// pairs: S and dP in both kernels, dV, dK, dQ), 256 threads a block as a
// 16 × 16 grid (tx, ty).  A thread computes S and dP at rows ty + 16a and
// keys tx + 16b (a, b < 4) and owns accumulator rows ty + 16r (keys in
// dkdv, queries in dq) at columns tx + 16n (n < DP/16), D padded to DP =
// 32, 64, 80 or 128 with zeros.  Tiles sit in shared memory row-major,
// DP + 1 floats a row (odd: the 16 rows a warp reads at one column fall
// in 16 banks), P and dS BK + 16 floats a row (the two rows a warp writes
// fall in opposite bank halves).  At DP = 128 the dkdv block takes 170 KB
// of shared memory, opted in with cudaFuncSetAttribute; a launch the card
// refuses returns its error.  Tensor cores (3xTF32 `mma.sync` as the
// forward's prefill_tc, or `wgmma`) are later work.
// Every entry point returns a cudaError_t; nothing here allocates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mask.cuh"

namespace {

using attn_mask::Range;

constexpr int THREADS = 256;  // 16 × 16
constexpr int BQ = 64;        // query rows a tile
constexpr int BK = 64;        // keys a tile
constexpr int PS = BK + 16;   // P / dS row stride (floats)
constexpr int DMAX = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

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
};

__device__ __forceinline__ Range keys_of(const Bwd& p, int pos_lo,
                                         int pos_hi) {
  return attn_mask::keys_seen(pos_lo, pos_hi, p.tk, p.causal, p.window,
                              p.chunk);
}

// ROWS rows of a (row-stride rs) matrix from row r0 into shared memory,
// DP + 1 floats a row; rows at or past n and columns at or past d are 0
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long rs, int r0, int n,
                                          int d) {
  for (int e = threadIdx.x; e < ROWS * DP; e += THREADS) {
    const int r = e / DP, c = e - r * DP;
    dst[r * (DP + 1) + c] =
        r0 + r < n && c < d ? src[(long long)(r0 + r) * rs + c] : 0.0f;
  }
}

// lse (in log2 units) and D of q rows q0 … q0 + BQ − 1 of one head
__device__ __forceinline__ void load_rows(float* ls, float* dl, const Bwd& p,
                                          long long head_row, int q0) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < p.tq;
    ls[r] = in ? p.lse[head_row + q0 + r] * LOG2E : -INFINITY;
    dl[r] = in ? p.delta[head_row + q0 + r] : 0.0f;
  }
}

// S = Q·Kᵀ and dP = dO·Vᵀ at this thread's rows ty + 16a and keys
// tx + 16b of the tiles in shared memory
template <int DP>
__device__ __forceinline__ void scores(const float* qs, const float* gs,
                                       const float* ks, const float* vs,
                                       int tx, int ty, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int SD = DP + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < DP; ++c) {
    float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = qs[(ty + 16 * a) * SD + c];
      ga[a] = gs[(ty + 16 * a) * SD + c];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = ks[(tx + 16 * b) * SD + c];
      vb[b] = vs[(tx + 16 * b) * SD + c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(ga[a], vb[b], dp[a][b]);
      }
  }
}

// P and dS of this thread's entries (query rows q0 + ty + 16a, keys
// k0 + tx + 16b) into shared memory (PS floats a row): P = exp(S/√D −
// lse) where the mask shows the key to the row, else 0 (never exp of a
// hidden entry: a row with lse = -inf has none visible)
__device__ __forceinline__ void probs(const Bwd& p, const float* ls,
                                      const float* dl, int q0, int k0,
                                      int tx, int ty, const float (&s)[4][4],
                                      const float (&dp)[4][4], float* ps,
                                      float* ds) {
  const float scale2 = p.scale * LOG2E;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a, i = q0 + r;
    const Range vr = keys_of(p, p.q_offset + i, p.q_offset + i);
    const float l2 = ls[r], dd = dl[r];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = k0 + tx + 16 * b;
      const bool ok = i < p.tq && j >= vr.lo && j < vr.hi;
      const float pv = ok ? exp2f(fmaf(s[a][b], scale2, -l2)) : 0.0f;
      if (ps != nullptr) ps[r * PS + tx + 16 * b] = pv;
      ds[r * PS + tx + 16 * b] = pv * (dp[a][b] - dd);
    }
  }
}

// rowdot: D[b, h, i] = Σ_d dO[b, i, h, d] · O[b, i, h, d], a warp a row
__global__ void __launch_bounds__(THREADS)
    flash_bwd_rowdot(const float* o, const float* dout, float* delta,
                     long long rows, int tq, int hq, int d) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
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

// dkdv: block (key tile, kv head, batch), key tiles taken lowest first
// (under a causal mask the lowest sees the most queries)
template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv(Bwd p) {
  constexpr int SD = DP + 1, NC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* const ks = smem;          // [BK][SD]
  float* const vs = ks + BK * SD;  // [BK][SD]
  float* const qs = vs + BK * SD;  // [BQ][SD]
  float* const gs = qs + BQ * SD;  // dO [BQ][SD]
  float* const ps = gs + BQ * SD;  // P [BQ][PS]
  float* const ds = ps + BQ * PS;  // dS [BQ][PS]
  float* const ls = ds + BQ * PS;  // lse · log2(e) [BQ]
  float* const dl = ls + BQ;       // D [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nyz = gridDim.y * gridDim.z;
  const long long lin =
      blockIdx.x + (long long)gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int k0 = (int)(lin / nyz) * BK;
  const int hk = (int)(lin % nyz) % gridDim.y;
  const int bi = (int)(lin % nyz) / gridDim.y;
  const int grp = p.hq / p.hkv;
  const long long kv_row = (long long)p.hkv * p.d;
  const long long q_row = (long long)p.hq * p.d;
  const long long kv_base = (long long)bi * p.tk * kv_row + (long long)hk * p.d;
  load_tile<DP, BK>(ks, p.k + kv_base, kv_row, k0, p.tk, p.d);
  load_tile<DP, BK>(vs, p.v + kv_base, kv_row, k0, p.tk, p.d);

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc_k[r][n] = acc_v[r][n] = 0.0f;

  for (int gi = 0; gi < grp; ++gi) {
    const int h = hk * grp + gi;
    const long long head_row = ((long long)bi * p.hq + h) * p.tq;
    const float* qb = p.q + (long long)bi * p.tq * q_row + (long long)h * p.d;
    const float* gb =
        p.dout + (long long)bi * p.tq * q_row + (long long)h * p.d;
    for (int q0 = 0; q0 < p.tq; q0 += BQ) {
      const int nrows = min(BQ, p.tq - q0);
      // the hull of the tile's visible keys: a superset, so no query
      // that sees a key of this tile is skipped
      const Range kr = keys_of(p, p.q_offset + q0, p.q_offset + q0 + nrows - 1);
      if (kr.hi <= k0 || kr.lo >= k0 + BK || kr.lo >= kr.hi) continue;
      __syncthreads();  // the last tile's reads of qs, gs, ps, ds are done
      load_tile<DP, BQ>(qs, qb, q_row, q0, p.tq, p.d);
      load_tile<DP, BQ>(gs, gb, q_row, q0, p.tq, p.d);
      load_rows(ls, dl, p, head_row, q0);
      __syncthreads();
      float s[4][4], dp[4][4];
      scores<DP>(qs, gs, ks, vs, tx, ty, s, dp);
      probs(p, ls, dl, q0, k0, tx, ty, s, dp, ps, ds);
      __syncthreads();
      // dV[j] += Σ_i P[i][j] dO[i], dK[j] += Σ_i dS[i][j] Q[i] at this
      // thread's keys ty + 16r and columns tx + 16n
      for (int i = 0; i < nrows; ++i) {
        float pj[4], sj[4], gq[NC], qq[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pj[r] = ps[i * PS + ty + 16 * r];
          sj[r] = ds[i * PS + ty + 16 * r];
        }
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          gq[n] = gs[i * SD + tx + 16 * n];
          qq[n] = qs[i * SD + tx + 16 * n];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            acc_v[r][n] = fmaf(pj[r], gq[n], acc_v[r][n]);
            acc_k[r][n] = fmaf(sj[r], qq[n], acc_k[r][n]);
          }
      }
    }
  }

  float* const dkb = p.grad + kv_base;
  float* const dvb = p.dv + kv_base;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= p.tk) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = tx + 16 * n;
      if (c < p.d) {
        dkb[j * kv_row + c] = acc_k[r][n] * p.scale;
        dvb[j * kv_row + c] = acc_v[r][n];
      }
    }
  }
}

// dq: block (q tile, q head, batch), heaviest q tile first (the last under
// a causal mask), as the forward's prefill
template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq(Bwd p) {
  constexpr int SD = DP + 1, NC = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;          // [BQ][SD]
  float* const gs = qs + BQ * SD;  // dO [BQ][SD]
  float* const ks = gs + BQ * SD;  // [BK][SD]
  float* const vs = ks + BK * SD;  // [BK][SD]
  float* const ds = vs + BK * SD;  // dS [BQ][PS]
  float* const ls = ds + BQ * PS;  // lse · log2(e) [BQ]
  float* const dl = ls + BQ;       // D [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nyz = gridDim.y * gridDim.z;
  const long long lin =
      blockIdx.x + (long long)gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int q0 = (gridDim.x - 1 - (int)(lin / nyz)) * BQ;
  const int h = (int)(lin % nyz) % gridDim.y;
  const int bi = (int)(lin % nyz) / gridDim.y;
  const int hk = h / (p.hq / p.hkv);
  const int nrows = min(BQ, p.tq - q0);
  const long long kv_row = (long long)p.hkv * p.d;
  const long long q_row = (long long)p.hq * p.d;
  const long long q_base = (long long)bi * p.tq * q_row + (long long)h * p.d;
  const long long kv_base = (long long)bi * p.tk * kv_row + (long long)hk * p.d;
  load_tile<DP, BQ>(qs, p.q + q_base, q_row, q0, p.tq, p.d);
  load_tile<DP, BQ>(gs, p.dout + q_base, q_row, q0, p.tq, p.d);
  load_rows(ls, dl, p, ((long long)bi * p.hq + h) * p.tq, q0);
  const Range kv = keys_of(p, p.q_offset + q0, p.q_offset + q0 + nrows - 1);

  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[a][n] = 0.0f;

  for (int k0 = kv.lo; k0 < kv.hi; k0 += BK) {
    __syncthreads();  // the last tile's reads of ks, vs, ds are done
    load_tile<DP, BK>(ks, p.k + kv_base, kv_row, k0, kv.hi, p.d);
    load_tile<DP, BK>(vs, p.v + kv_base, kv_row, k0, kv.hi, p.d);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<DP>(qs, gs, ks, vs, tx, ty, s, dp);
    probs(p, ls, dl, q0, k0, tx, ty, s, dp, nullptr, ds);
    __syncthreads();
    // dQ[i] += Σ_j dS[i][j] K[j] at this thread's rows ty + 16a and
    // columns tx + 16n
    const int nk = min(BK, kv.hi - k0);
    for (int j = 0; j < nk; ++j) {
      float si[4], kk[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) si[a] = ds[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) kk[n] = ks[j * SD + tx + 16 * n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[a][n] = fmaf(si[a], kk[n], acc[a][n]);
    }
  }

  float* const dqb = p.grad + q_base;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= p.tq) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = tx + 16 * n;
      if (c < p.d) dqb[i * q_row + c] = acc[a][n] * p.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int DP>
constexpr size_t dkdv_smem() {
  return sizeof(float) * ((size_t)(2 * BK + 2 * BQ) * (DP + 1) +
                          2 * BQ * PS + 2 * BQ);
}

template <int DP>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)(2 * BK + 2 * BQ) * (DP + 1) + BQ * PS +
                          2 * BQ);
}

// the padded head dim a kernel is instantiated for
int padded(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 80 ? 80 : 128; }

bool bad_shape(int bsz, int tq, int tk, int hq, int hkv, int d) {
  return bsz < 0 || tq < 0 || tk < 0 || d <= 0 || d > DMAX || hkv <= 0 ||
         hq <= 0 || hq % hkv != 0 || bsz > 65535 || hq > 65535;
}

template <int DP, bool DKDV>
int launch(const Bwd& p, cudaStream_t st) {
  const size_t smem = DKDV ? dkdv_smem<DP>() : dq_smem<DP>();
  auto kernel = DKDV ? flash_bwd_dkdv<DP> : flash_bwd_dq<DP>;
  // per call: the attribute belongs to the current device; a size the card
  // cannot give fails here, and the wrapper raises
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(DKDV ? (p.tk + BK - 1) / BK : (p.tq + BQ - 1) / BQ,
                  DKDV ? p.hkv : p.hq, p.bsz);
  kernel<<<grid, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <bool DKDV>
int launch_padded(const Bwd& p, cudaStream_t st) {
  switch (padded(p.d)) {
    case 32: return launch<32, DKDV>(p, st);
    case 64: return launch<64, DKDV>(p, st);
    case 80: return launch<80, DKDV>(p, st);
    default: return launch<128, DKDV>(p, st);
  }
}

Bwd make_bwd(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* grad, void* dv,
             int bsz, int tq, int tk, int hq, int hkv, int d, int causal,
             int window, int chunk, int q_offset, float scale) {
  return Bwd{static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<const float*>(dout),
             static_cast<const float*>(lse), static_cast<const float*>(delta),
             static_cast<float*>(grad), static_cast<float*>(dv), bsz, tq, tk,
             hq, hkv, d, causal, window, chunk, q_offset, scale};
}

}  // namespace

// All tensors contiguous f32: q, o, dout (bsz, tq, hq, d); k, v, dk, dv
// (bsz, tk, hkv, d); lse, delta (bsz, hq, tq).  window, chunk: 0 = no such
// mask; scale: 1/sqrt(d).  Each entry returns a cudaError_t.

// delta = rowdot(dout, o)
extern "C" int flash_attention_bwd_rowdot(const void* o, const void* dout,
                                          void* delta, int bsz, int tq,
                                          int hq, int d, void* stream) {
  if (bsz < 0 || tq < 0 || hq <= 0 || d <= 0 || d > DMAX)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)bsz * tq * hq;
  if (rows == 0) return (int)cudaGetLastError();
  const int per = THREADS / 32;
  flash_bwd_rowdot<<<(unsigned)((rows + per - 1) / per), THREADS, 0,
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
