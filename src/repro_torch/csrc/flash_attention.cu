// B5 — GQA flash attention (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:32
// (`_flash_kernel`, launched by `flash_attention_pallas` :82):
//     o[b, i, h, :] = softmax_j(q[b,i,h]·k[b,j,h/g] / sqrt(D) + mask)·v[b,j,h/g]
// for q (B, Tq, Hq, D) and k, v (B, Tk, Hkv, D), f32, g = Hq / Hkv.
// Query i sits at position q_offset + i, key j at j; the mask keeps
// j <= pos (causal), j > pos - window (sliding window) and
// j / chunk == pos / chunk (chunked attention).  A row with no visible
// key is 0, as in the reference (m starts at -1e30 and masked entries
// contribute p = 0, never exp(NaN)).
//
// The TPU kernel walks KV blocks as the innermost, sequential grid axis
// and keeps the running max, denominator and accumulator in VMEM scratch
// between grid steps.  Blocks on the card run in no order, so the KV
// walk is a loop inside the block: one block per (q tile, head, batch),
// the running statistics in registers, and the K, V and P tiles in
// shared memory.  Tiles that the masks hide entirely (beyond the causal
// edge, before the window or outside the chunk) are skipped; the ragged
// end of Tk is masked.  k and v may be strided views (the serving path
// hands in the written prefix of a (B, Tmax, Hkv, D) KV cache without a
// copy): only D must be contiguous.
//
// Bound on the card: operations at prefill (4·Tq·Tk_visible·D FLOP per
// head against q, k, v, o read or written once), bytes at decode (Tq = 1
// reads the whole K/V prefix for 4·Tk·D FLOP).  Design response: plain
// f32 FMA on CUDA cores (no tensor cores in this version), a 16×16
// thread grid in which each thread owns RI query rows × 4 keys of the
// logit tile and RI rows × ceil(D/16) columns of the output, with
// shared-memory strides padded by one word so that no access conflicts
// on a bank.  Decode (Tq <= 16) uses RI = 1, a 16-row q tile, so that
// the one live row does not drag 63 empty ones through the FMA loops.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int BK = 64;          // keys per tile
constexpr int KJ = BK / TX;     // keys per thread in a tile
constexpr int DMAX = 128;
constexpr int DC = DMAX / TX;   // output columns per thread, at most
constexpr float NEG = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int tq, tk, hq, hkv, d;
  long long kb, kt, kh;  // k strides in elements: batch, seq, head
  long long vb, vt, vh;
  int causal, window, chunk, q_offset;  // window, chunk: 0 = off
  float scale;
};

__device__ __forceinline__ float row_max(float x) {  // over the 16 tx lanes
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int RI>
size_t smem_floats(int d) {
  return (size_t)TY * RI * (d + 1) + (size_t)d * (BK + 1) + (size_t)BK * d +
         (size_t)TY * RI * (BK + 1);
}

template <int RI>
__global__ void __launch_bounds__(THREADS) flash_fwd(Params p) {
  constexpr int BQ = TY * RI;
  extern __shared__ float smem[];
  const int d = p.d;
  const int qs = d + 1;                 // padded row strides
  constexpr int ks = BK + 1;
  float* Qs = smem;                     // [BQ][d+1], pre-scaled
  float* Kt = Qs + BQ * qs;             // [d][BK+1], K transposed
  float* Vs = Kt + d * ks;              // [BK][d]
  float* Ps = Vs + BK * d;              // [BQ][BK+1]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const long long q_row = (long long)p.hq * d;  // q, o: contiguous

  const float* qb = p.q + (long long)bi * p.tq * q_row + (long long)h * d;
  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    const int qi = q0 + r;
    Qs[r * qs + c] = qi < p.tq ? qb[qi * q_row + c] * p.scale : 0.0f;
  }

  // the keys any row of this q tile can see
  const int q_last = min(q0 + BQ, p.tq) - 1;
  const int pos_lo = p.q_offset + q0, pos_hi = p.q_offset + q_last;
  int kv_lo = 0, kv_hi = p.tk;
  if (p.causal) kv_hi = min(kv_hi, pos_hi + 1);
  if (p.window > 0) kv_lo = max(kv_lo, pos_lo - p.window + 1);
  if (p.chunk > 0) {
    kv_lo = max(kv_lo, pos_lo / p.chunk * p.chunk);
    kv_hi = min(kv_hi, (pos_hi / p.chunk + 1) * p.chunk);
  }

  float m[RI], l[RI], acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  const float* kb = p.k + bi * p.kb + hk * p.kh;
  const float* vb = p.v + bi * p.vb + hk * p.vh;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // Qs written / the previous tile fully read
    for (int i = tid; i < BK * d; i += THREADS) {
      const int kk = i / d, c = i - kk * d;
      const long long kj = k0 + kk;
      float kv = 0.0f, vv = 0.0f;
      if (kj < kv_hi) {
        kv = kb[kj * p.kt + c];
        vv = vb[kj * p.vt + c];
      }
      Kt[c * ks + kk] = kv;
      Vs[kk * d + c] = vv;
    }
    __syncthreads();

    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < d; ++c) {
      float kr[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) kr[j] = Kt[c * ks + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float qv = Qs[(ty + TY * i) * qs + c];
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(qv, kr[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = p.q_offset + q0 + ty + TY * i;
      bool ok[KJ];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kpos = k0 + tx + TX * j;
        bool valid = kpos < kv_hi;
        if (p.causal) valid = valid && kpos <= qpos;
        if (p.window > 0) valid = valid && kpos > qpos - p.window;
        if (p.chunk > 0) valid = valid && kpos / p.chunk == qpos / p.chunk;
        ok[j] = valid;
        s[i][j] = valid ? s[i][j] : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(ty + TY * i) * ks + tx + TX * j] = pj;
        rs += pj;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kn = min(BK, kv_hi - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float vr[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + TX * c;
        vr[c] = col < d ? Vs[kk * d + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float pv = Ps[(ty + TY * i) * ks + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv, vr[c], acc[i][c]);
      }
    }
  }

  float* ob = p.o + (long long)bi * p.tq * q_row + (long long)h * d;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= p.tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + TX * c;
      if (col < d) ob[qi * q_row + col] = acc[i][c] / denom;
    }
  }
}

template <int RI>
int launch(const Params& p, int bsz, cudaStream_t st) {
  const size_t smem = smem_floats<RI>(p.d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<RI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BQ = TY * RI;
  dim3 grid((p.tq + BQ - 1) / BQ, p.hq, bsz);
  flash_fwd<RI><<<grid, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (bsz, tq, hq, d) contiguous f32; k, v: (bsz, tk, hkv, d) f32
// with unit stride along d and the given batch/seq/head strides.
// window, chunk: 0 = no such mask.  Returns a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int bsz, int tq, int tk, int hq,
                               int hkv, int d, long long kb, long long kt,
                               long long kh, long long vb, long long vt,
                               long long vh, int causal, int window,
                               int chunk, int q_offset, float scale,
                               void* stream) {
  if (d <= 0 || d > DMAX || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (bsz == 0 || tq == 0 || hq == 0) return (int)cudaGetLastError();
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(o),
           tq, tk, hq, hkv, d, kb, kt, kh, vb, vt, vh,
           causal, window, chunk, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tq <= TY ? launch<1>(p, bsz, st) : launch<4>(p, bsz, st);
}
