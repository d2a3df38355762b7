// B1 — fused batched COO semiring SpMM, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/coo_spmm.py:214
// (`_spmm_kernel`, launched by `_spmm_pallas_call` :260 /
// `spmm_pallas` :284):
//     out[d, b] = ⊕_{e : dst_e = d} w_e ⊗ x[src_e, b]
// the frontier advance `Δ ⊗ E` of every GSN round of the batched
// fixpoint — gather, ⊗ and segment-⊕ in one pass.  The TPU kernel
// buckets edges by (output block, source block) so that one x tile and
// one output tile sit in VMEM per grid step.  None of that carries
// over: on the card this is a gather, bound by bytes, and what matters
// is how many bytes an edge moves, from where, and how many gathers are
// in flight.
//
// Work items.  `plan_spmm` (kernels/coo_spmm.py) owns the geometry;
// the entries below launch what they are given.  Edges are sorted by
// destination on the host.  An item is at most E_CHUNK consecutive
// edges of one destination row: a longer row is cut into several items
// in edge order, and every output row is covered exactly once — a row
// that no edge reaches by one empty item that writes 0̄, so there is no
// fill pass (the first version wrote the whole output twice).  One warp
// runs one item at a time: `threads_per_edge` (T) lanes span a slab of
// T·V row elements with V-wide loads, and the warp's 32/T lane groups
// take further edges, so 32/T × UNROLL gathers a warp are in flight.
// The item's edge indices and weights are first staged in shared memory
// by one coalesced load, so no gather waits on an index load.  The
// groups fold by shuffle in a fixed tree order.  Items of a split row
// write partials to scratch, and a fold kernel combines them in item
// order.  A hub row (1,374 in-edges on the power-law graph) so runs on
// 11 warps at once instead of serially in one block.  A warp takes
// ITEMS items, a grid's width of warps apart (the items of one split
// row land on different warps), and loads all their bounds at once, so
// a run of short or empty rows does not wait on one load per row.
//
// Two paths:
//   words_bool — 𝔹 on packed lanes.  A pack kernel turns x's bool bytes
//     into 32-bit words (lane b in bit b%32 of word b/32: in memory the
//     reference's little-endian uint64 layout, `pack_lanes` :314), the
//     round ORs the gathered word rows (32 B an edge at 256 lanes, not
//     256 B), and an unpack kernel writes the bool output.  Bound:
//     bytes — x read once, the output written once, the indices; the
//     57 MB of word gathers hit L2 (x's words are 2.6 MB at 81,306 ×
//     256).
//   lanes_f32 — trop (min,+), maxplus (max,+), nat/real (+,×).  16-byte
//     loads a thread where the row width allows, else scalar loads with
//     more lane groups an edge.  Lanes go in slabs whose slice of x fits
//     in L2 (64 lanes of 81,306 rows: 20.8 MB of the 50 MB); the slab is
//     the slowest grid dimension, so one slab's x stays resident while
//     all its items run.  Bound: bytes counted once (x, the output, the
//     indices); the honest floor is the L2 rate for the nnz × lanes × 4
//     bytes of gathers.  Indices and outputs take the evict-first cache
//     path so they do not push the slab out of L2.
//
// Repeatability: every ⊕ runs in an order the plan fixes (edges in
// order within a lane group, a fixed shuffle tree across the groups,
// partials in item order), with no atomics, so real sums repeat bit for
// bit from call to call; OR, min and max are exact in any order.
//
// The entries return cudaErrorInvalidValue for a geometry they were not
// compiled for: items that do not cover [0, nnz) or are fewer than the
// rows, an item longer than E_CHUNK, a slab or vector width that was
// not compiled, words that do not cover the lanes, a grid that does not
// cover the items or the slabs, short scratch, misaligned vector
// operands.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

enum Mode { kBool = 0, kTrop = 1, kMaxPlus = 2, kSum = 3 };

constexpr int E_CHUNK = 128;   // most edges an item holds (py: E_CHUNK)
constexpr int WARPS = 8;       // warps a block of the round (py: WARPS)
constexpr int ITEMS = 4;       // items a warp (py: ITEMS_PER_WARP)
constexpr int UNROLL = 4;      // edges a lane group has in flight
constexpr int AUX_THREADS = 256;

template <int MODE> struct Op;
template <> struct Op<kBool> {       // (or, and) on 32 lanes a word
  using E = uint32_t;
  using W = uint8_t;
  __device__ static E zero() { return 0u; }
  __device__ static E mul(W w, E x) { return w ? x : 0u; }
  __device__ static E add(E a, E b) { return a | b; }
};
template <> struct Op<kTrop> {
  using E = float;
  using W = float;
  __device__ static E zero() { return INFINITY; }
  __device__ static E mul(W w, E x) { return w + x; }
  __device__ static E add(E a, E b) { return fminf(a, b); }
};
template <> struct Op<kMaxPlus> {
  using E = float;
  using W = float;
  __device__ static E zero() { return -INFINITY; }
  __device__ static E mul(W w, E x) { return w + x; }
  __device__ static E add(E a, E b) { return fmaxf(a, b); }
};
template <> struct Op<kSum> {        // nat and real
  using E = float;
  using W = float;
  __device__ static E zero() { return 0.0f; }
  __device__ static E mul(W w, E x) { return w * x; }
  __device__ static E add(E a, E b) { return a + b; }
};

// V consecutive row elements: one 16-byte load or store, or one scalar
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const uint32_t* p,
                                         uint32_t (&v)[4]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <typename E>
__device__ __forceinline__ void load_vec(const E* p, E (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_vec(uint32_t* p,
                                          const uint32_t (&v)[4]) {
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) {
  __stcs(p, v[0]);
}
__device__ __forceinline__ void store_vec(uint32_t* p,
                                          const uint32_t (&v)[1]) {
  __stcs(reinterpret_cast<unsigned int*>(p), v[0]);
}

// One warp per (item, slab).  Item i holds edges [item_edge[i],
// item_edge[i+1]) of one row; item_dst[i] ≥ 0 is that row of `out`,
// ~item_dst[i] its partial slot in `part` (a split row).  Rows are
// row_len elements (lanes, or 32-bit words); this warp covers elements
// [blockIdx.y · T·V, (blockIdx.y + 1) · T·V).  A warp runs ITEMS items
// one after another, a grid's width of warps apart (so the items of a
// split row run on different warps); their bounds and rows come in one
// load of its lanes, so an empty item costs one store.  An item's edge
// indices and weights are staged in shared memory in one coalesced
// load, so its gathers wait on no index load.
template <int MODE, int V>
__global__ void __launch_bounds__(WARPS * 32)
spmm_items(const int* __restrict__ src,
           const typename Op<MODE>::W* __restrict__ w,
           const int* __restrict__ item_edge,
           const int* __restrict__ item_dst,
           const typename Op<MODE>::E* __restrict__ x,
           typename Op<MODE>::E* __restrict__ out,
           typename Op<MODE>::E* __restrict__ part,
           int n_items, int row_len, int tpe) {
  using O = Op<MODE>;
  using E = typename O::E;
  using Wt = typename O::W;
  __shared__ int s_src[WARPS][E_CHUNK];
  __shared__ Wt s_w[WARPS][E_CHUNK];
  const int wid = threadIdx.x >> 5;
  const long long warp = (long long)blockIdx.x * WARPS + wid;
  if (warp >= n_items) return;               // warp-uniform
  const int lane = threadIdx.x & 31;
  const long long mine = warp + (long long)lane * gridDim.x * WARPS;
  const bool has = lane < ITEMS && mine < n_items;
  const int lo_l = has ? __ldcs(item_edge + mine) : 0;
  const int hi_l = has ? __ldcs(item_edge + mine + 1) : 0;
  const int dst_l = has ? __ldcs(item_dst + mine) : 0;
  const int count = __popc(__ballot_sync(0xffffffffu, has));
  const int groups = 32 / tpe;
  const int g = lane / tpe;
  const int c = (blockIdx.y * tpe + lane % tpe) * V;
  const bool on = c < row_len;               // row_len % V == 0
  int* ss = s_src[wid];
  Wt* sw = s_w[wid];
  for (int i = 0; i < count; ++i) {
    const int lo = __shfl_sync(0xffffffffu, lo_l, i);
    const int n = min(__shfl_sync(0xffffffffu, hi_l, i) - lo, E_CHUNK);
    const int d = __shfl_sync(0xffffffffu, dst_l, i);
    E acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = O::zero();
    if (n > 0) {                             // warp-uniform
      __syncwarp();                          // the last item's reads done
      for (int t = lane; t < n; t += 32) {
        ss[t] = __ldcs(src + lo + t);
        sw[t] = __ldcs(w + lo + t);
      }
      __syncwarp();
      if (on) {
        for (int t0 = g; t0 < n; t0 += groups * UNROLL) {
          int s[UNROLL];
          Wt wv[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int t = t0 + u * groups;
            s[u] = t < n ? ss[t] : -1;
            wv[u] = t < n ? sw[t] : Wt(0);
          }
          E xv[UNROLL][V];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (s[u] >= 0) load_vec(x + (long long)s[u] * row_len + c, xv[u]);
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            if (s[u] >= 0) {
#pragma unroll
              for (int k = 0; k < V; ++k)
                acc[k] = O::add(acc[k], O::mul(wv[u], xv[u][k]));
            }
        }
      }
      // lanes tpe, 2·tpe, … apart hold the same elements, other edges
      for (int off = tpe; off < 32; off <<= 1) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          acc[k] = O::add(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], off));
      }
    }
    if (g == 0 && on) {
      E* row = d >= 0 ? out + (long long)d * row_len
                      : part + (long long)(~d) * row_len;
      store_vec(row + c, acc);
    }
  }
}

// Split row k = the ⊕ of its partials fold_seg[k] .. fold_seg[k+1] - 1,
// in item order.
template <int MODE>
__global__ void spmm_fold(const int* __restrict__ fold_row,
                          const int* __restrict__ fold_seg,
                          const typename Op<MODE>::E* __restrict__ part,
                          typename Op<MODE>::E* __restrict__ out,
                          int n_split, int row_len) {
  using O = Op<MODE>;
  const long long total = (long long)n_split * row_len;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int k = (int)(i / row_len), c = (int)(i % row_len);
    const int a = fold_seg[k], b = fold_seg[k + 1];
    typename O::E acc = part[(long long)a * row_len + c];
    for (int s = a + 1; s < b; ++s)
      acc = O::add(acc, part[(long long)s * row_len + c]);
    out[(long long)fold_row[k] * row_len + c] = acc;
  }
}

// four bool bytes (any non-zero byte is true) → four bits
__device__ __forceinline__ uint32_t nibble(uint32_t v) {
  const uint32_t nz = (((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v) & 0x80808080u;
  return ((nz >> 7) * 0x01020408u) >> 24;
}
// four bits → four bool bytes (0 or 1)
__device__ __forceinline__ uint32_t spread(uint32_t n) {
  return ((n & 0xfu) * 0x00204081u) & 0x01010101u;
}

// (rows, lanes) bool bytes → (rows, words) 32-bit words, one thread a
// word; a word whose 32 bytes are whole and 16-byte aligned is read as
// two 16-byte loads
__global__ void spmm_pack(const uint8_t* __restrict__ x,
                          uint32_t* __restrict__ words, long long n_words,
                          int lanes, int row_words, int vec16) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_words; i += stride) {
    const long long r = i / row_words;
    const int b0 = (int)(i % row_words) * 32;
    const uint8_t* p = x + r * lanes + b0;
    uint32_t word = 0;
    if (vec16 && b0 + 32 <= lanes) {
      const uint4 q0 = __ldcs(reinterpret_cast<const uint4*>(p));
      const uint4 q1 = __ldcs(reinterpret_cast<const uint4*>(p + 16));
      word = nibble(q0.x) | nibble(q0.y) << 4 | nibble(q0.z) << 8 |
             nibble(q0.w) << 12 | nibble(q1.x) << 16 | nibble(q1.y) << 20 |
             nibble(q1.z) << 24 | nibble(q1.w) << 28;
    } else {
      const int m = min(32, lanes - b0);
      for (int j = 0; j < m; ++j) word |= (uint32_t)(p[j] != 0) << j;
    }
    words[i] = word;
  }
}

// (rows, words) → (rows, lanes) bool bytes, one thread a word
__global__ void spmm_unpack(const uint32_t* __restrict__ words,
                            uint8_t* __restrict__ out, long long n_words,
                            int lanes, int row_words, int vec16) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_words; i += stride) {
    const long long r = i / row_words;
    const int b0 = (int)(i % row_words) * 32;
    uint8_t* p = out + r * lanes + b0;
    const uint32_t word = words[i];
    if (vec16 && b0 + 32 <= lanes) {
      __stcs(reinterpret_cast<uint4*>(p),
             make_uint4(spread(word), spread(word >> 4), spread(word >> 8),
                        spread(word >> 12)));
      __stcs(reinterpret_cast<uint4*>(p + 16),
             make_uint4(spread(word >> 16), spread(word >> 20),
                        spread(word >> 24), spread(word >> 28)));
    } else {
      const int m = min(32, lanes - b0);
      for (int j = 0; j < m; ++j) p[j] = (uint8_t)((word >> j) & 1u);
    }
  }
}

int aux_grid(long long count) {
  long long blocks = (count + AUX_THREADS - 1) / AUX_THREADS;
  if (blocks < 1) blocks = 1;
  const long long cap = 132LL * 16;
  return (int)(blocks < cap ? blocks : cap);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int MODE>
int launch_items(const void* src, const void* w, const int* item_edge,
                 const int* item_dst, const int* fold_row,
                 const int* fold_seg, const void* x, void* out, void* part,
                 int n_items, int row_len, int vec, int tpe, int n_split,
                 int grid_x, int grid_y, cudaStream_t st) {
  using O = Op<MODE>;
  using E = typename O::E;
  const dim3 grid(grid_x, grid_y);
  const auto* s = static_cast<const int*>(src);
  const auto* wv = static_cast<const typename O::W*>(w);
  const auto* xv = static_cast<const E*>(x);
  auto* o = static_cast<E*>(out);
  auto* p = static_cast<E*>(part);
  if (n_items > 0 && row_len > 0) {
    if (vec == 4)
      spmm_items<MODE, 4><<<grid, WARPS * 32, 0, st>>>(
          s, wv, item_edge, item_dst, xv, o, p, n_items, row_len, tpe);
    else
      spmm_items<MODE, 1><<<grid, WARPS * 32, 0, st>>>(
          s, wv, item_edge, item_dst, xv, o, p, n_items, row_len, tpe);
  }
  if (n_split > 0 && row_len > 0)
    spmm_fold<MODE><<<aux_grid((long long)n_split * row_len), AUX_THREADS, 0,
                      st>>>(fold_row, fold_seg, p, o, n_split, row_len);
  return (int)cudaGetLastError();
}

}  // namespace

// The round: out (n_out, row_len) ← items over x (n_in, row_len), with
// the fold of split rows.  mode 0 is words_bool on packed words (x and
// out are 32-bit words, row_len = ceil(lanes / 32)); modes 1–3 are
// lanes_f32 (row_len = lanes).  item_edge (n_items + 1,) holds edge
// starts with the end sentinel, and the caller states its first and last
// entries and the longest item; item_dst (n_items,), fold_row (n_split,),
// fold_seg (n_split + 1,) are int32 on the device.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a foreign geometry.
extern "C" int coo_spmm_items(
    int mode, const void* src, const void* w, const void* item_edge,
    const void* item_dst, const void* fold_row, const void* fold_seg,
    const void* x, void* out, void* part, int nnz, int n_out, int lanes,
    int row_len, int vec, int tpe, int chunk, int n_items, int item_first,
    int item_last, int max_item_edges, int n_split, int n_part,
    long long part_elems, int grid_x, int grid_y, void* stream) {
  const bool words = mode == kBool;
  const int want_len = words ? (lanes + 31) / 32 : lanes;
  const int slab = tpe * vec;
  if (mode < kBool || mode > kSum || lanes < 0 || n_out < 0 || nnz < 0 ||
      row_len != want_len || chunk != E_CHUNK || max_item_edges < 0 ||
      max_item_edges > E_CHUNK || item_first != 0 || item_last != nnz ||
      n_items < n_out || (vec != 1 && vec != 4) || tpe < 1 || tpe > 32 ||
      (tpe & (tpe - 1)) != 0 || row_len % vec != 0 ||
      (long long)grid_x * WARPS * ITEMS < n_items || grid_y < 1 ||
      grid_y > 65535 || (long long)grid_y * slab < row_len || n_split < 0 ||
      n_part < n_split || (n_split == 0) != (n_part == 0) ||
      part_elems < (long long)n_part * row_len ||
      (vec == 4 && !(aligned16(x) && aligned16(out) &&
                     (n_part == 0 || aligned16(part)))))
    return (int)cudaErrorInvalidValue;
  if (grid_x == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ie = static_cast<const int*>(item_edge);
  const int* id = static_cast<const int*>(item_dst);
  const int* fr = static_cast<const int*>(fold_row);
  const int* fs = static_cast<const int*>(fold_seg);
  switch (mode) {
    case kBool:
      return launch_items<kBool>(src, w, ie, id, fr, fs, x, out, part,
                                 n_items, row_len, vec, tpe, n_split, grid_x,
                                 grid_y, st);
    case kTrop:
      return launch_items<kTrop>(src, w, ie, id, fr, fs, x, out, part,
                                 n_items, row_len, vec, tpe, n_split, grid_x,
                                 grid_y, st);
    case kMaxPlus:
      return launch_items<kMaxPlus>(src, w, ie, id, fr, fs, x, out, part,
                                    n_items, row_len, vec, tpe, n_split,
                                    grid_x, grid_y, st);
    default:
      return launch_items<kSum>(src, w, ie, id, fr, fs, x, out, part,
                                n_items, row_len, vec, tpe, n_split, grid_x,
                                grid_y, st);
  }
}

// x (rows, lanes) torch.bool → words (rows, row_words) 32-bit words
extern "C" int coo_spmm_pack(const void* x, void* words, int rows, int lanes,
                             int row_words, void* stream) {
  if (rows < 0 || lanes < 0 || row_words != (lanes + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * row_words;
  if (n > 0)
    spmm_pack<<<aux_grid(n), AUX_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(x), static_cast<uint32_t*>(words), n,
        lanes, row_words, (int)(aligned16(x) && lanes % 16 == 0));
  return (int)cudaGetLastError();
}

// words (rows, row_words) → out (rows, lanes) torch.bool
extern "C" int coo_spmm_unpack(const void* words, void* out, int rows,
                               int lanes, int row_words, void* stream) {
  if (rows < 0 || lanes < 0 || row_words != (lanes + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * row_words;
  if (n > 0)
    spmm_unpack<<<aux_grid(n), AUX_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<uint8_t*>(out), n,
        lanes, row_words, (int)(aligned16(out) && lanes % 16 == 0));
  return (int)cudaGetLastError();
}
