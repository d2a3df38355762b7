// B3 — semiring segment ⊕-reduce over COO ids, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/coo_segment.py:38
// (`_kernel`, launched by `segment_reduce_pallas` :64):
//     out[s, b] = ⊕_{i : ids[i] = s} vals[i, b]
// with ids outside [0, n) (the COO padding sentinels) dropped.  ⊕ is
// `or` for bool, min for trop, max for maxplus and + for nat/real.
//
// The TPU kernel sorts the entries into output blocks because a TPU
// cannot scatter.  The Hopper answer to the same problem is a reduction
// over sorted runs in which each output row has one owner and is
// written once, with no atomics on output rows.  Two paths:
//
//   runs — the payload arrives already in the order of a segment plan
//     (`plan_segment`, kernels/coo_segment.py): the entries whose id
//     lies in [0, n), stably sorted by id, cut into work items of at
//     most E_CHUNK consecutive entries of one row, a longer row cut
//     into several items, one empty item for a row no entry reaches (so
//     there is no fill pass).  The plan is built once per ids column:
//     the sparse contraction's column is memoized on its relation, so
//     one plan serves every round of every query.  Kernels:
//       segment_runs_scalar<MODE, E>  (m,) payloads, f32 or 𝔹 bytes.
//         A warp takes ITEMS consecutive items; their bounds arrive in
//         one load of its lanes, then every lane issues all of its loads
//         for all ITEMS items (entry lo + lane + 32·u, u < E_CHUNK/32)
//         before it waits on any: a mean row is ≈22 entries, so the
//         loads of one item alone would leave the memory system idle.
//         Each item folds by a fixed shuffle tree (𝔹: `__any_sync`);
//         lane i then stores item i, so a warp writes its rows in one
//         store.  (Aligned 32-bit words of four 𝔹 bytes, masked to the
//         item, were slower: more instructions a load, and no fewer
//         waits.)
//       segment_runs_rows<MODE, E, V>  (m, B) payloads: lane groups of
//         `tpe` threads span a slab of row elements (V-wide loads), the
//         32/tpe groups take further entries and fold by shuffle in a
//         fixed tree; ITEMS items a warp, a grid's width of warps apart.
//         𝔹 rows go as bytes, or as 32-bit words of four lanes (OR is
//         exact bytewise) when B % 4 == 0.
//     An item of a split row writes a partial, and the last item of the
//     row to finish (a per-row ticket: an atomic on the ticket, never on
//     the output) folds the row's partials in item order and resets the
//     ticket, so a call is one launch.  Every ⊕ so runs in an order the
//     plan fixes: real sums are the same on every call.
//   scatter — ids without a plan (one-shot keys such as those of
//     SparseRelation.to_dense): one thread per (entry, lane), global
//     atomics after a fill of 0̄ (a memset where 0̄ is all zero bytes).
//     trop uses the ordered-int trick for float atomicMin (sign bit
//     clear: IEEE bits order like signed ints; set: reversed as
//     unsigned), maxplus its mirror image, nat/real atomicAdd (so real
//     sums vary in order from run to run on this path).
//
// Bound on the card: bytes — the payload read once (4 B an f32 entry,
// 1 B a 𝔹 entry), the items' bounds and rows (8 B an item) and the
// output written once; there is no arithmetic to speak of.  The
// payload is usually in L2, written by the torch ⊗ just before.
//
// The entries return cudaErrorInvalidValue for a geometry they were not
// compiled for: items that do not cover [0, m) or are fewer than the
// rows, an item longer than E_CHUNK, another E_CHUNK, a kernel, vector
// or lane-group width that was not compiled, a grid that does not cover
// the items or the row, short scratch or tickets, misaligned operands.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

enum Mode { kBool = 0, kTrop = 1, kMaxPlus = 2, kSum = 3 };
enum Kernel { kScalar = 0, kRows = 1 };

constexpr int E_CHUNK = 128;   // most entries an item holds (py: E_CHUNK)
constexpr int WARPS = 8;       // warps a block (py: WARPS)
constexpr int ITEMS = 4;       // items a warp (py: ITEMS_PER_WARP)
constexpr int UNROLL = 4;      // rows kernel: entries a group has in flight
constexpr int PER_LANE = E_CHUNK / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(PER_LANE == 4, "segment_runs_scalar folds four loads a lane");

template <int MODE, typename E> struct Op;
template <typename E> struct Op<kBool, E> {   // bytes, or words of bytes
  __device__ static E zero() { return E(0); }
  __device__ static E add(E a, E b) { return a | b; }
};
template <> struct Op<kTrop, float> {
  __device__ static float zero() { return INFINITY; }
  __device__ static float add(float a, float b) { return fminf(a, b); }
};
template <> struct Op<kMaxPlus, float> {
  __device__ static float zero() { return -INFINITY; }
  __device__ static float add(float a, float b) { return fmaxf(a, b); }
};
template <> struct Op<kSum, float> {          // nat and real
  __device__ static float zero() { return 0.0f; }
  __device__ static float add(float a, float b) { return a + b; }
};

__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(FULL, v, off);
}
__device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int off) {
  return __shfl_xor_sync(FULL, v, off);
}
__device__ __forceinline__ uint8_t shfl_xor(uint8_t v, int off) {
  return (uint8_t)__shfl_xor_sync(FULL, (unsigned)v, off);
}

// V consecutive row elements: one 16-byte access, or one scalar
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <typename E>
__device__ __forceinline__ void load_vec(const E* p, E (&v)[1]) {
  v[0] = __ldcs(p);
}
__device__ __forceinline__ void load_cg(const float* p, float (&v)[4]) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <typename E>
__device__ __forceinline__ void load_cg(const E* p, E (&v)[1]) {
  v[0] = __ldcg(p);
}
__device__ __forceinline__ void store_cg(float* p, const float (&v)[4]) {
  __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
template <typename E>
__device__ __forceinline__ void store_cg(E* p, const E (&v)[1]) {
  __stcg(p, v[0]);
}

// The scalar kernels' last step.  Lane i < ITEMS holds item i's ⊕ `r`
// and its row `d` (≥ 0) or partial slot ~d (a split row).  Whole rows
// are stored; a partial is stored, then its row's ticket is taken: the
// item that takes the last one folds the row's partials in item order.
template <int MODE, typename E>
__device__ __forceinline__ void finish_scalar(
    E r, int d, bool has, const int* __restrict__ slot_fold,
    const int* __restrict__ fold_row, const int* __restrict__ fold_seg,
    E* __restrict__ out, E* __restrict__ part, int* __restrict__ tickets) {
  using O = Op<MODE, E>;
  if (has && d >= 0) out[d] = r;
  const bool split = has && d < 0;
  if (!__any_sync(FULL, split)) return;      // warp-uniform
  if (split) {
    const int s = ~d;
    __stcg(part + s, r);
    __threadfence();                         // the partial before the ticket
    const int k = __ldg(slot_fold + s);
    const int a = __ldg(fold_seg + k), b = __ldg(fold_seg + k + 1);
    if (atomicAdd(tickets + k, 1) == b - a - 1) {
      __threadfence();                       // the ticket before the reads
      E acc = __ldcg(part + a);
      for (int q = a + 1; q < b; ++q) acc = O::add(acc, __ldcg(part + q));
      out[__ldg(fold_row + k)] = acc;
      tickets[k] = 0;                        // ready for the next call
    }
  }
}

// (m,) payloads in plan order: f32, or 𝔹 as bool bytes.  Item i of the
// grid holds entries [item_edge[i], item_edge[i+1]); warp w takes items
// w·ITEMS .. w·ITEMS + ITEMS - 1.
template <int MODE, typename E>
__global__ void __launch_bounds__(WARPS * 32)
segment_runs_scalar(const E* __restrict__ vals,
                    const int* __restrict__ item_edge,
                    const int* __restrict__ item_dst,
                    const int* __restrict__ slot_fold,
                    const int* __restrict__ fold_row,
                    const int* __restrict__ fold_seg, E* __restrict__ out,
                    E* __restrict__ part, int* __restrict__ tickets,
                    int n_items) {
  using O = Op<MODE, E>;
  const int lane = threadIdx.x & 31;
  const long long first =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * ITEMS;
  if (first >= n_items) return;              // warp-uniform
  // lane j ≤ ITEMS: the start of item first + j (the end sentinel past
  // the last item, so missing items are empty)
  const int e_l = __ldg(item_edge + min(first + min(lane, ITEMS),
                                        (long long)n_items));
  const bool has = lane < ITEMS && first + lane < n_items;
  const int d_l = has ? __ldg(item_dst + first + lane) : 0;
  E v[ITEMS][PER_LANE];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int lo = __shfl_sync(FULL, e_l, i);
    const int hi = __shfl_sync(FULL, e_l, i + 1);
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) {
      const int t = lo + lane + 32 * u;
      v[i][u] = t < hi ? __ldcs(vals + t) : O::zero();
    }
  }
  E mine = O::zero();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    E a = O::add(O::add(v[i][0], v[i][1]), O::add(v[i][2], v[i][3]));
    if constexpr (MODE == kBool) {
      a = __any_sync(FULL, a != 0) ? 1 : 0;
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a = O::add(a, shfl_xor(a, off));
    }
    if (lane == i) mine = a;
  }
  finish_scalar<MODE, E>(mine, d_l, has, slot_fold, fold_row, fold_seg, out,
                         part, tickets);
}

// (m, B) payloads in plan order, rows of row_len elements.  One warp per
// (item, slab); this warp covers elements [blockIdx.y · tpe·V,
// (blockIdx.y + 1) · tpe·V) of a row.  A warp runs ITEMS items one after
// another, a grid's width of warps apart (a split row's items land on
// different warps); their bounds come in one load of its lanes.
template <int MODE, typename E, int V>
__global__ void __launch_bounds__(WARPS * 32)
segment_runs_rows(const E* __restrict__ vals,
                  const int* __restrict__ item_edge,
                  const int* __restrict__ item_dst,
                  const int* __restrict__ slot_fold,
                  const int* __restrict__ fold_row,
                  const int* __restrict__ fold_seg, E* __restrict__ out,
                  E* __restrict__ part, int* __restrict__ tickets,
                  int n_items, int row_len, int tpe) {
  using O = Op<MODE, E>;
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (warp >= n_items) return;               // warp-uniform
  const long long mine = warp + (long long)lane * gridDim.x * WARPS;
  const bool has = lane < ITEMS && mine < n_items;
  const int lo_l = has ? __ldg(item_edge + mine) : 0;
  const int hi_l = has ? __ldg(item_edge + mine + 1) : 0;
  const int dst_l = has ? __ldg(item_dst + mine) : 0;
  const int count = __popc(__ballot_sync(FULL, has));
  const int groups = 32 / tpe;
  const int g = lane / tpe;
  const int c = (blockIdx.y * tpe + lane % tpe) * V;
  const bool on = c < row_len;               // row_len % V == 0
  const bool owner = g == 0 && on;           // holds the row's elements
  for (int i = 0; i < count; ++i) {
    const int lo = __shfl_sync(FULL, lo_l, i);
    const int n = __shfl_sync(FULL, hi_l, i) - lo;
    const int d = __shfl_sync(FULL, dst_l, i);
    E acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = O::zero();
    if (on) {
      for (int t0 = g; t0 < n; t0 += groups * UNROLL) {
        E x[UNROLL][V];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int t = t0 + u * groups;
          if (t < n) {
            load_vec(vals + (long long)(lo + t) * row_len + c, x[u]);
          } else {
#pragma unroll
            for (int k = 0; k < V; ++k) x[u][k] = O::zero();
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = O::add(acc[k], x[u][k]);
      }
    }
    // lanes tpe, 2·tpe, … apart hold the same elements of other entries
    for (int off = tpe; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = O::add(acc[k], shfl_xor(acc[k], off));
    }
    if (d >= 0) {                            // warp-uniform
      if (owner) store_cg(out + (long long)d * row_len + c, acc);
      continue;
    }
    const int s = ~d;                        // a split row's partial
    if (owner) store_cg(part + (long long)s * row_len + c, acc);
    __threadfence();
    __syncwarp();
    int k = 0, last = 0;
    if (lane == 0) {
      k = __ldg(slot_fold + s);
      const int a = __ldg(fold_seg + k), b = __ldg(fold_seg + k + 1);
      last = atomicAdd(tickets + (long long)k * gridDim.y + blockIdx.y, 1) ==
             b - a - 1;
    }
    if (!__shfl_sync(FULL, last, 0)) continue;
    k = __shfl_sync(FULL, k, 0);
    __threadfence();
    if (owner) {
      const int a = __ldg(fold_seg + k), b = __ldg(fold_seg + k + 1);
      E r[V], x[V];
      load_cg(part + (long long)a * row_len + c, r);
      for (int q = a + 1; q < b; ++q) {
        load_cg(part + (long long)q * row_len + c, x);
#pragma unroll
        for (int j = 0; j < V; ++j) r[j] = O::add(r[j], x[j]);
      }
      store_cg(out + (long long)__ldg(fold_row + k) * row_len + c, r);
    }
    if (lane == 0) tickets[(long long)k * gridDim.y + blockIdx.y] = 0;
  }
}

struct Runs {                     // the plan's device arrays
  const int* item_edge;
  const int* item_dst;
  const int* slot_fold;
  const int* fold_row;
  const int* fold_seg;
  int* tickets;
};

template <int MODE, typename E>
void launch_scalar(const void* vals, const Runs& p, void* out, void* part,
                   int n_items, int grid_x, cudaStream_t st) {
  segment_runs_scalar<MODE, E><<<grid_x, WARPS * 32, 0, st>>>(
      static_cast<const E*>(vals), p.item_edge, p.item_dst, p.slot_fold,
      p.fold_row, p.fold_seg, static_cast<E*>(out), static_cast<E*>(part),
      p.tickets, n_items);
}

template <int MODE, typename E, int V>
void launch_rows(const void* vals, const Runs& p, void* out, void* part,
                 int n_items, int row_len, int tpe, dim3 grid,
                 cudaStream_t st) {
  segment_runs_rows<MODE, E, V><<<grid, WARPS * 32, 0, st>>>(
      static_cast<const E*>(vals), p.item_edge, p.item_dst, p.slot_fold,
      p.fold_row, p.fold_seg, static_cast<E*>(out), static_cast<E*>(part),
      p.tickets, n_items, row_len, tpe);
}

template <int MODE>
void launch_rows_f32(const void* vals, const Runs& p, void* out, void* part,
                     int n_items, int row_len, int vec, int tpe, dim3 grid,
                     cudaStream_t st) {
  if (vec == 4)
    launch_rows<MODE, float, 4>(vals, p, out, part, n_items, row_len, tpe,
                                grid, st);
  else
    launch_rows<MODE, float, 1>(vals, p, out, part, n_items, row_len, tpe,
                                grid, st);
}

// ---- the scatter path -----------------------------------------------------

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

__global__ void fill_float(float* out, long long count, float value) {
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

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// The runs path: out (n, row_len) ← the ⊕ of each row's run of vals
// (m, row_len), which are in plan order.  kernel 0 is segment_runs_scalar
// ((m,) payloads: f32, or bool bytes for mode 0); kernel 1 is
// segment_runs_rows (row_len
// elements of elem_bytes each: f32, or 𝔹 as bytes (1) or words of four
// bytes (4)).  item_edge (n_items + 1,) holds entry starts with the end
// sentinel, and the caller states its first and last entries and the
// longest item; item_dst (n_items,), slot_fold (n_part,), fold_row
// (n_split,), fold_seg (n_split + 1,) are int32 on the device, tickets
// (n_tickets,) int32 zeros that the call leaves zero.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a foreign geometry.
extern "C" int coo_segment_runs(
    int mode, int kernel, int elem_bytes, const void* vals,
    const void* item_edge, const void* item_dst, const void* slot_fold,
    const void* fold_row, const void* fold_seg, void* tickets, void* out,
    void* part, int m, int n, int row_len, int vec, int tpe, int chunk,
    int n_items, int item_first, int item_last, int max_item_edges,
    int n_split, int n_part, long long part_elems, long long n_tickets,
    int grid_x, int grid_y, void* stream) {
  const long long per_grid = (long long)grid_x * WARPS * ITEMS;
  bool ok = mode >= kBool && mode <= kSum && m >= 0 && n >= 0 &&
            chunk == E_CHUNK && n_items >= n && item_first == 0 &&
            item_last == m && max_item_edges >= 0 &&
            max_item_edges <= E_CHUNK && per_grid >= n_items &&
            n_split >= 0 && n_part >= n_split &&
            (n_split == 0) == (n_part == 0) &&
            part_elems >= (long long)n_part * row_len &&
            n_tickets >= (long long)n_split * grid_y;
  if (kernel == kScalar) {
    ok = ok && row_len == 1 && vec == 1 && tpe == 1 && grid_y == 1 &&
         elem_bytes == (mode == kBool ? 1 : 4);
  } else if (kernel == kRows) {
    const bool words = mode == kBool && elem_bytes == 4;
    ok = ok && row_len >= 1 && (vec == 1 || vec == 4) && tpe >= 1 &&
         tpe <= 32 && (tpe & (tpe - 1)) == 0 && row_len % vec == 0 &&
         grid_y >= 1 && grid_y <= 65535 &&
         (long long)grid_y * tpe * vec >= row_len &&
         (mode == kBool ? (elem_bytes == 1 || elem_bytes == 4)
                        : elem_bytes == 4) &&
         (vec == 1 || mode != kBool) &&
         (!words || (aligned(vals, 4) && aligned(out, 4) &&
                     (n_part == 0 || aligned(part, 4)))) &&
         (vec == 1 || (aligned(vals, 16) && aligned(out, 16) &&
                       (n_part == 0 || aligned(part, 16))));
  } else {
    ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  if (grid_x == 0 || n_items == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Runs p{static_cast<const int*>(item_edge),
               static_cast<const int*>(item_dst),
               static_cast<const int*>(slot_fold),
               static_cast<const int*>(fold_row),
               static_cast<const int*>(fold_seg), static_cast<int*>(tickets)};
  if (kernel == kScalar) {
    switch (mode) {
      case kBool:
        launch_scalar<kBool, uint8_t>(vals, p, out, part, n_items, grid_x, st);
        break;
      case kTrop:
        launch_scalar<kTrop, float>(vals, p, out, part, n_items, grid_x, st);
        break;
      case kMaxPlus:
        launch_scalar<kMaxPlus, float>(vals, p, out, part, n_items, grid_x,
                                       st);
        break;
      default:
        launch_scalar<kSum, float>(vals, p, out, part, n_items, grid_x, st);
    }
    return (int)cudaGetLastError();
  }
  const dim3 grid(grid_x, grid_y);
  switch (mode) {
    case kBool:
      if (elem_bytes == 4)
        launch_rows<kBool, uint32_t, 1>(vals, p, out, part, n_items, row_len,
                                        tpe, grid, st);
      else
        launch_rows<kBool, uint8_t, 1>(vals, p, out, part, n_items, row_len,
                                       tpe, grid, st);
      break;
    case kTrop:
      launch_rows_f32<kTrop>(vals, p, out, part, n_items, row_len, vec, tpe,
                             grid, st);
      break;
    case kMaxPlus:
      launch_rows_f32<kMaxPlus>(vals, p, out, part, n_items, row_len, vec,
                                tpe, grid, st);
      break;
    default:
      launch_rows_f32<kSum>(vals, p, out, part, n_items, row_len, vec, tpe,
                            grid, st);
  }
  return (int)cudaGetLastError();
}

// The scatter path: vals (m, lanes) contiguous, ids (m,) int32, out (n,
// lanes) — written completely (0̄ first, then the scatter).  Returns
// cudaGetLastError().
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
    if (out_count > 0) {
      const cudaError_t e = cudaMemsetAsync(o, 0, out_count, st);
      if (e != cudaSuccess) return (int)e;
    }
    if (total > 0)
      scatter_bool<<<grid_for(total, threads), threads, 0, st>>>(
          static_cast<const uint8_t*>(vals), id, o, total, lanes, n);
    return (int)cudaGetLastError();
  }
  float* o = static_cast<float*>(out);
  const float* v = static_cast<const float*>(vals);
  if (out_count > 0) {
    if (mode == kSum) {                      // 0.0f is all zero bytes
      const cudaError_t e =
          cudaMemsetAsync(o, 0, out_count * sizeof(float), st);
      if (e != cudaSuccess) return (int)e;
    } else {
      fill_float<<<grid_for(out_count, threads), threads, 0, st>>>(
          o, out_count, mode == kTrop ? INFINITY : -INFINITY);
    }
  }
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
