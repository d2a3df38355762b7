// B5's mask, shared by the forward (flash_attention.cu) and the backward
// (flash_attention_bwd.cu), so that both see the same keys.
//
// Query i sits at position q_offset + i, key j at j.  The mask keeps
// j <= pos (causal), j > pos - window (sliding window, window > 0) and
// j / chunk == pos / chunk (chunked attention, chunk > 0).  Whatever the
// masks, the keys one query sees form one interval, and both of its ends
// grow with the position: so the keys some query at a position in
// [pos_lo, pos_hi] sees lie in [lo(pos_lo), hi(pos_hi)).
#pragma once

namespace attn_mask {

struct Range {
  int lo, hi;  // keys [lo, hi)
};

// keys that some query at a position in [pos_lo, pos_hi] can see (the
// hull of their intervals); for pos_lo = pos_hi, exactly the keys that
// query sees
__host__ __device__ __forceinline__ Range keys_seen(int pos_lo, int pos_hi,
                                                    int tk, int causal,
                                                    int window, int chunk) {
  int lo = 0, hi = tk;
  if (causal && pos_hi + 1 < hi) hi = pos_hi + 1;
  if (window > 0 && pos_lo - window + 1 > lo) lo = pos_lo - window + 1;
  if (chunk > 0) {
    if (pos_lo / chunk * chunk > lo) lo = pos_lo / chunk * chunk;
    if ((pos_hi / chunk + 1) * chunk < hi) hi = (pos_hi / chunk + 1) * chunk;
  }
  return {lo, hi > lo ? hi : lo};
}

// keys that every query at a position in [pos_lo, pos_hi] sees (the
// intersection of their intervals; empty where a chunk edge falls between
// the two positions)
__host__ __device__ __forceinline__ Range keys_seen_by_all(int pos_lo,
                                                           int pos_hi, int tk,
                                                           int causal,
                                                           int window,
                                                           int chunk) {
  int lo = 0, hi = tk;
  if (causal && pos_lo + 1 < hi) hi = pos_lo + 1;
  if (window > 0 && pos_hi - window + 1 > lo) lo = pos_hi - window + 1;
  if (chunk > 0) {
    if (pos_lo / chunk != pos_hi / chunk) return {0, 0};
    if (pos_lo / chunk * chunk > lo) lo = pos_lo / chunk * chunk;
    if ((pos_lo / chunk + 1) * chunk < hi) hi = (pos_lo / chunk + 1) * chunk;
  }
  return {lo, hi > lo ? hi : lo};
}

// positions of the queries that see key `key` (0 <= key < tk): the
// transpose of keys_seen, so that key ∈ keys_seen(pos) exactly when pos
// lies in the range; [0, 2^30) stands for "no bound"
__host__ __device__ __forceinline__ Range queries_seeing(int key, int causal,
                                                         int window,
                                                         int chunk) {
  int lo = causal ? key : 0, hi = 1 << 30;
  if (window > 0 && window < hi - key) hi = key + window;
  if (chunk > 0) {
    if (key / chunk * chunk > lo) lo = key / chunk * chunk;
    if ((key / chunk + 1) * chunk < hi) hi = (key / chunk + 1) * chunk;
  }
  return {lo, hi > lo ? hi : lo};
}

}  // namespace attn_mask
