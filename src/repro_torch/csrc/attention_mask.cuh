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

}  // namespace attn_mask
