// Native edit-distance with error-breakdown counts for WER/CER.
//
// Same DP and tie-breaking as ssd_tpu_torch/evaluation/metrics.py (minimal cost,
// then maximal hits — matching the reference's fallback counter,
// src/evaluation/evaluate.py:61-98). Tokens are pre-hashed to int32 by the
// Python wrapper so one kernel serves both word- and char-level metrics.

#include <cstdint>
#include <vector>

namespace {

struct Cell {
  int32_t cost, ins, del, sub, hits;
};

inline bool better(const Cell& a, const Cell& b) {
  if (a.cost != b.cost) return a.cost < b.cost;
  return a.hits > b.hits;
}

}  // namespace

extern "C" {

// ref/hyp: int32 token ids. out: int32[5] = {cost, ins, del, sub, hits}.
void edit_distance_counts(const int32_t* ref, int32_t ref_len,
                          const int32_t* hyp, int32_t hyp_len, int32_t* out) {
  std::vector<Cell> prev(hyp_len + 1), cur(hyp_len + 1);
  for (int32_t j = 0; j <= hyp_len; ++j) prev[j] = {j, j, 0, 0, 0};
  for (int32_t i = 1; i <= ref_len; ++i) {
    cur[0] = {i, 0, i, 0, 0};
    const int32_t ri = ref[i - 1];
    for (int32_t j = 1; j <= hyp_len; ++j) {
      Cell ins = cur[j - 1];
      ins.cost += 1;
      ins.ins += 1;
      Cell del = prev[j];
      del.cost += 1;
      del.del += 1;
      Cell diag = prev[j - 1];
      if (ri == hyp[j - 1]) {
        diag.hits += 1;
      } else {
        diag.cost += 1;
        diag.sub += 1;
      }
      Cell best = ins;
      if (better(del, best)) best = del;
      if (better(diag, best)) best = diag;
      cur[j] = best;
    }
    prev.swap(cur);
  }
  const Cell& r = prev[hyp_len];
  out[0] = r.cost;
  out[1] = r.ins;
  out[2] = r.del;
  out[3] = r.sub;
  out[4] = r.hits;
}

}  // extern "C"
