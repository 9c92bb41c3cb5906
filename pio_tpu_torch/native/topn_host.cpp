// Native host-mirror top-N scorer — the serving loop of a single request
// on the host path (pio_tpu_torch/ops/topn.py, DeviceTopNScorer's
// _top_n_host_native). The port's copy of the reference's scorer, changed
// in one place: a score of -0.0 is returned as +0.0 (see the selection
// loop), as the port's numpy host path returns it.
//
// The numpy path is two passes per query: a [1, K] @ [K, N] BLAS matmul
// materializing all N scores, then argpartition+argsort over them. This
// kernel works from a TRANSPOSED [K, N] table in L1-sized column blocks:
// scores accumulate with stride-1 FMA over each block (auto-vectorized
// at -O3 -march=native), then a guarded scan updates a top-n min-heap —
// the N-float score array never exists and the selection pass touches
// each block while it is still cache-hot.
//
// Results are sorted by (-score, index): deterministic under ties, the
// order of the numpy host path's composite keys.

#include <algorithm>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

constexpr int32_t BLOCK = 4096;  // 16 KB of f32 scores — L1-resident

struct Entry {
  float score;
  int32_t idx;
};

// comparator for a MIN-heap on score (std heap primitives build a
// max-heap by "less"; inverting the score compare puts the smallest
// score at the root). Ties: the larger index sits nearer the root, so
// the smaller index survives eviction — matching the (-score, idx)
// output order.
inline bool heap_less(const Entry& a, const Entry& b) {
  if (a.score != b.score) return a.score > b.score;
  return a.idx < b.idx;
}

}  // namespace

extern "C" {

// rows: [n_rows, K] query-side factors (row-major); cols_t: [K, n_cols]
// TRANSPOSED table (row-major). codes: [B] row indices. Writes
// out_idx/out_val [B, topn] sorted by (-score, idx); topn <= n_cols.
// Returns 0, or -1 on a code outside [0, n_rows).
int topn_host_f32(const float* rows, const float* cols_t, int32_t n_rows,
                  int32_t n_cols, int32_t k_rank, const int32_t* codes,
                  int64_t b, int32_t topn, int64_t* out_idx,
                  float* out_val) {
  std::vector<Entry> heap(topn);
  float blk[BLOCK];
  for (int64_t q = 0; q < b; ++q) {
    int32_t code = codes[q];
    if (code < 0 || code >= n_rows) return -1;
    const float* qv = rows + static_cast<int64_t>(code) * k_rank;
    int32_t filled = 0;
    float thresh = 0.0f;  // valid once filled == topn
    for (int32_t j0 = 0; j0 < n_cols; j0 += BLOCK) {
      const int32_t w = std::min(BLOCK, n_cols - j0);
      if (k_rank == 0) {  // degenerate rank: every dot product is 0
        for (int32_t j = 0; j < w; ++j) blk[j] = 0.0f;
      } else {
        const float* c0 = cols_t + j0;
        const float q0 = qv[0];
        for (int32_t j = 0; j < w; ++j) blk[j] = q0 * c0[j];
      }
      for (int32_t k = 1; k < k_rank; ++k) {
        const float* ck = cols_t + static_cast<int64_t>(k) * n_cols + j0;
        const float qk = qv[k];
        for (int32_t j = 0; j < w; ++j) blk[j] += qk * ck[j];
      }
      // selection while the block is cache-hot; the threshold test is
      // almost always false, so the heap machinery rarely runs
      for (int32_t j = 0; j < w; ++j) {
        // + 0.0f turns -0.0 (a sum of negative zeros) into +0.0, as the
        // numpy host path does: the two tie anyway, but the returned
        // score must be the same bits
        float s = blk[j] + 0.0f;
        // NaN (diverged factors / corrupt model) would break the strict
        // weak ordering std::sort and the heap require — UB that can
        // crash the server. Both host paths map NaN to -inf: it ranks
        // tied-last and SURFACES as -inf.
        if (!(s == s)) s = -std::numeric_limits<float>::infinity();
        if (filled < topn) {
          heap[filled++] = {s, j0 + j};
          if (filled == topn) {
            std::make_heap(heap.begin(), heap.end(), heap_less);
            thresh = heap[0].score;
          }
        } else if (s > thresh) {
          std::pop_heap(heap.begin(), heap.end(), heap_less);
          heap[topn - 1] = {s, j0 + j};
          std::push_heap(heap.begin(), heap.end(), heap_less);
          thresh = heap[0].score;
        }
      }
    }
    std::sort(heap.begin(), heap.begin() + filled, heap_less);
    for (int32_t r = 0; r < topn; ++r) {
      out_idx[q * topn + r] = r < filled ? heap[r].idx : 0;
      out_val[q * topn + r] = r < filled ? heap[r].score : 0.0f;
    }
  }
  return 0;
}

}  // extern "C"
