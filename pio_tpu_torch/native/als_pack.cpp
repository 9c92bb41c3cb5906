// Native COO→blocked-CSR packer and wire encoders — the host side of ALS.
//
// The port's copy of the reference's packer. pio_tpu_torch/models/als.py
// sorts the rating edges by (user, item) and encodes the compact wire here
// (als_pack_count, als_sort_by_entity + als_sort_within_entity,
// als_rating_codes, als_delta_count + als_delta_fill) before the transfer
// to the device; its numpy routes (_counts_layout, _sort_edges_by_user,
// _encode_ratings, _delta_wire_size, _encode_items_delta, _pack_blocks)
// define every format and are held bitwise equal to these. als_pack_fill
// is the host
// block packer (_pack_blocks' layout: blocks sorted by entity id, padded
// slots carry other = -1). The numpy implementation is a single-threaded
// argsort + scatter; this one is a stable parallel counting sort writing
// straight into the caller's buffers.
//
// Exposed via a C ABI consumed with ctypes (pio_tpu_torch/native/__init__.py
// builds this file with g++ on first use). Unchanged from the reference's
// source apart from these comments: the port's wire is the reference's.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

int n_threads(int64_t n_edges, int32_t n_entities) {
  unsigned hw = std::thread::hardware_concurrency();
  int t = static_cast<int>(hw ? hw : 4);
  t = std::min(t, 16);
  // under ~1M edges the spawn cost outweighs the split
  if (n_edges < (1 << 20)) t = 1;
  // per-thread histograms cost T * n_entities * 8 bytes — cap the total
  // at ~256 MB so a huge sparse catalog can't trigger a multi-GB spike
  int64_t mem_cap = (256LL << 20) / (8 * std::max<int64_t>(1, n_entities));
  t = static_cast<int>(std::min<int64_t>(t, std::max<int64_t>(1, mem_cap)));
  return std::max(1, t);
}

template <typename F>
void parallel_ranges(int64_t n, int threads, F&& fn) {
  if (threads == 1) {
    fn(0, int64_t{0}, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([&fn, t, lo, hi] { fn(t, lo, hi); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Pass 1: per-entity degree histogram → counts[n_entities], and the total
// block count at the given width. Returns n_blocks, or -1 on bad input
// (an entity id outside [0, n_entities)).
int64_t als_pack_count(const int32_t* ent, int64_t n_edges,
                       int32_t n_entities, int32_t width,
                       int64_t* counts) {
  std::memset(counts, 0, sizeof(int64_t) * n_entities);
  const int T = n_threads(n_edges, n_entities);
  std::atomic<bool> ok{true};
  if (T == 1) {
    for (int64_t k = 0; k < n_edges; ++k) {
      int32_t e = ent[k];
      if (e < 0 || e >= n_entities) return -1;
      ++counts[e];
    }
  } else {
    std::vector<std::vector<int64_t>> part(
        T, std::vector<int64_t>(n_entities, 0));
    parallel_ranges(n_edges, T, [&](int t, int64_t lo, int64_t hi) {
      auto& h = part[t];
      for (int64_t k = lo; k < hi; ++k) {
        int32_t e = ent[k];
        if (e < 0 || e >= n_entities) {
          ok.store(false, std::memory_order_relaxed);
          return;
        }
        ++h[e];
      }
    });
    if (!ok.load()) return -1;
    for (int t = 0; t < T; ++t)
      for (int32_t e = 0; e < n_entities; ++e) counts[e] += part[t][e];
  }
  int64_t n_blocks = 0;
  for (int32_t e = 0; e < n_entities; ++e)
    n_blocks += (counts[e] + width - 1) / width;
  return n_blocks;
}

// Pass 2: stable scatter into the caller-allocated block arrays
// (block_ent [S], block_other [S*width], block_rating [S*width] — the
// caller may point these INTO its coalesced transfer buffers). counts is
// pass 1's output; S is the padded block count (≥ n_blocks). Edge order
// within an entity is preserved (stable, like the numpy argsort path).
// Returns 0.
int als_pack_fill(const int32_t* ent, const int32_t* other,
                  const float* rating, int64_t n_edges, int32_t n_entities,
                  int32_t width, const int64_t* counts, int64_t S,
                  int32_t* block_ent, int32_t* block_other,
                  float* block_rating) {
  const int T = n_threads(n_edges, n_entities);

  // entity → first flat slot of its first block
  std::vector<int64_t> slot_start(n_entities + 1);
  slot_start[0] = 0;
  for (int32_t e = 0; e < n_entities; ++e) {
    int64_t blocks = (counts[e] + width - 1) / width;
    slot_start[e + 1] = slot_start[e] + blocks * width;
  }

  // per-(thread, entity) write cursors: thread t starts after all edges
  // of the same entity owned by threads < t → stable by construction
  std::vector<std::vector<int64_t>> cursor(
      T, std::vector<int64_t>(n_entities, 0));
  if (T > 1) {
    parallel_ranges(n_edges, T, [&](int t, int64_t lo, int64_t hi) {
      auto& h = cursor[t];
      for (int64_t k = lo; k < hi; ++k) ++h[ent[k]];
    });
    // exclusive scan over threads per entity
    for (int32_t e = 0; e < n_entities; ++e) {
      int64_t acc = 0;
      for (int t = 0; t < T; ++t) {
        int64_t c = cursor[t][e];
        cursor[t][e] = acc;
        acc += c;
      }
    }
  }

  const int64_t total = S * static_cast<int64_t>(width);
  parallel_ranges(total, T, [&](int, int64_t lo, int64_t hi) {
    std::fill(block_other + lo, block_other + hi, int32_t{-1});
    std::memset(block_rating + lo, 0, sizeof(float) * (hi - lo));
  });

  parallel_ranges(n_edges, T, [&](int t, int64_t lo, int64_t hi) {
    auto& cur = cursor[t];
    for (int64_t k = lo; k < hi; ++k) {
      int32_t e = ent[k];
      int64_t pos = cur[e]++;
      // position → flat slot: whole blocks are width apart
      int64_t flat = slot_start[e] + pos;
      block_other[flat] = other[k];
      block_rating[flat] = rating[k];
    }
  });

  // block_ent: entity of each block, ascending; padding blocks point at
  // the last entity (their slots are all masked)
  std::vector<int64_t> block_start(n_entities + 1);
  block_start[0] = 0;
  for (int32_t e = 0; e < n_entities; ++e)
    block_start[e + 1] = block_start[e] + (counts[e] + width - 1) / width;
  parallel_ranges(n_entities, T, [&](int, int64_t lo, int64_t hi) {
    for (int64_t e = lo; e < hi; ++e)
      for (int64_t s = block_start[e]; s < block_start[e + 1]; ++s)
        block_ent[s] = static_cast<int32_t>(e);
  });
  for (int64_t s = block_start[n_entities]; s < S; ++s)
    block_ent[s] = n_entities - 1;
  return 0;
}

// Stable counting sort of (other, rating) by entity id — the wire-format
// reducer for the single-device path: once edges are entity-sorted, the
// per-edge entity plane collapses to a per-entity COUNTS array (65k× fewer
// bytes at MovieLens scale) and the device rebuilds ids with one repeat.
// counts is als_pack_count's output. Returns 0.
//
// Two-level scatter: a direct counting-sort scatter is TLB-miss bound
// (25M random 8 B writes across a 200 MB destination ≈ 35 ns each).
// Pass 1 partitions edges into ≤256 coarse buckets of contiguous entity
// ranges (≤256 active write streams — TLB-resident); pass 2 scatters
// each bucket internally, where the destination range is ~1 MB and
// cache-resident. Both passes are stable (edges keep arrival order per
// thread, threads are rank-ordered per bucket/entity), so the result
// matches a stable sort by entity exactly. Measured ~2× faster than the
// direct scatter at MovieLens-25M scale on one core.
int als_sort_by_entity(const int32_t* ent, const int32_t* other,
                       const float* rating, int64_t n_edges,
                       int32_t n_entities, const int64_t* counts,
                       int32_t* other_sorted, float* rating_sorted) {
  const int T = n_threads(n_edges, n_entities);

  std::vector<int64_t> edge_start(n_entities + 1);
  edge_start[0] = 0;
  for (int32_t e = 0; e < n_entities; ++e)
    edge_start[e + 1] = edge_start[e] + counts[e];

  // bucket = entity >> shift, sized so bucket count ≤ 256
  int shift = 0;
  while ((static_cast<int64_t>(n_entities - 1) >> shift) >= 256) ++shift;
  const int B = static_cast<int>(((n_entities - 1) >> shift) + 1);
  std::vector<int64_t> bucket_start(B + 1);
  for (int b = 0; b < B; ++b)
    bucket_start[b] = edge_start[std::min<int64_t>(
        static_cast<int64_t>(b) << shift, n_entities)];
  bucket_start[B] = n_edges;

  // per-(thread, bucket) cursors, stable by thread order
  std::vector<std::vector<int64_t>> bcur(T, std::vector<int64_t>(B, 0));
  if (T > 1) {
    parallel_ranges(n_edges, T, [&](int t, int64_t lo, int64_t hi) {
      auto& h = bcur[t];
      for (int64_t k = lo; k < hi; ++k) ++h[ent[k] >> shift];
    });
    for (int b = 0; b < B; ++b) {
      int64_t acc = 0;
      for (int t = 0; t < T; ++t) {
        int64_t c = bcur[t][b];
        bcur[t][b] = acc;
        acc += c;
      }
    }
  }

  // default-init scratch (every slot written exactly once)
  std::unique_ptr<uint64_t[]> packed(new uint64_t[n_edges]);
  std::unique_ptr<int32_t[]> ent_tmp(new int32_t[n_edges]);
  parallel_ranges(n_edges, T, [&](int t, int64_t lo, int64_t hi) {
    auto& cur = bcur[t];
    for (int64_t k = lo; k < hi; ++k) {
      int32_t e = ent[k];
      int64_t dst = bucket_start[e >> shift] + cur[e >> shift]++;
      uint32_t rbits;
      std::memcpy(&rbits, &rating[k], 4);
      ent_tmp[dst] = e;
      packed[dst] = (static_cast<uint64_t>(rbits) << 32) |
                    static_cast<uint32_t>(other[k]);
    }
  });

  // pass 2: buckets own disjoint entity ranges, so one global per-entity
  // cursor array has no cross-bucket races; parallel over buckets
  std::vector<int64_t> ecur(n_entities, 0);
  parallel_ranges(B, std::min(T, B), [&](int, int64_t blo, int64_t bhi) {
    for (int64_t b = blo; b < bhi; ++b) {
      for (int64_t k = bucket_start[b]; k < bucket_start[b + 1]; ++k) {
        int32_t e = ent_tmp[k];
        int64_t dst = edge_start[e] + ecur[e]++;
        uint64_t p = packed[k];
        other_sorted[dst] = static_cast<int32_t>(p & 0xFFFFFFFFu);
        uint32_t rbits = static_cast<uint32_t>(p >> 32);
        std::memcpy(&rating_sorted[dst], &rbits, 4);
      }
    }
  });
  return 0;
}

// Fused rating-wire classifier + encoder, one parallel pass: detects the
// half-star grid (every rating*2 a nonneg integer) and emits u8 codes.
// Returns the max code (0..510), or -1 if any rating is off-grid (caller
// encodes f16/f32 in numpy). Replaces a ~4-pass numpy
// pipeline on the pack hot path.
int64_t als_rating_codes(const float* rating, int64_t n_edges,
                         uint8_t* codes) {
  const int T = n_threads(n_edges, 1);
  std::vector<int64_t> maxes(T, 0);
  std::atomic<bool> ok{true};
  parallel_ranges(n_edges, T, [&](int t, int64_t lo, int64_t hi) {
    int64_t mx = 0;
    for (int64_t k = lo; k < hi; ++k) {
      float r2 = rating[k] * 2.0f;
      // range-guard BEFORE the int cast: float→int of NaN/inf/out-of-
      // range is UB (the guard also rejects NaN via negated compares)
      if (!(r2 >= 0.0f) || !(r2 <= 255.0f)) {
        ok.store(false, std::memory_order_relaxed);
        return;
      }
      int32_t v = static_cast<int32_t>(r2);
      if (static_cast<float>(v) != r2) {
        ok.store(false, std::memory_order_relaxed);
        return;
      }
      codes[k] = static_cast<uint8_t>(v);
      if (v > mx) mx = v;
    }
    maxes[t] = mx;
  });
  if (!ok.load()) return -1;
  int64_t mx = 0;
  for (int t = 0; t < T; ++t) mx = std::max(mx, maxes[t]);
  return mx;
}

// In-place stable sort of each entity's adjacency segment by the OTHER id
// (items ascending within a user). ALS is invariant to within-entity edge
// order, and the sorted adjacency is what makes the delta item wire
// (pio_tpu_torch/models/als.py _encode_items_delta) dense: gaps between
// consecutive items fit 12 bits almost everywhere. Matches numpy's
// np.lexsort((other, ent)) order exactly: stable on duplicate ids.
//
// Implementation: per-segment LSD radix over the id bytes (digit count
// from the global max id — 2 passes at MovieLens scale), with a stable
// insertion sort for tiny segments. Radix is branchless where introsort
// on random ids mispredicts half its compares — measured ~2× faster at
// 25M edges / 154-edge average segments, and the id+rating pair moves
// together so there is no key-pack/unpack pass. counts is
// als_pack_count's output. Returns 0.
int als_sort_within_entity(int32_t* other_sorted, float* rating_sorted,
                           int32_t n_entities, const int64_t* counts) {
  int64_t n_edges = 0, max_seg = 0;
  for (int32_t e = 0; e < n_entities; ++e) {
    n_edges += counts[e];
    max_seg = std::max(max_seg, counts[e]);
  }
  // fail loud rather than let the uint32 radix cursors wrap silently
  if (max_seg >= (1LL << 32)) return -1;
  const int T = n_threads(n_edges, n_entities);

  std::vector<int64_t> edge_start(n_entities + 1);
  edge_start[0] = 0;
  for (int32_t e = 0; e < n_entities; ++e)
    edge_start[e + 1] = edge_start[e] + counts[e];

  // digit count for the radix from the global max id (sequential scan:
  // ~1 ns/edge, keeps every segment's pass count identical)
  int32_t max_id = 0;
  for (int64_t k = 0; k < n_edges; ++k)
    max_id = std::max(max_id, other_sorted[k]);
  // 64-bit shift + passes<=4 bound: a 32-bit shift by 32 (ids >= 2^24)
  // would be UB and, with x86 mod-32 semantics, an infinite loop
  int passes = 1;
  while (passes < 4 &&
         (static_cast<uint64_t>(static_cast<uint32_t>(max_id)) >>
          (8 * passes)) != 0)
    ++passes;

  parallel_ranges(n_entities, T, [&](int, int64_t lo, int64_t hi) {
    std::vector<int32_t> tmp_o;
    std::vector<float> tmp_r;
    uint32_t cnt[256];
    for (int64_t e = lo; e < hi; ++e) {
      int64_t s = edge_start[e], n = counts[e];
      if (n < 2) continue;
      int32_t* o = other_sorted + s;
      float* r = rating_sorted + s;
      if (n <= 24) {
        // stable insertion sort (shift only while strictly greater)
        for (int64_t k = 1; k < n; ++k) {
          int32_t ok = o[k];
          float rk = r[k];
          int64_t j = k - 1;
          while (j >= 0 && o[j] > ok) {
            o[j + 1] = o[j];
            r[j + 1] = r[j];
            --j;
          }
          o[j + 1] = ok;
          r[j + 1] = rk;
        }
        continue;
      }
      if (static_cast<int64_t>(tmp_o.size()) < n) {
        tmp_o.resize(n);
        tmp_r.resize(n);
      }
      int32_t* src_o = o;
      float* src_r = r;
      int32_t* dst_o = tmp_o.data();
      float* dst_r = tmp_r.data();
      for (int pass = 0; pass < passes; ++pass) {
        const int shift = 8 * pass;
        std::memset(cnt, 0, sizeof(cnt));
        for (int64_t k = 0; k < n; ++k)
          ++cnt[(static_cast<uint32_t>(src_o[k]) >> shift) & 0xFF];
        uint32_t acc = 0;
        for (int b = 0; b < 256; ++b) {
          uint32_t c = cnt[b];
          cnt[b] = acc;
          acc += c;
        }
        for (int64_t k = 0; k < n; ++k) {
          uint32_t pos =
              cnt[(static_cast<uint32_t>(src_o[k]) >> shift) & 0xFF]++;
          dst_o[pos] = src_o[k];
          dst_r[pos] = src_r[k];
        }
        std::swap(src_o, dst_o);
        std::swap(src_r, dst_r);
      }
      if (passes & 1) {  // result landed in the scratch: copy back
        std::memcpy(o, src_o, sizeof(int32_t) * n);
        std::memcpy(r, src_r, sizeof(float) * n);
      }
    }
  });
  return 0;
}

// 12-bit delta item wire over a (user, item)-sorted edge array — the
// native route of pio_tpu_torch/models/als.py _encode_items_delta
// (the numpy route there defines the format). Pass 1 counts gaps ≥ 4096;
// pass 2 fills d_lo (u8 low byte), d_hi (high 4 bits nibble-packed, two
// edges per byte) and the sparse overflow (edge index, delta >> 12).
// counts segments the edges (zero entries allowed). Returns n_ovf, or
// -1 on a negative gap (input not item-sorted) or a gap ≥ 2^16.
int64_t als_delta_count(const int32_t* ids, const int64_t* counts,
                        int32_t n_segments) {
  int64_t n_ovf = 0, p = 0;
  for (int32_t s = 0; s < n_segments; ++s) {
    int32_t prev = 0;
    for (int64_t k = 0; k < counts[s]; ++k, ++p) {
      int64_t d = static_cast<int64_t>(ids[p]) - prev;
      if (d < 0 || d >= (1LL << 16)) return -1;
      if (d > 0xFFF) ++n_ovf;
      prev = ids[p];
    }
  }
  return n_ovf;
}

int als_delta_fill(const int32_t* ids, const int64_t* counts,
                   int32_t n_segments, int64_t n_edges,
                   uint8_t* d_lo, uint8_t* d_hi,
                   int32_t* ovf_idx, uint8_t* ovf_val) {
  std::memset(d_hi, 0, static_cast<size_t>((n_edges + 1) / 2));
  int64_t n_ovf = 0, p = 0;
  for (int32_t s = 0; s < n_segments; ++s) {
    int32_t prev = 0;
    for (int64_t k = 0; k < counts[s]; ++k, ++p) {
      int32_t d = ids[p] - prev;
      d_lo[p] = static_cast<uint8_t>(d & 0xFF);
      d_hi[p / 2] |= static_cast<uint8_t>(((d >> 8) & 0xF)
                                          << ((p % 2) ? 4 : 0));
      if (d > 0xFFF) {
        ovf_idx[n_ovf] = static_cast<int32_t>(p);
        ovf_val[n_ovf] = static_cast<uint8_t>(d >> 12);
        ++n_ovf;
      }
      prev = ids[p];
    }
  }
  return 0;
}

}  // extern "C"
