// Query-plan builder: the host-side hot path of pruned BM25 retrieval.
//
// Per query (term ids + query term frequencies):
//   1. walk the terms' sorted postings lists in one k-way merge, computing
//      the TRUE score of every doc matching >= 2 terms; keep the top
//      `multi_budget` by (score desc, doc asc) in a bounded min-heap
//      (exactness: a true top-k multi-term doc is within the top-k
//      multi-term docs by score — see ops/bm25.py);
//   2. per term, emit the union of its top-`max_m` postings by impact
//      (via the prebuilt impact_order permutation, ties doc-ascending)
//      and its postings for the selected multi docs, as ONE ascending run
//      per term;
//   3. cursor-merge the per-term runs straight into the doc-id-sorted
//      (doc_ids, weights) output row (the device's segmented scan wants
//      sorted runs; the merge replaces a materialise + std::sort + copy).
//
// Mirrors openintel_tpu_torch/ops/bm25.py::build_query_plan exactly, including
// tie-breaking, so the two paths produce identical candidate sets.
// Single-threaded per call; callers parallelise over query batches.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

// Phase timers, on when the caller passes an array for them: a worker adds
// each phase's nanoseconds into locals and hands them over once, when its
// range ends; without the array no clock is read.
//   0 dedup_prune (term dedup, prune check)  1 intersect (pairwise
//   intersections)  2 multi_select  3 emit (per-term runs)  4 merge
// Two counts follow the phases in the same array:
//   5 multi_queries (queries that grouped their hits by doc)
//   6 multi_hits (the hits those queries grouped)
constexpr int kPhases = 5;
constexpr int kMultiQueries = kPhases;
constexpr int kMultiHits = kPhases + 1;
constexpr int kSlots = kPhases + 2;

struct PhaseClock {
  int64_t* out;  // kSlots slots to add into, or null
  int64_t acc[kSlots] = {};
  explicit PhaseClock(int64_t* slots) : out(slots) {}
  ~PhaseClock() {
    if (out != nullptr)
      for (int i = 0; i < kSlots; ++i) out[i] += acc[i];
  }
  int64_t now() const {
    if (out == nullptr) return 0;
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }
  void add(int phase, int64_t since) {
    if (out != nullptr) acc[phase] += now() - since;
  }
  void count(int slot, int64_t n) { acc[slot] += n; }
};

}  // namespace

namespace {

struct MultiDoc {
  double score;
  int32_t doc;
};

// min-heap comparator: "worst" = lowest score, then HIGHEST doc id, so that
// replacement keeps the top-B by (score desc, doc asc), matching
// np.lexsort((docs, -scores))[:B].
struct WorstFirst {
  bool operator()(const MultiDoc& a, const MultiDoc& b) const {
    if (a.score != b.score) return a.score > b.score;  // lower score = worse
    return a.doc < b.doc;                              // higher doc = worse
  }
};

}  // namespace

namespace {

// First index in ascending a[lo, hi) with a[idx] >= t, galloping from lo.
// The planner's doc walks emit ascending targets, so a forward cursor +
// exponential search makes each lookup ~O(log gap) of mostly-sequential
// reads instead of a full-range binary search of random cache misses.
inline int64_t gallop_lower_bound(const int32_t* a, int64_t lo, int64_t hi,
                                  int32_t t) {
  if (lo >= hi || a[lo] >= t) return lo;
  int64_t step = 1, prev = lo;
  while (lo + step < hi && a[lo + step] < t) {
    prev = lo + step;
    step <<= 1;
  }
  const int64_t end = std::min(lo + step + 1, hi);
  return std::lower_bound(a + prev + 1, a + end, t) - a;
}

// One postings match discovered during pairwise intersection: doc `doc`
// matches the query term with accumulation key `key` at global posting
// index `pos`. `key` orders the later score accumulation (query-term order
// with the largest list last — the reference accumulation order).
struct Hit {
  int64_t pos;
  int32_t doc;
  uint16_t key;
};

inline void emit_hits(int32_t doc, int64_t pos_a, uint16_t key_a,
                      int64_t pos_b, uint16_t key_b, std::vector<Hit>& out) {
  out.push_back(Hit{pos_a, doc, key_a});
  out.push_back(Hit{pos_b, doc, key_b});
}

// Bits needed to hold v (0 for 0).
inline int bit_width(uint64_t v) { return v == 0 ? 0 : 64 - __builtin_clzll(v); }

// Groups `hits` by (doc, key) ascending: an LSD radix sort on the value
// doc << key_bits | key, whose width the query's largest doc id and key
// set, in as few digits of at most kDigitBits as that width needs (a small
// corpus makes fewer passes). One read counts every digit; a digit whose
// hits all share one bucket is skipped. `tmp` and `counts` are the
// worker's scratch, reused across its queries.
constexpr int kDigitBits = 11;

void radix_group_hits(std::vector<Hit>& hits, std::vector<Hit>& tmp,
                      std::vector<uint32_t>& counts, int doc_bits,
                      int key_bits) {
  const size_t n = hits.size();
  const int width = doc_bits + key_bits;
  const int passes = (width + kDigitBits - 1) / kDigitBits;
  const int digit = (width + passes - 1) / passes;
  const size_t buckets = size_t{1} << digit;
  const uint64_t mask = buckets - 1;
  auto value = [key_bits](const Hit& h) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(h.doc)) << key_bits) |
           h.key;
  };
  counts.assign(passes * buckets, 0);
  for (const Hit& h : hits) {
    const uint64_t v = value(h);
    for (int p = 0; p < passes; ++p)
      ++counts[p * buckets + ((v >> (p * digit)) & mask)];
  }
  tmp.resize(n);
  for (int p = 0; p < passes; ++p) {
    uint32_t* c = counts.data() + p * buckets;
    const int shift = p * digit;
    if (c[(value(hits[0]) >> shift) & mask] == n) continue;
    uint32_t sum = 0;
    for (size_t b = 0; b < buckets; ++b) {
      const uint32_t x = c[b];
      c[b] = sum;
      sum += x;
    }
    for (const Hit& h : hits) tmp[c[(value(h) >> shift) & mask]++] = h;
    hits.swap(tmp);
  }
}

#if defined(__AVX512F__)
// Vectorized sorted-i32 intersection of ids[alo, ahi) x ids[blo, bhi).
// Block-pair scheme: compare a 16-lane block of `a` against all 16
// rotations of a 16-lane block of `b` (covers every pair; rotations use
// immediate-count valignd so the 16 compares are independent), then advance
// the block whose max is <= the other's (elements left behind can never
// match the other list's remaining elements, so no match is missed; doc ids
// are unique within a postings list, so no match repeats). ~1-2
// cycles/element vs ~8 for the scalar merge on the mispredict-heavy
// comparable-size case. Matches are rare, so their position decode (a
// 16-element scan of the b block) stays scalar off the hot path.
inline void simd_intersect(const int32_t* ids, int64_t alo, int64_t ahi,
                           int64_t blo, int64_t bhi, uint16_t key_a,
                           uint16_t key_b, std::vector<Hit>& out) {
  const int32_t* a = ids + alo;
  const int32_t* b = ids + blo;
  const int64_t na = ahi - alo, nb = bhi - blo;
  int64_t i = 0, j = 0;
  while (i + 16 <= na && j + 16 <= nb) {
    const __m512i va = _mm512_loadu_si512(a + i);
    const __m512i vb = _mm512_loadu_si512(b + j);
    __mmask16 m = _mm512_cmpeq_epi32_mask(va, vb);
#define OPENINTEL_ROT_CMP(r) \
  m |= _mm512_cmpeq_epi32_mask(va, _mm512_alignr_epi32(vb, vb, r));
    OPENINTEL_ROT_CMP(1) OPENINTEL_ROT_CMP(2) OPENINTEL_ROT_CMP(3)
    OPENINTEL_ROT_CMP(4) OPENINTEL_ROT_CMP(5) OPENINTEL_ROT_CMP(6)
    OPENINTEL_ROT_CMP(7) OPENINTEL_ROT_CMP(8) OPENINTEL_ROT_CMP(9)
    OPENINTEL_ROT_CMP(10) OPENINTEL_ROT_CMP(11) OPENINTEL_ROT_CMP(12)
    OPENINTEL_ROT_CMP(13) OPENINTEL_ROT_CMP(14) OPENINTEL_ROT_CMP(15)
#undef OPENINTEL_ROT_CMP
    while (m) {
      const int lane = __builtin_ctz(m);
      m &= m - 1;
      const int32_t d = a[i + lane];
      // b's position: the match is inside the current b block by
      // construction (the mask came from comparing these two blocks)
      const int32_t* bp = std::lower_bound(b + j, b + j + 16, d);
      emit_hits(d, alo + i + lane, key_a, blo + (bp - b), key_b, out);
    }
    const int32_t amax = a[i + 15], bmax = b[j + 15];
    i += (amax <= bmax) ? 16 : 0;
    j += (bmax <= amax) ? 16 : 0;
  }
  // scalar tail
  while (i < na && j < nb) {
    const int32_t x = a[i], y = b[j];
    if (x == y) emit_hits(x, alo + i, key_a, blo + j, key_b, out);
    i += (x <= y);
    j += (y <= x);
  }
}
#endif

// Membership-based intersection for a pair whose LARGER side has a
// precomputed postings bitmap (index.bitmap_cache): iterate the smaller
// list — ascending, so the bit probes stream sequentially through the
// bitmap row with near-perfect prefetch — and test each doc's bit. A
// hit's position in the larger list (needed for its impact value) comes
// from a monotonic galloping cursor; hits are rare, so the lookups are
// off the hot path. O(na) probes replaces the O(na+nb) merge on
// comparable-size high-df pairs and the O(na log) scattered gallop on
// skewed ones — the pairwise merge was 51% of plan-assembly cost at
// bench scale.
inline void bitmap_intersect(const int32_t* ids, int64_t alo, int64_t ahi,
                             int64_t blo, int64_t bhi, const uint64_t* bm,
                             uint16_t key_a, uint16_t key_b,
                             std::vector<Hit>& out) {
  int64_t cur = blo;
  for (int64_t i = alo; i < ahi; ++i) {
    const uint32_t d = static_cast<uint32_t>(ids[i]);
    if (bm[d >> 6] & (1ull << (d & 63))) {
      cur = gallop_lower_bound(ids, cur, bhi, ids[i]);
      emit_hits(ids[i], i, key_a, cur, key_b, out);
      ++cur;
    }
  }
}

// Word-AND intersection when BOTH sides have bitmaps and the smaller list
// is large: AND the two bitmap rows 64 docs at a time (8 words per AVX512
// vector) and decode the rare nonzero words to doc ids; positions come
// from monotonic galloping cursors on both lists (matches ascending).
// Cost is a CONSTANT ~n_words/8 vector ops — independent of the two dfs —
// vs O(min-df) probes / O(df_a+df_b) merge, so it wins exactly on the
// big x big pairs where every other strategy is at its worst.
inline void bitmap_and_intersect(const int32_t* ids, int64_t alo, int64_t ahi,
                                 int64_t blo, int64_t bhi,
                                 const uint64_t* bm_a, const uint64_t* bm_b,
                                 int64_t n_words, uint16_t key_a,
                                 uint16_t key_b, std::vector<Hit>& out) {
  int64_t ca = alo, cb = blo;
  auto decode = [&](uint64_t word, int64_t w) {
    while (word) {
      const int bit = __builtin_ctzll(word);
      word &= word - 1;
      const int32_t d = static_cast<int32_t>((w << 6) + bit);
      ca = gallop_lower_bound(ids, ca, ahi, d);
      cb = gallop_lower_bound(ids, cb, bhi, d);
      emit_hits(d, ca, key_a, cb, key_b, out);
      ++ca;
      ++cb;
    }
  };
  int64_t w = 0;
#if defined(__AVX512F__)
  for (; w + 8 <= n_words; w += 8) {
    const __m512i va = _mm512_loadu_si512(bm_a + w);
    const __m512i vb = _mm512_loadu_si512(bm_b + w);
    const __m512i x = _mm512_and_si512(va, vb);
    __mmask8 nz = _mm512_test_epi64_mask(x, x);
    if (nz) {
      alignas(64) uint64_t tmp[8];
      _mm512_store_si512(tmp, x);
      while (nz) {
        const int lane = __builtin_ctz(nz);
        nz &= nz - 1;
        decode(tmp[lane], w + lane);
      }
    }
  }
#endif
  for (; w < n_words; ++w) {
    const uint64_t x = bm_a[w] & bm_b[w];
    if (x) decode(x, w);
  }
}

// Matches between the ascending ranges ids[alo, ahi) and ids[blo, bhi),
// appended to `out` as one Hit PER SIDE (doc, key, global posting index).
// Adaptive: comparable sizes take a vectorized (or mostly-branchless
// scalar) merge; skewed sizes gallop the smaller list's elements through
// the larger with a monotonic forward cursor.
void intersect_ranges(const int32_t* ids, int64_t alo, int64_t ahi,
                      int64_t blo, int64_t bhi, uint16_t key_a, uint16_t key_b,
                      std::vector<Hit>& out) {
  int64_t na = ahi - alo, nb = bhi - blo;
  if (na > nb) {
    std::swap(alo, blo);
    std::swap(ahi, bhi);
    std::swap(na, nb);
    std::swap(key_a, key_b);
  }
  if (na == 0) return;
  if (nb / na >= 24) {
    int64_t cur = blo;
    for (int64_t i = alo; i < ahi; ++i) {
      cur = gallop_lower_bound(ids, cur, bhi, ids[i]);
      if (cur >= bhi) return;
      if (ids[cur] == ids[i]) emit_hits(ids[i], i, key_a, cur, key_b, out);
    }
    return;
  }
#if defined(__AVX512F__)
  simd_intersect(ids, alo, ahi, blo, bhi, key_a, key_b, out);
#else
  int64_t i = alo, j = blo;
  while (i < ahi && j < bhi) {
    const int32_t a = ids[i], b = ids[j];
    if (a == b) emit_hits(a, i, key_a, j, key_b, out);
    i += (a <= b);
    j += (b <= a);
  }
#endif
}

// Builds plans for queries [b_lo, b_hi); returns max width or -(needed).
// `doc_mask` (nullable, n_docs bytes, 1 = eligible) builds the FILTERED
// plan with the NumPy reference's semantics (ops/bm25.py::build_query_plan
// doc_mask): masked docs never enter the plan; the prune flag still uses
// the RAW df; per-term pruning keeps the top-M *unmasked* impacts (the
// impact-descending walk under the mask, identical tie-breaking); the
// multi-term merge considers unmasked docs only. Masking is per-doc, so
// an unmasked doc's postings are exactly its raw postings — matched
// counts and scores need no further adjustment.
int64_t plan_build_range(const int64_t* term_offsets, const int32_t* doc_ids,
                         const float* impact, const int64_t* impact_order,
                         const float* idf, int64_t n_terms_vocab,
                         const int32_t* q_terms, int64_t b_lo, int64_t b_hi,
                         int64_t T, int64_t max_m, int64_t multi_budget,
                         const uint8_t* doc_mask,
                         const int64_t* pruned_offsets,
                         const int32_t* pruned_doc_ids,
                         const float* pruned_impact,
                         const int32_t* bm_slots, const uint64_t* bm_words,
                         int64_t bm_stride,
                         int32_t* out_ids, float* out_w, int64_t cap,
                         int64_t* out_widths, int64_t* phase_ns) {
  PhaseClock clk(phase_ns);
  std::vector<int32_t> terms;
  std::vector<int32_t> qtf;
  std::vector<std::pair<int32_t, float>> seg;
  std::vector<int32_t> seg_doc;
  std::vector<float> seg_imp;
  std::vector<int32_t> multi_sorted;
  std::vector<Hit> hits;
  std::vector<Hit> hits_tmp;
  std::vector<uint32_t> radix_counts;
  std::vector<double> key_w;
  std::vector<int32_t> run_doc;
  std::vector<float> run_w;
  std::vector<int64_t> run_start;
  std::vector<int64_t> merge_cur;
  std::vector<int64_t> merge_end;
  int64_t max_width = 0;

  for (int64_t b = b_lo; b < b_hi; ++b) {
    const int64_t prof_t0 = clk.now();
    const int32_t* qt = q_terms + b * T;
    terms.clear();
    qtf.clear();
    for (int64_t i = 0; i < T; ++i) {
      int32_t t = qt[i];
      if (t <= 0 || t >= n_terms_vocab) continue;
      bool found = false;
      for (size_t j = 0; j < terms.size(); ++j) {
        if (terms[j] == t) {
          qtf[j]++;
          found = true;
          break;
        }
      }
      if (!found) {
        terms.push_back(t);
        qtf.push_back(1);
      }
    }
    const size_t nt = terms.size();
    multi_sorted.clear();

    // Per-query prune flag, matching the NumPy reference exactly: any term
    // whose df exceeds max_m trips pruning for the whole query. max_m == 0
    // is a LEGAL budget (each term contributes only forced multi-term
    // docs), not a disable switch — the native path is only taken when
    // pruning is requested (ops/bm25.py routes None elsewhere).
    bool prune = false;
    for (size_t j = 0; j < nt; ++j) {
      int64_t df = term_offsets[terms[j] + 1] - term_offsets[terms[j]];
      if (df > max_m) prune = true;
    }
    clk.add(0, prof_t0);

    if (prune && nt > 1 && multi_budget > 0) {
      // Exact top-`multi_budget` docs matching >= 2 distinct query terms,
      // by TRUE score. Two phases (replacing the previous k-way union walk,
      // which paid ~30 cycles/doc on the ~95% of union docs matching only
      // ONE term — measured 0.47 of the 0.51 ms/query planner cost at
      // bench scale):
      //   1. candidate docs = union of all pairwise postings intersections
      //      (cheap: a tight merge / gallop per pair, no scoring, no heap);
      //   2. exact-score ONLY the candidates with per-term galloping
      //      forward cursors (candidates are few: random co-occurrence
      //      makes |intersections| << |union|).
      // Scores accumulate in the SAME order as before (small terms in
      // query-term order, the largest list last) so near-tie selection at
      // the budget boundary is bit-identical to the NumPy reference path.
      size_t big = 0;
      for (size_t j = 1; j < nt; ++j) {
        if (term_offsets[terms[j] + 1] - term_offsets[terms[j]] >
            term_offsets[terms[big] + 1] - term_offsets[terms[big]])
          big = j;
      }
      // accumulation-order keys: query-term order, the largest list last
      // (matching the reference paths); per-key weights idf * qtf
      key_w.assign(nt + 1, 0.0);
      const uint16_t big_key = static_cast<uint16_t>(nt);
      for (size_t j = 0; j < nt; ++j) {
        const uint16_t key =
            (j == big) ? big_key : static_cast<uint16_t>(j);
        key_w[key] = static_cast<double>(idf[terms[j]]) * qtf[j];
      }
      hits.clear();
      const int64_t prof_t1 = clk.now();
      for (size_t i = 0; i + 1 < nt; ++i) {
        const uint16_t ki = (i == big) ? big_key : static_cast<uint16_t>(i);
        for (size_t j = i + 1; j < nt; ++j) {
          const uint16_t kj =
              (j == big) ? big_key : static_cast<uint16_t>(j);
          // ranges + keys ordered smaller-list-first
          int64_t slo = term_offsets[terms[i]], shi = term_offsets[terms[i] + 1];
          int64_t llo = term_offsets[terms[j]], lhi = term_offsets[terms[j] + 1];
          uint16_t ks = ki, kl = kj;
          int32_t t_small = terms[i], t_large = terms[j];
          if (shi - slo > lhi - llo) {
            std::swap(slo, llo);
            std::swap(shi, lhi);
            std::swap(ks, kl);
            std::swap(t_small, t_large);
          }
          const int32_t slot_l =
              (bm_slots != nullptr) ? bm_slots[t_large] : -1;
          const int32_t slot_s =
              (bm_slots != nullptr) ? bm_slots[t_small] : -1;
          if (slot_l >= 0 && slot_s >= 0 && (shi - slo) * 4 >= bm_stride) {
            // both big: constant-cost word AND beats per-element probes
            bitmap_and_intersect(
                doc_ids, slo, shi, llo, lhi,
                bm_words + static_cast<int64_t>(slot_s) * bm_stride,
                bm_words + static_cast<int64_t>(slot_l) * bm_stride,
                bm_stride, ks, kl, hits);
          } else if (slot_l >= 0) {
            bitmap_intersect(doc_ids, slo, shi, llo, lhi,
                             bm_words + static_cast<int64_t>(slot_l) * bm_stride,
                             ks, kl, hits);
          } else {
            intersect_ranges(doc_ids, slo, shi, llo, lhi, ks, kl, hits);
          }
        }
      }
      clk.add(1, prof_t1);
      const int64_t prof_t2 = clk.now();
      if (hits.size() <= 2 * static_cast<size_t>(multi_budget)) {
        // Every multi doc carries >= 2 hits, so n_multi <= hits/2 <=
        // multi_budget: the bounded heap could never overflow and the
        // selection is simply ALL distinct (unmasked) docs — skip the
        // (doc, key) sort and the exact-score accumulation entirely.
        // Measured: most queries at bench scale land here (random
        // co-occurrence keeps |intersections| well under the budget).
        for (const Hit& h : hits)
          if (doc_mask == nullptr || doc_mask[h.doc])
            multi_sorted.push_back(h.doc);
        std::sort(multi_sorted.begin(), multi_sorted.end());
        multi_sorted.erase(
            std::unique(multi_sorted.begin(), multi_sorted.end()),
            multi_sorted.end());
      } else {
        // hits -> per-doc exact scores: group the hits by (doc, key), then
        // accumulate each doc's score in key order with the same-key dedup
        // (the duplicate is the same match rediscovered via another pair,
        // identical pos by postings uniqueness), so scores and tie-breaking
        // are bit-identical to a global (doc, key) sort's. The heap's order
        // is strict, so the docs it keeps do not depend on the order they
        // arrive in.
        clk.count(kMultiQueries, 1);
        clk.count(kMultiHits, static_cast<int64_t>(hits.size()));
        int32_t max_doc = 0;
        for (size_t j = 0; j < nt; ++j) {
          const int64_t lo = term_offsets[terms[j]];
          const int64_t hi = term_offsets[terms[j] + 1];
          if (hi > lo) max_doc = std::max(max_doc, doc_ids[hi - 1]);
        }
        radix_group_hits(hits, hits_tmp, radix_counts,
                         bit_width(static_cast<uint32_t>(max_doc)),
                         bit_width(big_key));
        std::priority_queue<MultiDoc, std::vector<MultiDoc>, WorstFirst>
            heap;
        const size_t n_hits = hits.size();
        for (size_t i = 0; i < n_hits;) {
          const int32_t m = hits[i].doc;
          size_t e = i + 1;
          while (e < n_hits && hits[e].doc == m) ++e;
          // a masked doc can never enter the plan
          if (doc_mask != nullptr && !doc_mask[m]) {
            i = e;
            continue;
          }
          double score = 0.0;
          uint32_t prev_key = UINT32_MAX;
          for (; i < e; ++i) {
            const Hit& h = hits[i];
            if (h.key == prev_key) continue;
            prev_key = h.key;
            score += static_cast<double>(impact[h.pos]) * key_w[h.key];
          }
          MultiDoc md{score, m};
          if (static_cast<int64_t>(heap.size()) < multi_budget) {
            heap.push(md);
          } else {
            const MultiDoc& worst = heap.top();
            if (md.score > worst.score ||
                (md.score == worst.score && md.doc < worst.doc)) {
              heap.pop();
              heap.push(md);
            }
          }
        }
        multi_sorted.reserve(heap.size());
        while (!heap.empty()) {
          multi_sorted.push_back(heap.top().doc);
          heap.pop();
        }
        std::sort(multi_sorted.begin(), multi_sorted.end());
      }
      clk.add(2, prof_t2);
    }

    // Per-term emission into one ASCENDING run per term (run_doc/run_w,
    // boundaries in run_start), then a cursor merge straight into the
    // output row — the row used to be materialised unsorted and
    // std::sort'ed, but it is by construction a concatenation of per-term
    // ascending runs, so the k-way merge is linear and fuses the sort
    // with the output copy (~15% of plan cost at bench scale).
    const int64_t prof_t3 = clk.now();
    run_doc.clear();
    run_w.clear();
    run_start.assign(1, 0);
    for (size_t j = 0; j < nt; ++j) {
      const int32_t t = terms[j];
      const int64_t lo = term_offsets[t], hi = term_offsets[t + 1];
      const float w = idf[t] * static_cast<float>(qtf[j]);
      const int64_t df = hi - lo;
      if (!prune || df <= max_m) {
        for (int64_t p = lo; p < hi; ++p)
          if (doc_mask == nullptr || doc_mask[doc_ids[p]]) {
            run_doc.push_back(doc_ids[p]);
            run_w.push_back(impact[p] * w);
          }
        run_start.push_back(static_cast<int64_t>(run_doc.size()));
        continue;
      }
      // top-M by impact. Fast path: the prebuilt doc-sorted pruned cache
      // (index.pruned_cache — one contiguous (doc, impact) slice per term,
      // same (-impact, doc) top-M selection), a linear copy. Fallback (no
      // cache, or under a mask where the top-M *unmasked* selection
      // differs): walk the impact-order permutation — (order array is
      // (-impact, doc)-sorted per segment, values are GLOBAL posting
      // indices) — never touching the other df - M postings, then doc-sort.
      const int32_t* sdoc;
      const float* simp;
      int64_t scnt;
      if (pruned_offsets != nullptr && doc_mask == nullptr) {
        const int64_t plo = pruned_offsets[t];
        sdoc = pruned_doc_ids + plo;
        simp = pruned_impact + plo;
        scnt = pruned_offsets[t + 1] - plo;
      } else {
        seg.clear();
        if (doc_mask == nullptr) {
          for (int64_t p = 0; p < max_m; ++p) {
            const int64_t idx = impact_order[lo + p];
            seg.emplace_back(doc_ids[idx], impact[idx]);
          }
        } else {
          // under a mask: the first M UNMASKED entries of the impact walk
          for (int64_t p = 0;
               p < df && static_cast<int64_t>(seg.size()) < max_m; ++p) {
            const int64_t idx = impact_order[lo + p];
            if (doc_mask[doc_ids[idx]])
              seg.emplace_back(doc_ids[idx], impact[idx]);
          }
        }
        std::sort(seg.begin(), seg.end(),
                  [](const std::pair<int32_t, float>& x,
                     const std::pair<int32_t, float>& y) {
                    return x.first < y.first;
                  });
        seg_doc.resize(seg.size());
        seg_imp.resize(seg.size());
        for (size_t p = 0; p < seg.size(); ++p) {
          seg_doc[p] = seg[p].first;
          seg_imp[p] = seg[p].second;
        }
        sdoc = seg_doc.data();
        simp = seg_imp.data();
        scnt = static_cast<int64_t>(seg_doc.size());
      }
      // union in the forced multi docs this term also matches: both lists
      // ascending -> ONE merged ascending walk (top-M entries emitted in
      // place, multi-only docs gallop into the full postings); same
      // one-entry-per-(term, doc) multiset as the old two-runs-then-sort
      // emission. multi_sorted is already mask-filtered.
      int64_t a = 0;
      int64_t pcur = lo;
      for (size_t c = 0; c < multi_sorted.size(); ++c) {
        const int32_t d = multi_sorted[c];
        while (a < scnt && sdoc[a] < d) {
          run_doc.push_back(sdoc[a]);
          run_w.push_back(simp[a] * w);
          ++a;
        }
        if (a < scnt && sdoc[a] == d) continue;  // in top-M
        pcur = gallop_lower_bound(doc_ids, pcur, hi, d);
        if (pcur < hi && doc_ids[pcur] == d) {
          run_doc.push_back(d);
          run_w.push_back(impact[pcur] * w);
        }
      }
      for (int64_t p = a; p < scnt; ++p) {
        run_doc.push_back(sdoc[p]);
        run_w.push_back(simp[p] * w);
      }
      run_start.push_back(static_cast<int64_t>(run_doc.size()));
    }

    clk.add(3, prof_t3);
    const int64_t width = static_cast<int64_t>(run_doc.size());
    if (width > cap) return -width;
    max_width = std::max(max_width, width);
    out_widths[b] = width;
    const int64_t prof_t4 = clk.now();
    int32_t* oi = out_ids + b * cap;
    float* ow = out_w + b * cap;
    // cursor merge of the per-term ascending runs into the output row;
    // equal doc ids (a multi doc forced into several terms) may land in
    // any relative order — the device segmented scan reduces by doc, and
    // the NumPy reference's np.sort is equally tie-agnostic.
    const size_t n_runs_total = run_start.size() - 1;
    merge_cur.assign(run_start.begin(), run_start.end() - 1);
    merge_end.assign(run_start.begin() + 1, run_start.end());
    size_t nruns = 0;
    for (size_t r = 0; r < n_runs_total; ++r) {
      if (merge_cur[r] < merge_end[r]) {
        merge_cur[nruns] = merge_cur[r];
        merge_end[nruns] = merge_end[r];
        ++nruns;
      }
    }
    int64_t o = 0;
    while (nruns > 1) {
      size_t best = 0;
      int32_t bd = run_doc[merge_cur[0]];
      for (size_t r = 1; r < nruns; ++r) {
        const int32_t d = run_doc[merge_cur[r]];
        if (d < bd) {
          bd = d;
          best = r;
        }
      }
      oi[o] = bd;
      ow[o] = run_w[merge_cur[best]];
      ++o;
      if (++merge_cur[best] >= merge_end[best]) {
        merge_cur[best] = merge_cur[nruns - 1];
        merge_end[best] = merge_end[nruns - 1];
        --nruns;
      }
    }
    if (nruns == 1) {
      for (int64_t p = merge_cur[0]; p < merge_end[0]; ++p, ++o) {
        oi[o] = run_doc[p];
        ow[o] = run_w[p];
      }
    }
    clk.add(4, prof_t4);
  }
  return max_width;
}

}  // namespace

extern "C" {

// Returns the max row width written, or -(needed_width) if any row exceeds
// `cap` (caller re-allocates and retries). All outputs caller-allocated:
// out_ids/out_w are (B, cap) row-major, out_widths is (B,). Parallel over
// queries with `n_threads` (0 = hardware concurrency); rows are disjoint so
// workers share nothing but read-only index arrays. `doc_mask` (nullable,
// n_docs bytes) builds the filtered plan — see plan_build_range.
// `phase_ns` (nullable, 7 slots) receives, added to what it holds, each
// phase's nanoseconds and the two counts summed over the worker threads
// (see PhaseClock).
int64_t plan_build_masked(const int64_t* term_offsets, const int32_t* doc_ids,
                          const float* impact, const int64_t* impact_order,
                          const float* idf, int64_t n_terms_vocab,
                          const int32_t* q_terms, int64_t B, int64_t T,
                          int64_t max_m, int64_t multi_budget,
                          const uint8_t* doc_mask,
                          const int64_t* pruned_offsets,
                          const int32_t* pruned_doc_ids,
                          const float* pruned_impact,
                          const int32_t* bm_slots, const uint64_t* bm_words,
                          int64_t bm_stride,
                          int32_t* out_ids, float* out_w, int64_t cap,
                          int64_t* out_widths, int64_t n_threads,
                          int64_t* phase_ns) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min(n_threads, std::max<int64_t>(B, 1));
  if (n_threads == 1) {
    return plan_build_range(term_offsets, doc_ids, impact, impact_order, idf,
                            n_terms_vocab, q_terms, 0, B, T, max_m,
                            multi_budget, doc_mask, pruned_offsets,
                            pruned_doc_ids, pruned_impact, bm_slots, bm_words,
                            bm_stride, out_ids, out_w, cap, out_widths,
                            phase_ns);
  }
  std::vector<int64_t> results(n_threads, 0);
  // one row of phase slots a worker, summed into phase_ns after the join
  std::vector<int64_t> slots(phase_ns != nullptr ? n_threads * kSlots : 0, 0);
  std::vector<std::thread> workers;
  const int64_t chunk = (B + n_threads - 1) / n_threads;
  for (int64_t w = 0; w < n_threads; ++w) {
    const int64_t lo = w * chunk, hi = std::min(B, lo + chunk);
    if (lo >= hi) break;
    int64_t* mine = phase_ns != nullptr ? slots.data() + w * kSlots : nullptr;
    workers.emplace_back([=, &results]() {
      results[w] = plan_build_range(term_offsets, doc_ids, impact,
                                    impact_order, idf, n_terms_vocab, q_terms,
                                    lo, hi, T, max_m, multi_budget, doc_mask,
                                    pruned_offsets, pruned_doc_ids,
                                    pruned_impact, bm_slots, bm_words,
                                    bm_stride, out_ids, out_w, cap,
                                    out_widths, mine);
    });
  }
  for (auto& t : workers) t.join();
  for (size_t i = 0; i < slots.size(); ++i) phase_ns[i % kSlots] += slots[i];
  int64_t max_width = 0;
  for (int64_t r : results) {
    if (r < 0) return r;  // some row overflowed cap
    max_width = std::max(max_width, r);
  }
  return max_width;
}

// Unfiltered entry (kept for .so compatibility with older bindings).
int64_t plan_build(const int64_t* term_offsets, const int32_t* doc_ids,
                   const float* impact, const int64_t* impact_order,
                   const float* idf, int64_t n_terms_vocab,
                   const int32_t* q_terms, int64_t B, int64_t T,
                   int64_t max_m, int64_t multi_budget,
                   int32_t* out_ids, float* out_w, int64_t cap,
                   int64_t* out_widths, int64_t n_threads) {
  return plan_build_masked(term_offsets, doc_ids, impact, impact_order, idf,
                           n_terms_vocab, q_terms, B, T, max_m, multi_budget,
                           nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, 0, out_ids, out_w, cap, out_widths,
                           n_threads, nullptr);
}

// Source-hash stamp: build() passes -DOPENINTEL_SRC_HASH="<sha256 of the
// .cpp sources>"; the Python loader compares it against a fresh hash of
// the on-disk sources and degrades to the Python path on mismatch, so a
// stale .so can never silently serve older planner semantics.
const char* openintel_src_hash() {
#ifdef OPENINTEL_SRC_HASH
  return OPENINTEL_SRC_HASH;
#else
  return "";
#endif
}

}  // extern "C"




