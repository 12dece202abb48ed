// Native host-side caption-metric kernels: the port's own copy of the
// ROUGE-L and BLEU parts of ekaid_tpu/native/caption.cpp, for the inner
// loops of ekaid_torch/metrics/caption.py (~70K test answers x up to 91
// tokens):
//
//   * lcs_len        - ROUGE-L's O(T^2) dynamic program.
//   * bleu_counts    - clipped n-gram match/total counts per segment
//                      (n-grams packed into 64-bit keys, vocab < 2^16;
//                      counting via sorted vectors, no hashing).
//
// Tokens arrive as int32 ids (Python owns the string->id mapping, ids
// local to a segment), a whole eval in one call of each *_batch entry
// point; unit tests hold them to the Python implementations. METEOR's
// alignment stays in Python: the search is cheap beside the per-word
// stem and synonym lookups that feed it, so a native copy was no
// faster.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// Collect sorted packed n-grams of order n from ids[0..len).
void ngrams(const int32_t* ids, int64_t len, int n,
            std::vector<uint64_t>* out) {
  out->clear();
  if (len < n) return;
  for (int64_t i = 0; i + n <= len; ++i) {
    uint64_t key = 0;
    for (int j = 0; j < n; ++j)
      key = (key << 16) | static_cast<uint64_t>(ids[i + j] & 0xffff);
    out->push_back(key);
  }
  std::sort(out->begin(), out->end());
}

int64_t lcs_len(const int32_t* a, int64_t na, const int32_t* b,
                int64_t nb) {
  if (na == 0 || nb == 0) return 0;
  std::vector<int64_t> prev(nb + 1, 0), cur(nb + 1, 0);
  for (int64_t i = 1; i <= na; ++i) {
    for (int64_t j = 1; j <= nb; ++j) {
      if (a[i - 1] == b[j - 1])
        cur[j] = prev[j - 1] + 1;
      else
        cur[j] = prev[j] > cur[j - 1] ? prev[j] : cur[j - 1];
    }
    std::swap(prev, cur);
  }
  return prev[nb];
}

// Clipped BLEU counts for one candidate against nrefs references.
// refs_flat: concatenated reference ids; ref_lens[nrefs].
// out_matches/out_totals: [max_n] each.
void bleu_counts(const int32_t* cand, int64_t nc,
                 const int32_t* refs_flat, const int64_t* ref_lens,
                 int64_t nrefs, int64_t max_n, int64_t* out_matches,
                 int64_t* out_totals) {
  std::vector<uint64_t> cg, rg, best;
  for (int n = 1; n <= max_n; ++n) {
    ngrams(cand, nc, n, &cg);
    out_totals[n - 1] = static_cast<int64_t>(cg.size());
    // max reference count per n-gram ("clip" numerator)
    best.clear();  // parallel to runs of cg
    std::vector<int64_t> best_cnt;
    // gather distinct candidate n-grams + their counts
    std::vector<uint64_t> dv;
    std::vector<int64_t> dc;
    for (size_t i = 0; i < cg.size();) {
      size_t j = i;
      while (j < cg.size() && cg[j] == cg[i]) ++j;
      dv.push_back(cg[i]);
      dc.push_back(static_cast<int64_t>(j - i));
      i = j;
    }
    std::vector<int64_t> maxref(dv.size(), 0);
    const int32_t* rp = refs_flat;
    for (int64_t r = 0; r < nrefs; ++r) {
      ngrams(rp, ref_lens[r], n, &rg);
      rp += ref_lens[r];
      // count occurrences of each dv entry in rg (both sorted)
      size_t gi = 0;
      for (size_t i = 0; i < dv.size(); ++i) {
        while (gi < rg.size() && rg[gi] < dv[i]) ++gi;
        size_t gj = gi;
        while (gj < rg.size() && rg[gj] == dv[i]) ++gj;
        int64_t cnt = static_cast<int64_t>(gj - gi);
        if (cnt > maxref[i]) maxref[i] = cnt;
        gi = gj;
      }
    }
    int64_t m = 0;
    for (size_t i = 0; i < dv.size(); ++i)
      m += dc[i] < maxref[i] ? dc[i] : maxref[i];
    out_matches[n - 1] = m;
  }
}

}  // namespace

// The entry points take a whole eval in one call. Token lists arrive
// flattened: list k is ids[off[k] .. off[k + 1]).
extern "C" {

// pair p: the LCS length of lists 2p and 2p + 1.
void lcs_len_batch(const int32_t* ids, const int64_t* off, int64_t n_pairs,
                   int64_t* out) {
  for (int64_t p = 0; p < n_pairs; ++p) {
    const int64_t* o = off + 2 * p;
    out[p] = lcs_len(ids + o[0], o[1] - o[0], ids + o[1], o[2] - o[1]);
  }
}

// segment s: the candidate is list seg[s], its references the lists
// seg[s] + 1 .. seg[s + 1] - 1. out_matches/out_totals: [n_seg, max_n].
void bleu_counts_batch(const int32_t* ids, const int64_t* off,
                       const int64_t* seg, int64_t n_seg, int64_t max_n,
                       int64_t* out_matches, int64_t* out_totals) {
  std::vector<int64_t> ref_lens;
  for (int64_t s = 0; s < n_seg; ++s) {
    const int64_t c = seg[s];
    ref_lens.clear();
    for (int64_t k = c + 1; k < seg[s + 1]; ++k)
      ref_lens.push_back(off[k + 1] - off[k]);
    bleu_counts(ids + off[c], off[c + 1] - off[c], ids + off[c + 1],
                ref_lens.data(), static_cast<int64_t>(ref_lens.size()),
                max_n, out_matches + s * max_n, out_totals + s * max_n);
  }
}

}  // extern "C"
