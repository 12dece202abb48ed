// Native host-side caption-metric kernels: the port's own copy of the
// ROUGE-L and BLEU parts of ekaid_tpu/native/caption.cpp, and CIDEr-D,
// for the inner loops of ekaid_torch/metrics/caption.py (~70K test
// answers x up to 91 tokens):
//
//   * lcs_len        - ROUGE-L's O(T^2) dynamic program.
//   * bleu_counts    - clipped n-gram match/total counts per segment
//                      (counting via sorted vectors, no hashing).
//   * cider          - CIDEr-D: document frequency over the references,
//                      each side's tf-idf vector of every order, the
//                      clipped dot product and the Gaussian length
//                      penalty.
//
// Tokens arrive as int32 ids >= 0, numbered once for the whole corpus
// (Python owns the string->id mapping), a whole eval in one call of each
// *_batch entry point; an n-gram is keyed by its ids + 1 in 32 bits
// apiece, so n <= 4 and keys of different orders differ. Unit tests
// hold them to the Python implementations. METEOR's alignment stays in
// Python: the search is cheap beside the per-word stem and synonym
// lookups that feed it, so a native copy was no faster.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

using Key = unsigned __int128;

// Collect sorted packed n-grams of order n from ids[0..len).
void ngrams(const int32_t* ids, int64_t len, int n, std::vector<Key>* out) {
  out->clear();
  for (int64_t i = 0; i + n <= len; ++i) {
    Key key = 0;
    for (int j = 0; j < n; ++j)
      key = (key << 32) | (static_cast<uint32_t>(ids[i + j]) + 1u);
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
  std::vector<Key> cg, rg;
  for (int n = 1; n <= max_n; ++n) {
    ngrams(cand, nc, n, &cg);
    out_totals[n - 1] = static_cast<int64_t>(cg.size());
    // gather distinct candidate n-grams + their counts
    std::vector<Key> dv;
    std::vector<int64_t> dc;
    for (size_t i = 0; i < cg.size();) {
      size_t j = i;
      while (j < cg.size() && cg[j] == cg[i]) ++j;
      dv.push_back(cg[i]);
      dc.push_back(static_cast<int64_t>(j - i));
      i = j;
    }
    // max reference count per n-gram ("clip" numerator)
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

// One order's tf-idf vector: distinct n-grams by key, their weights
// (count x idf) and the vector's norm.
struct TfIdf {
  std::vector<Key> keys;
  std::vector<double> vals;
  double norm = 0.0;
};

// Document frequency: in how many images' references each n-gram
// occurs, as sorted keys and their counts.
class DocFreq {
 public:
  void add(std::vector<Key>* image_grams) {
    std::sort(image_grams->begin(), image_grams->end());
    image_grams->erase(
        std::unique(image_grams->begin(), image_grams->end()),
        image_grams->end());
    all_.insert(all_.end(), image_grams->begin(), image_grams->end());
  }

  void finish(int64_t n_docs) {
    std::sort(all_.begin(), all_.end());
    for (size_t i = 0; i < all_.size();) {
      size_t j = i;
      while (j < all_.size() && all_[j] == all_[i]) ++j;
      keys_.push_back(all_[i]);
      counts_.push_back(static_cast<double>(j - i));
      i = j;
    }
    all_ = std::vector<Key>();
    log_docs_ = std::log(static_cast<double>(std::max<int64_t>(n_docs, 1)));
  }

  double idf(Key key) const {
    auto it = std::lower_bound(keys_.begin(), keys_.end(), key);
    double df = it != keys_.end() && *it == key ? counts_[it - keys_.begin()]
                                                : 0.0;
    return log_docs_ - std::log(std::max(1.0, df));
  }

 private:
  std::vector<Key> all_, keys_;
  std::vector<double> counts_;
  double log_docs_ = 0.0;
};

void tf_idf(const int32_t* ids, int64_t len, int n, const DocFreq& df,
            std::vector<Key>* grams, TfIdf* out) {
  ngrams(ids, len, n, grams);
  out->keys.clear();
  out->vals.clear();
  double sq = 0.0;
  for (size_t i = 0; i < grams->size();) {
    size_t j = i;
    while (j < grams->size() && (*grams)[j] == (*grams)[i]) ++j;
    const double v = static_cast<double>(j - i) * df.idf((*grams)[i]);
    out->keys.push_back((*grams)[i]);
    out->vals.push_back(v);
    sq += v * v;
    i = j;
  }
  out->norm = std::sqrt(sq);
}

// CIDEr-D's clipped product: sum over the reference's n-grams of
// min(hyp, ref) x ref, the hypothesis' weight 0 where it lacks one.
double clipped_dot(const TfIdf& hyp, const TfIdf& ref) {
  double val = 0.0;
  size_t h = 0;
  for (size_t i = 0; i < ref.keys.size(); ++i) {
    while (h < hyp.keys.size() && hyp.keys[h] < ref.keys[i]) ++h;
    const double hv = h < hyp.keys.size() && hyp.keys[h] == ref.keys[i]
                          ? hyp.vals[h] : 0.0;
    val += std::min(hv, ref.vals[i]) * ref.vals[i];
  }
  return val;
}

}  // namespace

// The entry points take a whole eval in one call. Token lists arrive
// flattened: list k is ids[off[k] .. off[k + 1]). Segment s is lists
// seg[s] .. seg[s + 1] - 1: its candidate, then its references.
extern "C" {

// segment s < n_seg: the LCS length of its candidate with each of its
// references, reference list k at out[k - s - 1].
void lcs_len_batch(const int32_t* ids, const int64_t* off,
                   const int64_t* seg, int64_t n_seg, int64_t* out) {
  for (int64_t s = 0; s < n_seg; ++s) {
    const int64_t c = seg[s];
    for (int64_t k = c + 1; k < seg[s + 1]; ++k)
      out[k - s - 1] = lcs_len(ids + off[k], off[k + 1] - off[k],
                               ids + off[c], off[c + 1] - off[c]);
  }
}

// segment s < n_seg: out_matches/out_totals [n_seg, max_n].
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

// CIDEr-D of the candidates of segments 0 .. n_scored - 1 into
// out[n_scored]: the references of all n_seg segments are the corpus
// whose document frequency and size (n_seg images) give the idf.
// Orders 1 .. max_n, Gaussian length penalty of width sigma, x10.
void cider_batch(const int32_t* ids, const int64_t* off, const int64_t* seg,
                 int64_t n_seg, int64_t n_scored, int64_t max_n,
                 double sigma, double* out) {
  DocFreq df;
  std::vector<Key> grams, image_grams;
  for (int64_t s = 0; s < n_seg; ++s) {
    image_grams.clear();
    for (int64_t k = seg[s] + 1; k < seg[s + 1]; ++k)
      for (int n = 1; n <= max_n; ++n) {
        ngrams(ids + off[k], off[k + 1] - off[k], n, &grams);
        image_grams.insert(image_grams.end(), grams.begin(), grams.end());
      }
    df.add(&image_grams);
  }
  df.finish(n_seg);

  std::vector<TfIdf> hyp(max_n);
  TfIdf ref;
  for (int64_t s = 0; s < n_scored; ++s) {
    const int64_t c = seg[s], hl = off[c + 1] - off[c];
    for (int n = 0; n < max_n; ++n)
      tf_idf(ids + off[c], hl, n + 1, df, &grams, &hyp[n]);
    double total = 0.0;
    for (int64_t k = c + 1; k < seg[s + 1]; ++k) {
      const int64_t rl = off[k + 1] - off[k];
      const double delta = static_cast<double>(hl - rl);
      const double penalty =
          std::exp(-(delta * delta) / (2 * (sigma * sigma)));
      double sim = 0.0;
      for (int n = 0; n < max_n; ++n) {
        tf_idf(ids + off[k], rl, n + 1, df, &grams, &ref);
        double val = clipped_dot(hyp[n], ref);
        if (hyp[n].norm != 0.0 && ref.norm != 0.0)
          val /= hyp[n].norm * ref.norm;
        sim += val * penalty;
      }
      total += sim / static_cast<double>(max_n);
    }
    const int64_t n_refs = seg[s + 1] - c - 1;
    out[s] = 10.0 * total / static_cast<double>(std::max<int64_t>(n_refs, 1));
  }
}

}  // extern "C"
