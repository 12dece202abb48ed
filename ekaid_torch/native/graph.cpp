// Native host-side graph construction for the extraction pipeline: the
// port's own copy of ekaid_tpu/native/graph.cpp.
//
// The reference builds its spatial adjacency with a per-pair Python loop
// (O(52^2) per image, "feature extraction/ana_bbox_generator.py":320-335).
// This library is the C++ path on the host (ctypes-loaded by
// ekaid_torch/native/bindings.py; the numpy version stays as the plain
// version).
//
// Semantics mirror ekaid_torch/ops/graph.py (label priority contains >
// inside > iou >= 0.5 > disconnected > 8 angular sectors; +1-pixel IoU
// convention; lower triangle from the reversal table). Unit tests
// cross-check it against the numpy implementation.
//
// match_disease is the greedy disease-to-anatomy re-anchoring of
// ekaid_torch/extract/pipeline.py::match_disease_to_anatomy (the holder
// steal rule included); exact_match compares 0-terminated token rows.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

const int kReverse[12] = {0, 2, 1, 3, 8, 9, 10, 11, 4, 5, 6, 7};

inline double iou_plus_one(const float* a, const float* b) {
  double ixmin = a[0] > b[0] ? a[0] : b[0];
  double ixmax = a[2] < b[2] ? a[2] : b[2];
  double iymin = a[1] > b[1] ? a[1] : b[1];
  double iymax = a[3] < b[3] ? a[3] : b[3];
  double iw = ixmax - ixmin + 1.0;
  double ih = iymax - iymin + 1.0;
  if (iw < 0) iw = 0;
  if (ih < 0) ih = 0;
  double inter = iw * ih;
  double uni = (a[2] - a[0] + 1.0) * (a[3] - a[1] + 1.0) +
               (b[2] - b[0] + 1.0) * (b[3] - b[1] + 1.0) - inter;
  return uni > 0 ? inter / uni : 0.0;
}

inline int relation_type(const float* a, const float* b, double lx,
                         double ly) {
  if (a[0] < b[0] && a[1] < b[1] && a[2] > b[2] && a[3] > b[3]) return 1;
  if (a[0] > b[0] && a[1] > b[1] && a[2] < b[2] && a[3] < b[3]) return 2;
  if (iou_plus_one(a, b) >= 0.5) return 3;
  double cax = (a[0] + a[2]) * 0.5, cay = (a[1] + a[3]) * 0.5;
  double cbx = (b[0] + b[2]) * 0.5, cby = (b[1] + b[3]) * 0.5;
  double dx = cbx - cax, dy = cby - cay;
  if (std::sqrt(dx * dx + dy * dy) >= (lx + ly) / 3.0) return 0;
  double ang = std::atan2(dy, dx) / M_PI * 180.0;
  if (ang < 0) ang += 360.0;
  int sector = static_cast<int>(std::ceil(ang / 45.0)) + 3;
  if (sector < 4) sector = 4;
  if (sector > 11) sector = 11;
  return sector;
}

}  // namespace

extern "C" {

// boxes: [n_imgs, n_boxes, 4] float32; out: [n_imgs, pad, pad] int32
// (zero-initialized by the caller). Upper triangle including the
// diagonal gets relation_type(b_i, b_j); the lower triangle the
// reversal of the mirrored entry (get_adj_matrix write pattern).
void spatial_adjacency_batch(const float* boxes, int64_t n_imgs,
                             int64_t n_boxes, int64_t pad, float img_w,
                             float img_h, int32_t* out) {
  for (int64_t im = 0; im < n_imgs; ++im) {
    const float* bb = boxes + im * n_boxes * 4;
    int32_t* adj = out + im * pad * pad;
    for (int64_t i = 0; i < n_boxes; ++i) {
      for (int64_t j = i; j < n_boxes; ++j) {
        int t = relation_type(bb + i * 4, bb + j * 4, img_w, img_h);
        adj[i * pad + j] = t;
        adj[j * pad + i] = kReverse[t];
      }
    }
  }
}

// dis_boxes [n_dis, 4], dis_valid [n_dis], ana_boxes [n_ana, 4];
// out_assign [n_ana]: the disease index each anatomy box takes, -1 when
// none. Diseases in order; anatomy box j goes to the first disease whose
// IoU beats its best so far, and later to a better one only while its
// holder keeps another box.
void match_disease(const float* dis_boxes, const uint8_t* dis_valid,
                   int64_t n_dis, const float* ana_boxes, int64_t n_ana,
                   int32_t* out_assign) {
  std::vector<double> best_iou(n_ana, 0.0);
  std::vector<int32_t> holder(n_ana, -1);
  std::vector<int32_t> hold_count(n_dis, 0);
  for (int64_t i = 0; i < n_dis; ++i) {
    if (!dis_valid[i]) continue;
    for (int64_t j = 0; j < n_ana; ++j) {
      double iou = iou_plus_one(dis_boxes + i * 4, ana_boxes + j * 4);
      if (!(iou > best_iou[j])) continue;
      if (holder[j] < 0) {
        hold_count[i] += 1;
      } else if (hold_count[holder[j]] > 1) {
        hold_count[holder[j]] -= 1;
        hold_count[i] += 1;
      } else {
        continue;
      }
      best_iou[j] = iou;
      holder[j] = static_cast<int32_t>(i);
    }
  }
  for (int64_t j = 0; j < n_ana; ++j) out_assign[j] = holder[j];
}

// seq, gt [n, t] int32, 0-terminated; out[i] = 1 when row i of seq
// equals row i of gt up to and including the first 0 (or over all t).
void exact_match(const int32_t* seq, const int32_t* gt, int64_t n,
                 int64_t t, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* s = seq + i * t;
    const int32_t* g = gt + i * t;
    uint8_t ok = 1;
    for (int64_t j = 0; j < t; ++j) {
      if (s[j] != g[j]) {
        ok = 0;
        break;
      }
      if (s[j] == 0) break;
    }
    out[i] = ok;
  }
}

}  // extern "C"
