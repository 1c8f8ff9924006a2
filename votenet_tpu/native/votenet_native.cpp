// Native host-side kernels for votenet_tpu.
//
// The reference implements its host-side math as TF C++ CPU kernels
// (tf_ops/3d_nms/tf_nms3d.cpp) and leans on shapely/numpy loops for eval
// (evaluator.py:26-161) and np.loadtxt for depth files (sunutils.py:178-180).
// This library provides the framework's native equivalents, exposed
// through a plain C ABI consumed via ctypes (no pybind11 in the image):
//
//   vn_parse_floats   - fast whitespace-float parser (depth .txt loader)
//   vn_iou3d_matrix   - exact oriented 3D IoU (Sutherland-Hodgman clip)
//   vn_greedy_match   - VOC detection matching (eval_det_cls inner loop)
//   vn_nms3d          - greedy oriented NMS keep-mask (host twin of the
//                       device op in votenet_tpu/ops/nms3d.py)
//
// Build: make -C votenet_tpu/native  (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

namespace {

struct P2 {
  double x, z;
};

inline double signed_area(const P2* poly, int n) {
  double a = 0.0;
  for (int i = 0; i < n; ++i) {
    const P2& p = poly[i];
    const P2& q = poly[(i + 1) % n];
    a += p.x * q.z - q.x * p.z;
  }
  return 0.5 * a;
}

// Sutherland-Hodgman: clip `subject` by convex `clip` (any winding).
// Returns |area| of the intersection.
double convex_clip_area(const P2* subject_in, int ns, const P2* clip_in, int nc) {
  P2 clip[16];
  if (signed_area(clip_in, nc) < 0) {
    for (int i = 0; i < nc; ++i) clip[i] = clip_in[nc - 1 - i];
  } else {
    std::memcpy(clip, clip_in, sizeof(P2) * nc);
  }
  P2 bufa[32], bufb[32];
  P2* cur = bufa;
  P2* nxt = bufb;
  int n = ns;
  std::memcpy(cur, subject_in, sizeof(P2) * ns);
  for (int e = 0; e < nc; ++e) {
    if (n == 0) return 0.0;
    const P2 a = clip[e];
    const P2 b = clip[(e + 1) % nc];
    const double ex = b.x - a.x, ez = b.z - a.z;
    int m = 0;
    for (int i = 0; i < n; ++i) {
      const P2 p = cur[i];
      const P2 q = cur[(i + 1) % n];
      const bool pin = ex * (p.z - a.z) - ez * (p.x - a.x) >= 0;
      const bool qin = ex * (q.z - a.z) - ez * (q.x - a.x) >= 0;
      if (pin) nxt[m++] = p;
      if (pin != qin) {
        const double dx = q.x - p.x, dz = q.z - p.z;
        const double denom = ex * dz - ez * dx;
        if (denom != 0.0) {
          const double t = (ex * (a.z - p.z) - ez * (a.x - p.x)) / denom;
          nxt[m++] = {p.x + t * dx, p.z + t * dz};
        }
      }
    }
    std::swap(cur, nxt);
    n = m;
  }
  if (n < 3) return 0.0;
  return std::fabs(signed_area(cur, n));
}

// corners: (8,3) row-major floats, reference layout (top face = rows 0-3,
// y extent rows 0 vs 4). Computes the same IoU as evaluator.py:26-39.
double iou3d_one(const float* b1, const float* b2) {
  P2 q1[4], q2[4];
  for (int i = 0; i < 4; ++i) {
    q1[i] = {b1[i * 3 + 0], b1[i * 3 + 2]};
    q2[i] = {b2[i * 3 + 0], b2[i * 3 + 2]};
  }
  const double a1 = std::fabs(signed_area(q1, 4));
  const double a2 = std::fabs(signed_area(q2, 4));
  const double y1t = b1[0 * 3 + 1], y1b = b1[4 * 3 + 1];
  const double y2t = b2[0 * 3 + 1], y2b = b2[4 * 3 + 1];
  const double inter_area = convex_clip_area(q1, 4, q2, 4);
  const double y_ov = std::max(0.0, std::min(y1t, y2t) - std::max(y1b, y2b));
  const double inter_vol = inter_area * y_ov;
  const double uni = a1 * (y1t - y1b) + a2 * (y2t - y2b) - inter_vol;
  return uni > 0.0 ? inter_vol / uni : 0.0;
}

}  // namespace

extern "C" {

// Parse whitespace-separated floats from `text` (len bytes) into out.
// Returns the number of floats written (caller sizes `out` generously).
int64_t vn_parse_floats(const char* text, int64_t len, double* out, int64_t cap) {
  const char* p = text;
  const char* end = text + len;
  int64_t n = 0;
  while (p < end && n < cap) {
    char* q;
    double v = strtod(p, &q);
    if (q == p) {
      ++p;
      continue;
    }
    out[n++] = v;
    p = q;
  }
  return n;
}

// dets: (nd, 8, 3), gts: (ng, 8, 3) float32; out: (nd, ng) float32.
void vn_iou3d_matrix(const float* dets, int64_t nd, const float* gts, int64_t ng,
                     float* out) {
  for (int64_t i = 0; i < nd; ++i)
    for (int64_t j = 0; j < ng; ++j)
      out[i * ng + j] = static_cast<float>(iou3d_one(dets + i * 24, gts + j * 24));
}

// VOC greedy matching for one image (the evaluator.py:125-149 inner loop):
// iou (nd, ng) with detections already sorted by descending confidence.
// Writes tp/fp (nd) as 0/1 bytes. Threshold is strict (> ovthresh).
void vn_greedy_match(const float* iou, int64_t nd, int64_t ng, float ovthresh,
                     uint8_t* tp, uint8_t* fp) {
  std::vector<uint8_t> used(ng, 0);
  for (int64_t d = 0; d < nd; ++d) {
    double ovmax = -1.0;
    int64_t jmax = -1;
    for (int64_t j = 0; j < ng; ++j) {
      const double v = iou[d * ng + j];
      if (v > ovmax) {
        ovmax = v;
        jmax = j;
      }
    }
    if (jmax >= 0 && ovmax > ovthresh && !used[jmax]) {
      tp[d] = 1;
      fp[d] = 0;
      used[jmax] = 1;
    } else {
      tp[d] = 0;
      fp[d] = 1;
    }
  }
}

// Greedy oriented 3D NMS for one batch element (host twin of the device op;
// same rules as tf_nms3d.cpp:202-264): candidates where obj1 > obj0,
// descending score order, suppress when IoU strictly exceeds the threshold.
// corners (n, 8, 3); scores (n); obj (n, 2); keep (n) 0/1 out.
void vn_nms3d(const float* corners, const float* scores, const float* obj,
              int64_t n, float iou_threshold, uint8_t* keep) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return scores[a] > scores[b]; });
  std::vector<int64_t> selected;
  std::memset(keep, 0, n);
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (!(obj[i * 2 + 1] > obj[i * 2 + 0])) continue;
    bool ok = true;
    for (int64_t j : selected) {
      if (iou3d_one(corners + i * 24, corners + j * 24) > iou_threshold) {
        ok = false;
        break;
      }
    }
    if (ok) {
      selected.push_back(i);
      keep[i] = 1;
    }
  }
}

}  // extern "C"
