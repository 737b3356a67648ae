// Rotated BEV IoU + greedy NMS (native host-side kernel; a copy of the
// repo's csrc/nms_rotated.cpp).
//
// Replaces the reference's iou3d CUDA extension
// (third_party/bev_mmdet3d/ops/iou3d/src — boxes_iou_bev / nms_gpu): the box
// counts after top-k (<=500) make this a host problem, so the
// polygon-clipping IoU runs as native code.  Bound with ctypes by the port's
// native.py, which builds it with g++ at first use and raises if it cannot.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

// corners of (cx, cy, w, l, yaw), counter-clockwise
void box_corners(const float* b, Pt out[4]) {
  const double cx = b[0], cy = b[1], w = b[2], l = b[3], yaw = b[4];
  const double c = std::cos(yaw), s = std::sin(yaw);
  const double dx[4] = {w / 2, -w / 2, -w / 2, w / 2};
  const double dy[4] = {l / 2, l / 2, -l / 2, -l / 2};
  for (int i = 0; i < 4; i++) {
    out[i].x = cx + c * dx[i] - s * dy[i];
    out[i].y = cy + s * dx[i] + c * dy[i];
  }
}

double polygon_area(const Pt* p, int n) {
  double a = 0;
  for (int i = 0; i < n; i++) {
    int j = (i + 1) % n;
    a += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return std::fabs(a) * 0.5;
}

// Sutherland–Hodgman clip of subject polygon by convex CCW clip polygon
int clip_polygon(const Pt* subject, int n_subj, const Pt clip[4], Pt* out) {
  Pt buf[16];
  int n = n_subj;
  std::memcpy(out, subject, sizeof(Pt) * n_subj);
  for (int e = 0; e < 4 && n > 0; e++) {
    const Pt a = clip[e], b = clip[(e + 1) % 4];
    const double ex = b.x - a.x, ey = b.y - a.y;
    int m = 0;
    for (int i = 0; i < n; i++) {
      const Pt cur = out[i], nxt = out[(i + 1) % n];
      const bool cin = ex * (cur.y - a.y) - ey * (cur.x - a.x) >= 0;
      const bool nin = ex * (nxt.y - a.y) - ey * (nxt.x - a.x) >= 0;
      if (cin) buf[m++] = cur;
      if (cin != nin) {
        const double dx = nxt.x - cur.x, dy = nxt.y - cur.y;
        const double denom = ex * dy - ey * dx;
        if (std::fabs(denom) > 1e-12) {
          const double t = (ex * (a.y - cur.y) - ey * (a.x - cur.x)) / denom;
          buf[m].x = cur.x + t * dx;
          buf[m].y = cur.y + t * dy;
          m++;
        }
      }
    }
    std::memcpy(out, buf, sizeof(Pt) * m);
    n = m;
  }
  return n;
}

double rotated_iou(const float* a, const float* b) {
  Pt pa[4], pb[4], inter[16];
  box_corners(a, pa);
  box_corners(b, pb);
  const int n = clip_polygon(pa, 4, pb, inter);
  const double ia = n >= 3 ? polygon_area(inter, n) : 0.0;
  const double ua = (double)a[2] * a[3] + (double)b[2] * b[3] - ia;
  return ua > 1e-12 ? ia / ua : 0.0;
}

}  // namespace

extern "C" {

// boxes: [n, 5] (cx, cy, w, l, yaw) float32, order: caller-sorted by score
// descending. keep_out: [n] int64 buffer; returns number kept.
int64_t nms_rotated(const float* boxes, int64_t n, float iou_threshold,
                    int64_t* keep_out) {
  std::vector<uint8_t> suppressed(n, 0);
  int64_t n_keep = 0;
  for (int64_t i = 0; i < n; i++) {
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    const float* bi = boxes + i * 5;
    const double ri =
        0.5 * (std::max(bi[2], bi[3]));
    for (int64_t j = i + 1; j < n; j++) {
      if (suppressed[j]) continue;
      const float* bj = boxes + j * 5;
      // cheap reject: centers farther than the sum of circumradii
      const double dx = bi[0] - bj[0], dy = bi[1] - bj[1];
      const double rj = 0.5 * std::max(bj[2], bj[3]);
      if (dx * dx + dy * dy > (ri + rj) * (ri + rj) * 2.0) continue;
      if (rotated_iou(bi, bj) > iou_threshold) suppressed[j] = 1;
    }
  }
  return n_keep;
}

// pairwise IoU matrix [n, m] for boxes5 arrays
void rotated_iou_matrix(const float* a, int64_t n, const float* b, int64_t m,
                        float* out) {
  for (int64_t i = 0; i < n; i++)
    for (int64_t j = 0; j < m; j++)
      out[i * m + j] = (float)rotated_iou(a + i * 5, b + j * 5);
}

// Axis-aligned greedy NMS (the 2D family's multiclass_nms hot loop —
// mmdet nms replacement).  boxes: [n, 4] xyxy float32, caller-sorted by
// score descending.  keep_out: [n] int64 buffer; returns number kept.
int64_t nms_2d(const float* boxes, int64_t n, float iou_threshold,
               int64_t* keep_out) {
  std::vector<uint8_t> suppressed(n, 0);
  std::vector<float> area(n);
  for (int64_t i = 0; i < n; i++) {
    const float* b = boxes + i * 4;
    area[i] = std::max(b[2] - b[0], 0.0f) * std::max(b[3] - b[1], 0.0f);
  }
  int64_t n_keep = 0;
  for (int64_t i = 0; i < n; i++) {
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    const float* bi = boxes + i * 4;
    for (int64_t j = i + 1; j < n; j++) {
      if (suppressed[j]) continue;
      const float* bj = boxes + j * 4;
      const float xx1 = std::max(bi[0], bj[0]);
      const float yy1 = std::max(bi[1], bj[1]);
      const float xx2 = std::min(bi[2], bj[2]);
      const float yy2 = std::min(bi[3], bj[3]);
      const float iw = xx2 - xx1, ih = yy2 - yy1;
      if (iw <= 0 || ih <= 0) continue;
      const float inter = iw * ih;
      const float uni = area[i] + area[j] - inter;
      if (uni > 1e-12f && inter / uni > iou_threshold) suppressed[j] = 1;
    }
  }
  return n_keep;
}

}  // extern "C"
