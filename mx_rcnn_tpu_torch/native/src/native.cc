// Host-side runtime kernels for mx_rcnn_tpu_torch (C++17, no dependencies;
// copy of mx_rcnn_tpu/native/src/native.cc).
//
// Replacements for the reference's compiled host code
// (SURVEY.md §3.5): the Cython cpu_nms, the COCO maskApi RLE routines, and
// the input pipeline's resize+normalize inner loop (the reference leaned on
// OpenCV there; this removes that dependency from the hot path).  All
// entry points are extern "C" and operate on caller-owned buffers so the
// Python side is a thin ctypes wrapper.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Greedy NMS (reference: rcnn/cython/cpu_nms.pyx).
//
// boxes: (n, 4) float32 x1,y1,x2,y2 sorted by caller or not — order is
// taken from `order` (descending score indices).  keep_out receives the
// kept indices; returns the number kept.
int cpu_nms(const float* boxes, const int* order, int n, float thresh,
            int* keep_out) {
  std::vector<char> suppressed(n, 0);
  std::vector<float> areas(n);
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    areas[i] = std::max(0.f, b[2] - b[0] + 1.f) * std::max(0.f, b[3] - b[1] + 1.f);
  }
  int kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    const float* bi = boxes + 4 * i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = boxes + 4 * j;
      float xx1 = std::max(bi[0], bj[0]);
      float yy1 = std::max(bi[1], bj[1]);
      float xx2 = std::min(bi[2], bj[2]);
      float yy2 = std::min(bi[3], bj[3]);
      float w = std::max(0.f, xx2 - xx1 + 1.f);
      float h = std::max(0.f, yy2 - yy1 + 1.f);
      float inter = w * h;
      float iou = inter / (areas[i] + areas[j] - inter);
      if (iou > thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

// ---------------------------------------------------------------------------
// RLE mask routines (reference: rcnn/pycocotools/maskApi.c contract —
// column-major alternating 0/1 run lengths, first run counts zeros).

// Encode a (h, w) uint8 mask (row-major in memory) into counts_out
// (caller-allocated, capacity h*w+1).  Returns the number of runs.
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts_out) {
  int n_runs = 0;
  uint8_t cur = 0;  // runs start with zeros
  uint32_t run = 0;
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {  // column-major scan
      uint8_t v = mask[(size_t)y * w + x] ? 1 : 0;
      if (v == cur) {
        ++run;
      } else {
        counts_out[n_runs++] = run;
        cur = v;
        run = 1;
      }
    }
  }
  counts_out[n_runs++] = run;
  return n_runs;
}

// Intersection of two RLEs in run space (no decode).
static int64_t rle_intersection(const uint32_t* a, int na, const uint32_t* b,
                                int nb) {
  int64_t inter = 0;
  int ia = 0, ib = 0;
  int64_t ea = a[0], eb = b[0];  // current run end positions
  int64_t pos = 0;
  while (ia < na && ib < nb) {
    int64_t end = std::min(ea, eb);
    if ((ia & 1) && (ib & 1)) inter += end - pos;
    pos = end;
    if (ea == end && ++ia < na) ea += a[ia];
    if (eb == end && ++ib < nb) eb += b[ib];
  }
  return inter;
}

int64_t rle_area(const uint32_t* counts, int n) {
  int64_t area = 0;
  for (int i = 1; i < n; i += 2) area += counts[i];
  return area;
}

// IoU matrix between n_d and n_g RLEs.  Flattened inputs: counts_flat holds
// all runs back to back, offsets/lengths index them (dts first, then gts).
void rle_iou(const uint32_t* counts_flat, const int64_t* offsets,
             const int32_t* lengths, int n_d, int n_g, double* iou_out) {
  std::vector<int64_t> areas(n_d + n_g);
  for (int i = 0; i < n_d + n_g; ++i)
    areas[i] = rle_area(counts_flat + offsets[i], lengths[i]);
  for (int i = 0; i < n_d; ++i) {
    for (int j = 0; j < n_g; ++j) {
      int64_t inter =
          rle_intersection(counts_flat + offsets[i], lengths[i],
                           counts_flat + offsets[n_d + j], lengths[n_d + j]);
      int64_t uni = areas[i] + areas[n_d + j] - inter;
      iou_out[(size_t)i * n_g + j] = uni > 0 ? (double)inter / (double)uni : 0.0;
    }
  }
}

// ---------------------------------------------------------------------------
// Input pipeline: bilinear resize into a zero-padded canvas + channelwise
// normalize, fused (reference: rcnn/io/image.py resize + transform, done
// via OpenCV + numpy in two passes).
//
// src: (sh, sw, 3) uint8 RGB.  dst: (dh, dw, 3) float32 canvas, fully
// overwritten (resized region top-left, rest zeros... normalized zeros).
// scale maps dst pixel -> src pixel (same factor both axes); nh/nw is the
// resized extent.  mean/std are per-channel.
void letterbox_normalize(const uint8_t* src, int sh, int sw, float* dst,
                         int dh, int dw, int nh, int nw, float scale,
                         const float* mean, const float* std_) {
  (void)scale;  // boxes use it; pixels use cv2's per-axis ratios below
  float inv_std[3] = {1.f / std_[0], 1.f / std_[1], 1.f / std_[2]};
  float pad[3] = {-mean[0] * inv_std[0], -mean[1] * inv_std[1],
                  -mean[2] * inv_std[2]};
  // cv2.resize convention: per-axis ratio src_extent / dst_extent (nh/nw
  // are rounded, so these differ slightly from 1/scale per axis).
  float ratio_y = (float)sh / (float)(nh > 0 ? nh : 1);
  float ratio_x = (float)sw / (float)(nw > 0 ? nw : 1);
  for (int y = 0; y < dh; ++y) {
    float* row = dst + (size_t)y * dw * 3;
    if (y >= nh) {
      for (int x = 0; x < dw; ++x)
        for (int c = 0; c < 3; ++c) row[3 * x + c] = pad[c];
      continue;
    }
    // cv2.INTER_LINEAR convention: src = (dst + 0.5) * inv_scale - 0.5.
    float sy = (y + 0.5f) * ratio_y - 0.5f;
    sy = std::max(0.f, std::min(sy, (float)sh - 1));
    int y0 = (int)sy;
    int y1 = std::min(y0 + 1, sh - 1);
    float ly = sy - y0;
    const uint8_t* r0 = src + (size_t)y0 * sw * 3;
    const uint8_t* r1 = src + (size_t)y1 * sw * 3;
    for (int x = 0; x < dw; ++x) {
      if (x >= nw) {
        for (int c = 0; c < 3; ++c) row[3 * x + c] = pad[c];
        continue;
      }
      float sx = (x + 0.5f) * ratio_x - 0.5f;
      sx = std::max(0.f, std::min(sx, (float)sw - 1));
      int x0 = (int)sx;
      int x1 = std::min(x0 + 1, sw - 1);
      float lx = sx - x0;
      for (int c = 0; c < 3; ++c) {
        float v = (1 - ly) * ((1 - lx) * r0[3 * x0 + c] + lx * r0[3 * x1 + c]) +
                  ly * ((1 - lx) * r1[3 * x0 + c] + lx * r1[3 * x1 + c]);
        row[3 * x + c] = (v - mean[c]) * inv_std[c];
      }
    }
  }
}

}  // extern "C"
