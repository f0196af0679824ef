// Multi-level FPN ROIAlign backward (kernel B2).
//
// Replaces mx_rcnn_tpu/ops/pallas/roi_align.py::multilevel_roi_align_bwd_pallas
// (_bwd_kernel).  It computes the transpose of kernel B1 (roi_align.cu) with
// respect to the pyramid, as ops/roi_align.py::multilevel_roi_align_bwd does
// in plain torch: every bilinear tap of every sample of every bin adds
// (g / sr^2) * (wy * wx) into its cell's gradient, accumulated in f32 and
// cast once to the feature dtype.  Rois get no gradient.  Each roi reads
// the level the forward assigned it (level_idx, saved by the autograd
// Function), and its sample geometry is computed exactly as B1 computes it.
//
// Determinism.  The Pallas kernel adds each roi's window into HBM by
// read-modify-write, which is correct on the TPU only because its grid
// runs in sequence.  Here blocks run in parallel, and float atomics would
// sum in a different order on every launch.  So each block owns one tile of
// output: (image, level, 8 x 8 cells, 32 channels), one lane per channel,
// with an f32 accumulator for the tile in shared memory.  The block walks
// its image's rois in index order, skips those of another level or whose
// sample footprint misses the tile, and for the rest adds each tap that
// lands in the tile in a fixed order (roi, bin, sample, tap).  Every
// accumulator element is written by one lane only, so two launches on the
// same inputs give the same bits, and no memset or atomic is needed: the
// tiles partition the output, and each block writes its tile once.
//
// Bound on the H100: memory (each cotangent element read once, each
// gradient element written once).  This first form is not near it: every
// block scans all the rois of its image and re-reads the cotangent of each
// roi that touches it; see PERF.md for its time against the bound.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTile = 8;         // cells per side of a block's tile
constexpr int kGroup = 32;       // channels per block: one lane each
constexpr int kMaxSamples = 64;  // pooled * sampling_ratio
constexpr int kMaxPooled = 32;

}  // namespace

// Passed by value from ctypes (ops/cuda/roi_align.py::_GradPyramid): per
// level, the (B, H, W, C) gradient map, its H and W, its pyramid level l
// (stride 2**l), its tile columns, and the first tile index of each level
// in the grid's x dimension (tile_start[num_levels] = all tiles).
struct GradPyramid {
  void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int level[kMaxLevels];
  int tiles_x[kMaxLevels];
  int tile_start[kMaxLevels + 1];
  int num_levels;
};

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// One roi's geometry at its level, as B1 computes it.
struct RoiGeom {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* roi, int level,
                                            int pooled) {
  const float scale = ldexpf(1.0f, -level);
  RoiGeom r;
  r.x1 = roi[0] * scale;
  r.y1 = roi[1] * scale;
  const float rw = fmaxf(roi[2] * scale - r.x1, 1.0f);
  const float rh = fmaxf(roi[3] * scale - r.y1, 1.0f);
  r.bin_w = rw / static_cast<float>(pooled);
  r.bin_h = rh / static_cast<float>(pooled);
  return r;
}

// The sample coordinate of bin p, sub-sample i along one axis.
__device__ __forceinline__ float sample_at(float start, float bin, int p, int i,
                                           int sr) {
  const float f = (static_cast<float>(i) + 0.5f) / static_cast<float>(sr);
  return start + (static_cast<float>(p) + f) * bin;
}

// Lowest and highest cell any tap of samples lo..hi can touch along an
// axis of n cells.  Sample coordinates rise with (bin, sub-sample) and
// clamp and floor keep the order, so the ends bound every tap.
__device__ __forceinline__ void tap_span(float lo, float hi, int n, int* first,
                                         int* last) {
  const float nf = static_cast<float>(n);
  *first = static_cast<int>(floorf(fminf(fmaxf(lo, 0.0f), nf - 1.0f)));
  *last = min(static_cast<int>(floorf(fminf(fmaxf(hi, 0.0f), nf - 1.0f))) + 1,
              n - 1);
}

// Per-sample tap table along one axis: taps t0, t1, the weight of t0
// (1 - frac), frac, and whether the sample is inside (-1, n).
struct AxisTable {
  int t0[kMaxSamples];
  int t1[kMaxSamples];
  float w0[kMaxSamples];
  float w1[kMaxSamples];
  bool in[kMaxSamples];
  bool hit[kMaxPooled];  // bin p has a tap inside the tile
};

__device__ __forceinline__ void fill_axis(AxisTable* t, int s, float coord,
                                          int n) {
  const float nf = static_cast<float>(n);
  const float v = fminf(fmaxf(coord, 0.0f), nf - 1.0f);
  const float v0 = floorf(v);
  const float frac = v - v0;
  const int i0 = static_cast<int>(v0);
  t->t0[s] = i0;
  t->t1[s] = min(i0 + 1, n - 1);
  t->w0[s] = 1.0f - frac;
  t->w1[s] = frac;
  t->in[s] = coord > -1.0f && coord < nf;
}

template <typename T>
__global__ void __launch_bounds__(kGroup)
    roi_align_bwd(GradPyramid pyr, const float* __restrict__ rois,
                  const int* __restrict__ level_idx, const T* __restrict__ g,
                  int rois_per_image, int channels, int pooled, int sr) {
  __shared__ float acc[kTile * kTile * kGroup];
  __shared__ AxisTable ys, xs;

  const int tile = blockIdx.x;
  const int b = blockIdx.z;
  const int lane = threadIdx.x;
  const int c = blockIdx.y * kGroup + lane;
  int li = 0;
  while (li + 1 < pyr.num_levels && tile >= pyr.tile_start[li + 1]) ++li;
  const int t = tile - pyr.tile_start[li];
  const int hl = pyr.h[li];
  const int wl = pyr.w[li];
  const int ty0 = (t / pyr.tiles_x[li]) * kTile;
  const int tx0 = (t % pyr.tiles_x[li]) * kTile;
  const int n_s = pooled * sr;
  const float count = static_cast<float>(sr * sr);

  for (int i = lane; i < kTile * kTile * kGroup; i += kGroup) acc[i] = 0.0f;

  for (int base = 0; base < rois_per_image; base += kGroup) {
    // Which of the next 32 rois reach this tile: one roi per lane.
    const int j = base + lane;
    bool hit = false;
    if (j < rois_per_image) {
      const int n = b * rois_per_image + j;
      if (level_idx[n] == li) {
        const RoiGeom r = roi_geom(rois + 4 * n, pyr.level[li], pooled);
        int y_first, y_last, x_first, x_last;
        tap_span(sample_at(r.y1, r.bin_h, 0, 0, sr),
                 sample_at(r.y1, r.bin_h, pooled - 1, sr - 1, sr), hl, &y_first,
                 &y_last);
        tap_span(sample_at(r.x1, r.bin_w, 0, 0, sr),
                 sample_at(r.x1, r.bin_w, pooled - 1, sr - 1, sr), wl, &x_first,
                 &x_last);
        hit = y_first < ty0 + kTile && y_last >= ty0 && x_first < tx0 + kTile &&
              x_last >= tx0;
      }
    }
    unsigned mask = __ballot_sync(0xffffffffu, hit);
    while (mask) {  // the hits in index order
      const int k = __ffs(mask) - 1;
      mask &= mask - 1;
      const int n = b * rois_per_image + base + k;
      const RoiGeom r = roi_geom(rois + 4 * n, pyr.level[li], pooled);
      for (int i = lane; i < 2 * n_s; i += kGroup) {
        const int s = i < n_s ? i : i - n_s;
        if (i < n_s) {
          fill_axis(&ys, s, sample_at(r.y1, r.bin_h, s / sr, s % sr, sr), hl);
        } else {
          fill_axis(&xs, s, sample_at(r.x1, r.bin_w, s / sr, s % sr, sr), wl);
        }
      }
      __syncwarp();
      for (int i = lane; i < 2 * pooled; i += kGroup) {
        AxisTable* a = i < pooled ? &ys : &xs;
        const int p = i < pooled ? i : i - pooled;
        const int lo = i < pooled ? ty0 : tx0;
        bool any = false;
        for (int q = 0; q < sr; ++q) {
          const int s = p * sr + q;
          any |= a->in[s] && ((a->t0[s] >= lo && a->t0[s] < lo + kTile) ||
                              (a->t1[s] >= lo && a->t1[s] < lo + kTile));
        }
        a->hit[p] = any;
      }
      __syncwarp();
      if (c < channels) {
        const T* gr = g + static_cast<size_t>(n) * pooled * pooled * channels + c;
        for (int py = 0; py < pooled; ++py) {
          if (!ys.hit[py]) continue;
          for (int px = 0; px < pooled; ++px) {
            if (!xs.hit[px]) continue;
            const float gs =
                to_float(gr[static_cast<size_t>(py * pooled + px) * channels]) /
                count;
            for (int iy = 0; iy < sr; ++iy) {
              const int sy = py * sr + iy;
              if (!ys.in[sy]) continue;
              for (int ix = 0; ix < sr; ++ix) {
                const int sx = px * sr + ix;
                if (!xs.in[sx]) continue;
                const int yt[2] = {ys.t0[sy] - ty0, ys.t1[sy] - ty0};
                const float yw[2] = {ys.w0[sy], ys.w1[sy]};
                const int xt[2] = {xs.t0[sx] - tx0, xs.t1[sx] - tx0};
                const float xw[2] = {xs.w0[sx], xs.w1[sx]};
#pragma unroll
                for (int u = 0; u < 2; ++u) {
#pragma unroll
                  for (int v = 0; v < 2; ++v) {
                    if (yt[u] >= 0 && yt[u] < kTile && xt[v] >= 0 &&
                        xt[v] < kTile) {
                      float* cell = &acc[(yt[u] * kTile + xt[v]) * kGroup + lane];
                      *cell = *cell + gs * (yw[u] * xw[v]);
                    }
                  }
                }
              }
            }
          }
        }
      }
      __syncwarp();  // the tables are rewritten for the next roi
    }
  }

  if (c < channels) {
    T* out = static_cast<T*>(pyr.ptr[li]) + static_cast<size_t>(b) * hl * wl * channels;
    for (int cy = 0; cy < kTile && ty0 + cy < hl; ++cy) {
      for (int cx = 0; cx < kTile && tx0 + cx < wl; ++cx) {
        out[(static_cast<size_t>(ty0 + cy) * wl + tx0 + cx) * channels + c] =
            from_float<T>(acc[(cy * kTile + cx) * kGroup + lane]);
      }
    }
  }
}

}  // namespace

MX_ERROR_STRING_EXPORT

// The tile edge the wrapper cuts each level into (grid x).
MX_EXPORT int roi_align_bwd_tile() { return kTile; }

// rois (N, 4) f32 in image coordinates, N = images * rois_per_image;
// level_idx (N,) i32 indexing pyr's levels; g (N, S, S, C) in the feature
// dtype; pyr's maps (images, H, W, C) in the same dtype are written whole.
// dtype: 0 = float32, 1 = bfloat16.
MX_EXPORT int roi_align_backward(GradPyramid pyr, const void* rois,
                                 const void* level_idx, const void* g,
                                 int images, int rois_per_image, int channels,
                                 int pooled, int sampling_ratio, int dtype,
                                 void* stream) {
  if (pooled < 1 || pooled > kMaxPooled || sampling_ratio < 1 ||
      pooled * sampling_ratio > kMaxSamples || pyr.num_levels < 1 ||
      pyr.num_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = pyr.tile_start[pyr.num_levels];
  if (images <= 0 || channels <= 0 || tiles <= 0) return 0;
  const dim3 grid(tiles, (channels + kGroup - 1) / kGroup, images);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* l = static_cast<const int*>(level_idx);
  if (dtype == 0) {
    roi_align_bwd<float><<<grid, kGroup, 0, s>>>(
        pyr, r, l, static_cast<const float*>(g), rois_per_image, channels,
        pooled, sampling_ratio);
  } else if (dtype == 1) {
    roi_align_bwd<__nv_bfloat16><<<grid, kGroup, 0, s>>>(
        pyr, r, l, static_cast<const __nv_bfloat16*>(g), rois_per_image,
        channels, pooled, sampling_ratio);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
