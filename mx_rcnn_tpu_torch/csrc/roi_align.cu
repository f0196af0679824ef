// Multi-level FPN ROIAlign forward (kernel B1).
//
// Replaces mx_rcnn_tpu/ops/pallas/roi_align.py::multilevel_roi_align_pallas
// (_kernel).  It computes what the XLA oracle
// mx_rcnn_tpu/ops/roi_align.py::multilevel_roi_align computes, and what
// ops/roi_align.py::multilevel_roi_align is in this package:
//   * each roi pools from its assigned level (the wrapper assigns levels
//     with the port's fpn_level_assignment, extent bound included);
//   * bin (py, px) averages sampling_ratio^2 bilinear samples; a sample
//     outside (-1, H) x (-1, W) counts zero, one inside clamps to the
//     [0, H-1] x [0, W-1] cell range, and y1 = min(y0 + 1, H - 1);
//   * f32 interpolation with f32 accumulation, summed in the oracle's
//     order, divided by sr^2, cast once to the feature dtype.
// None of the Pallas kernel's TPU devices is carried over: no window
// classes or 8-aligned origins, no W padding, no hi/lo bf16 weight split.
//
// Bound on the H100: memory.  Every output element is written once and
// reads 4 * sr^2 feature values through L2.  Design: one block per roi,
// threads across channels, so each of the 4 * sr^2 taps of a bin is one
// coalesced row read (512 B of bf16 at C = 256) from the NHWC pyramid
// that the backbone's channels_last layout already gives; the per-roi
// geometry is a handful of scalars every thread recomputes.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;

}  // namespace

// Passed by value from ctypes (ops/cuda/roi_align.py::_Pyramid): per level,
// the (B, H, W, C) feature map, its H and W, and its pyramid level l
// (stride 2**l).
struct Pyramid {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int level[kMaxLevels];
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

template <typename T>
__global__ void roi_align_fwd(Pyramid pyr, const float* __restrict__ rois,
                              const int* __restrict__ level_idx,
                              int rois_per_image, int channels, int pooled,
                              int sr, T* __restrict__ out) {
  const int n = blockIdx.x;
  const int b = n / rois_per_image;
  const int li = level_idx[n];
  const int hl = pyr.h[li];
  const int wl = pyr.w[li];
  const T* feat = static_cast<const T*>(pyr.ptr[li]) +
                  static_cast<size_t>(b) * hl * wl * channels;
  const float hf = static_cast<float>(hl);
  const float wf = static_cast<float>(wl);

  const float scale = ldexpf(1.0f, -pyr.level[li]);
  const float x1 = rois[n * 4 + 0] * scale;
  const float y1 = rois[n * 4 + 1] * scale;
  const float rw = fmaxf(rois[n * 4 + 2] * scale - x1, 1.0f);
  const float rh = fmaxf(rois[n * 4 + 3] * scale - y1, 1.0f);
  const float bin_w = rw / static_cast<float>(pooled);
  const float bin_h = rh / static_cast<float>(pooled);
  const float count = static_cast<float>(sr * sr);

  T* o = out + static_cast<size_t>(n) * pooled * pooled * channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    for (int py = 0; py < pooled; ++py) {
      for (int px = 0; px < pooled; ++px) {
        float acc = 0.0f;
        for (int iy = 0; iy < sr; ++iy) {
          const float fy = (static_cast<float>(iy) + 0.5f) / static_cast<float>(sr);
          const float sy = y1 + (static_cast<float>(py) + fy) * bin_h;
          const float y = fminf(fmaxf(sy, 0.0f), hf - 1.0f);
          const float y0 = floorf(y);
          const float ly = y - y0;
          const int y0i = static_cast<int>(y0);
          const int y1i = min(y0i + 1, hl - 1);
          const float wy0 = 1.0f - ly;
          for (int ix = 0; ix < sr; ++ix) {
            const float fx = (static_cast<float>(ix) + 0.5f) / static_cast<float>(sr);
            const float sx = x1 + (static_cast<float>(px) + fx) * bin_w;
            const bool inside = sy > -1.0f && sy < hf && sx > -1.0f && sx < wf;
            const float x = fminf(fmaxf(sx, 0.0f), wf - 1.0f);
            const float x0 = floorf(x);
            const float lx = x - x0;
            const int x0i = static_cast<int>(x0);
            const int x1i = min(x0i + 1, wl - 1);
            const float wx0 = 1.0f - lx;
            const float g00 = to_float(feat[(static_cast<size_t>(y0i) * wl + x0i) * channels + c]);
            const float g01 = to_float(feat[(static_cast<size_t>(y0i) * wl + x1i) * channels + c]);
            const float g10 = to_float(feat[(static_cast<size_t>(y1i) * wl + x0i) * channels + c]);
            const float g11 = to_float(feat[(static_cast<size_t>(y1i) * wl + x1i) * channels + c]);
            const float v = g00 * wy0 * wx0 + g01 * wy0 * lx + g10 * ly * wx0 +
                            g11 * ly * lx;
            acc = acc + v * (inside ? 1.0f : 0.0f);
          }
        }
        o[(static_cast<size_t>(py) * pooled + px) * channels + c] =
            from_float<T>(acc / count);
      }
    }
  }
}

}  // namespace

MX_ERROR_STRING_EXPORT

// rois (N, 4) f32 in image coordinates, N = images * rois_per_image;
// level_idx (N,) i32 indexing pyr's levels; out (N, S, S, C) in the
// feature dtype.  dtype: 0 = float32, 1 = bfloat16.
MX_EXPORT int roi_align_forward(Pyramid pyr, const void* rois,
                                const void* level_idx, void* out,
                                int num_rois, int rois_per_image,
                                int channels, int pooled, int sampling_ratio,
                                int dtype, void* stream) {
  if (num_rois <= 0) return 0;
  const int threads = min(256, ((channels + 31) / 32) * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* l = static_cast<const int*>(level_idx);
  if (dtype == 0) {
    roi_align_fwd<float><<<num_rois, threads, 0, s>>>(
        pyr, r, l, rois_per_image, channels, pooled, sampling_ratio,
        static_cast<float*>(out));
  } else if (dtype == 1) {
    roi_align_fwd<__nv_bfloat16><<<num_rois, threads, 0, s>>>(
        pyr, r, l, rois_per_image, channels, pooled, sampling_ratio,
        static_cast<__nv_bfloat16*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
