// Shared device helpers of the port's kernels.
//
// Every kernel is built with --fmad=false (ops/cuda/_build.py): each
// multiply and add below rounds on its own, as the plain torch versions
// do, so the kernels can be held bitwise against them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MX_EXPORT extern "C" __attribute__((visibility("default")))

// Every library exports the text of its CUDA error codes.
#define MX_ERROR_STRING_EXPORT                                  \
  MX_EXPORT const char* kernel_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));  \
  }

// geometry/boxes.py::snap -- round onto the 2**-bits grid, half to even
// (rintf, as torch.round and jnp.round; roundf would round half away from
// zero).  The scale and the scale back are exact powers of two.
__device__ __forceinline__ float snap_grid(float x, float scale) {
  return rintf(x * scale) * (1.0f / scale);
}

// IoU of boxes a and b as geometry/boxes.py::iou_matrix computes it,
// given each box's area: intersection clamped at zero, the union summed
// as (area_a + area_b) - inter, and a zero-union guard.
__device__ __forceinline__ float box_iou(float ax1, float ay1, float ax2,
                                         float ay2, float area_a, float bx1,
                                         float by1, float bx2, float by2,
                                         float area_b) {
  float iw = fmaxf(fminf(ax2, bx2) - fmaxf(ax1, bx1), 0.0f);
  float ih = fmaxf(fminf(ay2, by2) - fmaxf(ay1, by1), 0.0f);
  float inter = iw * ih;
  float uni = (area_a + area_b) - inter;
  return uni > 0.0f ? inter / uni : 0.0f;
}

// The suppression test of ops/nms.py: IoU snapped to 2**-16, then a
// strict compare against the f32 threshold.
__device__ __forceinline__ bool suppresses(float iou, float thresh) {
  return snap_grid(iou, 65536.0f) > thresh;
}
