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
// Bound on the H100.  At the serving shape of r50_fpn_coco (batch 2, 1000
// rois an image, C = 256, bf16) the bytes bound is 0.042 ms (the pyramid
// read once, the 25.1 M outputs written once, at 3.35 TB/s).  The
// arithmetic is fixed by the bitwise contract: per output element and
// sample, (g00*wy0)*wx0 + (g01*wy0)*lx + (g10*ly)*wx0 + (g11*ly)*lx, the
// inside multiply and the add, each rounded on its own (--fmad=false):
// about 53 FP instructions an element, some 0.04 ms at the card's
// non-fused f32 rate.  Both bounds meet near 0.04 ms, so what decides the
// time is how many instructions surround that arithmetic.
//
// Design.  One block per roi.  Its sample geometry depends on the roi and
// one axis only, so it is computed once, into per-roi tap tables in shared
// memory: for each axis and each of the S * sr sample positions, the low
// and high cell's element offset, l and 1 - l, and the inside flag, with
// exactly the expressions (and so the bits) the per-element form used.
// Threads then take work items (bin, 8 channels): one 16-byte load a tap
// (eight bf16, or two of four f32) and eight f32 sums in registers, so a
// warp covers 256 channels of one bin, reads each table entry as a
// shared-memory broadcast, and issues a tap's load once for eight
// channels.  With sr = 2 (every configuration) the sample loops unroll, so
// a bin's 16 loads are issued ahead of its arithmetic.  Channel counts
// that are not a multiple of 8, or rows not 16-byte aligned, take the
// same kernel with one channel a thread (the tail path).  The outputs are
// bitwise those of the per-element form this kernel replaced (one thread a
// channel, the geometry recomputed for every element):
// the same tables, the same expression order, the same division and cast.
// A roi's window is not staged in shared memory: at 38 cells a side it is
// up to 780 KB at C = 256, and each cell serves only one or two samples,
// which L1 and L2 already catch.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // pooled * sampling_ratio, per axis
constexpr int kVec = 8;          // channels a thread on the vector path
constexpr int kThreads = 256;    // a block (one roi); chosen by measurement

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

// V channels from p into g, as f32.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&g)[V]);
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&g)[V]);

template <>
__device__ __forceinline__ void load_vec<1>(const float* p, float (&g)[1]) {
  g[0] = __ldg(p);
}
template <>
__device__ __forceinline__ void load_vec<1>(const __nv_bfloat16* p,
                                            float (&g)[1]) {
  g[0] = __bfloat162float(p[0]);
}
template <>
__device__ __forceinline__ void load_vec<kVec>(const float* p,
                                               float (&g)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  g[0] = a.x, g[1] = a.y, g[2] = a.z, g[3] = a.w;
  g[4] = b.x, g[5] = b.y, g[6] = b.z, g[7] = b.w;
}
template <>
__device__ __forceinline__ void load_vec<kVec>(const __nv_bfloat16* p,
                                               float (&g)[kVec]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    g[2 * i] = __uint_as_float(w[i] << 16);
    g[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// out[0..V) = acc / count, cast to T (bf16: round to nearest even, as
// torch's cast).
template <int V>
__device__ __forceinline__ void store_vec(float* o, const float (&acc)[V],
                                          float count) {
  if constexpr (V == 1) {
    o[0] = acc[0] / count;
  } else {
    reinterpret_cast<float4*>(o)[0] = make_float4(
        acc[0] / count, acc[1] / count, acc[2] / count, acc[3] / count);
    reinterpret_cast<float4*>(o)[1] = make_float4(
        acc[4] / count, acc[5] / count, acc[6] / count, acc[7] / count);
  }
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* o,
                                          const float (&acc)[V], float count) {
  if constexpr (V == 1) {
    o[0] = __float2bfloat16(acc[0] / count);
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(acc[2 * i] / count));
      const unsigned hi =
          __bfloat16_as_ushort(__float2bfloat16(acc[2 * i + 1] / count));
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One sample position along one axis: the element offsets of its low and
// high cell (cell index times the axis' pitch), l and 1 - l.
struct __align__(16) AxisTap {
  int off0;
  int off1;
  float l;
  float w0;
};

// T the feature dtype, V channels a thread (kVec or 1), SR the sampling
// ratio when fixed at compile time (0: read ``sr``).
template <typename T, int V, int SR>
__global__ void roi_align_fwd(Pyramid pyr, const float* __restrict__ rois,
                              const int* __restrict__ level_idx,
                              int rois_per_image, int channels, int pooled,
                              int sr_arg, T* __restrict__ out) {
  __shared__ AxisTap ytab[kMaxSamples];
  __shared__ AxisTap xtab[kMaxSamples];
  __shared__ bool yin[kMaxSamples];
  __shared__ bool xin[kMaxSamples];

  const int sr = SR > 0 ? SR : sr_arg;
  const int n = blockIdx.x;
  const int b = n / rois_per_image;
  const int li = level_idx[n];
  const int hl = pyr.h[li];
  const int wl = pyr.w[li];
  const int ns = pooled * sr;

  // The tables: entry s < ns is y sample s, entry ns + s is x sample s.
  for (int e = threadIdx.x; e < 2 * ns; e += blockDim.x) {
    const bool is_x = e >= ns;
    const int s = is_x ? e - ns : e;
    const int p = s / sr;
    const int i = s - p * sr;
    const float scale = ldexpf(1.0f, -pyr.level[li]);
    const float x1 = rois[n * 4 + 0] * scale;
    const float y1 = rois[n * 4 + 1] * scale;
    const float rw = fmaxf(rois[n * 4 + 2] * scale - x1, 1.0f);
    const float rh = fmaxf(rois[n * 4 + 3] * scale - y1, 1.0f);
    const float start = is_x ? x1 : y1;
    const float bin = (is_x ? rw : rh) / static_cast<float>(pooled);
    const int cells = is_x ? wl : hl;
    const float extent = static_cast<float>(cells);
    const float f = (static_cast<float>(i) + 0.5f) / static_cast<float>(sr);
    const float sc = start + (static_cast<float>(p) + f) * bin;
    const float c = fminf(fmaxf(sc, 0.0f), extent - 1.0f);
    const float c0 = floorf(c);
    const float l = c - c0;
    const int c0i = static_cast<int>(c0);
    const int c1i = min(c0i + 1, cells - 1);
    const int pitch = is_x ? channels : wl * channels;
    const AxisTap t = {c0i * pitch, c1i * pitch, l, 1.0f - l};
    const bool inside = sc > -1.0f && sc < extent;
    if (is_x) {
      xtab[s] = t;
      xin[s] = inside;
    } else {
      ytab[s] = t;
      yin[s] = inside;
    }
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(pyr.ptr[li]) +
                  static_cast<size_t>(b) * hl * wl * channels;
  T* o = out + static_cast<size_t>(n) * pooled * pooled * channels;
  const float count = static_cast<float>(sr * sr);
  const int groups = channels / V;
  const int items = pooled * pooled * groups;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int bin = item / groups;
    const int c = (item - bin * groups) * V;
    const int py = bin / pooled;
    const int px = bin - py * pooled;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int iy = 0; iy < (SR > 0 ? SR : sr); ++iy) {
      const AxisTap ty = ytab[py * sr + iy];
      const bool iny = yin[py * sr + iy];
#pragma unroll
      for (int ix = 0; ix < (SR > 0 ? SR : sr); ++ix) {
        const AxisTap tx = xtab[px * sr + ix];
        const float m = (iny && xin[px * sr + ix]) ? 1.0f : 0.0f;
        float g00[V], g01[V], g10[V], g11[V];
        load_vec<V>(feat + (ty.off0 + tx.off0 + c), g00);
        load_vec<V>(feat + (ty.off0 + tx.off1 + c), g01);
        load_vec<V>(feat + (ty.off1 + tx.off0 + c), g10);
        load_vec<V>(feat + (ty.off1 + tx.off1 + c), g11);
        const float ly = ty.l, wy0 = ty.w0, lx = tx.l, wx0 = tx.w0;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float val = g00[v] * wy0 * wx0 + g01[v] * wy0 * lx +
                            g10[v] * ly * wx0 + g11[v] * ly * lx;
          acc[v] = acc[v] + val * m;
        }
      }
    }
    store_vec<V>(o + static_cast<size_t>(bin) * channels + c, acc, count);
  }
}

template <typename T, int V>
void launch(int sr, int num_rois, cudaStream_t s, Pyramid pyr,
            const float* rois, const int* level_idx, int rois_per_image,
            int channels, int pooled, T* out) {
  if (sr == 2) {
    roi_align_fwd<T, V, 2><<<num_rois, kThreads, 0, s>>>(
        pyr, rois, level_idx, rois_per_image, channels, pooled, sr, out);
  } else {
    roi_align_fwd<T, V, 0><<<num_rois, kThreads, 0, s>>>(
        pyr, rois, level_idx, rois_per_image, channels, pooled, sr, out);
  }
}

template <typename T>
void launch_dtype(bool vec, int sr, int num_rois, cudaStream_t s,
                  Pyramid pyr, const float* rois, const int* level_idx,
                  int rois_per_image, int channels, int pooled, T* out) {
  if (vec) {
    launch<T, kVec>(sr, num_rois, s, pyr, rois, level_idx,
                    rois_per_image, channels, pooled, out);
  } else {
    launch<T, 1>(sr, num_rois, s, pyr, rois, level_idx,
                 rois_per_image, channels, pooled, out);
  }
}

}  // namespace

MX_ERROR_STRING_EXPORT

// rois (N, 4) f32 in image coordinates, N = images * rois_per_image;
// level_idx (N,) i32 indexing pyr's levels; out (N, S, S, C) in the
// feature dtype.  dtype: 0 = float32, 1 = bfloat16.  vec: C is a multiple
// of 8 and every map and ``out`` start 16-byte aligned (8 channels a
// thread; else one).  Each level's H * W * C must be below 2**31.
MX_EXPORT int roi_align_forward(Pyramid pyr, const void* rois,
                                const void* level_idx, void* out,
                                int num_rois, int rois_per_image,
                                int channels, int pooled, int sampling_ratio,
                                int dtype, int vec, void* stream) {
  if (num_rois <= 0) return 0;
  if (pooled < 1 || sampling_ratio < 1 ||
      pooled * sampling_ratio > kMaxSamples || channels < 1 ||
      (vec && channels % kVec != 0) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* l = static_cast<const int*>(level_idx);
  if (dtype == 0) {
    launch_dtype<float>(vec != 0, sampling_ratio, num_rois, s, pyr, r,
                        l, rois_per_image, channels, pooled,
                        static_cast<float*>(out));
  } else {
    launch_dtype<__nv_bfloat16>(vec != 0, sampling_ratio, num_rois, s,
                                pyr, r, l, rois_per_image, channels, pooled,
                                static_cast<__nv_bfloat16*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
