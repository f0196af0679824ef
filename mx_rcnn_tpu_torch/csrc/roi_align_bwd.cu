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
// sum in a different order on every launch.  So each output element has
// one writer, and every element sums in a fixed order: roi index, then bin
// (py, px), then sample (iy, ix), then tap (u, v), with the tap term
// gs * (wy * wx), gs = g / sr^2.  Two launches on the same inputs give the
// same bits, and the same bits as the one-warp-a-tile form this kernel
// replaced (PR 2's), which summed in that order too.
//
// Bound on the H100: memory.  Each cotangent element is read once and
// each gradient element written once; at the train shapes of r50_fpn_coco
// (batch 2, 512 rois an image, C = 256, bf16) that is mostly the ~91 MB
// pyramid gradient, some 0.035 ms at 3.35 TB/s.
//
// Design.  A binning kernel first computes each roi's tile rectangle at
// its level from the same sample footprint the taps see (roi_geom,
// sample_at, tap_span) and sets the roi's bit in the list of every 8 x 8
// tile in it: a per-(image, tile) bitset over the image's rois, which is
// its roi list in index order, of fixed size, so nothing waits on the host
// for a list length.  A list may hold a roi that touches no tap of the
// tile (the main kernel re-checks every tap); it never misses one.
//
// The main kernel runs one block per (tile, channel slab of up to 128,
// image), 64 threads a 8-channel group: a thread owns one cell and eight
// channels, and keeps their sums in registers.  (A shared-memory
// accumulator serialized every tap: the compiler cannot prove that a tap's
// store does not alias the next tap's cell or the tables, so each add
// waited on a shared-memory round trip.)  Warp 0 turns the tile's bitset
// into roi indices in shared memory.  The rois are then taken in chunks of
// 16: a warp per (roi, axis) builds the chunk's tap tables at once, for
// all the block's channels (a lane a bin; ballots find the first and last
// sample with a tap on each row and column of the tile), one barrier, and
// the block prefetches into L1 the cotangent of the bins that reach the
// tile.  Each thread then walks the chunk's rois in order, and for each
// only the bins and samples that reach its cell: it reads the bin's
// cotangent as one 16-byte load (bf16) or two (f32) and adds each tap on
// its cell to its eight sums.  Two barriers a chunk, none between its
// rois.  An empty tile stores its zeros with the same 16-byte stores.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTile = 8;                   // cells per side of a block's tile
constexpr int kCells = kTile * kTile;
constexpr int kVec = 8;                    // channels a thread
constexpr int kMaxGroups = 16;             // channel groups a block (128 ch)
constexpr int kMaxThreads = kCells * kMaxGroups;
constexpr int kMaxSamples = 64;            // pooled * sampling_ratio
constexpr int kChunk = 16;                 // rois whose tables are built at once
constexpr int kMaxPooled = 32;            // a lane a bin

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

// Eight channels c .. c + 7 as 16-byte loads and stores when ``vec`` (C a
// multiple of 8 and 16-byte aligned rows), else one at a time, the first
// ``nc`` of them.
__device__ __forceinline__ void load8(const float* p, bool vec, int nc,
                                      float* v) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = k < nc ? p[k] : 0.0f;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool vec, int nc,
                                      float* v) {
  if (vec) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      v[2 * k] = __low2float(h[k]);
      v[2 * k + 1] = __high2float(h[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = k < nc ? __bfloat162float(p[k]) : 0.0f;
  }
}
__device__ __forceinline__ void store8(float* p, bool vec, int nc,
                                       const float* v) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (k < nc) p[k] = v[k];
  }
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, bool vec, int nc,
                                       const float* v) {
  // __float2bfloat16 rounds to nearest even, as torch's cast.
  if (vec) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k)
      h[k] = __halves2bfloat162(__float2bfloat16(v[2 * k]),
                                __float2bfloat16(v[2 * k + 1]));
    *reinterpret_cast<uint4*>(p) = a;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      if (k < nc) p[k] = __float2bfloat16(v[k]);
  }
}

// One roi's geometry at its level, as B1 computes it.
struct RoiGeom {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ RoiGeom roi_geom(float4 roi, int level, int pooled) {
  const float scale = ldexpf(1.0f, -level);
  RoiGeom r;
  r.x1 = roi.x * scale;
  r.y1 = roi.y * scale;
  const float rw = fmaxf(roi.z * scale - r.x1, 1.0f);
  const float rh = fmaxf(roi.w * scale - r.y1, 1.0f);
  r.bin_w = rw / static_cast<float>(pooled);
  r.bin_h = rh / static_cast<float>(pooled);
  return r;
}

// Roi n's corners (rois (N, 4) f32, 16-byte aligned rows).
__device__ __forceinline__ float4 roi_at(const float* __restrict__ rois, int n) {
  return __ldg(reinterpret_cast<const float4*>(rois) + n);
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

// One sample along an axis of n cells: taps t0, t1, the weight of t0
// (1 - frac), frac, and whether the sample is inside (-1, n).
struct AxisSample {
  int t0, t1;
  float w0, w1;
  bool in;
};

__device__ __forceinline__ AxisSample axis_sample(float coord, int n) {
  const float nf = static_cast<float>(n);
  const float v = fminf(fmaxf(coord, 0.0f), nf - 1.0f);
  const float v0 = floorf(v);
  const float frac = v - v0;
  AxisSample a;
  a.t0 = static_cast<int>(v0);
  a.t1 = min(a.t0 + 1, n - 1);
  a.w0 = 1.0f - frac;
  a.w1 = frac;
  a.in = coord > -1.0f && coord < nf;
  return a;
}

// One roi's tap tables, per sample, along both axes; for each row and
// column of the tile the first and last sample with a tap on it (lo > hi:
// none), and over the whole tile (the rectangle of bins to prefetch).  The
// samples with a tap on a cell are contiguous, as sample positions rise
// with the bin and clamp and floor keep the order.
struct RoiTables {
  int t0[2][kMaxSamples], t1[2][kMaxSamples];      // [0]: y, [1]: x
  float w0[2][kMaxSamples], w1[2][kMaxSamples];
  int lo[2][kTile], hi[2][kTile];
  int rlo[2], rhi[2];
};

// Warp ``axis`` (0: y, 1: x) builds roi q's tables along its axis: lane p
// takes bin p's samples, and ballots find each row's or column's samples.
__device__ __forceinline__ void build_axis(RoiTables* tb, int axis, float4 q,
                                           int level, int pooled, int sr,
                                           int n, int c0, int lane) {
  const RoiGeom geo = roi_geom(q, level, pooled);
  const float start = axis == 0 ? geo.y1 : geo.x1;
  const float bin = axis == 0 ? geo.bin_h : geo.bin_w;
  const bool mine = lane < pooled;
  int lo[kTile], hi[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) lo[i] = kMaxSamples, hi[i] = -1;
  for (int k = 0; k < sr; ++k) {
    AxisSample a{0, 0, 0.0f, 0.0f, false};
    if (mine) {
      const int s = lane * sr + k;
      a = axis_sample(sample_at(start, bin, lane, k, sr), n);
      tb->t0[axis][s] = a.t0;
      tb->t1[axis][s] = a.t1;
      tb->w0[axis][s] = a.w0;
      tb->w1[axis][s] = a.w1;
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const int cell = c0 + i;
      const unsigned m =
          __ballot_sync(0xffffffffu, a.in && (a.t0 == cell || a.t1 == cell));
      if (m) {
        lo[i] = min(lo[i], (__ffs(m) - 1) * sr + k);
        hi[i] = max(hi[i], (31 - __clz(m)) * sr + k);
      }
    }
  }
  if (lane == 0) {
    int rlo = kMaxSamples, rhi = -1;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      tb->lo[axis][i] = lo[i];
      tb->hi[axis][i] = hi[i];
      rlo = min(rlo, lo[i]);
      rhi = max(rhi, hi[i]);
    }
    tb->rlo[axis] = rlo;
    tb->rhi[axis] = rhi;
  }
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// One thread per roi: set the roi's bit in the list of every tile of its
// level that its sample footprint reaches.  lists (images, tiles, words)
// u32, zeroed by the caller; words = ceil(rois_per_image / 32).
__global__ void roi_tile_bins(GradPyramid pyr, const float* __restrict__ rois,
                              const int* __restrict__ level_idx, int images,
                              int rois_per_image, int pooled, int sr,
                              int words, unsigned* __restrict__ lists) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= images * rois_per_image) return;
  const int li = level_idx[n];
  if (li < 0 || li >= pyr.num_levels) return;
  const int b = n / rois_per_image;
  const int r = n % rois_per_image;
  const RoiGeom g = roi_geom(roi_at(rois, n), pyr.level[li], pooled);
  int y_first, y_last, x_first, x_last;
  tap_span(sample_at(g.y1, g.bin_h, 0, 0, sr),
           sample_at(g.y1, g.bin_h, pooled - 1, sr - 1, sr), pyr.h[li],
           &y_first, &y_last);
  tap_span(sample_at(g.x1, g.bin_w, 0, 0, sr),
           sample_at(g.x1, g.bin_w, pooled - 1, sr - 1, sr), pyr.w[li],
           &x_first, &x_last);
  const int tiles = pyr.tile_start[pyr.num_levels];
  unsigned* row = lists + static_cast<size_t>(b) * tiles * words + (r >> 5);
  const unsigned bit = 1u << (r & 31);
  for (int ty = y_first / kTile; ty <= y_last / kTile; ++ty) {
    for (int tx = x_first / kTile; tx <= x_last / kTile; ++tx) {
      const int tile = pyr.tile_start[li] + ty * pyr.tiles_x[li] + tx;
      atomicOr(row + static_cast<size_t>(tile) * words, bit);
    }
  }
}

// One block per (tile, channel slab, image): thread t owns cell t / groups
// of the tile and channels slab0 + 8 * (t % groups) + 0..7, its sums in
// registers.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_bwd(GradPyramid pyr, const float* __restrict__ rois,
                  const unsigned* __restrict__ lists, int words,
                  const T* __restrict__ g, int rois_per_image, int channels,
                  int pooled, int sr, int groups, bool vec) {
  extern __shared__ int ids[];  // the tile's roi indices, in order
  __shared__ RoiTables tabs[kChunk];
  __shared__ int list_len;

  const int tile = blockIdx.x;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int cell = t / groups;
  const int cy = cell / kTile;
  const int cx = cell % kTile;
  const int slab0 = blockIdx.y * groups * kVec;
  const int c = slab0 + (t % groups) * kVec;
  const int nc = max(0, min(kVec, channels - c));

  int li = 0;
  while (li + 1 < pyr.num_levels && tile >= pyr.tile_start[li + 1]) ++li;
  const int lt = tile - pyr.tile_start[li];
  const int hl = pyr.h[li];
  const int wl = pyr.w[li];
  const int level = pyr.level[li];
  const int ty0 = (lt / pyr.tiles_x[li]) * kTile;
  const int tx0 = (lt % pyr.tiles_x[li]) * kTile;
  const int tiles = pyr.tile_start[pyr.num_levels];
  const int yc = ty0 + cy;  // this thread's cell
  const int xc = tx0 + cx;
  const bool owner = yc < hl && xc < wl && nc > 0;
  T* out = static_cast<T*>(pyr.ptr[li]) +
           (static_cast<size_t>(b) * hl * wl + static_cast<size_t>(yc) * wl + xc) *
               channels + c;

  // The tile's list, bitset -> indices in order: warp 0, a word a lane.
  if (warp == 0) {
    const unsigned* list =
        lists + (static_cast<size_t>(b) * tiles + tile) * words;
    int base = 0;
    for (int w0 = 0; w0 < words; w0 += 32) {
      const int w = w0 + lane;
      unsigned bits = w < words ? list[w] : 0u;
      const int cnt = __popc(bits);
      int incl = cnt;
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      int pos = base + incl - cnt;
      while (bits) {
        ids[pos++] = (w << 5) + __ffs(bits) - 1;
        bits &= bits - 1;
      }
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) list_len = base;
  }
  __syncthreads();
  const int len = list_len;

  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
  // g / sr^2: when sr^2 is a power of two, the product with its exact
  // reciprocal is the same correctly rounded number as the quotient, and
  // an IEEE division costs some twenty instructions.
  const int count_i = sr * sr;
  const float count = static_cast<float>(count_i);
  const bool pow2 = (count_i & (count_i - 1)) == 0;
  const float inv_count = 1.0f / count;
  const int roi0 = b * rois_per_image;
  const size_t roi_elems = static_cast<size_t>(pooled) * pooled * channels;
  const int slab_bytes =
      static_cast<int>(sizeof(T)) * min(groups * kVec, channels - slab0);
  const int lines = (slab_bytes + 127) / 128;
  const int warps = blockDim.x / 32;

  for (int c0 = 0; c0 < len; c0 += kChunk) {
    const int m = min(kChunk, len - c0);
    // The chunk's tables, a warp a (roi, axis).
    for (int item = warp; item < 2 * m; item += warps) {
      const int axis = item % 2;
      build_axis(&tabs[item / 2], axis, roi_at(rois, roi0 + ids[c0 + item / 2]),
                 level, pooled, sr, axis == 0 ? hl : wl, axis == 0 ? ty0 : tx0,
                 lane);
    }
    __syncthreads();
    // The cotangent lines of the bins that reach the tile, for this slab,
    // into L1 ahead of the sums.
    for (int r = 0; r < m; ++r) {
      const RoiTables* tb = &tabs[r];
      if (tb->rlo[0] > tb->rhi[0] || tb->rlo[1] > tb->rhi[1]) continue;
      const int by0 = tb->rlo[0] / sr, bx0 = tb->rlo[1] / sr;
      const int nby = tb->rhi[0] / sr - by0 + 1;
      const int nbx = tb->rhi[1] / sr - bx0 + 1;
      const char* base = reinterpret_cast<const char*>(
          g + (roi0 + ids[c0 + r]) * roi_elems + slab0);
      for (int i = t; i < nby * nbx * lines; i += blockDim.x) {
        const int bin = (by0 + i / (nbx * lines)) * pooled + bx0 + (i / lines) % nbx;
        prefetch_l1(base + static_cast<size_t>(bin) * channels * sizeof(T) +
                    min((i % lines) * 128, slab_bytes - 1));
      }
    }
    for (int r = 0; owner && r < m; ++r) {
      const RoiTables* tb = &tabs[r];
      const int ylo = tb->lo[0][cy], yhi = tb->hi[0][cy];
      const int xlo = tb->lo[1][cx], xhi = tb->hi[1][cx];
      if (ylo > yhi || xlo > xhi) continue;
      const T* gr = g + (roi0 + ids[c0 + r]) * roi_elems + c;
      // Bins (py, px), then samples (iy, ix), then taps (u, v): the order
      // of every element's sum.
      for (int py = ylo / sr; py <= yhi / sr; ++py) {
        for (int px = xlo / sr; px <= xhi / sr; ++px) {
          float gs[kVec];
          load8(gr + static_cast<size_t>(py * pooled + px) * channels, vec, nc,
                gs);
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            gs[k] = pow2 ? gs[k] * inv_count : gs[k] / count;
          for (int iy = 0; iy < sr; ++iy) {
            const int sy = py * sr + iy;
            if (sy < ylo || sy > yhi) continue;
            const int yt[2] = {tb->t0[0][sy], tb->t1[0][sy]};
            const float yw[2] = {tb->w0[0][sy], tb->w1[0][sy]};
            for (int ix = 0; ix < sr; ++ix) {
              const int sx = px * sr + ix;
              if (sx < xlo || sx > xhi) continue;
              const int xt[2] = {tb->t0[1][sx], tb->t1[1][sx]};
              const float xw[2] = {tb->w0[1][sx], tb->w1[1][sx]};
#pragma unroll
              for (int u = 0; u < 2; ++u) {
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                  if (yt[u] == yc && xt[v] == xc) {
                    const float wt = yw[u] * xw[v];
#pragma unroll
                    for (int k = 0; k < kVec; ++k) acc[k] = acc[k] + gs[k] * wt;
                  }
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk rewrites the tables
  }
  if (owner) store8(out, vec, nc, acc);
}

int check_args(const GradPyramid& pyr, int pooled, int sampling_ratio) {
  if (pooled < 1 || pooled > kMaxPooled || sampling_ratio < 1 ||
      pooled * sampling_ratio > kMaxSamples || pyr.num_levels < 1 ||
      pyr.num_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Zero the lists and bin every roi into them.
int bin_rois(const GradPyramid& pyr, const void* rois, const void* level_idx,
             void* lists, int images, int rois_per_image, int pooled,
             int sampling_ratio, cudaStream_t s) {
  const int words = (rois_per_image + 31) / 32;
  const size_t bytes = sizeof(unsigned) * static_cast<size_t>(images) *
                       pyr.tile_start[pyr.num_levels] * words;
  cudaError_t err = cudaMemsetAsync(lists, 0, bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = images * rois_per_image;
  roi_tile_bins<<<(n + 127) / 128, 128, 0, s>>>(
      pyr, static_cast<const float*>(rois), static_cast<const int*>(level_idx),
      images, rois_per_image, pooled, sampling_ratio, words,
      static_cast<unsigned*>(lists));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_main(const GradPyramid& pyr, const void* rois, const void* lists,
                const void* g, int images, int rois_per_image, int channels,
                int pooled, int sampling_ratio, int groups, bool vec,
                cudaStream_t s) {
  const int tiles = pyr.tile_start[pyr.num_levels];
  // The roi indices sit beside the static tables; past 48 KB in all the
  // dynamic part needs the attribute, which any size may set.
  const size_t smem = sizeof(int) * static_cast<size_t>(rois_per_image);
  cudaError_t err = cudaFuncSetAttribute(
      roi_align_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slab = groups * kVec;
  const dim3 grid(tiles, (channels + slab - 1) / slab, images);
  roi_align_bwd<T><<<grid, kCells * groups, smem, s>>>(
      pyr, static_cast<const float*>(rois),
      static_cast<const unsigned*>(lists), (rois_per_image + 31) / 32,
      static_cast<const T*>(g), rois_per_image, channels, pooled,
      sampling_ratio, groups, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

MX_ERROR_STRING_EXPORT

// The tile edge the wrapper cuts each level into (grid x).
MX_EXPORT int roi_align_bwd_tile() { return kTile; }

// The binning pass alone: lists (images, tiles, ceil(R/32)) u32 out, the
// bit r % 32 of word r / 32 set when roi r may touch the tile.
MX_EXPORT int roi_tile_lists(GradPyramid pyr, const void* rois,
                             const void* level_idx, void* lists, int images,
                             int rois_per_image, int pooled,
                             int sampling_ratio, void* stream) {
  if (int rc = check_args(pyr, pooled, sampling_ratio)) return rc;
  if (images <= 0 || rois_per_image <= 0 || pyr.tile_start[pyr.num_levels] <= 0)
    return 0;
  return bin_rois(pyr, rois, level_idx, lists, images, rois_per_image, pooled,
                  sampling_ratio, static_cast<cudaStream_t>(stream));
}

// rois (N, 4) f32 in image coordinates, N = images * rois_per_image, rows
// 16-byte aligned; level_idx (N,) i32 indexing pyr's levels; g (N, S, S, C)
// in the feature dtype; lists scratch as for roi_tile_lists; pyr's maps
// (images, H, W, C) in the same dtype are written whole.  dtype: 0 =
// float32, 1 = bfloat16; groups: 8-channel groups a block (1..16, the
// channel slab is 8 * groups); vec: C is a multiple of 8 and g's rows are
// 16-byte aligned.
MX_EXPORT int roi_align_backward(GradPyramid pyr, const void* rois,
                                 const void* level_idx, const void* g,
                                 void* lists, int images, int rois_per_image,
                                 int channels, int pooled, int sampling_ratio,
                                 int dtype, int groups, int vec, void* stream) {
  if (int rc = check_args(pyr, pooled, sampling_ratio)) return rc;
  if ((dtype != 0 && dtype != 1) || groups < 1 || groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  if (images <= 0 || channels <= 0 || pyr.tile_start[pyr.num_levels] <= 0)
    return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rois_n = rois_per_image > 0 ? rois_per_image : 0;
  if (rois_n > 0) {
    if (int rc = bin_rois(pyr, rois, level_idx, lists, images, rois_n, pooled,
                          sampling_ratio, s))
      return rc;
  }
  if (dtype == 0) {
    return launch_main<float>(pyr, rois, lists, g, images, rois_n, channels,
                              pooled, sampling_ratio, groups, vec != 0, s);
  }
  return launch_main<__nv_bfloat16>(pyr, rois, lists, g, images, rois_n,
                                    channels, pooled, sampling_ratio, groups,
                                    vec != 0, s);
}
