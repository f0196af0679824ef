// The fused proposal middle (kernel B3): decode -> clip -> snap ->
// min-size mask -> greedy NMS, per (image, FPN level).
//
// Replaces mx_rcnn_tpu/ops/pallas/middle.py::fused_middle_levels
// (_middle_kernel).  The top-k front half stays in torch
// (ops/proposals.py::_topk_candidates); this kernel takes the candidates in
// top-k order -- scores descending, ties by ascending index -- so greedy
// NMS in positional order equals the plain chain's stable-argsort order
// (the contract of middle.py:12-27).  Its outputs are bitwise equal to
// ops/proposals.py::decode_candidates + ops/nms.py::nms_mask over the same
// candidates:
//   * decode with weights (1,1,1,1) and BBOX_XFORM_CLIP, every multiply and
//     add rounded on its own (--fmad=false) and expf (never __expf);
//   * clip to the image, snap to 1/256 px with rintf (half to even);
//   * w, h > 0 (or >= min_size) keeps the score, else -inf;
//   * IoU with clamped areas, snapped to 2**-16, compared > thresh;
//   * a candidate whose box fails the size test or whose score is not
//     finite (the -inf pad lanes) neither keeps nor suppresses.
//
// Bound on the H100: the greedy chain's sequential dependence, not bytes
// (36 B a candidate in, 21 B out) and hardly arithmetic (about 0.001 ms
// of decode and IoU tests at the serving shape, batch 2, 5 levels,
// k = 1000).  The floor is the sweep's ceil(k / 64) chunk steps.
//
// Design: two launches, B4's pattern (nms.cu), counted as one call by the
// wrapper.
//   (a) fused_middle_masks: one 64-thread block per (upper-triangle 64x64
//       tile, problem) -- 136 tiles x 10 problems at k = 1000.  The block
//       decodes its 64 column candidates into shared memory and each thread
//       its row candidate in registers (decoding is deterministic, so a
//       candidate decoded by several blocks has the same bits in each), and
//       writes the row's 64-bit suppression word for the tile.  The
//       diagonal tiles write ``boxes`` and the masked ``scores``, once each.
//   (b) fused_middle_sweep: the chunked sweep of nms_sweep.cuh, one block a
//       problem, reading a row's validity back as isfinite(masked score):
//       ceil(k / 64) chunk steps, one barrier each, where the kernel this
//       one replaced took a barrier per candidate.
// The word scratch is (problems, k, ceil(k / 64)) u64 from the wrapper,
// 128 KB a problem at k = 1000.

#include "common.cuh"
#include "nms_sweep.cuh"

namespace {

using sweep::kTile;

constexpr float kXformClip = 4.135166556742356f;  // BBOX_XFORM_CLIP

// A decoded candidate: its snapped box, its clamped area and whether it
// may keep and suppress.
struct Cand {
  float x1, y1, x2, y2, area;
  bool ok;  // passes the size test
  bool valid;
};

__device__ __forceinline__ Cand decode(const float* __restrict__ anchors,
                                       const float* __restrict__ deltas,
                                       float score, size_t j, float img_h,
                                       float img_w, float min_size) {
  const float* a = anchors + j * 4;
  const float* d = deltas + j * 4;
  const float aw = a[2] - a[0];
  const float ah = a[3] - a[1];
  const float ax = a[0] + 0.5f * aw;
  const float ay = a[1] + 0.5f * ah;
  const float dw = fminf(d[2], kXformClip);
  const float dh = fminf(d[3], kXformClip);
  const float cx = d[0] * aw + ax;
  const float cy = d[1] * ah + ay;
  const float w = expf(dw) * aw;
  const float h = expf(dh) * ah;
  Cand c;
  c.x1 = snap_grid(fminf(fmaxf(cx - 0.5f * w, 0.0f), img_w), 256.0f);
  c.y1 = snap_grid(fminf(fmaxf(cy - 0.5f * h, 0.0f), img_h), 256.0f);
  c.x2 = snap_grid(fminf(fmaxf(cx + 0.5f * w, 0.0f), img_w), 256.0f);
  c.y2 = snap_grid(fminf(fmaxf(cy + 0.5f * h, 0.0f), img_h), 256.0f);
  const float bw = c.x2 - c.x1;
  const float bh = c.y2 - c.y1;
  c.ok = min_size <= 0.0f ? (bw > 0.0f && bh > 0.0f)
                          : (bw >= min_size && bh >= min_size);
  c.area = fmaxf(bw, 0.0f) * fmaxf(bh, 0.0f);
  c.valid = c.ok && isfinite(score);
  return c;
}

__global__ void __launch_bounds__(kTile)
    fused_middle_masks(const float* __restrict__ anchors,
                       const float* __restrict__ deltas,
                       const float* __restrict__ scores,
                       const float* __restrict__ image_hw, int levels, int k,
                       int col_blocks, float min_size, float thresh,
                       float* __restrict__ boxes_out,
                       float* __restrict__ scores_out,
                       unsigned long long* __restrict__ mask) {
  const int p = blockIdx.y;  // image * levels + level
  int row_block, col_block;
  sweep::triangle_tile(blockIdx.x, col_blocks, &row_block, &col_block);
  const int image = p / levels;
  const float img_h = image_hw[image * 2 + 0];
  const float img_w = image_hw[image * 2 + 1];
  const size_t base = static_cast<size_t>(p) * k;

  __shared__ float cbox[kTile][5];
  __shared__ bool cvalid[kTile];
  const int t = threadIdx.x;
  const int col0 = col_block * kTile;
  const int cols = min(kTile, k - col0);
  const bool diagonal = row_block == col_block;
  Cand cj;
  if (t < cols) {
    const size_t j = base + col0 + t;
    const float s = scores[j];
    cj = decode(anchors, deltas, s, j, img_h, img_w, min_size);
    cbox[t][0] = cj.x1;
    cbox[t][1] = cj.y1;
    cbox[t][2] = cj.x2;
    cbox[t][3] = cj.y2;
    cbox[t][4] = cj.area;
    cvalid[t] = cj.valid;
    if (diagonal) {
      float* o = boxes_out + j * 4;
      o[0] = cj.x1;
      o[1] = cj.y1;
      o[2] = cj.x2;
      o[3] = cj.y2;
      scores_out[j] = cj.ok ? s : -INFINITY;
    }
  }
  __syncthreads();

  const int i = row_block * kTile + t;
  if (i >= k) return;
  const Cand ci = diagonal ? cj
                           : decode(anchors, deltas, scores[base + i],
                                    base + i, img_h, img_w, min_size);
  unsigned long long bits = 0;
  if (ci.valid) {
    for (int c = 0; c < cols; ++c) {
      const int j = col0 + c;
      if (j <= i || !cvalid[c]) continue;
      const float iou = box_iou(ci.x1, ci.y1, ci.x2, ci.y2, ci.area,
                                cbox[c][0], cbox[c][1], cbox[c][2],
                                cbox[c][3], cbox[c][4]);
      if (suppresses(iou, thresh)) bits |= 1ULL << c;
    }
  }
  mask[(base + i) * col_blocks + col_block] = bits;
}

// Whether candidate i may keep and suppress, read back from its masked
// score: finite exactly when the box passed the size test and the score
// was finite.
struct FiniteScore {
  const float* s;
  __device__ __forceinline__ bool operator()(int i) const {
    return isfinite(s[i]);
  }
};

__global__ void __launch_bounds__(sweep::kThreads)
    fused_middle_sweep(const float* __restrict__ scores_out, int k, int cb,
                       const unsigned long long* __restrict__ mask,
                       uint8_t* __restrict__ keep_out) {
  extern __shared__ unsigned long long smem[];
  const size_t p = blockIdx.x;
  sweep::sweep_problem(FiniteScore{scores_out + p * k}, k, cb,
                       mask + p * k * cb, keep_out + p * k, smem);
}

}  // namespace

MX_ERROR_STRING_EXPORT

// anchors, deltas (B, L, k, 4) f32; scores (B, L, k) f32; image_hw (B, 2)
// f32; mask scratch (B, L, k, ceil(k/64)) u64 (only the words at or above
// the diagonal are written) -> boxes (B, L, k, 4) f32, masked scores
// (B, L, k) f32, keep (B, L, k) u8.
MX_EXPORT int fused_middle_levels(const void* anchors, const void* deltas,
                                  const void* scores, const void* image_hw,
                                  void* mask, void* boxes_out,
                                  void* scores_out, void* keep_out,
                                  int images, int levels, int k,
                                  float min_size, float thresh,
                                  void* stream) {
  if (images <= 0 || levels <= 0 || k <= 0) return 0;
  if (k > sweep::max_rows()) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int problems = images * levels;
  const int col_blocks = (k + kTile - 1) / kTile;
  const dim3 grid(col_blocks * (col_blocks + 1) / 2, problems);
  fused_middle_masks<<<grid, kTile, 0, s>>>(
      static_cast<const float*>(anchors), static_cast<const float*>(deltas),
      static_cast<const float*>(scores), static_cast<const float*>(image_hw),
      levels, k, col_blocks, min_size, thresh, static_cast<float*>(boxes_out),
      static_cast<float*>(scores_out),
      static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sweep::smem_bytes(col_blocks);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_middle_sweep,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_middle_sweep<<<problems, sweep::kThreads, smem, s>>>(
      static_cast<const float*>(scores_out), k, col_blocks,
      static_cast<const unsigned long long*>(mask),
      static_cast<uint8_t*>(keep_out));
  return static_cast<int>(cudaGetLastError());
}
