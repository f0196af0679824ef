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
//   * IoU with clamped areas, snapped to 2**-16, compared > thresh.
//
// Bound on the H100: the greedy chain's sequential dependence, not bytes
// (36 B a candidate in, 21 B out) and hardly arithmetic.  Design: one block
// per (image, level), candidates in shared memory, one barrier per greedy
// step i; in step i every thread tests its candidates j > i against box i
// when box i is still alive.  Blocks of different images and levels run in
// parallel on different SMs.

#include "common.cuh"

namespace {

constexpr float kXformClip = 4.135166556742356f;  // BBOX_XFORM_CLIP
constexpr int kMaxThreads = 1024;

__global__ void fused_middle(const float* __restrict__ anchors,
                             const float* __restrict__ deltas,
                             const float* __restrict__ scores,
                             const float* __restrict__ image_hw, int levels,
                             int k, float min_size, float thresh,
                             float* __restrict__ boxes_out,
                             float* __restrict__ scores_out,
                             uint8_t* __restrict__ keep_out) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + k;
  float* sx2 = sy1 + k;
  float* sy2 = sx2 + k;
  float* sarea = sy2 + k;
  uint8_t* alive = reinterpret_cast<uint8_t*>(sarea + k);

  const int problem = blockIdx.x;  // image * levels + level
  const int image = problem / levels;
  const float img_h = image_hw[image * 2 + 0];
  const float img_w = image_hw[image * 2 + 1];
  const size_t base = static_cast<size_t>(problem) * k;

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float* a = anchors + (base + j) * 4;
    const float* d = deltas + (base + j) * 4;
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
    const float x1 = snap_grid(fminf(fmaxf(cx - 0.5f * w, 0.0f), img_w), 256.0f);
    const float y1 = snap_grid(fminf(fmaxf(cy - 0.5f * h, 0.0f), img_h), 256.0f);
    const float x2 = snap_grid(fminf(fmaxf(cx + 0.5f * w, 0.0f), img_w), 256.0f);
    const float y2 = snap_grid(fminf(fmaxf(cy + 0.5f * h, 0.0f), img_h), 256.0f);
    const float bw = x2 - x1;
    const float bh = y2 - y1;
    const bool ok = min_size <= 0.0f ? (bw > 0.0f && bh > 0.0f)
                                     : (bw >= min_size && bh >= min_size);
    const float s = scores[base + j];
    float* o = boxes_out + (base + j) * 4;
    o[0] = x1;
    o[1] = y1;
    o[2] = x2;
    o[3] = y2;
    scores_out[base + j] = ok ? s : -INFINITY;
    sx1[j] = x1;
    sy1[j] = y1;
    sx2[j] = x2;
    sy2[j] = y2;
    sarea[j] = fmaxf(bw, 0.0f) * fmaxf(bh, 0.0f);
    alive[j] = (ok && isfinite(s)) ? 1 : 0;
  }

  for (int i = 0; i < k; ++i) {
    __syncthreads();  // alive[i] is final: only steps < i write it
    if (!alive[i]) continue;
    const float bx1 = sx1[i], by1 = sy1[i], bx2 = sx2[i], by2 = sy2[i];
    const float barea = sarea[i];
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
      if (!alive[j]) continue;
      const float iou = box_iou(bx1, by1, bx2, by2, barea, sx1[j], sy1[j],
                                sx2[j], sy2[j], sarea[j]);
      if (suppresses(iou, thresh)) alive[j] = 0;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    keep_out[base + j] = alive[j];
}

}  // namespace

MX_ERROR_STRING_EXPORT

// Shared memory a block needs for k candidates.
MX_EXPORT int fused_middle_smem_bytes(int k) {
  return k * (5 * static_cast<int>(sizeof(float)) + 1);
}

// anchors, deltas (B, L, k, 4) f32; scores (B, L, k) f32; image_hw (B, 2)
// f32 -> boxes (B, L, k, 4) f32, masked scores (B, L, k) f32, keep
// (B, L, k) u8.
MX_EXPORT int fused_middle_levels(const void* anchors, const void* deltas,
                                  const void* scores, const void* image_hw,
                                  void* boxes_out, void* scores_out,
                                  void* keep_out, int images, int levels,
                                  int k, float min_size, float thresh,
                                  void* stream) {
  if (images <= 0 || levels <= 0 || k <= 0) return 0;
  const int smem = fused_middle_smem_bytes(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_middle, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = min(kMaxThreads, ((k + 31) / 32) * 32);
  fused_middle<<<images * levels, threads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(anchors), static_cast<const float*>(deltas),
      static_cast<const float*>(scores), static_cast<const float*>(image_hw),
      levels, k, min_size, thresh, static_cast<float*>(boxes_out),
      static_cast<float*>(scores_out), static_cast<uint8_t*>(keep_out));
  return static_cast<int>(cudaGetLastError());
}
