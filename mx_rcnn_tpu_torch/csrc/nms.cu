// Greedy NMS keep mask over score-sorted boxes (kernel B4).
//
// Replaces mx_rcnn_tpu/ops/pallas/nms.py::nms_mask_pallas (_nms_kernel).
// The stable score sort stays outside, in the wrapper
// (ops/cuda/nms.py), as it does around the Pallas kernel; this file takes
// the sorted boxes and their valid flags of P independent problems (the
// batch and the FPN levels folded together) and returns each keep mask in
// sorted order:
//
//   for i in order:  alive[j > i] &= ~(alive[i] & snap16(iou(i, j)) > t)
//
// Invalid lanes neither keep nor suppress.  The area of a box is
// (x2 - x1) * (y2 - y1), unclamped, as in the Pallas kernel (nms.py:101).
//
// Bound on the H100: neither bytes (16 B a box) nor arithmetic (a few
// hundred thousand IoUs, some microseconds of the card's float32 rate):
// the greedy chain's dependence, row after row, is the floor.  So the
// sequential part must touch fast memory only.
//
// Kernel 1 computes the suppression relation as 64-bit masks, one block a
// 64x64 tile and one thread a row, over the tiles at or above the
// diagonal only.  Kernel 2 is the chunked sweep of nms_sweep.cuh (shared
// with B3), one block a problem: n/64 chunk steps, one barrier each.
// The wrapper counts one call, two launches, as one.

#include "common.cuh"
#include "nms_sweep.cuh"

namespace {

using sweep::kTile;

__global__ void nms_tile_masks(const float* __restrict__ boxes,
                               const uint8_t* __restrict__ valid, int n,
                               int col_blocks, float thresh,
                               unsigned long long* __restrict__ mask) {
  const int p = blockIdx.y;
  int row_block, col_block;
  sweep::triangle_tile(blockIdx.x, col_blocks, &row_block, &col_block);
  const float* b = boxes + static_cast<size_t>(p) * n * 4;
  const uint8_t* v = valid + static_cast<size_t>(p) * n;

  __shared__ float cb[kTile][5];
  __shared__ uint8_t cv[kTile];
  const int t = threadIdx.x;
  const int col0 = col_block * kTile;
  const int cols = min(kTile, n - col0);
  if (t < cols) {
    const float* q = b + (col0 + t) * 4;
    cb[t][0] = q[0];
    cb[t][1] = q[1];
    cb[t][2] = q[2];
    cb[t][3] = q[3];
    cb[t][4] = (q[2] - q[0]) * (q[3] - q[1]);
    cv[t] = v[col0 + t];
  }
  __syncthreads();

  const int i = row_block * kTile + t;
  if (i >= n) return;
  unsigned long long bits = 0;
  if (v[i]) {
    const float* r = b + i * 4;
    const float x1 = r[0], y1 = r[1], x2 = r[2], y2 = r[3];
    const float area = (x2 - x1) * (y2 - y1);
    for (int c = 0; c < cols; ++c) {
      const int j = col0 + c;
      if (j <= i || !cv[c]) continue;
      const float iou = box_iou(x1, y1, x2, y2, area, cb[c][0], cb[c][1],
                                cb[c][2], cb[c][3], cb[c][4]);
      if (suppresses(iou, thresh)) bits |= 1ULL << c;
    }
  }
  mask[(static_cast<size_t>(p) * n + i) * col_blocks + col_block] = bits;
}

// Whether row i of a problem may keep and suppress: its valid byte.
struct ByteValid {
  const uint8_t* v;
  __device__ __forceinline__ bool operator()(int i) const { return v[i] != 0; }
};

// One block per problem; dynamic shared memory holds sweep::smem_bytes(cb).
__global__ void __launch_bounds__(sweep::kThreads)
    nms_sweep(const uint8_t* __restrict__ valid, int n, int cb,
              const unsigned long long* __restrict__ mask,
              uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  const int p = blockIdx.x;
  sweep::sweep_problem(ByteValid{valid + static_cast<size_t>(p) * n}, n, cb,
                       mask + static_cast<size_t>(p) * n * cb,
                       keep + static_cast<size_t>(p) * n, smem);
}

}  // namespace

MX_ERROR_STRING_EXPORT

// boxes (P, n, 4) f32 sorted by score, valid (P, n) u8 in the same order,
// mask scratch (P, n, ceil(n/64)) u64 (only the words at or above the
// diagonal are written), keep (P, n) u8 out.
MX_EXPORT int nms_keep_sorted(const void* boxes, const void* valid,
                              void* mask, void* keep, int problems, int n,
                              float thresh, void* stream) {
  if (problems <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kTile - 1) / kTile;
  const size_t smem = sweep::smem_bytes(col_blocks);
  if (n > sweep::max_rows()) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(col_blocks * (col_blocks + 1) / 2, problems);
  nms_tile_masks<<<grid, kTile, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid), n,
      col_blocks, thresh, static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_sweep,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_sweep<<<problems, sweep::kThreads, smem, s>>>(
      static_cast<const uint8_t*>(valid), n, col_blocks,
      static_cast<const unsigned long long*>(mask),
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
