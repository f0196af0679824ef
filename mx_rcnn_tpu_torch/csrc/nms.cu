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
// diagonal only: the sweep reads word w of row i only for w >= i / 64, so
// the words below the diagonal are neither written nor read.
//
// Kernel 2 sweeps one problem per block in chunks of 64 rows.  The
// chunk's mask rows (words w >= chunk) are staged in shared memory with
// cp.async, two buffers deep, so the next chunk's copy is in flight while
// this one resolves.  Every thread resolves the chunk's diagonal word in
// registers (64 dependent mask steps, their loads from shared memory issued
// ahead, no global wait; all threads compute the same word, so no barrier
// hands it out), then the
// threads OR the kept rows' words w > chunk into the shared "removed"
// bitset in parallel (OR is exact in any order).  One __syncthreads a
// chunk: the sequential part is n/64 chunk steps instead of n global round
// trips.  "removed" starts as ~valid, so padding and invalid rows are
// never kept.  Shared memory: 2 * 64 * ceil(n/64) words for the buffers
// (16 KB at n = 1000, 32 KB at n = 2000), which caps n near 14,000.

#include "common.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kSweepThreads = 256;
constexpr int kOrGroups = 8;  // kept rows split r % 8 across threads

// Tile t of the upper triangle (row-major over rows) of a cb x cb grid.
__device__ __forceinline__ void triangle_tile(int t, int cb, int* row,
                                              int* col) {
  int r = 0;
  while (t >= cb - r) {
    t -= cb - r;
    ++r;
  }
  *row = r;
  *col = r + t;
}

__global__ void nms_tile_masks(const float* __restrict__ boxes,
                               const uint8_t* __restrict__ valid, int n,
                               int col_blocks, float thresh,
                               unsigned long long* __restrict__ mask) {
  const int p = blockIdx.y;
  int row_block, col_block;
  triangle_tile(blockIdx.x, col_blocks, &row_block, &col_block);
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

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage chunk ``word``'s rows, words w >= word, as buf[r * (cb - word) +
// (w - word)].  Rows past n are left unwritten: they are never kept.
__device__ __forceinline__ void stage_chunk(
    unsigned long long* buf, const unsigned long long* __restrict__ m, int n,
    int cb, int word) {
  const int width = cb - word;
  const int rows = min(kTile, n - word * kTile);
  for (int k = threadIdx.x; k < rows * width; k += blockDim.x) {
    const int r = k / width;
    const int w = word + k % width;
    cp_async8(buf + k, m + static_cast<size_t>(word * kTile + r) * cb + w);
  }
  cp_async_commit();
}

// One block per problem; dynamic shared memory holds removed[cb] and two
// chunk buffers of 64 * cb words.
__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep(const uint8_t* __restrict__ valid, int n, int cb,
              const unsigned long long* __restrict__ mask,
              uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;
  unsigned long long* bufs = smem + cb;  // two buffers of kTile * cb words
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const uint8_t* v = valid + static_cast<size_t>(p) * n;
  const unsigned long long* m = mask + static_cast<size_t>(p) * n * cb;
  uint8_t* k = keep + static_cast<size_t>(p) * n;

  stage_chunk(bufs, m, n, cb, 0);
  // removed = ~valid, 64 rows a word, one warp a word.
  for (int w = warp; w < cb; w += kSweepThreads / 32) {
    const int i = w * kTile + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, i < n && v[i]);
    const unsigned hi = __ballot_sync(0xffffffffu, i + 32 < n && v[i + 32]);
    if (lane == 0)
      removed[w] = ~(static_cast<unsigned long long>(hi) << 32 | lo);
  }

  for (int word = 0; word < cb; ++word) {
    cp_async_wait_all();
    // This chunk's rows have landed, the previous chunk's ORs into
    // removed[] are visible, and the other buffer is no longer read.
    __syncthreads();
    if (word + 1 < cb)
      stage_chunk(bufs + ((word + 1) & 1) * kTile * cb, m, n, cb, word + 1);
    const unsigned long long* blk = bufs + (word & 1) * kTile * cb;
    const int width = cb - word;

    // Resolve the diagonal word: each kept row clears the later rows it
    // suppresses.  Every thread computes the same bits.  The loads do not
    // depend on ``alive``, so the unrolled loop issues them ahead and the
    // chain is one mask-and per row; rows past n (unstaged) are never
    // alive, so their words are masked out.
    unsigned long long alive = ~removed[word];
#pragma unroll 16
    for (int r = 0; r < kTile; ++r) {
      const unsigned long long live = 0ULL - ((alive >> r) & 1ULL);
      alive &= ~(blk[r * width] & live);
    }
    if (t < kTile && word * kTile + t < n)
      k[word * kTile + t] = static_cast<uint8_t>((alive >> t) & 1ULL);

    // OR the kept rows' words w > word into removed[]: thread item (w,
    // grp) takes rows grp, grp + 8, ..., eight independent loads.
    for (int item = t; item < (width - 1) * kOrGroups; item += blockDim.x) {
      const int w = 1 + item % (width - 1);
      const int grp = item / (width - 1);
      unsigned long long acc = 0;
#pragma unroll
      for (int q = 0; q < kTile / kOrGroups; ++q) {
        const int r = grp + kOrGroups * q;
        acc |= blk[r * width + w] & (0ULL - ((alive >> r) & 1ULL));
      }
      if (acc) atomicOr(&removed[word + w], acc);
    }
  }
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
  const size_t smem = sizeof(unsigned long long) *
                      (static_cast<size_t>(col_blocks) + 2 * kTile * col_blocks);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
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
  nms_sweep<<<problems, kSweepThreads, smem, s>>>(
      static_cast<const uint8_t*>(valid), n, col_blocks,
      static_cast<const unsigned long long*>(mask),
      static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
