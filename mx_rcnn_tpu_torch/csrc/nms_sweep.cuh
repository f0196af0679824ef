// The greedy NMS sweep over 64-bit suppression words, shared by kernels B4
// (nms.cu) and B3 (middle.cu).
//
// Both first write the suppression relation of each problem as words:
// mask[i * cb + w] bit c is set when row i (kept) removes row 64 * w + c,
// for the 64 x 64 tiles at or above the diagonal only (cb = ceil(n / 64);
// the words below the diagonal are neither written nor read).  The sweep
// then resolves one problem per block in chunks of 64 rows, in order:
//
//   for i in order:  alive[j > i] &= ~(alive[i] & mask[i, j])
//
// The chunk's mask rows (words w >= chunk) are staged in shared memory with
// cp.async, two buffers deep, so the next chunk's copy is in flight while
// this one resolves.  Every thread resolves the chunk's diagonal word in
// registers (64 dependent mask steps, their loads from shared memory issued
// ahead, no global wait; all threads compute the same word, so no barrier
// hands it out), then the threads OR the kept rows' words w > chunk into
// the shared "removed" bitset in parallel (OR is exact in any order).  One
// __syncthreads a chunk: the sequential part is n/64 chunk steps instead of
// n barriers or global round trips.  "removed" starts as ~valid, so rows
// that are not valid (padding, masked scores) are never kept.  Shared
// memory: 8 * (cb + 2 * 64 * cb) bytes (16.5 KB at n = 1000, 33 KB at
// n = 2000), which caps n at 14,400 (max_rows).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sweep {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kOrGroups = 8;  // kept rows split r % 8 across threads
constexpr int kMaxSmem = 227 * 1024;

// Shared memory of one sweep block: removed[cb] and two chunk buffers.
inline size_t smem_bytes(int cb) {
  return sizeof(unsigned long long) *
         (static_cast<size_t>(cb) + 2 * static_cast<size_t>(kTile) * cb);
}

// The most rows a problem may have: whole 64-row chunks whose sweep fits
// the shared memory a block can take.
inline int max_rows() {
  return kTile * static_cast<int>(kMaxSmem / (sizeof(unsigned long long) *
                                              (1 + 2 * kTile)));
}

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

// Sweep one problem with the whole block (kThreads threads): valid(i) says
// whether row i < n may keep and suppress, m is the problem's (n, cb) mask
// words, keep (n,) u8 out; smem holds smem_bytes(cb).
template <class Valid>
__device__ __forceinline__ void sweep_problem(
    Valid valid, int n, int cb, const unsigned long long* __restrict__ m,
    uint8_t* __restrict__ keep, unsigned long long* smem) {
  unsigned long long* removed = smem;
  unsigned long long* bufs = smem + cb;  // two buffers of kTile * cb words
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  stage_chunk(bufs, m, n, cb, 0);
  // removed = ~valid, 64 rows a word, one warp a word.
  for (int w = warp; w < cb; w += kThreads / 32) {
    const int i = w * kTile + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, i < n && valid(i));
    const unsigned hi =
        __ballot_sync(0xffffffffu, i + 32 < n && valid(i + 32));
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
      keep[word * kTile + t] = static_cast<uint8_t>((alive >> t) & 1ULL);

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

}  // namespace sweep
