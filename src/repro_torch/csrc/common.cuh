// Shared device helpers of the AdHash Hopper kernels (sm_90a).
//
// Every kernel of this directory takes the worker axis W as a grid
// dimension (blockIdx.y, or blockIdx.x for one-block-per-worker passes) and
// is exported through a plain C function that launches on the caller's
// stream and returns cudaGetLastError(), so the Python wrapper can raise on
// a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ADHASH_FULL_MASK 0xffffffffu

namespace adhash {

// Inclusive prefix sum over one warp.
template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T n = __shfl_up_sync(ADHASH_FULL_MASK, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Inclusive prefix sum over the block (blockDim.x a multiple of 32, at most
// 1024).  ``warp_sums`` is shared scratch of 32 entries; ``*total`` receives
// the block-wide sum.  Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ T block_inclusive_scan(T v, T* warp_sums,
                                                  T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_inclusive_scan(v);
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T s = lane < n_warps ? warp_sums[lane] : T(0);
    s = warp_inclusive_scan(s);
    warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return v;
}

// First index i in [lo, hi) with a[i] >= x (a sorted ascending).
template <typename T, typename K>
__device__ __forceinline__ int64_t lower_bound(const T* a, int64_t lo,
                                               int64_t hi, K x) {
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First index i in [lo, hi) with a[i] > x (a sorted ascending).
template <typename T, typename K>
__device__ __forceinline__ int64_t upper_bound(const T* a, int64_t lo,
                                               int64_t hi, K x) {
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// Per-worker scan over tiles, in parallel across the whole card.  A scan of
// f(w, i) over i < n for every worker w runs as
//   1. tile_sums       grid (n_tiles, W): the sum of each tile of kScanTile
//                      elements;
//   2. scan_tile_sums  grid (W): exclusive scan of each worker's tile sums
//                      in place (tile order), and the worker's total;
//   3. a kernel of the caller, grid (n_tiles, W), that rescans its tile
//      with block_inclusive_scan and adds the tile's base.
// Each thread takes kScanItems consecutive elements.  The wrappers size the
// (W, n_tiles) scratch with the same tile (SCAN_TILE in Python).
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;
constexpr int64_t kScanTile = (int64_t)kScanThreads * kScanItems;

inline int64_t scan_tiles(int64_t n) { return (n + kScanTile - 1) / kScanTile; }

namespace {

template <typename F>
__global__ void tile_sums(F f, int64_t n, int64_t n_tiles,
                          int64_t* __restrict__ sums) {
  __shared__ int64_t warp_sums[32];
  const int64_t w = blockIdx.y;
  const int64_t t = blockIdx.x;
  const int64_t first = t * kScanTile + (int64_t)threadIdx.x * kScanItems;
  int64_t s = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    if (first + k < n) s += f(w, first + k);
  int64_t total;
  block_inclusive_scan(s, warp_sums, &total);
  if (threadIdx.x == 0) sums[w * n_tiles + t] = total;
}

__global__ void scan_tile_sums(int64_t* __restrict__ sums, int64_t n_tiles,
                               int64_t* __restrict__ totals) {
  __shared__ int64_t warp_sums[32];
  const int64_t w = blockIdx.x;
  int64_t carry = 0;
  for (int64_t base = 0; base < n_tiles; base += blockDim.x) {
    const int64_t t = base + threadIdx.x;
    const int64_t v = t < n_tiles ? sums[w * n_tiles + t] : 0;
    int64_t chunk;
    const int64_t inc = block_inclusive_scan(v, warp_sums, &chunk);
    if (t < n_tiles) sums[w * n_tiles + t] = carry + inc - v;
    carry += chunk;
  }
  if (threadIdx.x == 0) totals[w] = carry;
}

}  // namespace

}  // namespace adhash
