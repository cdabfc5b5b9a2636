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
// Single-pass decoupled look-back (expand.cu, bucket.cu).  Tiles of a scan
// take their order from an atomic ticket, so a tile waits only on tiles
// that are already running.  Each tile owns one 64-bit state word per
// scanned quantity (expand: one; bucket_by_dest: one per destination): a
// flag in the top two bits and the value below them (values stay below
// 2^62).  A tile publishes its aggregate, then its inclusive prefix, each
// as one aligned 64-bit store of flag and value together, and readers load
// the whole word: a reader that sees a flag sees the value written with
// it, so no fence is needed between values and flags.  No other data is
// handed from tile to tile through these words.
constexpr unsigned long long kStateAggregate = 1ull << 62;
constexpr unsigned long long kStatePrefix = 2ull << 62;
constexpr unsigned long long kStateValue = kStateAggregate - 1;

__device__ __forceinline__ void publish_state(unsigned long long* p,
                                              unsigned long long flag,
                                              int64_t value) {
  *(volatile unsigned long long*)p = flag | (unsigned long long)value;
}

__device__ __forceinline__ unsigned long long read_state(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ int64_t warp_sum(int64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(ADHASH_FULL_MASK, v, o);
  return v;
}

// Sum of the values of tiles [0, tile), tile >= 1, by one whole warp; tile
// j's state word is states[j * stride].  Lane i reads tile - 1 - i, then
// 32 tiles further back each round; the walk stops at the nearest
// inclusive prefix, as soon as every tile between has published its
// aggregate.  The caller has published this tile's aggregate and
// publishes its prefix.
__device__ inline int64_t look_back(const unsigned long long* states,
                                   int64_t stride, int64_t tile) {
  const int lane = threadIdx.x & 31;
  int64_t excl = 0;
  for (int64_t j = tile - 1 - lane;; j -= 32) {
    unsigned long long st;
    unsigned prefixes, upto;
    while (true) {
      st = kStatePrefix;  // before tile 0: an empty prefix
      if (j >= 0) st = read_state(states + j * stride);
      const unsigned ready = __ballot_sync(ADHASH_FULL_MASK, st >> 62 != 0);
      prefixes = __ballot_sync(ADHASH_FULL_MASK, st >> 62 == 2);
      // the lanes up to the nearest prefix (bit 31 wraps to all lanes)
      upto = prefixes ? ((prefixes & (0u - prefixes)) << 1) - 1u
                      : ADHASH_FULL_MASK;
      if ((ready & upto) == upto) break;
    }
    excl += warp_sum((upto >> lane) & 1u ? (int64_t)(st & kStateValue) : 0);
    if (prefixes) break;
  }
  return excl;
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
// (W, n_tiles) scratch with the same tile (build.tiles().scan in Python).
// The build sets ADHASH_SCAN_ITEMS from the tuned table (kernels/tuning.py).
#ifndef ADHASH_SCAN_ITEMS
#define ADHASH_SCAN_ITEMS 8
#endif
constexpr int kScanThreads = 1024;
constexpr int kScanItems = ADHASH_SCAN_ITEMS;
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
