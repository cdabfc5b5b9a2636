// expand: variable-multiplicity join expansion on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/relalg_ops/expand.py
// (expand_pallas, pallas_call at :108), which accumulates, per output lane,
// masked-compare sums over every input row (O(out_cap * n) compares)
// because the TPU has no cheap gather, and keeps its running cumsum in
// int32.
//
// Two steps per call:
//  (a) an inclusive int64 scan of max(hi - lo, 0) over each worker's row
//      into ``cum``, plus the unwrapped int64 total — the three-launch tile
//      scan of common.cuh, parallel over (tile of 8192 rows, worker).  int64
//      matters: the retry protocol reads ``total`` and virtual totals pass
//      2^31 (the int32 cum of the TPU kernel would wrap).
//  (b) expand_lanes: each block covers 2048 consecutive output lanes of one
//      worker.  Two threads binary-search ``cum`` for the rows producing the
//      block's first and last valid lane; every lane t < total then searches
//      only that row span (upper bound of t), so its loads hit the lines the
//      block shares in L1: left = that row, right_pos = lo[left] + t -
//      cum[left-1].  Lanes at or past the total are invalid; their
//      left/right_pos are unspecified (written as n-1 / 0) and every
//      consumer masks them.
//
// Bound on the card: bytes.  On the main path n reaches 2^20 rows per
// worker (the probe values of probe_and_reply), so the scan reads lo/hi
// twice and writes cum once (24 bytes a row) and the lane pass writes 9
// bytes a lane.  A first design scanned with one block per worker (8 of 132
// SMs at W = 8) and took most of the device time of the LUBM joins; the
// tile scan spreads it over the card.
#include "common.cuh"

namespace {

constexpr int kLaneThreads = 256;
constexpr int kLaneItems = 8;    // lanes per thread, strided by the block

// max(hi - lo, 0) of row i of worker w: the value expand scans.
struct RangeCount {
  const int32_t* lo;
  const int32_t* hi;
  int64_t n;
  __device__ int64_t operator()(int64_t w, int64_t i) const {
    const int64_t d = (int64_t)hi[w * n + i] - (int64_t)lo[w * n + i];
    return d > 0 ? d : 0;
  }
};

// Pass 3 of the scan: rescan one tile, add its base, write ``cum``.
__global__ void expand_cum(RangeCount f, const int64_t* __restrict__ base,
                           int64_t n_tiles, int64_t* __restrict__ cum) {
  __shared__ int64_t warp_sums[32];
  const int64_t w = blockIdx.y;
  const int64_t t = blockIdx.x;
  const int64_t n = f.n;
  const int64_t first =
      t * adhash::kScanTile + (int64_t)threadIdx.x * adhash::kScanItems;
  int64_t run[adhash::kScanItems];
  int64_t sum = 0;
#pragma unroll
  for (int k = 0; k < adhash::kScanItems; ++k) {
    if (first + k < n) sum += f(w, first + k);
    run[k] = sum;
  }
  int64_t tile_total;
  const int64_t before =
      adhash::block_inclusive_scan(sum, warp_sums, &tile_total) - sum +
      base[w * n_tiles + t];
#pragma unroll
  for (int k = 0; k < adhash::kScanItems; ++k)
    if (first + k < n) cum[w * n + first + k] = before + run[k];
}

__global__ void expand_lanes(const int32_t* __restrict__ lo,
                             const int64_t* __restrict__ cum,
                             const int64_t* __restrict__ total,
                             int32_t* __restrict__ left,
                             int32_t* __restrict__ right_pos,
                             uint8_t* __restrict__ valid, int64_t n,
                             int64_t out_cap) {
  __shared__ int64_t rows[2];  // rows producing the block's first/last lane
  const int64_t w = blockIdx.y;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x * kLaneItems;
  const int64_t tot = total[w];
  const int64_t* c = cum + w * n;
  if (t0 < tot && threadIdx.x < 2) {
    int64_t t = t0;
    if (threadIdx.x == 1) {  // the block's last valid lane
      t = t0 + (int64_t)blockDim.x * kLaneItems - 1;
      if (t > tot - 1) t = tot - 1;
    }
    rows[threadIdx.x] = adhash::upper_bound(c, 0, n, t);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kLaneItems; ++k) {
    const int64_t t = t0 + (int64_t)k * blockDim.x + threadIdx.x;
    if (t >= out_cap) break;
    const int64_t o = w * out_cap + t;
    if (t >= tot) {
      left[o] = (int32_t)(n - 1);
      right_pos[o] = 0;
      valid[o] = 0;
      continue;
    }
    // monotone: the producing row lies in [rows[0], rows[1]], and rows[1]
    // is at most n - 1 because cum[n-1] = tot > t
    const int64_t l = adhash::upper_bound(c, rows[0], rows[1], t);
    const int64_t start = l > 0 ? c[l - 1] : 0;
    left[o] = (int32_t)l;
    right_pos[o] = (int32_t)((int64_t)lo[w * n + l] + (t - start));
    valid[o] = 1;
  }
}

}  // namespace

// lo, hi: (W, n) int32; tile_sums: (W, ceil(n / 8192)) int64 scratch;
// cum: (W, n) int64 scratch; total: (W,) int64; left, right_pos:
// (W, out_cap) int32; valid: (W, out_cap) bool.  n >= 1.
extern "C" int adhash_expand(const void* lo, const void* hi, void* tile_sums,
                             void* cum, void* total, void* left,
                             void* right_pos, void* valid, int w, int64_t n,
                             int64_t out_cap, void* stream) {
  if (w == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const RangeCount f{(const int32_t*)lo, (const int32_t*)hi, n};
  const int64_t n_tiles = adhash::scan_tiles(n);
  int64_t* sums = (int64_t*)tile_sums;
  dim3 tgrid((unsigned)n_tiles, (unsigned)w);
  adhash::tile_sums<<<tgrid, adhash::kScanThreads, 0, s>>>(f, n, n_tiles,
                                                           sums);
  adhash::scan_tile_sums<<<w, adhash::kScanThreads, 0, s>>>(
      sums, n_tiles, (int64_t*)total);
  expand_cum<<<tgrid, adhash::kScanThreads, 0, s>>>(f, sums, n_tiles,
                                                    (int64_t*)cum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || out_cap == 0) return (int)err;
  const int64_t per_block = (int64_t)kLaneThreads * kLaneItems;
  dim3 grid((unsigned)((out_cap + per_block - 1) / per_block), (unsigned)w);
  expand_lanes<<<grid, kLaneThreads, 0, s>>>(
      (const int32_t*)lo, (const int64_t*)cum, (const int64_t*)total,
      (int32_t*)left, (int32_t*)right_pos, (uint8_t*)valid, n, out_cap);
  return (int)cudaGetLastError();
}
