// bucket_by_dest: stable per-destination send buffers on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/relalg_ops/bucket.py
// (bucket_by_dest_pallas, pallas_call at :103), which places rows with a
// (block_n x cap_peer) one-hot compare plane per destination because the
// TPU vector unit has no scatter.
//
// Contract: send is (W, n_dest, cap_peer, k); destination d's valid rows
// appear in their input order in slots [0, min(count_d, cap_peer)); every
// slot at or past count_d holds ``pad``; rows past cap_peer are dropped and
// counts (W, n_dest) report the unclamped number each destination wanted.
// Unordered atomic slot claims would break the input order, so placement
// is a stable counting sort in four launches:
//  1. bucket_hist    per (worker, tile of 1024 rows): shared-memory
//                    histogram of destinations (order-free, atomics fine).
//  2. bucket_scan    per worker: block-wide exclusive scan of the tile
//                    histograms, in tile order, one destination at a time
//                    -> each tile's base slot; the totals are the counts.
//  3. bucket_scatter per (worker, tile): stable rank inside the tile — a
//                    warp groups its lanes by destination with
//                    __match_any_sync and ranks each lane by the __popc of
//                    its lower peers; warps are scanned in order per
//                    destination in shared memory — then rows with
//                    rank < cap_peer are written to their slot.
//  4. bucket_pad     writes ``pad`` into every slot at or past the count.
//
// Bound on the card: bytes.  Rows are read twice (histogram, scatter) and
// written once; the scan and the ranks stay in shared memory and L2.  The
// scatter is coalesced within runs of one destination.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;  // rows per tile == threads per block

__global__ void bucket_hist(const int32_t* __restrict__ dest,
                            const uint8_t* __restrict__ valid,
                            int32_t* __restrict__ tile_counts, int64_t n,
                            int n_dest, int64_t n_tiles) {
  extern __shared__ int32_t hist[];
  const int64_t w = blockIdx.y;
  const int64_t tile = blockIdx.x;
  for (int d = threadIdx.x; d < n_dest; d += blockDim.x) hist[d] = 0;
  __syncthreads();
  const int64_t r = tile * kTile + threadIdx.x;
  if (r < n && valid[w * n + r]) {
    const int32_t d = dest[w * n + r];
    if (d >= 0 && d < n_dest) atomicAdd(&hist[d], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n_dest; d += blockDim.x)
    tile_counts[(w * n_tiles + tile) * n_dest + d] = hist[d];
}

__global__ void bucket_scan(int32_t* __restrict__ tile_counts,
                            int32_t* __restrict__ counts, int n_dest,
                            int64_t n_tiles) {
  __shared__ int32_t warp_sums[32];
  const int64_t w = blockIdx.x;
  for (int d = 0; d < n_dest; ++d) {
    int32_t carry = 0;
    for (int64_t base = 0; base < n_tiles; base += blockDim.x) {
      const int64_t t = base + threadIdx.x;
      int32_t* c = tile_counts + (w * n_tiles + t) * n_dest + d;
      const int32_t v = t < n_tiles ? *c : 0;
      int32_t base_total;
      const int32_t inc =
          adhash::block_inclusive_scan(v, warp_sums, &base_total);
      if (t < n_tiles) *c = carry + inc - v;  // exclusive, in tile order
      carry += base_total;
    }
    if (threadIdx.x == 0) counts[w * n_dest + d] = carry;
  }
}

template <int K>
__global__ void bucket_scatter(const int32_t* __restrict__ values,
                               const int32_t* __restrict__ dest,
                               const uint8_t* __restrict__ valid,
                               const int32_t* __restrict__ tile_base,
                               int32_t* __restrict__ send, int64_t n,
                               int n_dest, int64_t cap_peer,
                               int64_t n_tiles) {
  extern __shared__ int32_t warp_counts[];  // [n_warps][n_dest]
  const int64_t w = blockIdx.y;
  const int64_t tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int j = threadIdx.x; j < n_warps * n_dest; j += blockDim.x)
    warp_counts[j] = 0;
  __syncthreads();

  const int64_t r = tile * kTile + threadIdx.x;
  int32_t d = -1;
  if (r < n && valid[w * n + r]) {
    const int32_t dd = dest[w * n + r];
    if (dd >= 0 && dd < n_dest) d = dd;
  }
  // every lane takes part, including rows past n (d = -1)
  const unsigned peers = __match_any_sync(ADHASH_FULL_MASK, d);
  const int rank_in_warp = __popc(peers & ((1u << lane) - 1u));
  if (d >= 0 && lane == __ffs(peers) - 1)
    warp_counts[warp * n_dest + d] = __popc(peers);
  __syncthreads();
  // exclusive scan over warps, in warp order, per destination
  for (int dd = threadIdx.x; dd < n_dest; dd += blockDim.x) {
    int32_t run = 0;
    for (int wp = 0; wp < n_warps; ++wp) {
      const int32_t v = warp_counts[wp * n_dest + dd];
      warp_counts[wp * n_dest + dd] = run;
      run += v;
    }
  }
  __syncthreads();
  if (d < 0) return;
  const int64_t rank = (int64_t)tile_base[(w * n_tiles + tile) * n_dest + d] +
                       warp_counts[warp * n_dest + d] + rank_in_warp;
  if (rank >= cap_peer) return;
  const int32_t* src = values + (w * n + r) * K;
  int32_t* dst = send + ((w * n_dest + d) * cap_peer + rank) * K;
#pragma unroll
  for (int c = 0; c < K; ++c) dst[c] = src[c];
}

__global__ void bucket_pad(int32_t* __restrict__ send,
                           const int32_t* __restrict__ counts, int64_t slots,
                           int64_t cap_peer, int k, int32_t pad) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= slots) return;
  const int64_t wd = i / cap_peer;  // flat (worker, destination)
  const int64_t s = i - wd * cap_peer;
  if (s < counts[wd]) return;
  for (int c = 0; c < k; ++c) send[i * k + c] = pad;
}

}  // namespace

// values: (W, n, k) int32; dest: (W, n) int32; valid: (W, n) bool;
// tile_counts: (W, ceil(n/1024), n_dest) int32 scratch;
// counts: (W, n_dest) int32; send: (W, n_dest, cap_peer, k) int32.
// k is 1 or 3; n_dest at most 256.
extern "C" int adhash_bucket_by_dest(const void* values, const void* dest,
                                     const void* valid, void* tile_counts,
                                     void* counts, void* send, int w,
                                     int64_t n, int k, int n_dest,
                                     int64_t cap_peer, int pad,
                                     void* stream) {
  if (w == 0 || n_dest == 0) return (int)cudaSuccess;
  if (k != 1 && k != 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 0) {
    dim3 grid((unsigned)n_tiles, (unsigned)w);
    bucket_hist<<<grid, kTile, n_dest * sizeof(int32_t), s>>>(
        (const int32_t*)dest, (const uint8_t*)valid, (int32_t*)tile_counts,
        n, n_dest, n_tiles);
  }
  bucket_scan<<<w, 1024, 0, s>>>((int32_t*)tile_counts, (int32_t*)counts,
                                 n_dest, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    dim3 grid((unsigned)n_tiles, (unsigned)w);
    const size_t smem = (size_t)(kTile / 32) * n_dest * sizeof(int32_t);
    if (k == 1)
      bucket_scatter<1><<<grid, kTile, smem, s>>>(
          (const int32_t*)values, (const int32_t*)dest,
          (const uint8_t*)valid, (const int32_t*)tile_counts,
          (int32_t*)send, n, n_dest, cap_peer, n_tiles);
    else
      bucket_scatter<3><<<grid, kTile, smem, s>>>(
          (const int32_t*)values, (const int32_t*)dest,
          (const uint8_t*)valid, (const int32_t*)tile_counts,
          (int32_t*)send, n, n_dest, cap_peer, n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t slots = (int64_t)w * n_dest * cap_peer;
  if (slots > 0) {
    bucket_pad<<<(unsigned)((slots + 255) / 256), 256, 0, s>>>(
        (int32_t*)send, (const int32_t*)counts, slots, cap_peer, k, pad);
  }
  return (int)cudaGetLastError();
}
