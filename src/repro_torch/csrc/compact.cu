// unique_compact: per-worker sort + dedupe + compact on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/relalg_ops/compact.py
// (unique_compact_pallas :72, pallas_call at :93), which sorts the whole
// row in VMEM with an unrolled bitonic network twice (once to sort, once to
// compact) because the TPU vector unit has no gather or scatter.
//
// Contract: key invalid slots to ``pad`` (strictly above every valid
// value), sort each worker's row, keep the first occurrence of each valid
// value, compact the survivors to a prefix of ``out_cap`` and pad the rest;
// n_unique (int64) counts every unique value, also those past out_cap.
// int32 and int64 keys; the whole output is specified.
//
// Bound on the card: bytes.  The function reads W*n keys and flags and
// writes W*out_cap keys; at the main path's row (n ~ 2^18 per worker, W = 8)
// that is a few microseconds of HBM time, and the rows fit in L2.  What
// costs is the sort, so it is an LSD radix sort over 8-bit digits (Hopper
// scatters freely; the TPU's bitonic network was a workaround), segmented
// by worker row, grid (tiles of 4096 keys, W):
//  1. radix_hist_raw  one read of the row: flips the sign bit (unsigned
//                     order == signed order) and counts every digit of the
//                     *valid* slots per tile into the row's bin totals.
//                     Invalid slots would all be ``pad``, which sorts last
//                     and which dedupe drops, so they are left out of every
//                     count and every scatter: the sorted row is the first
//                     V (valid count) slots of a buffer, nothing past it is
//                     read, and pad's high bits never block a digit skip.
//  2. radix_plan      per row: V, each digit's bin bases (exclusive scan
//                     of the row's bin totals) and the digits to skip: a
//                     digit with one bin holding the whole row moves
//                     nothing.  Decided on the device, no host sync; LUBM's
//                     small non-negative ids skip the top digit, int64 rows
//                     more.
//  3. per digit       radix_hist (the tiles' bin counts of the row as it
//                     now lies; digit 0 keeps pass 1's) and radix_scatter:
//                     a tile ranks its keys stably in shared memory
//                     (rank_tile: each warp groups its lanes by digit with
//                     __match_any_sync and ranks by __popc, as bucket.cu
//                     does; warps and rounds in order), adds the earlier
//                     tiles' counts to the bin base, lays the tile out by
//                     digit in shared memory and writes each bin's run
//                     contiguously.  Ping-pong buffers; the lowest digit
//                     always runs (it drops the invalid slots), a skipped
//                     digit returns at once.
//  4. the card-wide tile scan of common.cuh counts the first occurrences
//     (x != prev) among the first V slots; each tile writes its survivors
//     below out_cap, and a last launch pads every slot past n_unique.
// A row of one tile (n <= 4096) takes every digit in one launch
// (radix_sort_tile, the same ranking, the tile kept in shared memory).
// At int32 a row of many tiles takes at most 4 scatter passes, each reading
// and writing the row once, in 14 launches; a row of one tile 5 launches.
// Budget (ptxas -v, sm_90a): 256 threads a block; radix_scatter 80 (int32)
// and 96 (int64) registers with 26 and 43 KB of shared memory,
// radix_sort_tile 88 and 113 registers with 25 and 42 KB; no spills.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;              // radix passes: one bin a thread
constexpr int kWarps = kThreads / 32;
// keys per thread; the build sets ADHASH_RADIX_ITEMS from the tuned table
// (kernels/tuning.py), and the wrapper sizes its histograms with the same
// tile (build.tiles().radix)
#ifndef ADHASH_RADIX_ITEMS
#define ADHASH_RADIX_ITEMS 16
#endif
constexpr int kItems = ADHASH_RADIX_ITEMS;
constexpr int kTile = kThreads * kItems;   // 4096 keys per tile by default
constexpr int kWarpKeys = kTile / kWarps;  // 512 consecutive keys per warp
constexpr int kBins = 256;
constexpr int kNone = kBins;               // digit of an empty slot

template <typename T>
struct Radix;
template <>
struct Radix<int32_t> {
  using U = uint32_t;
  static constexpr int kDigits = 4;
};
template <>
struct Radix<int64_t> {
  using U = uint64_t;
  static constexpr int kDigits = 8;
};

// Digit d of x in unsigned order (sign bit flipped).
template <typename T>
__device__ __forceinline__ int digit_of(T x, int d) {
  using U = typename Radix<T>::U;
  const U u = (U)x ^ ((U)1 << (8 * sizeof(T) - 1));
  return (int)((u >> (8 * d)) & 0xFF);
}

// Passes that ran before digit d's (d >= 1): digit 0 always runs, digit
// d' in [1, d) unless skipped.  Pass k reads buffer (k - 1) & 1 and writes
// buffer k & 1; pass 0 reads the input.
__device__ __forceinline__ int passes_before(unsigned skip, int d) {
  return 1 + __popc(~skip & ((1u << d) - 2u));
}

// Add one to bin dg of ``hist`` for every lane, one shared atomic per
// distinct digit of the warp (a row's high digits are often all equal).
__device__ __forceinline__ void warp_count(int32_t* hist, int dg) {
  const unsigned peers = __match_any_sync(ADHASH_FULL_MASK, dg);
  if (dg != kNone && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[dg], __popc(peers));
}

// Shared memory of a stable tile ranking.
struct RankSmem {
  int32_t wcnt[kWarps][kBins];  // per warp counts, then warp offsets
  int32_t start[kBins];         // first slot of each bin in the tile
  int32_t warp_sums[32];
};

// Stable rank of a tile's keys by one digit.  Lane ``lane`` of warp
// ``warp`` holds keys warp * 512 + r * 32 + lane (r < kItems), in tile
// order; dg[r] is a key's digit, kNone for an empty slot.  Returns the
// tile's key count; slot[r] is key r's slot in the tile laid out by digit
// (stable), and ``cnt`` is bin ``threadIdx.x``'s count.  Every thread of
// the block must call it.
__device__ __forceinline__ int32_t rank_tile(const int (&dg)[kItems],
                                             int32_t (&slot)[kItems],
                                             int32_t& cnt, RankSmem& sm) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int i = tid; i < kWarps * kBins; i += kThreads)
    (&sm.wcnt[0][0])[i] = 0;
  __syncthreads();
  // each warp ranks its 512 keys, 32 at a time, in order
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const unsigned peers = __match_any_sync(ADHASH_FULL_MASK, dg[r]);
    const int before = __popc(peers & ((1u << lane) - 1u));
    const int32_t run = dg[r] != kNone ? sm.wcnt[warp][dg[r]] : 0;
    __syncwarp();
    if (dg[r] != kNone && before == 0)
      sm.wcnt[warp][dg[r]] = run + __popc(peers);
    __syncwarp();
    slot[r] = run + before;
  }
  __syncthreads();
  // per bin (one a thread): warps' offsets in warp order, the bin's start
  cnt = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    const int32_t c = sm.wcnt[q][tid];
    sm.wcnt[q][tid] = cnt;
    cnt += c;
  }
  int32_t total;
  sm.start[tid] =
      adhash::block_inclusive_scan(cnt, sm.warp_sums, &total) - cnt;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r)
    if (dg[r] != kNone) slot[r] += sm.start[dg[r]] + sm.wcnt[warp][dg[r]];
  return total;
}

// The int32 scratch of a call, per worker w:
//   info[w * 4 + 0]   V, the row's valid count
//   info[w * 4 + 1]   bit mask of the skipped digits
//   info[w * 4 + 2]   buffer that holds the sorted row
//   base[(w * D + d) * 256 + b]       first slot of bin b of digit d
//   hist[((w * D + d) * n_tiles + t) * 256 + b]   keys of tile t in bin b
// and, zeroed by the caller, tot[(w * D + d) * 256 + b]: the row's keys in
// bin b of digit d.

// A row of one tile (n <= 4096): every digit in shared memory, one launch.
// Digit 0 drops the invalid slots; a later digit whose keys all share one
// bin is skipped.  Writes the sorted row to buffer 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
radix_sort_tile(const T* __restrict__ values, const uint8_t* __restrict__ valid,
                T* __restrict__ keys, int32_t* __restrict__ info, int64_t n) {
  constexpr int D = Radix<T>::kDigits;
  __shared__ RankSmem sm;
  __shared__ T sorted[kTile];
  const int64_t w = blockIdx.x;
  const int first = (threadIdx.x >> 5) * kWarpKeys + (threadIdx.x & 31);
  T x[kItems];
  int dg[kItems];
  int32_t slot[kItems];
  int32_t cnt;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int p = first + r * 32;
    const bool ok = p < n && valid[w * n + p];
    x[r] = ok ? values[w * n + p] : T(0);
    dg[r] = ok ? digit_of(x[r], 0) : kNone;
  }
  int32_t v = 0;
#pragma unroll 1
  for (int d = 0; d < D; ++d) {
    if (d > 0) {
#pragma unroll
      for (int r = 0; r < kItems; ++r)
        dg[r] = first + r * 32 < v ? digit_of(x[r], d) : kNone;
    }
    const int32_t total = rank_tile(dg, slot, cnt, sm);
    if (d == 0) v = total;
    else if (__syncthreads_or(cnt == v)) continue;  // one bin: no move
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kItems; ++r)
      if (dg[r] != kNone) sorted[slot[r]] = x[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kItems; ++r) x[r] = sorted[first + r * 32];
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r)
    if (first + r * 32 < v) keys[w * n + first + r * 32] = x[r];
  if (threadIdx.x == 0) {
    info[w * 4 + 0] = v;
    info[w * 4 + 2] = 0;
  }
}

// Pass 1 of a row of many tiles: count every digit of the valid slots per
// tile; keep digit 0's per-tile counts and add every digit's into the row
// totals.
template <typename T>
__global__ void __launch_bounds__(kThreads)
radix_hist_raw(const T* __restrict__ values, const uint8_t* __restrict__ valid,
               int32_t* __restrict__ hist, int32_t* __restrict__ tot,
               int64_t n, int64_t n_tiles) {
  constexpr int D = Radix<T>::kDigits;
  __shared__ int32_t sh[D][kBins];
  const int64_t w = blockIdx.y;
  const int64_t t = blockIdx.x;
  for (int i = threadIdx.x; i < D * kBins; i += kThreads) (&sh[0][0])[i] = 0;
  __syncthreads();
#pragma unroll 4
  for (int it = 0; it < kItems; ++it) {
    const int64_t p = t * kTile + it * kThreads + threadIdx.x;
    const bool ok = p < n && valid[w * n + p];
    const T x = ok ? values[w * n + p] : T(0);
#pragma unroll
    for (int d = 0; d < D; ++d) warp_count(sh[d], ok ? digit_of(x, d) : kNone);
  }
  __syncthreads();
  hist[(w * D * n_tiles + t) * kBins + threadIdx.x] = sh[0][threadIdx.x];
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (sh[d][threadIdx.x] != 0)
      atomicAdd(&tot[(w * D + d) * kBins + threadIdx.x], sh[d][threadIdx.x]);
}

// Pass 2, one block per row: V, the bin bases of every digit, the skips.
template <typename T>
__global__ void __launch_bounds__(kThreads)
radix_plan(int32_t* __restrict__ info, int32_t* __restrict__ bin_base,
           const int32_t* __restrict__ tot) {
  constexpr int D = Radix<T>::kDigits;
  __shared__ int32_t warp_sums[32];
  const int64_t w = blockIdx.x;
  const int b = threadIdx.x;
  int32_t v = 0;
  unsigned skip = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int32_t c = tot[(w * D + d) * kBins + b];
    int32_t all;
    const int32_t inc = adhash::block_inclusive_scan(c, warp_sums, &all);
    bin_base[(w * D + d) * kBins + b] = inc - c;
    if (d == 0) v = all;  // every digit's bins hold the same V keys
    else if (__syncthreads_or(c == v)) skip |= 1u << d;
  }
  if (b == 0) {
    info[w * 4 + 0] = v;
    info[w * 4 + 1] = (int32_t)skip;
    info[w * 4 + 2] = (passes_before(skip, D) - 1) & 1;
  }
}

// Per-tile bin counts of digit d (>= 1) over the row as it now lies.
template <typename T>
__global__ void __launch_bounds__(kThreads)
radix_hist(const T* __restrict__ keys, const int32_t* __restrict__ info,
           int32_t* __restrict__ hist, int64_t n, int64_t n_tiles, int d) {
  constexpr int D = Radix<T>::kDigits;
  __shared__ int32_t sh[kBins];
  const int64_t w = blockIdx.y;
  const int64_t t = blockIdx.x;
  const unsigned skip = (unsigned)info[w * 4 + 1];
  const int64_t v = info[w * 4];
  if ((skip >> d) & 1u || t * kTile >= v) return;
  const T* src = keys + ((passes_before(skip, d) - 1) & 1) * gridDim.y * n +
                 w * n;
  sh[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll 4
  for (int it = 0; it < kItems; ++it) {
    const int64_t p = t * kTile + it * kThreads + threadIdx.x;
    warp_count(sh, p < v ? digit_of(src[p], d) : kNone);
  }
  __syncthreads();
  hist[((w * D + d) * n_tiles + t) * kBins + threadIdx.x] = sh[threadIdx.x];
}

// Scatter one tile of a row of many tiles by digit d, stably.  Digit 0
// reads the input and drops the invalid slots; a later digit reads the
// previous pass's buffer.
template <typename T>
__global__ void __launch_bounds__(kThreads)
radix_scatter(const T* __restrict__ values, const uint8_t* __restrict__ valid,
              T* __restrict__ keys, const int32_t* __restrict__ info,
              const int32_t* __restrict__ bin_base,
              const int32_t* __restrict__ hist, int64_t n, int64_t n_tiles,
              int d) {
  constexpr int D = Radix<T>::kDigits;
  __shared__ RankSmem sm;
  __shared__ int32_t dst_base[kBins];  // global slot of the tile's slot 0
  __shared__ T sorted[kTile];          // the tile laid out by digit
  const int64_t w = blockIdx.y;
  const int64_t t = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t plane = gridDim.y * n;  // one (W, n) buffer
  const T* src;
  T* dst;
  int64_t limit;
  if (d == 0) {
    src = values + w * n;
    dst = keys + w * n;
    limit = n;
  } else {
    const unsigned skip = (unsigned)info[w * 4 + 1];
    if ((skip >> d) & 1u) return;
    const int k = passes_before(skip, d);
    src = keys + ((k - 1) & 1) * plane + w * n;
    dst = keys + (k & 1) * plane + w * n;
    limit = info[w * 4];
  }
  if (t * kTile >= limit) return;
  const int64_t first = t * kTile + (tid >> 5) * kWarpKeys + (tid & 31);
  T x[kItems];
  int dg[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t p = first + r * 32;
    bool ok = p < limit;
    if (d == 0 && ok) ok = valid[w * n + p];
    x[r] = ok ? src[p] : T(0);
    dg[r] = ok ? digit_of(x[r], d) : kNone;
  }
  int32_t slot[kItems];
  int32_t cnt;
  const int32_t total = rank_tile(dg, slot, cnt, sm);
  // global slot of the tile's run of bin tid: the bin's base plus the keys
  // of the earlier tiles
  const int32_t* col = hist + (w * D + d) * n_tiles * kBins + tid;
  int32_t g = bin_base[(w * D + d) * kBins + tid];
#pragma unroll 8
  for (int64_t q = 0; q < t; ++q) g += col[q * kBins];
  dst_base[tid] = g - sm.start[tid];
#pragma unroll
  for (int r = 0; r < kItems; ++r)
    if (dg[r] != kNone) sorted[slot[r]] = x[r];
  __syncthreads();
  for (int j = tid; j < total; j += kThreads) {
    const T y = sorted[j];
    dst[dst_base[digit_of(y, d)] + j] = y;
  }
}

// 1 where slot i of worker w's sorted row is the first occurrence of a
// valid value: the flag the compaction scans.  The sorted row is the first
// V slots of the buffer radix_plan names.
template <typename T>
struct FirstOccurrence {
  const T* keys;
  int64_t plane;
  int64_t n;
  const int32_t* info;
  __device__ const T* row(int64_t w) const {
    return keys + info[w * 4 + 2] * plane + w * n;
  }
  __device__ int64_t operator()(int64_t w, int64_t i) const {
    if (i >= info[w * 4]) return 0;
    const T* r = row(w);
    return i == 0 || r[i] != r[i - 1];
  }
};

// Pass 3 of the tile scan: rescan one tile's flags, add the tile's base,
// write its survivors that land below out_cap.
template <typename T>
__global__ void compact_tile(FirstOccurrence<T> f,
                             const int64_t* __restrict__ base,
                             int64_t n_tiles, int64_t n_scan,
                             T* __restrict__ uniq, int64_t out_cap) {
  __shared__ int64_t warp_sums[32];
  const int64_t w = blockIdx.y;
  const int64_t t = blockIdx.x;
  const int64_t first =
      t * adhash::kScanTile + (int64_t)threadIdx.x * adhash::kScanItems;
  int64_t flag[adhash::kScanItems];
  int64_t cnt = 0;
#pragma unroll
  for (int k = 0; k < adhash::kScanItems; ++k) {
    flag[k] = first + k < n_scan ? f(w, first + k) : 0;
    cnt += flag[k];
  }
  int64_t tile_total;
  int64_t pos = adhash::block_inclusive_scan(cnt, warp_sums, &tile_total) -
                cnt + base[w * n_tiles + t];
  const T* row = f.row(w);
#pragma unroll
  for (int k = 0; k < adhash::kScanItems; ++k) {
    if (flag[k]) {
      if (pos < out_cap) uniq[w * out_cap + pos] = row[first + k];
      ++pos;
    }
  }
}

// Pad every slot at or past the worker's unique count.
template <typename T>
__global__ void compact_pad(T* __restrict__ uniq,
                            const int64_t* __restrict__ n_unique,
                            int64_t out_cap, T pad) {
  const int64_t w = blockIdx.y;
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < out_cap && j >= n_unique[w]) uniq[w * out_cap + j] = pad;
}

template <typename T>
int launch(const void* values, const void* valid, void* keys, void* scratch,
           void* totals, void* tile_sums, void* uniq, void* n_unique, int w,
           int64_t n, int64_t out_cap, T pad, void* stream) {
  constexpr int D = Radix<T>::kDigits;
  if (w == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  int32_t* info = (int32_t*)scratch;
  int32_t* bin_base = info + 4 * (int64_t)w;
  int32_t* hist = bin_base + (int64_t)w * D * kBins;
  const T* vals = (const T*)values;
  const uint8_t* ok = (const uint8_t*)valid;
  T* buf = (T*)keys;
  if (n_tiles <= 1) {
    radix_sort_tile<T><<<w, kThreads, 0, s>>>(vals, ok, buf, info, n);
  } else {
    const dim3 grid((unsigned)n_tiles, (unsigned)w);
    radix_hist_raw<T><<<grid, kThreads, 0, s>>>(vals, ok, hist,
                                                (int32_t*)totals, n, n_tiles);
    radix_plan<T><<<w, kThreads, 0, s>>>(info, bin_base,
                                         (const int32_t*)totals);
    for (int d = 0; d < D; ++d) {
      if (d > 0)
        radix_hist<T><<<grid, kThreads, 0, s>>>(buf, info, hist, n, n_tiles,
                                                d);
      radix_scatter<T><<<grid, kThreads, 0, s>>>(vals, ok, buf, info,
                                                 bin_base, hist, n, n_tiles,
                                                 d);
    }
  }
  const FirstOccurrence<T> f{buf, (int64_t)w * n, n, info};
  const int64_t n_scan = n > 0 ? n : 1;
  const int64_t scan_tiles = adhash::scan_tiles(n_scan);
  int64_t* sums = (int64_t*)tile_sums;
  const dim3 tgrid((unsigned)scan_tiles, (unsigned)w);
  adhash::tile_sums<<<tgrid, adhash::kScanThreads, 0, s>>>(f, n_scan,
                                                           scan_tiles, sums);
  adhash::scan_tile_sums<<<w, adhash::kScanThreads, 0, s>>>(
      sums, scan_tiles, (int64_t*)n_unique);
  compact_tile<T><<<tgrid, adhash::kScanThreads, 0, s>>>(
      f, sums, scan_tiles, n_scan, (T*)uniq, out_cap);
  if (out_cap > 0) {
    const dim3 pgrid((unsigned)((out_cap + 255) / 256), (unsigned)w);
    compact_pad<T><<<pgrid, 256, 0, s>>>((T*)uniq, (const int64_t*)n_unique,
                                         out_cap, pad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// values: (W, n) int32|int64, n < 2^31; valid: (W, n) bool; keys: (2, W, n)
// of the value type (ping-pong buffers); scratch: int32, 4*W +
// W*D*256*(1 + ceil(n / 4096)) entries (D = 4 for int32, 8 for int64);
// totals: W*D*256 int32, zeroed; tile_sums: (W, ceil(max(n, 1) / 8192))
// int64; uniq: (W, out_cap); n_unique: (W,) int64.
extern "C" int adhash_unique_compact_i32(const void* values,
                                         const void* valid, void* keys,
                                         void* scratch, void* totals,
                                         void* tile_sums, void* uniq,
                                         void* n_unique, int w, int64_t n,
                                         int64_t out_cap, int32_t pad,
                                         void* stream) {
  return launch<int32_t>(values, valid, keys, scratch, totals, tile_sums, uniq,
                         n_unique, w, n, out_cap, pad, stream);
}

extern "C" int adhash_unique_compact_i64(const void* values,
                                         const void* valid, void* keys,
                                         void* scratch, void* totals,
                                         void* tile_sums, void* uniq,
                                         void* n_unique, int w, int64_t n,
                                         int64_t out_cap, int64_t pad,
                                         void* stream) {
  return launch<int64_t>(values, valid, keys, scratch, totals, tile_sums, uniq,
                         n_unique, w, n, out_cap, pad, stream);
}
