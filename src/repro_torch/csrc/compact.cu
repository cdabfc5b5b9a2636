// unique_compact: per-worker sort + dedupe + compact on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/relalg_ops/compact.py
// (unique_compact_pallas, pallas_call at :93), which sorts the whole row in
// VMEM with an unrolled bitonic network twice (once to sort, once to
// compact) because the TPU vector unit has no gather or scatter.
//
// Contract: key invalid slots to ``pad`` (strictly above every valid
// value), sort each worker's row, keep the first occurrence of each valid
// value, compact the survivors to a prefix of ``out_cap`` and pad the rest;
// n_unique (int64) counts every unique value, also those past out_cap.
//
// The sort is hand-written (the TPU kernel sorts in its own body):
//  * a row whose power-of-two length fits one CTA's shared memory
//    (kSmemBytes) is keyed, loaded and bitonic-sorted there in one launch;
//  * a larger row — the relation's per-worker capacity, ~2^18 on LUBM
//    q4chain at 100 universities, past the 227 KB of shared memory — goes
//    through a multi-launch global bitonic sort: tiles of kTile elements
//    are sorted in shared memory, then each merge level k runs its strides
//    j >= kTile as global compare-exchange launches and finishes the
//    strides below kTile in shared memory.
// Then the first occurrences (x != prev, x != pad) are counted with the
// card-wide tile scan of common.cuh; each tile writes its survivors below
// out_cap, and a last launch pads every slot past n_unique.
//
// Bound on the card: at 2^18 elements a row, the global bitonic stages:
// each launch reads and writes the whole (W, n_pad) buffer, log2(n_pad) -
// log2(kTile) + 1 launches per merge level, O(n log^2 n) compare-exchanges
// in all.  The shared-memory stages keep the short strides out of device
// memory; a radix sort is the known fix.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 2 * kThreads;         // elements per shared-memory tile
constexpr int kSmemBytes = 96 * 1024;       // single-launch sort limit

template <typename T>
__device__ __forceinline__ void cmp_swap(T& a, T& b, bool asc) {
  if ((a > b) == asc) {
    const T t = a;
    a = b;
    b = t;
  }
}

// Load a row (keyed: invalid -> pad, past n -> pad) into shared memory,
// bitonic-sort it completely there, store it.  One block per worker.
template <typename T>
__global__ void sort_row_smem(const T* __restrict__ values,
                              const uint8_t* __restrict__ valid,
                              T* __restrict__ out, int64_t n, int64_t n_pad,
                              T pad) {
  extern __shared__ unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int64_t w = blockIdx.x;
  for (int64_t i = threadIdx.x; i < n_pad; i += blockDim.x)
    s[i] = (i < n && valid[w * n + i]) ? values[w * n + i] : pad;
  __syncthreads();
  for (int64_t k = 2; k <= n_pad; k <<= 1) {
    for (int64_t j = k >> 1; j > 0; j >>= 1) {
      for (int64_t p = threadIdx.x; p < n_pad / 2; p += blockDim.x) {
        const int64_t i = (p / j) * 2 * j + (p % j);  // lower index of pair
        cmp_swap(s[i], s[i + j], (i & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int64_t i = threadIdx.x; i < n_pad; i += blockDim.x)
    out[w * n_pad + i] = s[i];
}

// Key the row into ``out`` (invalid or past n -> pad).
template <typename T>
__global__ void key_row(const T* __restrict__ values,
                        const uint8_t* __restrict__ valid,
                        T* __restrict__ out, int64_t n, int64_t n_pad,
                        T pad) {
  const int64_t w = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  out[w * n_pad + i] = (i < n && valid[w * n + i]) ? values[w * n + i] : pad;
}

// One tile of kTile elements in shared memory: run merge levels
// k in [k_lo, k_hi] (k_lo == k_hi for a merge tail) over strides
// j < kTile (j starting at min(k, kTile) / 2).  Direction of a pair
// follows the global index: ascending iff (i & k) == 0.
template <typename T>
__global__ void tile_bitonic(T* __restrict__ data, int64_t n_pad,
                             int64_t k_lo, int64_t k_hi) {
  __shared__ T s[kTile];
  const int64_t w = blockIdx.y;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  T* row = data + w * n_pad + base;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) s[i] = row[i];
  __syncthreads();
  for (int64_t k = k_lo; k <= k_hi; k <<= 1) {
    const int64_t j0 = (k < kTile ? k : kTile) >> 1;
    for (int64_t j = j0; j > 0; j >>= 1) {
      const int p = threadIdx.x;  // kTile / 2 pairs == kThreads threads
      const int i = (int)((p / j) * 2 * j + (p % j));
      cmp_swap(s[i], s[i + j], ((base + i) & k) == 0);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) row[i] = s[i];
}

// One global compare-exchange stride j (>= kTile) of merge level k.
template <typename T>
__global__ void global_step(T* __restrict__ data, int64_t n_pad, int64_t k,
                            int64_t j) {
  const int64_t w = blockIdx.y;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pad / 2) return;
  const int64_t i = (p / j) * 2 * j + (p % j);
  T* row = data + w * n_pad;
  T a = row[i];
  T b = row[i + j];
  cmp_swap(a, b, (i & k) == 0);
  row[i] = a;
  row[i + j] = b;
}

// 1 where element i of worker w's sorted row is the first occurrence of a
// valid value: the flag the compaction scans.
template <typename T>
struct FirstOccurrence {
  const T* sorted;
  int64_t n_pad;
  T pad;
  __device__ int64_t operator()(int64_t w, int64_t i) const {
    const T* row = sorted + w * n_pad;
    const T x = row[i];
    return x != pad && (i == 0 || x != row[i - 1]);
  }
};

// Pass 3 of the tile scan: rescan one tile's flags, add the tile's base,
// write its survivors that land below out_cap.
template <typename T>
__global__ void compact_tile(FirstOccurrence<T> f,
                             const int64_t* __restrict__ base,
                             int64_t n_tiles, T* __restrict__ uniq,
                             int64_t out_cap) {
  __shared__ int64_t warp_sums[32];
  const int64_t w = blockIdx.y;
  const int64_t t = blockIdx.x;
  const int64_t first =
      t * adhash::kScanTile + (int64_t)threadIdx.x * adhash::kScanItems;
  int64_t flag[adhash::kScanItems];
  int64_t cnt = 0;
#pragma unroll
  for (int k = 0; k < adhash::kScanItems; ++k) {
    flag[k] = first + k < f.n_pad ? f(w, first + k) : 0;
    cnt += flag[k];
  }
  int64_t tile_total;
  int64_t pos = adhash::block_inclusive_scan(cnt, warp_sums, &tile_total) -
                cnt + base[w * n_tiles + t];
  const T* row = f.sorted + w * f.n_pad;
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
int launch(const void* values, const void* valid, void* scratch,
           void* tile_sums, void* uniq, void* n_unique, int w, int64_t n,
           int64_t n_pad, int64_t out_cap, T pad, void* stream) {
  if (w == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  T* buf = (T*)scratch;  // (W, n_pad)
  const size_t row_bytes = (size_t)n_pad * sizeof(T);
  if (row_bytes <= (size_t)kSmemBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        sort_row_smem<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    sort_row_smem<T><<<w, kThreads, row_bytes, s>>>(
        (const T*)values, (const uint8_t*)valid, buf, n, n_pad, pad);
  } else {
    // n_pad is a power of two > kSmemBytes / sizeof(T) >= kTile
    dim3 kgrid((unsigned)((n_pad + 255) / 256), (unsigned)w);
    key_row<T><<<kgrid, 256, 0, s>>>((const T*)values, (const uint8_t*)valid,
                                     buf, n, n_pad, pad);
    dim3 tgrid((unsigned)(n_pad / kTile), (unsigned)w);
    tile_bitonic<T><<<tgrid, kThreads, 0, s>>>(buf, n_pad, 2, kTile);
    dim3 ggrid((unsigned)((n_pad / 2 + 255) / 256), (unsigned)w);
    for (int64_t k = 2 * (int64_t)kTile; k <= n_pad; k <<= 1) {
      for (int64_t j = k >> 1; j >= kTile; j >>= 1)
        global_step<T><<<ggrid, 256, 0, s>>>(buf, n_pad, k, j);
      tile_bitonic<T><<<tgrid, kThreads, 0, s>>>(buf, n_pad, k, k);
    }
  }
  const FirstOccurrence<T> f{buf, n_pad, pad};
  const int64_t n_tiles = adhash::scan_tiles(n_pad);
  int64_t* sums = (int64_t*)tile_sums;
  dim3 tgrid((unsigned)n_tiles, (unsigned)w);
  adhash::tile_sums<<<tgrid, adhash::kScanThreads, 0, s>>>(f, n_pad, n_tiles,
                                                           sums);
  adhash::scan_tile_sums<<<w, adhash::kScanThreads, 0, s>>>(
      sums, n_tiles, (int64_t*)n_unique);
  compact_tile<T><<<tgrid, adhash::kScanThreads, 0, s>>>(f, sums, n_tiles,
                                                         (T*)uniq, out_cap);
  if (out_cap > 0) {
    dim3 pgrid((unsigned)((out_cap + 255) / 256), (unsigned)w);
    compact_pad<T><<<pgrid, 256, 0, s>>>((T*)uniq,
                                         (const int64_t*)n_unique, out_cap,
                                         pad);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// values: (W, n) int32|int64; valid: (W, n) bool; scratch: (W, n_pad) of
// the value type, n_pad a power of two >= max(n, 2); tile_sums:
// (W, ceil(n_pad / 8192)) int64 scratch; uniq: (W, out_cap); n_unique:
// (W,) int64.
extern "C" int adhash_unique_compact_i32(const void* values,
                                         const void* valid, void* scratch,
                                         void* tile_sums, void* uniq,
                                         void* n_unique, int w, int64_t n,
                                         int64_t n_pad, int64_t out_cap,
                                         int32_t pad, void* stream) {
  return launch<int32_t>(values, valid, scratch, tile_sums, uniq, n_unique,
                         w, n, n_pad, out_cap, pad, stream);
}

extern "C" int adhash_unique_compact_i64(const void* values,
                                         const void* valid, void* scratch,
                                         void* tile_sums, void* uniq,
                                         void* n_unique, int w, int64_t n,
                                         int64_t n_pad, int64_t out_cap,
                                         int64_t pad, void* stream) {
  return launch<int64_t>(values, valid, scratch, tile_sums, uniq, n_unique,
                         w, n, n_pad, out_cap, pad, stream);
}
