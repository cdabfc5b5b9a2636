// bucket_by_dest: stable per-destination send buffers on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/relalg_ops/bucket.py
// (bucket_by_dest_pallas, pallas_call at :103), which places rows with a
// (block_n x cap_peer) one-hot compare plane per destination because the
// TPU vector unit has no scatter.
//
// Contract: send is (W, n_dest, cap_peer, k); destination d's valid rows
// appear in their input order in slots [0, min(count_d, cap_peer)); every
// slot at or past count_d holds ``pad``; send_valid marks the slots below
// count_d; rows past cap_peer are dropped; max_wanted (W,) is the largest
// unclamped count_d of each worker.
//
// Bound on the card: bytes, and the padded output sets it.  The function
// must read ``valid`` of every row and ``dest`` and ``values`` of the valid
// rows, and write all of send and send_valid.  On the LUBM path (n = 2^20
// rows into 8 destinations of cap_peer = 2^20 slots) about 4.6% of the rows
// are valid, so nearly all the bytes are the pad fill, and the valid rows
// come first: the reply routes rows whose destination (the sender) never
// decreases, the hash exchange a prefix of hashed values.  One call is a
// memset (tile states, counts, tickets) and two kernels:
//  (a) bucket_place, one pass over the rows in tiles of 4096, tile order
//      per worker from an atomic ticket.  The grid interleaves the workers
//      (block b serves worker b % W): blocks start in index order, so every
//      worker's first tiles, which hold the rows on the path, start in the
//      first wave instead of after the earlier workers' empty tiles.  A tile
//      reads its valid bytes with 16-byte loads; one with no valid row
//      publishes a zero aggregate and exits, as most tiles past the valid
//      prefix do.  Otherwise it reads dest of its valid rows only, ranks
//      them stably by destination (each warp groups its lanes with
//      __match_any_sync and ranks by __popc; warps in order), publishes its
//      n_dest counts as look-back aggregates and adds them to the worker's
//      counts (atomics: no tile waits for the totals), sorts its row
//      indices by destination in shared memory (input order within each),
//      finds each destination's tile prefix by the decoupled look-back of
//      common.cuh (one state word per (tile, destination); warp q walks
//      destinations q, q + 8, ...), and writes each destination's run as
//      one contiguous block of k * len words gathered from the tile's
//      values: a scalar head, 16-byte stores, a scalar tail.  Rows of rank
//      >= cap_peer are dropped.
//  (b) bucket_fill, grid (slot chunks, W * n_dest): writes ``pad`` into the
//      slots [count_d, cap_peer) and the whole send_valid (ones below
//      count_d, zeros from it), 16-byte stores between scalar edges and no
//      per-slot divide; the first chunk of each worker writes max_wanted.
// Budget (ptxas -v, sm_90a): bucket_place 64 registers (capped for four
// blocks an SM; a cap of 40 spilled and was slower) and 24.7 KB of shared
// memory, bucket_fill 30 registers; no spills.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // rows a thread ranks
constexpr int kTile = kThreads * kItems;   // 4096 rows a tile
constexpr int kWarpRows = kTile / kWarps;  // 512 consecutive rows a warp
constexpr int kMaxDest = kThreads;         // one destination a thread
constexpr int kNone = -1;                  // destination of a skipped row
constexpr int64_t kFillWords = 12288;      // send words a fill block spans

struct Shared {
  int32_t wcnt[kWarps][kMaxDest];  // per warp counts, then warp offsets
  int32_t cnt[kMaxDest];           // the tile's rows per destination
  int32_t start[kMaxDest];         // first staged row of each destination
  int64_t excl[kMaxDest];          // rows of earlier tiles per destination
  int32_t warp_sums[32];
  uint4 valid[kTile / 16];         // the tile's valid bytes
  uint16_t order[kTile];           // the tile's valid rows by destination
  unsigned ticket;
};

// Scratch of one call, all zeroed by the memset: tile states (W, n_tiles,
// n_dest), counts (W, n_dest) int64, tickets (W,) uint32.
struct Layout {
  int64_t n_tiles, counts, tickets, bytes;
  Layout(int w, int64_t n, int n_dest) {
    n_tiles = (n + kTile - 1) / kTile;
    counts = 8 * w * n_tiles * n_dest;
    tickets = counts + 8 * (int64_t)w * n_dest;
    bytes = tickets + 4 * (int64_t)w;
  }
};

// Block-wide copy of a destination's run, ``words`` int32: word j is column
// j % K of row order[j / K] of the tile's values.  Scalar stores up to
// dst's first 16-byte boundary, 16-byte stores, scalar tail.
template <int K>
__device__ __forceinline__ void copy_run(const uint16_t* order,
                                         const int32_t* __restrict__ tile,
                                         int32_t* dst, int64_t words) {
  const int tid = threadIdx.x;
  auto word = [&](int64_t j) {
    return tile[(int64_t)order[j / K] * K + j % K];
  };
  int64_t head = (4 - (((uintptr_t)dst >> 2) & 3)) & 3;
  head = head < words ? head : words;
  if (tid < head) dst[tid] = word(tid);
  const int64_t body = (words - head) >> 2;
  int4* out = reinterpret_cast<int4*>(dst + head);
  for (int64_t q = tid; q < body; q += kThreads) {
    const int64_t j = head + 4 * q;
    out[q] = make_int4(word(j), word(j + 1), word(j + 2), word(j + 3));
  }
  const int64_t tail = head + 4 * body;
  if (tid < words - tail) dst[tail + tid] = word(tail + tid);
}

// Block-wide fill of p[lo, hi) with ``value`` (``word``: value repeated
// over 4 bytes): scalar head and tail, 16-byte stores between.
template <typename T>
__device__ __forceinline__ void fill_range(T* p, int64_t lo, int64_t hi,
                                           T value, int32_t word) {
  constexpr int64_t kPer = 16 / sizeof(T);
  if (lo >= hi) return;
  const int tid = threadIdx.x;
  T* first = p + lo;
  const int64_t n = hi - lo;
  int64_t head = ((16 - ((uintptr_t)first & 15)) & 15) / sizeof(T);
  head = head < n ? head : n;
  if (tid < head) first[tid] = value;
  const int64_t body = (n - head) / kPer;
  const int4 v = make_int4(word, word, word, word);
  int4* out = reinterpret_cast<int4*>(first + head);
  for (int64_t q = tid; q < body; q += kThreads) out[q] = v;
  const int64_t tail = head + kPer * body;
  if (tid < n - tail) first[tail + tid] = value;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 4)
bucket_place(const int32_t* __restrict__ values,
             const int32_t* __restrict__ dest,
             const uint8_t* __restrict__ valid,
             unsigned long long* __restrict__ states,
             int64_t* __restrict__ counts, unsigned* __restrict__ tickets,
             int32_t* __restrict__ send, int n_workers, int64_t n,
             int n_dest, int64_t cap_peer, int64_t n_tiles) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // blocks start in index order: interleaving the workers starts every
  // worker's first tiles (on the path, the ones holding rows) at once
  const int64_t w = blockIdx.x % n_workers;
  if (tid == 0) sh.ticket = atomicAdd(tickets + w, 1u);
  __syncthreads();
  const int64_t tile = sh.ticket;
  const int64_t row0 = w * n + tile * kTile;  // flat index of the first row
  const int64_t left = n - tile * kTile;
  const int nr = (int)(left < kTile ? left : kTile);
  unsigned long long* st = states + w * n_tiles * n_dest;

  // the tile's valid bytes, 16 a thread
  const uint8_t* vrow = valid + row0;
  if (nr == kTile && ((uintptr_t)vrow & 15) == 0) {
    sh.valid[tid] = reinterpret_cast<const uint4*>(vrow)[tid];
  } else {
    uint8_t* vb = reinterpret_cast<uint8_t*>(sh.valid);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = tid * 16 + i;
      vb[r] = r < nr ? vrow[r] : 0;
    }
  }
  const uint4 mine = sh.valid[tid];
  if (!__syncthreads_or((mine.x | mine.y | mine.z | mine.w) != 0)) {
    // no row here: a zero aggregate, which later tiles' look-backs pass
    if (tid < n_dest)
      adhash::publish_state(st + tile * n_dest + tid,
                            tile == 0 ? adhash::kStatePrefix
                                      : adhash::kStateAggregate, 0);
    return;
  }

  // stable rank by destination: warp q holds rows q * 512 + r * 32 + lane;
  // pk[r] holds the row's destination + 1 (0: skipped), then its rank
  // among the warp's rows of that destination above bit 9
  for (int i = tid; i < kWarps * kMaxDest; i += kThreads)
    (&sh.wcnt[0][0])[i] = 0;
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(sh.valid);
  int32_t pk[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = warp * kWarpRows + r * 32 + lane;
    pk[r] = 0;
    if (vb[i]) {
      const int32_t x = dest[row0 + i];
      if (x >= 0 && x < n_dest) pk[r] = x + 1;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int d = pk[r] - 1;
    const unsigned peers = __match_any_sync(ADHASH_FULL_MASK, d);
    const int before = __popc(peers & ((1u << lane) - 1u));
    const int32_t run = d != kNone ? sh.wcnt[warp][d] : 0;
    __syncwarp();
    if (d != kNone && before == 0) sh.wcnt[warp][d] = run + __popc(peers);
    __syncwarp();
    pk[r] |= (run + before) << 9;
  }
  __syncthreads();
  // per destination (one a thread): warp offsets in warp order, the count
  int32_t c = 0;
  if (tid < n_dest) {
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const int32_t v = sh.wcnt[q][tid];
      sh.wcnt[q][tid] = c;
      c += v;
    }
    // the aggregate goes out first, so that later tiles can pass this one
    adhash::publish_state(st + tile * n_dest + tid,
                          tile == 0 ? adhash::kStatePrefix
                                    : adhash::kStateAggregate, c);
    if (c) atomicAdd((unsigned long long*)(counts + w * n_dest + tid),
                     (unsigned long long)c);
  }
  int32_t total;
  const int32_t start =
      adhash::block_inclusive_scan(c, sh.warp_sums, &total) - c;
  if (tid < n_dest) {
    sh.cnt[tid] = c;
    sh.start[tid] = start;
    if (tile == 0) sh.excl[tid] = 0;
  }
  __syncthreads();

  // the valid rows' order by destination, input order within each
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int d = (pk[r] & 511) - 1;
    if (d == kNone) continue;
    sh.order[(pk[r] >> 9) + sh.start[d] + sh.wcnt[warp][d]] =
        (uint16_t)(warp * kWarpRows + r * 32 + lane);
  }
  // each destination's rows in earlier tiles
  if (tile > 0) {
    for (int d = warp; d < n_dest; d += kWarps) {
      const int64_t e = adhash::look_back(st + d, n_dest, tile);
      if (lane == 0) {
        sh.excl[d] = e;
        adhash::publish_state(st + tile * n_dest + d, adhash::kStatePrefix,
                              e + sh.cnt[d]);
      }
    }
  }
  __syncthreads();

  // each destination's run, contiguous, below cap_peer
  for (int d = 0; d < n_dest; ++d) {
    const int64_t e = sh.excl[d];
    const int64_t room = cap_peer - e;
    const int64_t len = sh.cnt[d] < room ? sh.cnt[d] : room;
    if (len > 0)
      copy_run<K>(sh.order + sh.start[d], values + row0 * K,
                  send + ((w * n_dest + d) * cap_peer + e) * K, len * K);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
bucket_fill(const int64_t* __restrict__ counts, int32_t* __restrict__ send,
            uint8_t* __restrict__ send_valid,
            int64_t* __restrict__ max_wanted, int n_dest, int64_t cap_peer,
            int32_t pad) {
  constexpr int64_t kSlots = kFillWords / K;
  const int64_t s = blockIdx.y;  // flat (worker, destination)
  const int64_t a = (int64_t)blockIdx.x * kSlots;
  const int64_t b = a + kSlots < cap_peer ? a + kSlots : cap_peer;
  const int64_t count = counts[s];
  const int64_t live = count < cap_peer ? count : cap_peer;
  if (blockIdx.x == 0 && s % n_dest == 0 && threadIdx.x == 0) {
    int64_t m = 0;
    for (int d = 0; d < n_dest; ++d) m = counts[s + d] > m ? counts[s + d] : m;
    max_wanted[s / n_dest] = m;
  }
  const int64_t lo = a > live ? a : live;
  fill_range<int32_t>(send + s * cap_peer * K, lo * K, b * K, pad, pad);
  uint8_t* sv = send_valid + s * cap_peer;
  fill_range<uint8_t>(sv, a, b < live ? b : live, 1, 0x01010101);
  fill_range<uint8_t>(sv, lo, b, 0, 0);
}

template <int K>
cudaError_t launch(const void* values, const void* dest, const void* valid,
                   void* scratch, void* send, void* send_valid,
                   void* max_wanted, int w, int64_t n, int n_dest,
                   int64_t cap_peer, int pad, cudaStream_t s) {
  const Layout at(w, n, n_dest);
  auto* states = (unsigned long long*)scratch;
  auto* counts = (int64_t*)((char*)scratch + at.counts);
  auto* tickets = (unsigned*)((char*)scratch + at.tickets);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)at.bytes, s);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    bucket_place<K><<<dim3((unsigned)(at.n_tiles * w), 1), kThreads, 0, s>>>(
        (const int32_t*)values, (const int32_t*)dest, (const uint8_t*)valid,
        states, counts, tickets, (int32_t*)send, w, n, n_dest, cap_peer,
        at.n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t slots = kFillWords / K;
  const int64_t chunks = cap_peer > 0 ? (cap_peer + slots - 1) / slots : 1;
  bucket_fill<K><<<dim3((unsigned)chunks, (unsigned)(w * n_dest)), kThreads,
                   0, s>>>(counts, (int32_t*)send, (uint8_t*)send_valid,
                           (int64_t*)max_wanted, n_dest, cap_peer,
                           (int32_t)pad);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch adhash_bucket_by_dest takes for (W, n) rows.
extern "C" int64_t adhash_bucket_scratch_bytes(int w, int64_t n,
                                               int n_dest) {
  return Layout(w, n, n_dest).bytes;
}

// values: (W, n, k) int32; dest: (W, n) int32; valid: (W, n) bool;
// scratch: adhash_bucket_scratch_bytes of it; send: (W, n_dest, cap_peer,
// k) int32, 16-byte aligned; send_valid: (W, n_dest, cap_peer) bool,
// 16-byte aligned; max_wanted: (W,) int64.  k is 1 or 3; n_dest in
// [1, 256].
extern "C" int adhash_bucket_by_dest(const void* values, const void* dest,
                                     const void* valid, void* scratch,
                                     void* send, void* send_valid,
                                     void* max_wanted, int w, int64_t n,
                                     int k, int n_dest, int64_t cap_peer,
                                     int pad, void* stream) {
  if (w == 0) return (int)cudaSuccess;
  if ((k != 1 && k != 3) || n_dest < 1 || n_dest > kMaxDest)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(k == 1 ? launch<1> : launch<3>)(
      values, dest, valid, scratch, send, send_valid, max_wanted, w, n,
      n_dest, cap_peer, pad, s);
}
