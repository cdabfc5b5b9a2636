// expand: variable-multiplicity join expansion on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/relalg_ops/expand.py
// (expand_pallas, pallas_call at :108), which accumulates, per output lane,
// masked-compare sums over every input row (O(out_cap * n) compares)
// because the TPU has no cheap gather, and keeps its running cumsum in
// int32.
//
// Bound on the card: bytes.  Row i of worker w owns the output lanes
// [start_i, start_i + c_i), c_i = max(hi_i - lo_i, 0) and start_i the
// exclusive int64 prefix of the counts; lane t of row i holds left = i and
// right_pos = lo_i + t - start_i.  The least traffic is lo and hi read once
// (8 bytes a row) and 9 bytes written a lane.  On the LUBM path the rows
// outnumber the lanes (the reply expands n = 2^23 probe ranges into 2^20
// lanes, with under 1% of the rows non-empty), so the row scan is the cost
// to cut, and no per-row prefix may go through device memory.  One call is
// a memset (the scan's tile states and counters) and two kernels:
//  (a) expand_scan, one pass over the rows, grid (tiles of 4096 rows, W):
//      coalesced loads of lo and hi, transposed through shared memory so a
//      thread scans 16 consecutive counts; the tile's lane prefix stays in
//      shared memory.  Tile prefixes in int64 by a single-pass decoupled
//      look-back (a tile publishes its sum, then its inclusive prefix; the
//      next tile's first warp reads its predecessors' states 32 at a time);
//      tile order from an atomic counter, so a tile only waits on tiles
//      already running.  int64 matters: the retry protocol reads ``total``
//      and virtual totals pass 2^31.  A tile then writes its own lanes below
//      out_cap, when there are at most 16384 of them (all of the reply's
//      and finalize_join's tiles): striped over the block, each lane's row
//      found in the shared prefix, each warp's search narrowed to the rows
//      its 32 lanes span.  A tile with more lanes cuts them into pieces at
//      multiples of 2048 lanes and queues them.
//  (b) expand_lanes, grid (2048-lane blocks, W): writes the lanes at or
//      past the total as invalid (left = n-1, right_pos = 0; consumers mask
//      them), a plain stream, then takes queued pieces in turn: reloads the
//      piece's rows (at most one tile's), rescans them in shared memory and
//      writes its lanes as (a) does.  So one long row (match_rows: n = 1,
//      10^5 lanes) is spread over the card instead of one block.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // consecutive rows a thread scans
constexpr int kTile = kThreads * kItems;
constexpr int kLaneBlock = 2048;  // lanes of a piece, and of a fill block
constexpr int64_t kDirect = 16384;  // most lanes a tile writes itself

// shared-memory index of count i, one word of padding per 32 so that both
// the striped writes and the blocked reads are free of bank conflicts
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

struct Shared {
  // the rows' counts, then in place their inclusive lane prefix from the
  // first row, saturated at 2^32 - 1 (every lane searched lies below it)
  uint32_t incl[padded(kTile)];
  int64_t warp_sums[32];
  int64_t first;  // expand_scan: the tile's first lane
  unsigned ticket;  // a claimed tile or piece
};

// Lanes [first_lane, end_lane) of rows [r0, r1) of worker w, row r0
// starting at lane row_start.
struct Piece {
  int64_t first_lane, end_lane, row_start;
  int32_t w, r0, r1;
};

// Scratch of one call: tile states, then W tile counters, the number of
// pieces and the pieces' claim counter (all zeroed), then the pieces.
struct Layout {
  int64_t n_tiles, zero_bytes, bytes;
  Layout(int w, int64_t n, int64_t out_cap) {
    n_tiles = (n + kTile - 1) / kTile;
    zero_bytes = 8 * w * n_tiles + 8 * ((w + 2 + 1) / 2);
    // pieces: the lane blocks of every worker, plus two cut ends a tile
    const int64_t cap = w * ((out_cap + kLaneBlock - 1) / kLaneBlock +
                             2 * (out_cap / kDirect + 1));
    bytes = zero_bytes + cap * (int64_t)sizeof(Piece);
  }
};

// Sum of the tiles before ``tile`` (one warp; ``agg`` is this tile's sum):
// publishes the tile's aggregate, looks back (common.cuh), publishes its
// inclusive prefix.  Counts < 2^32 and rows < 2^31 keep the sums below
// 2^62, as the state words require.
__device__ int64_t tile_prefix(unsigned long long* states, int64_t tile,
                               int64_t agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) adhash::publish_state(states, adhash::kStatePrefix, agg);
    return 0;
  }
  if (lane == 0)
    adhash::publish_state(states + tile, adhash::kStateAggregate, agg);
  const int64_t excl = adhash::look_back(states, 1, tile);
  if (lane == 0)
    adhash::publish_state(states + tile, adhash::kStatePrefix, excl + agg);
  return excl;
}

// Loads rows [r0, r0 + nr) (nr <= kTile) of one worker and leaves in
// sh.incl the inclusive prefix of their counts, visible after the caller's
// next barrier; returns their sum.  Every thread of the block calls it.
__device__ int64_t prefix_rows(const int32_t* __restrict__ lw,
                               const int32_t* __restrict__ hw, int64_t r0,
                               int nr, Shared& sh) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + threadIdx.x;
    const int64_t d = i < nr ? (int64_t)hw[r0 + i] - (int64_t)lw[r0 + i] : 0;
    sh.incl[padded(i)] = d > 0 ? (uint32_t)d : 0u;
  }
  __syncthreads();
  uint32_t c[kItems];
  int64_t sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    c[k] = sh.incl[padded(threadIdx.x * kItems + k)];
    sum += c[k];
  }
  int64_t agg;  // the scan's barriers order the reads above and writes below
  int64_t run = adhash::block_inclusive_scan(sum, sh.warp_sums, &agg) - sum;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    run += c[k];
    sh.incl[padded(threadIdx.x * kItems + k)] =
        run < 0xffffffffll ? (uint32_t)run : 0xffffffffu;
  }
  return agg;
}

// First r in [lo, hi) with sh.incl[r] > u: the row holding lane u.
__device__ __forceinline__ int row_of(const Shared& sh, int lo, int hi,
                                      uint32_t u) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sh.incl[padded(mid)] <= u) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Writes lanes first + u, u in [u0, u1), of rows r0 + r (r < nr) whose
// inclusive lane prefix from lane ``first`` is sh.incl[r] (u1 at most
// sh.incl[nr - 1]).  Lanes are striped over the block; a warp first finds
// the rows of its first and last lane (the same reads in every lane), and
// each lane searches only between them.
__device__ void write_lanes(const Shared& sh, int nr,
                            const int32_t* __restrict__ lw, int64_t r0,
                            int64_t first, int64_t u0, int64_t u1,
                            int32_t* __restrict__ left,
                            int32_t* __restrict__ right_pos,
                            uint8_t* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  for (int64_t b = u0 + (threadIdx.x - lane); b < u1; b += kThreads) {
    const int64_t last = b + 31 < u1 ? b + 31 : u1 - 1;
    const int ra = row_of(sh, 0, nr, (uint32_t)b);
    const int rb = row_of(sh, ra, nr, (uint32_t)last);
    const int64_t u = b + lane;
    if (u < u1) {
      const int r = row_of(sh, ra, rb + 1, (uint32_t)u);
      const int64_t before = r > 0 ? sh.incl[padded(r - 1)] : 0;
      left[first + u] = (int32_t)(r0 + r);
      right_pos[first + u] = (int32_t)((int64_t)lw[r0 + r] + (u - before));
      valid[first + u] = 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
expand_scan(const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
            unsigned long long* __restrict__ states,
            unsigned* __restrict__ counters, Piece* __restrict__ pieces,
            int64_t* __restrict__ total, int32_t* __restrict__ left,
            int32_t* __restrict__ right_pos, uint8_t* __restrict__ valid,
            int64_t n, int64_t n_tiles, int64_t out_cap) {
  __shared__ Shared sh;
  const int64_t w = blockIdx.y;
  if (threadIdx.x == 0) sh.ticket = atomicAdd(counters + w, 1u);
  __syncthreads();
  const int64_t tile = sh.ticket;
  const int64_t r0 = tile * kTile;
  const int nr = (int)(n - r0 < kTile ? n - r0 : kTile);
  const int32_t* lw = lo + w * n;
  const int64_t agg = prefix_rows(lw, hi + w * n, r0, nr, sh);
  if (threadIdx.x < 32) {
    const int64_t excl = tile_prefix(states + w * n_tiles, tile, agg);
    if (threadIdx.x == 0) {
      sh.first = excl;
      if (tile == n_tiles - 1) total[w] = excl + agg;
    }
  }
  __syncthreads();
  const int64_t first = sh.first;
  if (first >= out_cap || agg == 0) return;
  const int64_t end = first + agg < out_cap ? first + agg : out_cap;
  if (end - first <= kDirect) {
    write_lanes(sh, nr, lw, r0, first, 0, end - first, left + w * out_cap,
                right_pos + w * out_cap, valid + w * out_cap);
    return;
  }
  // more lanes than a block should write: cut at multiples of kLaneBlock
  const int64_t block0 = first / kLaneBlock;
  const int64_t n_pieces = (end - 1) / kLaneBlock - block0 + 1;
  if (threadIdx.x == 0)  // every thread has read the tile's ticket
    sh.ticket = atomicAdd(counters + gridDim.y, (unsigned)n_pieces);
  __syncthreads();
  for (int64_t j = threadIdx.x; j < n_pieces; j += kThreads) {
    const int64_t t0 = j == 0 ? first : (block0 + j) * kLaneBlock;
    const int64_t t1 =
        (block0 + j + 1) * kLaneBlock < end ? (block0 + j + 1) * kLaneBlock
                                            : end;
    const int ra = row_of(sh, 0, nr, (uint32_t)(t0 - first));
    const int rb = row_of(sh, ra, nr, (uint32_t)(t1 - 1 - first));
    Piece p;
    p.first_lane = t0;
    p.end_lane = t1;
    p.row_start = first + (ra > 0 ? sh.incl[padded(ra - 1)] : 0);
    p.w = (int32_t)w;
    p.r0 = (int32_t)(r0 + ra);
    p.r1 = (int32_t)(r0 + rb + 1);
    pieces[sh.ticket + j] = p;
  }
}

__global__ void __launch_bounds__(kThreads)
expand_lanes(const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
             unsigned* __restrict__ counters,
             const Piece* __restrict__ pieces,
             const int64_t* __restrict__ total, int32_t* __restrict__ left,
             int32_t* __restrict__ right_pos, uint8_t* __restrict__ valid,
             int64_t n, int64_t out_cap) {
  __shared__ Shared sh;
  const int64_t w = blockIdx.y;
  const int64_t t0 = (int64_t)blockIdx.x * kLaneBlock;
  const int64_t t1 = t0 + kLaneBlock < out_cap ? t0 + kLaneBlock : out_cap;
  const int64_t live = total[w] < out_cap ? total[w] : out_cap;
  for (int64_t t = (live > t0 ? live : t0) + threadIdx.x; t < t1;
       t += kThreads) {
    left[w * out_cap + t] = (int32_t)(n - 1);
    right_pos[w * out_cap + t] = 0;
    valid[w * out_cap + t] = 0;
  }
  const unsigned n_pieces = counters[gridDim.y];
  while (n_pieces > 0) {
    __syncthreads();  // the previous piece's shared reads are done
    if (threadIdx.x == 0)
      sh.ticket = atomicAdd(counters + gridDim.y + 1, 1u);
    __syncthreads();
    if (sh.ticket >= n_pieces) break;
    const Piece p = pieces[sh.ticket];
    const int32_t* lw = lo + (int64_t)p.w * n;
    const int nr = p.r1 - p.r0;
    prefix_rows(lw, hi + (int64_t)p.w * n, p.r0, nr, sh);
    __syncthreads();
    write_lanes(sh, nr, lw, p.r0, p.row_start, p.first_lane - p.row_start,
                p.end_lane - p.row_start, left + p.w * out_cap,
                right_pos + p.w * out_cap, valid + p.w * out_cap);
  }
}

}  // namespace

// Bytes of scratch adhash_expand takes for (W, n) rows into out_cap lanes.
extern "C" int64_t adhash_expand_scratch_bytes(int w, int64_t n,
                                               int64_t out_cap) {
  return Layout(w, n, out_cap).bytes;
}

// lo, hi: (W, n) int32, n >= 1; scratch: adhash_expand_scratch_bytes of
// it; total: (W,) int64; left, right_pos: (W, out_cap) int32; valid:
// (W, out_cap) bool.
extern "C" int adhash_expand(const void* lo, const void* hi, void* scratch,
                             void* total, void* left, void* right_pos,
                             void* valid, int w, int64_t n, int64_t out_cap,
                             void* stream) {
  if (w == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const Layout at(w, n, out_cap);
  auto* states = (unsigned long long*)scratch;
  auto* counters = (unsigned*)(states + w * at.n_tiles);
  auto* pieces = (Piece*)((char*)scratch + at.zero_bytes);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)at.zero_bytes, s);
  if (err != cudaSuccess) return (int)err;
  expand_scan<<<dim3((unsigned)at.n_tiles, (unsigned)w), kThreads, 0, s>>>(
      (const int32_t*)lo, (const int32_t*)hi, states, counters, pieces,
      (int64_t*)total, (int32_t*)left, (int32_t*)right_pos, (uint8_t*)valid,
      n, at.n_tiles, out_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess || out_cap == 0) return (int)err;
  const dim3 grid((unsigned)((out_cap + kLaneBlock - 1) / kLaneBlock),
                  (unsigned)w);
  expand_lanes<<<grid, kThreads, 0, s>>>(
      (const int32_t*)lo, (const int32_t*)hi, counters, pieces,
      (const int64_t*)total, (int32_t*)left, (int32_t*)right_pos,
      (uint8_t*)valid, n, out_cap);
  return (int)cudaGetLastError();
}
