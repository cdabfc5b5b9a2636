// range_search / span_search: the DSJ semi-join probe on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/semijoin/semijoin.py
// (semijoin_probe, pallas_call at :89), which counts ``keys < probe`` and
// ``keys <= probe`` with masked-compare reductions because the TPU vector
// unit has no cheap gather (O(N) compares per probe).
//
// Semantics are those of torch.searchsorted: for each (worker, probe) the
// left and right insertion points in that worker's sorted, dtype-max padded
// key row.  The span form (span_search) returns two left insertion points,
// of ``lo_keys`` and ``hi_keys`` (any order: ``hi_key < lo_key`` is a plain
// second search).  Templated on int64 keys (the composite p*NID+s|o index
// keys) and int32 keys (the candidate keys finalize_join sorts).  For a
// probe equal to the pad value this returns ``hi = N`` where the Pallas
// kernel returns the padded length; callers mask that case.
//
// Bound on the card: bytes, once the searches are cheap.  On the LUBM path
// the reply probe reads M = 2^23 probes per worker (8 senders x 2^20
// lanes) of which usually under 1% are live: a padding lane holds the
// clamped key p*NID, the same in every padding lane.  finalize_join's probe
// is unsorted over int32 keys (N = 2^23, mostly pad), with about 9% live
// lanes and the rest equal to the pad.  The design:
//  * Padding lanes do not search.  Each lane remembers its last two
//    distinct probes and their answers; a probe equal to one reuses it.
//    Lanes of a warp that hold one new probe (__match_any_sync) queue one
//    search.  A warp of padding lanes thus costs coalesced loads and
//    stores only.
//  * The searches of a chunk (a warp's 128 probes, or 64 in the span form)
//    go through the warp's queue in shared memory and are spread over its
//    32 lanes, so the few live lanes of each row of 32 do not search one
//    after another while the rest wait.  Warps never wait on each other.
//  * The top levels of a search come from shared memory.  Blocks are
//    persistent per worker (two per SM, a grid-stride loop over chunks)
//    and stage a sample of the worker's key row, every 2^shift-th key, once
//    per block; the sample's size follows the probes a block takes, so a
//    launch of a few probes (match_ranges: M = 1) stages one key a thread.
//    The span form's two ends are two queued searches, run side by side.
//  * The last levels run inside one span of 2^shift - 1 consecutive keys
//    in device memory.  The right end of a range is the left end unless
//    the key there equals the probe (one more load, in the same line);
//    then it is galloped from the left end (match ranges are short), or
//    searched through the sample when the run of equal keys is long (a
//    probe equal to the pad).
//  * The next chunk's probes are loaded before this chunk's searches, so
//    enough bytes are in flight to stream at the memory's rate.
// Nothing assumes an order of the probes.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
// probes per lane per chunk, 32 apart (and as many of the next chunk in
// flight)
__host__ __device__ constexpr int items(bool span) { return span ? 2 : 4; }
constexpr int kSampleBytes = 32 * 1024;
constexpr int kBlocksPerSm = 2;  // blocks an SM holds (64 registers each)

template <typename T>
__device__ __forceinline__ void swap_values(T& a, T& b) {
  const T t = a;
  a = b;
  b = t;
}

// First index in [lo, n) whose key fails ``a[j] <= x``, given that every
// key before lo passes: probe a[lo] and then keys at doubling distances
// until one fails, then binary-search the last gap.  O(log(answer - lo))
// loads.
template <typename T>
__device__ __forceinline__ int64_t gallop(const T* a, int64_t lo, int64_t n,
                                          T x) {
  int64_t hi = lo;
  int64_t step = 1;
  while (hi < n && a[hi] <= x) {
    lo = hi + 1;
    hi = lo + step;
    step <<= 1;
  }
  if (hi > n) hi = n;
  return adhash::upper_bound(a, lo, hi, x);
}

// Side-left (Upper: side-right) insertion point of x in row[0, n), whose
// every 2^shift-th key row[j << shift], j < s_len, is staged in ``sample``.
template <typename T, bool Upper>
__device__ __forceinline__ int64_t sampled_bound(const T* __restrict__ row,
                                                 const T* sample, int64_t n,
                                                 int s_len, int shift, T x) {
  const int64_t j = Upper ? adhash::upper_bound(sample, 0, s_len, x)
                          : adhash::lower_bound(sample, 0, s_len, x);
  // the answer is in ((j-1) << shift, j << shift]
  const int64_t lo = j == 0 ? 0 : ((j - 1) << shift) + 1;
  const int64_t hi = j == s_len ? n : (j << shift);
  return Upper ? adhash::upper_bound(row, lo, hi, x)
               : adhash::lower_bound(row, lo, hi, x);
}

// The items() probes of a lane from probe i on, 32 apart (0 past m).
template <typename T, bool Span>
__device__ __forceinline__ void load_probes(const T* __restrict__ pw,
                                            const T* __restrict__ qw,
                                            int64_t i, int64_t m, T* p,
                                            T* q) {
#pragma unroll
  for (int k = 0; k < items(Span); ++k) {
    p[k] = i + k * 32 < m ? pw[i + k * 32] : T(0);
    q[k] = Span && i + k * 32 < m ? qw[i + k * 32] : T(0);
  }
}

// Shared memory of a block: the sample, and each warp's queue of one
// chunk's searches: a probe each (the span form queues its two ends as two
// searches), and the answers.
template <typename T, bool Span>
struct Shared {
  static constexpr int kChunk = 32 * items(Span);  // probes per warp
  static constexpr int kQueue = kChunk * (Span ? 2 : 1);
  static constexpr int kWarps = kThreads / 32;
  T sample[kSampleBytes / sizeof(T)];
  T qp[kWarps][kQueue];
  int32_t ql[kWarps][kQueue];
  int32_t qh[kWarps][Span ? 1 : kChunk];
};

// (lo, hi) of range_search's probe x in row[0, n).
template <typename T>
__device__ __forceinline__ void search_range(const T* __restrict__ row,
                                             const T* sample, int64_t n,
                                             int s_len, int shift, T x,
                                             int32_t* lo, int32_t* hi) {
  const int64_t a = sampled_bound<T, false>(row, sample, n, s_len, shift, x);
  int64_t b = a;
  if (a < n && row[a] <= x) {  // x is a key: gallop over its copies, if
    const int64_t near = a + 64 < n ? a + 64 : n;  // they are few
    b = gallop(row, a, near, x);
    if (b == near && near < n)
      b = sampled_bound<T, true>(row, sample, n, s_len, shift, x);
  }
  *lo = (int32_t)a;
  *hi = (int32_t)b;
}

template <typename T, bool Span>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
probe_kernel(const T* __restrict__ keys, const T* __restrict__ probes,
             const T* __restrict__ probes_hi, int32_t* __restrict__ lo_out,
             int32_t* __restrict__ hi_out, int64_t n, int64_t m, int shift,
             int s_len) {
  constexpr int kItems = items(Span);
  constexpr int kChunk = Shared<T, Span>::kChunk;
  extern __shared__ __align__(16) unsigned char smem[];
  Shared<T, Span>& sh = *reinterpret_cast<Shared<T, Span>*>(smem);
  const int64_t w = blockIdx.y;
  const T* row = keys + w * n;
#pragma unroll 8
  for (int j = threadIdx.x; j < s_len; j += kThreads)
    sh.sample[j] = row[(int64_t)j << shift];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* qp = sh.qp[warp];
  int32_t* ql = sh.ql[warp];
  int32_t* qh = sh.qh[warp];
  const T* pw = probes + w * m;
  const T* qw = probes_hi + w * m;
  // the lane's last two distinct probes (decided in the first loop of a
  // chunk) and their answers (filled in the second, by the same steps),
  // newest first
  int held = 0;
  T mp[2] = {0, 0}, mq[2] = {0, 0};
  int32_t ml[2] = {0, 0}, mh[2] = {0, 0};
  const int64_t stride = (int64_t)gridDim.x * kThreads / 32 * kChunk;
  int64_t base = ((int64_t)blockIdx.x * kThreads / 32 + warp) * kChunk;
  T p[kItems], q[kItems];  // this chunk's probes; the next chunk's, in flight
  load_probes<T, Span>(pw, qw, base + lane, m, p, q);
  for (; base < m; base += stride) {
    T p_next[kItems], q_next[kItems];
    load_probes<T, Span>(pw, qw, base + stride + lane, m, p_next, q_next);
    int src[kItems];  // queue slot of the item's answer; -1, -2: memo entry
    int queued = 0;   // warp-uniform
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool live = base + k * 32 + lane < m;
      const bool hit0 =
          held > 0 && p[k] == mp[0] && (!Span || q[k] == mq[0]);
      const bool hit1 =
          held > 1 && p[k] == mp[1] && (!Span || q[k] == mq[1]);
      bool need = false;
      src[k] = -1;
      if (live && !hit0 && hit1) {
        src[k] = -2;  // the older entry becomes the newest
        swap_values(mp[0], mp[1]);
        swap_values(mq[0], mq[1]);
      } else if (live && !hit0) {
        need = true;  // a new entry, answered by the queue
        mp[1] = mp[0];
        mq[1] = mq[0];
        mp[0] = p[k];
        mq[0] = q[k];
        held = held < 2 ? held + 1 : 2;
      }
      const unsigned todo = __ballot_sync(ADHASH_FULL_MASK, need);
      if (todo) {  // queue one search per distinct probe
        unsigned group = __match_any_sync(ADHASH_FULL_MASK, p[k]);
        if (Span) group &= __match_any_sync(ADHASH_FULL_MASK, q[k]);
        group &= todo;
        const int leader = need ? __ffs(group) - 1 : lane;
        const unsigned leaders =
            __ballot_sync(ADHASH_FULL_MASK, need && leader == lane);
        const int slot = queued + __popc(leaders & ((1u << lane) - 1u));
        if (need && leader == lane) {
          if (Span) {
            qp[2 * slot] = p[k];
            qp[2 * slot + 1] = q[k];
          } else {
            qp[slot] = p[k];
          }
        }
        const int led = __shfl_sync(ADHASH_FULL_MASK, slot, leader);
        if (need) src[k] = led;
        queued += __popc(leaders);
      }
    }
    if (queued) {  // the warp's lanes take the queued searches
      __syncwarp();
      for (int e = lane; e < queued * (Span ? 2 : 1); e += 32) {
        if (Span)
          ql[e] = (int32_t)sampled_bound<T, false>(row, sh.sample, n, s_len,
                                                   shift, qp[e]);
        else
          search_range(row, sh.sample, n, s_len, shift, qp[e], ql + e,
                       qh + e);
      }
      __syncwarp();
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = base + k * 32 + lane;
      if (i >= m) continue;
      if (src[k] >= 0) {
        ml[1] = ml[0];
        mh[1] = mh[0];
        ml[0] = Span ? ql[2 * src[k]] : ql[src[k]];
        mh[0] = Span ? ql[2 * src[k] + 1] : qh[src[k]];
      } else if (src[k] == -2) {
        swap_values(ml[0], ml[1]);
        swap_values(mh[0], mh[1]);
      }
      lo_out[w * m + i] = ml[0];
      hi_out[w * m + i] = mh[0];
    }
    if (queued) __syncwarp();  // the queue is read before it refills
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      p[k] = p_next[k];
      q[k] = q_next[k];
    }
  }
}

template <typename T, bool Span>
cudaError_t launch_kernel(dim3 grid, cudaStream_t s, const void* keys,
                          const void* probes, const void* probes_hi,
                          void* lo, void* hi, int64_t n, int64_t m,
                          int shift, int s_len) {
  constexpr int bytes = (int)sizeof(Shared<T, Span>);
  static bool sized = false;  // shared memory past 48 KB is opted into
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_kernel<T, Span>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  probe_kernel<T, Span><<<grid, kThreads, bytes, s>>>(
      (const T*)keys, (const T*)probes, (const T*)probes_hi, (int32_t*)lo,
      (int32_t*)hi, n, m, shift, s_len);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* keys, const void* probes, const void* probes_hi,
           void* lo, void* hi, int w, int64_t n, int64_t m, int span,
           void* stream) {
  if (w == 0 || m == 0) return (int)cudaSuccess;
  // blocks per worker: one chunk for each warp, at most the blocks the
  // card holds at once over all workers
  static int sms = 0;  // the card's SM count, read once
  if (sms == 0) {
    int dev;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t max_bpw = ((int64_t)sms * kBlocksPerSm + w - 1) / w;
  const int64_t pass = kThreads * items(span != 0);
  int64_t bpw = (m + pass - 1) / pass;
  if (bpw > max_bpw) bpw = max_bpw;
  // a sample no longer than the probes a block takes (or it costs more to
  // stage than it saves), and no larger than the shared buffer
  int64_t cap = (m + bpw - 1) / bpw;
  if (cap < kThreads) cap = kThreads;  // one load a thread costs one trip
  const int64_t smem_cap = kSampleBytes / (int64_t)sizeof(T);
  if (cap > smem_cap) cap = smem_cap;
  int shift = 0;
  while (((n + (int64_t(1) << shift) - 1) >> shift) > cap) ++shift;
  const int s_len = (int)((n + (int64_t(1) << shift) - 1) >> shift);
  const dim3 grid((unsigned)bpw, (unsigned)w);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(span ? launch_kernel<T, true>(grid, s, keys, probes, probes_hi,
                                             lo, hi, n, m, shift, s_len)
                    : launch_kernel<T, false>(grid, s, keys, probes,
                                              probes_hi, lo, hi, n, m, shift,
                                              s_len));
}

}  // namespace

extern "C" int adhash_range_search_i64(const void* keys, const void* probes,
                                       const void* probes_hi, void* lo,
                                       void* hi, int w, int64_t n, int64_t m,
                                       int span, void* stream) {
  return launch<int64_t>(keys, probes, probes_hi, lo, hi, w, n, m, span,
                         stream);
}

extern "C" int adhash_range_search_i32(const void* keys, const void* probes,
                                       const void* probes_hi, void* lo,
                                       void* hi, int w, int64_t n, int64_t m,
                                       int span, void* stream) {
  return launch<int32_t>(keys, probes, probes_hi, lo, hi, w, n, m, span,
                         stream);
}
