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
// of ``lo_keys`` and ``hi_keys``.  Templated on int64 keys (the composite
// p*NID+s|o index keys) and int32 keys (the candidate keys finalize_join
// sorts).  For a probe equal to the pad value this returns ``hi = N`` where
// the Pallas kernel returns the padded length; callers mask that case.
//
// Bound on the card: dependent loads through L2.  One thread per (worker,
// probe) runs a binary search of log2(N) dependent loads for the left end;
// each load pulls a 32-byte sector, so at M = 2^16 probes and N = 2^20
// keys per worker the sector traffic through L2, not HBM, is what the time
// tracks.  A worker's key row (a few MB at the LUBM sizes) stays in the
// 50 MB L2, and neighbouring probes share the top levels of the search, so
// those hit in L1.  The right end is found by galloping from the left end
// (match ranges are short: usually one or two loads next to a[lo], already
// in cache) instead of a second full search.
#include "common.cuh"

namespace {

// First index in [lo, n) whose key fails ``a[j] <= x`` (Upper) or
// ``a[j] < x`` (lower), given that every key before lo passes: probe a[lo]
// and then keys at doubling distances until one fails, then binary-search
// the last gap.  O(log(answer - lo)) loads.
template <typename T, bool Upper>
__device__ __forceinline__ int64_t gallop(const T* a, int64_t lo, int64_t n,
                                          T x) {
  int64_t hi = lo;
  int64_t step = 1;
  while (hi < n && (Upper ? a[hi] <= x : a[hi] < x)) {
    lo = hi + 1;
    hi = lo + step;
    step <<= 1;
  }
  if (hi > n) hi = n;
  return Upper ? adhash::upper_bound(a, lo, hi, x)
               : adhash::lower_bound(a, lo, hi, x);
}

template <typename T>
__global__ void probe_kernel(const T* __restrict__ keys,
                             const T* __restrict__ probes,
                             const T* __restrict__ probes_hi,
                             int32_t* __restrict__ lo_out,
                             int32_t* __restrict__ hi_out, int64_t n,
                             int64_t m, int span) {
  const int64_t w = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const T* row = keys + w * n;
  const T p = probes[w * m + i];
  const int64_t lo = adhash::lower_bound(row, 0, n, p);
  int64_t hi;
  if (span) {
    const T q = probes_hi[w * m + i];
    // every a[j] < p <= q for j < lo, so the answer lies at or past lo
    hi = q >= p ? gallop<T, false>(row, lo, n, q)
                : adhash::lower_bound(row, 0, n, q);
  } else {
    hi = gallop<T, true>(row, lo, n, p);
  }
  lo_out[w * m + i] = (int32_t)lo;
  hi_out[w * m + i] = (int32_t)hi;
}

template <typename T>
int launch(const void* keys, const void* probes, const void* probes_hi,
           void* lo, void* hi, int w, int64_t n, int64_t m, int span,
           void* stream) {
  if (w == 0 || m == 0) return (int)cudaSuccess;
  const int threads = 256;
  dim3 grid((unsigned)((m + threads - 1) / threads), (unsigned)w);
  probe_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)keys, (const T*)probes, (const T*)probes_hi, (int32_t*)lo,
      (int32_t*)hi, n, m, span);
  return (int)cudaGetLastError();
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
