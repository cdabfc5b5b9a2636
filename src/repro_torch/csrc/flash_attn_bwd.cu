// flash_attention backward, float32: dq, dk and dv of the attention forward
// pass, on the CUDA cores.
//
// No TPU kernel to replace: the JAX package differentiates
// src/repro/models/attention.py:_blocked_attn (:62) by autodiff.  This
// computes what that autodiff computes, from the forward's output O and
// per-row log-sum-exp L (flash_attn.cu / flash_attn_sm90.cu store it):
//
//   P  = exp(Q K^T * hd^-1/2 - L)   (masked: s < S; s <= q_offset + t
//                                    when causal, top-left aligned; with a
//                                    window w > 0 also s > q_offset + t - w)
//   D  = rowsum(dO o O)
//   dS = P o (dO V^T - D)
//   dQ = hd^-1/2 dS K,   dK = hd^-1/2 dS^T Q,   dV = P^T dO
//
// with dK and dV summed over the H / KV query heads of each KV head (GQA).
// q, o, dO, dq: (B, T, H, hd); k, v, dk, dv: (B, S, KV, hd); contiguous,
// float32; L and D (B, H, T) float32; hd in {16, 32, 64, 128, 256}.  Every
// product and sum is float32.  A window of at least q_offset + T hides
// nothing and gives the unwindowed launch's bits; a query row that sees no
// key (only a window can make one) is outside the contract, as in the
// forward.  bf16 inputs go to the tensor-core kernel of
// flash_attn_bwd_sm90.cu.
//
// Bound on the card: operations.  With P recomputed in both passes a
// (query tile, key tile) pair costs 7 products of 64 x 64 x hd (S and dP
// twice, dV, dK, dQ), 3.5x the forward's two.  The tensor cores would take
// f32 only as TF32, which would not hold float32's 1e-4, so this kernel
// runs exact f32 FMAs on the CUDA cores (67 TFLOP/s peak).
//
// Design: three launches, deterministic, no atomics (two launches on the
// same inputs give the same bits).
//  1. ``bwd_rowdot``: one warp per (b, t, h) row computes D.
//  2. ``bwd_dkdv``: one CTA of 256 threads per (b, KV head, tile of 64
//     keys).  K and V stay in shared memory; the CTA walks the query tiles
//     of every query head of the group (when causal, only those at or past
//     the tile's first key; with a window, only those whose rows' windows
//     reach its last key), recomputes P^T and dS^T (64 x 64, a 4 x 4
//     block a thread) and accumulates dV += P^T dO and dK += dS^T Q in
//     registers (4 keys x hd/16 columns a thread each).
//  3. ``bwd_dq``: one CTA per (b * H + h, tile of 64 queries), longest
//     first when causal; Q, dO, L and D stay in shared memory, the CTA
//     walks the key tiles from the one its first row's window starts in
//     (0 without a window) up to the diagonal and accumulates dQ += dS K.
// Rows past T and keys past S are loaded as zeros and masked out of P, so
// they add nothing to any sum.  Shared memory at hd = 128: 170 KB (dK dV)
// and 153 KB (dQ), one CTA per SM.  At hd 256 four 64-row tiles of 256
// floats would take 302 KB, over the 227 KB a CTA may have, so the tiles
// there are 32 rows (a 2 x 2 block of the 32 x 32 P^T a thread; 143 KB and
// 138 KB), the same code at another tile size.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 row groups (ty) x 16 column lanes (tx)
constexpr float kLog2e = 1.4426950408889634f;

// Tile sizes at head dim HD: B rows of a query tile and of a key tile (64;
// 32 at hd 256, where 64-row tiles exceed a CTA's shared memory); each
// thread owns R rows (ty * R + i) and C columns (tx + 16 * j) of the B x B
// P^T and dS^T tiles, whose smem row stride is PLD.
template <int HD>
struct Tiles {
  static constexpr int B = HD > 128 ? 32 : 64;
  static constexpr int R = B / 16;
  static constexpr int C = B / 16;
  static constexpr int PLD = B + 4;
};

// Four consecutive floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Columns a thread owns in a 64 x HD accumulator: NC = HD / 16 of them, in
// NCH chunks of VEC consecutive columns at ch * 16 * VEC + tx * VEC.
template <int HD>
struct Cols {
  static constexpr int NC = HD / 16;
  static constexpr int VEC = NC < 4 ? NC : 4;
  static constexpr int NCH = NC / VEC;
  static constexpr int LD = HD + 4;  // row stride of a 64 x HD smem tile
};

// Rows [0, B) of a (rows, HD) matrix with row stride ``ld`` into shared
// memory as float, row stride HD + 4; rows at or past ``valid`` are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* sm, const float* g,
                                          int64_t ld, int64_t valid) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < Tiles<HD>::B * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    const float4 x =
        r < valid ? load4(g + r * ld + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(sm + r * Cols<HD>::LD + c) = x;
  }
}

// acc[i][j] = a[ty*R + i] . b[tx + 16j] over HD (two B x HD smem tiles).
template <int HD, int kR = Tiles<HD>::R, int kC = Tiles<HD>::C>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         float (&acc)[kR][kC], int ty,
                                         int tx) {
  constexpr int LD = Cols<HD>::LD;
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[kR], bv[kC];
#pragma unroll
    for (int i = 0; i < kR; ++i) av[i] = load4(a + (ty * kR + i) * LD + d);
#pragma unroll
    for (int j = 0; j < kC; ++j) bv[j] = load4(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        s = fmaf(av[i].w, bv[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][c] += sum_m p[ty*R + i][m] * x[m][col(c)]: p a B x B smem tile
// (row stride PLD), x a B x HD smem tile.
template <int HD, int kR = Tiles<HD>::R>
__device__ __forceinline__ void acc_tile(const float* p, const float* x,
                                         float (&acc)[kR][HD / 16], int ty,
                                         int tx) {
  using C = Cols<HD>;
  constexpr int kPld = Tiles<HD>::PLD;
#pragma unroll 2
  for (int m = 0; m < Tiles<HD>::B; m += 4) {
    float4 pv[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) pv[i] = load4(p + (ty * kR + i) * kPld + m);
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const float* xr = x + (m + mm) * C::LD + tx * C::VEC;
#pragma unroll
      for (int ch = 0; ch < C::NCH; ++ch) {
        float xv[C::VEC];
        if constexpr (C::VEC == 4) {
          const float4 t = load4(xr + ch * 16 * C::VEC);
          xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
        } else if constexpr (C::VEC == 2) {
          const float2 t = *reinterpret_cast<const float2*>(xr);
          xv[0] = t.x; xv[1] = t.y;
        } else {
          xv[0] = xr[0];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const float pi = mm == 0 ? pv[i].x
                           : mm == 1 ? pv[i].y
                           : mm == 2 ? pv[i].z
                                     : pv[i].w;
#pragma unroll
          for (int e = 0; e < C::VEC; ++e)
            acc[i][ch * C::VEC + e] = fmaf(pi, xv[e], acc[i][ch * C::VEC + e]);
        }
      }
    }
  }
}

// Rows ty*R + i (< valid) of a B x HD accumulator, times ``mul``, into
// global memory with row stride ``ld``.
template <int HD, int kR = Tiles<HD>::R>
__device__ __forceinline__ void store_acc(float* g, int64_t ld, int64_t valid,
                                          const float (&acc)[kR][HD / 16],
                                          float mul, int ty, int tx) {
  using C = Cols<HD>;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty * kR + i;
    if (r >= valid) continue;
#pragma unroll
    for (int ch = 0; ch < C::NCH; ++ch)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        g[r * ld + ch * 16 * C::VEC + tx * C::VEC + e] =
            acc[i][ch * C::VEC + e] * mul;
  }
}

// 1. D[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d], one warp a row.
template <int HD>
__global__ void __launch_bounds__(kThreads)
bwd_rowdot(const float* __restrict__ o, const float* __restrict__ dout,
           float* __restrict__ dsum, int64_t rows, int64_t t_len,
           int n_heads) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane * 4; d < HD; d += 128) {
    const float4 a = load4(o + row * HD + d);
    const float4 b = load4(dout + row * HD + d);
    s += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(ADHASH_FULL_MASK, s, off);
  if (lane == 0) {
    const int64_t h = row % n_heads;
    const int64_t bt = row / n_heads;  // b * T + t
    const int64_t b = bt / t_len;
    dsum[(b * n_heads + h) * t_len + bt % t_len] = s;
  }
}

template <int HD>
constexpr int dkdv_smem_floats() {
  using T = Tiles<HD>;
  return 4 * T::B * Cols<HD>::LD + 2 * T::B * T::PLD + 2 * T::B;
}
template <int HD>
constexpr int dq_smem_floats() {
  using T = Tiles<HD>;
  return 4 * T::B * Cols<HD>::LD + T::B * T::PLD + 2 * T::B;
}
static_assert(dkdv_smem_floats<256>() * 4 <= 227 * 1024 &&
                  dkdv_smem_floats<128>() * 4 <= 227 * 1024,
              "tiles exceed a CTA's shared memory");

// 2. dK and dV of one tile of B keys of one KV head.
template <int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ dsum,
         float* __restrict__ dk, float* __restrict__ dv, int64_t t_len,
         int64_t s_len, int n_heads, int n_kv, int causal, int64_t q_offset,
         int64_t window, float scale) {
  constexpr int LD = Cols<HD>::LD;
  constexpr int NC = Cols<HD>::NC;
  constexpr int kB = Tiles<HD>::B, kR = Tiles<HD>::R, kC = Tiles<HD>::C;
  constexpr int kPld = Tiles<HD>::PLD;
  extern __shared__ float4 smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;
  float* Os = Qs + kB * LD;  // dO
  float* Ps = Os + kB * LD;  // P^T (keys x queries)
  float* Ss = Ps + kB * kPld;  // dS^T
  float* Ls = Ss + kB * kPld;  // L of the query tile, log2 units
  float* Dd = Ls + kB;         // D of the query tile

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int b = blockIdx.y / n_kv;
  const int kh = blockIdx.y % n_kv;
  const int g = n_heads / n_kv;
  const int64_t n0 = (int64_t)blockIdx.x * kB;
  const int64_t q_ld = (int64_t)n_heads * HD;
  const int64_t kv_ld = (int64_t)n_kv * HD;
  const int64_t kv_off = ((int64_t)b * s_len * n_kv + kh) * HD + n0 * kv_ld;
  load_tile<HD>(Ks, k + kv_off, kv_ld, s_len - n0);
  load_tile<HD>(Vs, v + kv_off, kv_ld, s_len - n0);

  float dk_acc[kR][NC], dv_acc[kR][NC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // when causal, query t sees this tile only if q_offset + t >= n0; with a
  // window only if q_offset + t - window < n0 + kB - 1 (its last key)
  const int64_t m_first =
      causal ? (n0 > q_offset ? (n0 - q_offset) / kB * kB : 0) : 0;
  const int64_t m_stop =
      window > 0 ? max((int64_t)0,
                       min(t_len, n0 + kB + window - 1 - q_offset))
                 : t_len;
  const float scale_log2 = scale * kLog2e;
  for (int hh = 0; hh < g; ++hh) {
    const int h = kh * g + hh;
    const int64_t q_off = ((int64_t)b * t_len * n_heads + h) * HD;
    const int64_t r_off = ((int64_t)b * n_heads + h) * t_len;
    for (int64_t m0 = m_first; m0 < m_stop; m0 += kB) {
      __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are read
      load_tile<HD>(Qs, q + q_off + m0 * q_ld, q_ld, t_len - m0);
      load_tile<HD>(Os, dout + q_off + m0 * q_ld, q_ld, t_len - m0);
      if (tid < kB) {
        const int64_t t = m0 + tid;
        Ls[tid] = t < t_len ? lse[r_off + t] * kLog2e : 0.f;
        Dd[tid] = t < t_len ? dsum[r_off + t] : 0.f;
      }
      __syncthreads();
      float s[kR][kC], dp[kR][kC];
      dot_tile<HD>(Ks, Qs, s, ty, tx);   // K Q^T
      dot_tile<HD>(Vs, Os, dp, ty, tx);  // V dO^T
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          const int m = tx + 16 * j;
          const int64_t kpos = n0 + ty * kR + i;
          const int64_t t = m0 + m;
          const bool ok = kpos < s_len && t < t_len &&
                          (!causal || kpos <= q_offset + t) &&
                          (window <= 0 || kpos > q_offset + t - window);
          const float p =
              ok ? exp2f(fmaf(s[i][j], scale_log2, -Ls[m])) : 0.f;
          Ps[(ty * kR + i) * kPld + m] = p;
          Ss[(ty * kR + i) * kPld + m] = p * (dp[i][j] - Dd[m]);
        }
      __syncthreads();
      acc_tile<HD>(Ps, Os, dv_acc, ty, tx);  // dV += P^T dO
      acc_tile<HD>(Ss, Qs, dk_acc, ty, tx);  // dK += dS^T Q
    }
  }
  store_acc<HD>(dk + kv_off, kv_ld, s_len - n0, dk_acc, scale, ty, tx);
  store_acc<HD>(dv + kv_off, kv_ld, s_len - n0, dv_acc, 1.f, ty, tx);
}

// 3. dQ of one tile of B queries of one query head.
template <int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ dsum,
       float* __restrict__ dq, int64_t t_len, int64_t s_len, int n_heads,
       int n_kv, int causal, int64_t q_offset, int64_t window, float scale) {
  constexpr int LD = Cols<HD>::LD;
  constexpr int NC = Cols<HD>::NC;
  constexpr int kB = Tiles<HD>::B, kR = Tiles<HD>::R, kC = Tiles<HD>::C;
  constexpr int kPld = Tiles<HD>::PLD;
  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Os = Qs + kB * LD;  // dO
  float* Ks = Os + kB * LD;
  float* Vs = Ks + kB * LD;
  float* Ss = Vs + kB * LD;  // dS (queries x keys)
  float* Ls = Ss + kB * kPld;
  float* Dd = Ls + kB;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int b = blockIdx.y / n_heads;
  const int h = blockIdx.y % n_heads;
  const int kh = h / (n_heads / n_kv);
  const int64_t n_qt = (t_len + kB - 1) / kB;
  const int64_t qt = causal ? n_qt - 1 - blockIdx.x : blockIdx.x;
  const int64_t m0 = qt * kB;
  const int64_t q_ld = (int64_t)n_heads * HD;
  const int64_t kv_ld = (int64_t)n_kv * HD;
  const int64_t q_off = ((int64_t)b * t_len * n_heads + h) * HD + m0 * q_ld;
  const int64_t r_off = ((int64_t)b * n_heads + h) * t_len;
  const int64_t kv_off = ((int64_t)b * s_len * n_kv + kh) * HD;
  load_tile<HD>(Qs, q + q_off, q_ld, t_len - m0);
  load_tile<HD>(Os, dout + q_off, q_ld, t_len - m0);
  if (tid < kB) {
    const int64_t t = m0 + tid;
    Ls[tid] = t < t_len ? lse[r_off + t] * kLog2e : 0.f;
    Dd[tid] = t < t_len ? dsum[r_off + t] : 0.f;
  }

  int64_t n_tiles = (s_len + kB - 1) / kB;
  if (causal) {
    const int64_t last = q_offset + min(m0 + kB, t_len) - 1;
    n_tiles = min(n_tiles, last / kB + 1);
  }
  // with a window, from the key tile the first row's window starts in
  int64_t first = 0;
  if (window > 0 && q_offset + m0 - window + 1 > 0)
    first = min((q_offset + m0 - window + 1) / kB, n_tiles);
  float dq_acc[kR][NC];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;
  const float scale_log2 = scale * kLog2e;
  for (int64_t tile = first; tile < n_tiles; ++tile) {
    const int64_t n0 = tile * kB;
    __syncthreads();  // the previous tile's K and dS are read
    load_tile<HD>(Ks, k + kv_off + n0 * kv_ld, kv_ld, s_len - n0);
    load_tile<HD>(Vs, v + kv_off + n0 * kv_ld, kv_ld, s_len - n0);
    __syncthreads();
    float s[kR][kC], dp[kR][kC];
    dot_tile<HD>(Qs, Ks, s, ty, tx);   // Q K^T
    dot_tile<HD>(Os, Vs, dp, ty, tx);  // dO V^T
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int r = ty * kR + i;
        const int64_t t = m0 + r;
        const int64_t kpos = n0 + tx + 16 * j;
        const bool ok = kpos < s_len && t < t_len &&
                        (!causal || kpos <= q_offset + t) &&
                        (window <= 0 || kpos > q_offset + t - window);
        const float p = ok ? exp2f(fmaf(s[i][j], scale_log2, -Ls[r])) : 0.f;
        Ss[r * kPld + tx + 16 * j] = p * (dp[i][j] - Dd[r]);
      }
    __syncthreads();
    acc_tile<HD>(Ss, Ks, dq_acc, ty, tx);  // dQ += dS K
  }
  store_acc<HD>(dq + q_off, q_ld, t_len - m0, dq_acc, scale, ty, tx);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dsum, void* dq, void* dk,
           void* dv, int b, int64_t t, int64_t s, int h, int kv, int causal,
           int64_t q_offset, int64_t window, cudaStream_t stream) {
  constexpr int kB = Tiles<HD>::B;
  const size_t smem_kv = dkdv_smem_floats<HD>() * sizeof(float);
  const size_t smem_q = dq_smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)HD);
  const int64_t rows = (int64_t)b * t * h;
  bwd_rowdot<HD><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                   kThreads, 0, stream>>>(
      (const float*)o, (const float*)dout, (float*)dsum, rows, t, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv<HD><<<dim3((unsigned)((s + kB - 1) / kB), (unsigned)(b * kv)),
                 kThreads, smem_kv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)dsum, (float*)dk, (float*)dv, t, s, h,
      kv, causal, q_offset, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq<HD><<<dim3((unsigned)((t + kB - 1) / kB), (unsigned)(b * h)),
               kThreads, smem_q, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)dsum, (float*)dq, t, s, h, kv, causal,
      q_offset, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (b, t, h, hd); k, v, dk, dv: (b, s, kv, hd); float32,
// contiguous, 16-byte aligned; lse (b, h, t) float32; dsum: scratch for D,
// at least b * h * t float32; h a multiple of kv; hd in {16, 32, 64, 128,
// 256}; t, s < 2^31; window 0 (none) or the number of keys a query sees,
// itself included.
extern "C" int adhash_flash_attn_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dsum, void* dq, void* dk,
    void* dv, int b, int64_t t, int64_t s, int h, int kv, int hd, int causal,
    int64_t q_offset, int64_t window, void* stream) {
  if (b == 0 || t == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, t, s, h,
                        kv, causal, q_offset, window, st);
    case 32:
      return launch<32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, t, s, h,
                        kv, causal, q_offset, window, st);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, t, s, h,
                        kv, causal, q_offset, window, st);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, t, s, h,
                         kv, causal, q_offset, window, st);
    case 256:
      return launch<256>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, t, s, h,
                         kv, causal, q_offset, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
