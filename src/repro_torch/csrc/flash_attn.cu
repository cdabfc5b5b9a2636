// flash_attention, float32: the attention forward pass on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_fwd :76, pallas_call at :97) for float32 inputs and
// computes the function of repro.models.attention._blocked_attn:
//
//   o[b,t,h] = softmax_s(q[b,t,h] . k[b,s,h/g] * hd^-1/2, masked) . v[b,s,h/g]
//
// with g = H / KV (grouped-query attention: each query head reads its KV
// head in place, nothing is repeated), the mask ``s < S``, when causal
// ``s <= q_offset + t`` (top-left alignment shifted by q_offset, as the
// Pallas kernel and _blocked_attn align it), and with a window w > 0
// ``s > q_offset + t - w``.  Inputs are (B, T, H, hd) and
// (B, S, KV, hd), contiguous, float32; T and S are any length (ragged tiles
// are masked in the kernel, nothing is padded).  bf16 inputs go to the
// tensor-core kernel of flash_attn_sm90.cu.
//
// Bound on the card: operations, on the f32 rate.  At T = S = 4096 and
// hd = 128 the function does 4*T*S*hd flops per head (halved when causal)
// on 2*(T+S)*hd elements.  The tensor cores would take f32 only as TF32,
// which keeps about three decimal digits and would not hold float32's
// 1e-4, so this kernel runs exact f32 FMAs on the CUDA cores (67 TFLOP/s
// peak) and keeps every operand in shared memory and registers.
//
// Design.  One CTA of 128 threads per (b*H + h, tile of 64 query rows).
// The CTA stages the scaled Q tile once, then walks the KV tiles of 64 keys
// (only those at or below the diagonal when causal): K and V go to shared
// memory, each thread computes a 4 x 8 block of scores (rows ty*4..,
// columns tx + 8j), keeps its 4 rows' running max and partial sum in
// registers (the 8 threads of a row reduce with shuffles), writes P over
// the K buffer and accumulates P.V into its 4 rows' slice of the output.
// Causal CTAs run longest-first (the last query tile is blockIdx.x = 0).
// With a window the CTA starts at the first key tile its first row sees,
// and masks the tiles that cross a row's left edge; a window of at least
// q_offset + T hides nothing and runs the unwindowed schedule (same bits).
// Shared memory: 97 KB at hd = 128, two CTAs per SM; 193 KB at hd = 256
// (recurrentgemma-2b's heads), one CTA per SM, and an accumulator of 4
// rows x 32 columns a thread.
//
// When ``lse`` is not null the kernel also stores each row's log-sum-exp of
// the scaled logits, (B, H, T) float32, which the backward
// (flash_attn_bwd.cu) takes to recompute the softmax.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64;        // query rows per CTA
constexpr int kBN = 64;        // keys per KV tile
constexpr int kThreads = 128;  // 16 row groups (ty) x 8 column lanes (tx)
constexpr int kRows = 4;       // query rows per thread
constexpr int kCols = 8;       // score columns per thread (tx + 8j)
constexpr int kPld = kBN + 4;  // row stride of P in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// Rows [0, 64) of a (rows, HD) matrix with row stride ``ld`` into shared
// memory times ``mul``, row stride ``sld``; rows at or past ``valid`` are
// zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* sm, int sld, const float* g,
                                          int64_t ld, int64_t valid,
                                          float mul) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < kBN * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    const float4 x = r < valid
                         ? *reinterpret_cast<const float4*>(g + r * ld + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(sm + r * sld + c) =
        make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
  }
}

template <int VEC>
struct VecF;
template <>
struct VecF<4> {
  using type = float4;
};
template <>
struct VecF<2> {
  using type = float2;
};

template <int HD>
constexpr int smem_floats() {
  return kBM * HD                                              // Q
         + (kBN * (HD + 4) > kBM * kPld ? kBN * (HD + 4) : kBM * kPld)  // K|P
         + kBN * HD;                                           // V
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int64_t t_len,
                  int64_t s_len, int n_heads, int n_kv, int causal,
                  int64_t q_offset, int64_t window, float qscale) {
  // output columns per thread: NCH chunks of VEC at chunk*8*VEC + tx*VEC
  constexpr int VEC = HD >= 32 ? 4 : 2;
  constexpr int NCH = HD / (8 * VEC);
  constexpr int KLD = HD + 4;  // padded: the 8 lanes of a row group read
                               // 8 different keys without bank conflicts
  using VF = typename VecF<VEC>::type;

  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBM * HD;  // also P once the scores are taken
  float* Vs = Ks + (kBN * KLD > kBM * kPld ? kBN * KLD : kBM * kPld);

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int kh = h / (n_heads / n_kv);
  const int n_qt = (int)((t_len + kBM - 1) / kBM);
  const int qt = causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int64_t m0 = (int64_t)qt * kBM;

  const int64_t q_ld = (int64_t)n_heads * HD;
  const int64_t kv_ld = (int64_t)n_kv * HD;
  const float* qb = q + ((int64_t)b * t_len * n_heads + h) * HD + m0 * q_ld;
  const float* kb = k + ((int64_t)b * s_len * n_kv + kh) * HD;
  const float* vb = v + ((int64_t)b * s_len * n_kv + kh) * HD;

  load_tile<HD>(Qs, HD, qb, q_ld, t_len - m0, qscale);

  int64_t n_tiles = (s_len + kBN - 1) / kBN;
  if (causal) {
    const int64_t last = q_offset + min(m0 + kBM, t_len) - 1;
    n_tiles = min(n_tiles, last / kBN + 1);
  }
  // none wholly left of the first row's window
  int64_t first = 0;
  if (window > 0 && q_offset + m0 - window + 1 > 0)
    first = min((q_offset + m0 - window + 1) / kBN, n_tiles);

  float acc[kRows][NCH * VEC];
  float m_run[kRows];
  float l_run[kRows];  // this thread's columns only; reduced at the end
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH * VEC; ++c) acc[i][c] = 0.f;
  }
  const int64_t qpos0 = q_offset + m0 + ty * kRows;

  for (int64_t tile = first; tile < n_tiles; ++tile) {
    const int64_t n0 = tile * kBN;
    __syncthreads();  // the previous tile's P and V are consumed
    load_tile<HD>(Ks, KLD, kb + n0 * kv_ld, kv_ld, s_len - n0, 1.f);
    load_tile<HD>(Vs, HD, vb + n0 * kv_ld, kv_ld, s_len - n0, 1.f);
    __syncthreads();

    // scores: 4 rows x 8 columns per thread, already in log2 units
    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows];
      float4 kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * kRows + i) * HD +
                                                 d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * KLD + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float s = sc[i][j];
          s = fmaf(qv[i].x, kv[j].x, s);
          s = fmaf(qv[i].y, kv[j].y, s);
          s = fmaf(qv[i].z, kv[j].z, s);
          s = fmaf(qv[i].w, kv[j].w, s);
          sc[i][j] = s;
        }
    }

    // mask and online softmax; the 8 lanes of a row group hold one row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int64_t kpos = n0 + tx + 8 * j;
        const bool ok = kpos < s_len && (!causal || kpos <= qpos0 + i) &&
                        (window <= 0 || kpos > qpos0 + i - window);
        sc[i][j] = ok ? sc[i][j] : -CUDART_INF_F;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(ADHASH_FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(ADHASH_FULL_MASK, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(ADHASH_FULL_MASK, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float corr = exp2f(m_run[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        sc[i][j] = exp2f(sc[i][j] - base);
        sum += sc[i][j];
      }
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCH * VEC; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done reading K
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        Ps[(ty * kRows + i) * kPld + tx + 8 * j] = sc[i][j];
    __syncthreads();

    // acc += P . V over the tile's 64 keys
#pragma unroll 2
    for (int s0 = 0; s0 < kBN; s0 += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * kRows + i) * kPld +
                                                 s0);
#pragma unroll
      for (int ss = 0; ss < 4; ++ss) {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const VF vv = *reinterpret_cast<const VF*>(
              Vs + (s0 + ss) * HD + ch * 8 * VEC + tx * VEC);
          const float* ve = reinterpret_cast<const float*>(&vv);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float p = ss == 0   ? pv[i].x
                            : ss == 1 ? pv[i].y
                            : ss == 2 ? pv[i].z
                                      : pv[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][ch * VEC + e] = fmaf(p, ve[e], acc[i][ch * VEC + e]);
          }
        }
      }
    }
  }

  // normalise and store this thread's rows
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(ADHASH_FULL_MASK, l, 1);
    l += __shfl_xor_sync(ADHASH_FULL_MASK, l, 2);
    l += __shfl_xor_sync(ADHASH_FULL_MASK, l, 4);
    const int64_t r = m0 + ty * kRows + i;
    if (r >= t_len) continue;
    if (lse != nullptr && tx == 0)  // m and l are in log2 units
      lse[((int64_t)b * n_heads + h) * t_len + r] =
          (m_run[i] + log2f(fmaxf(l, 1e-30f))) * 0.6931471805599453f;
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    float* orow = o + (((int64_t)b * t_len + r) * n_heads + h) * HD;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      VF out;
      float* vals = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = acc[i][ch * VEC + e] * inv_l;
      *reinterpret_cast<VF*>(orow + ch * 8 * VEC + tx * VEC) = out;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int64_t t, int64_t s, int h, int kv, int causal,
           int64_t q_offset, int64_t window, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((t + kBM - 1) / kBM), (unsigned)(b * h));
  const float qscale = kLog2e / sqrtf((float)HD);
  flash_attn_kernel<HD><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, t, s, h, kv, causal, q_offset, window, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (b, t, h, hd) float32; k, v: (b, s, kv, hd) float32; all contiguous
// and 16-byte aligned, h a multiple of kv, hd in {16, 32, 64, 128, 256};
// window 0 (none) or the number of keys a query sees, itself included; lse
// (b, h, t) float32 or null.  A row that sees no key gets zeros and an LSE
// of -inf.
extern "C" int adhash_flash_attn_f32(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int b, int64_t t,
                                     int64_t s, int h, int kv, int hd,
                                     int causal, int64_t q_offset,
                                     int64_t window, void* stream) {
  if (b == 0 || t == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, lse, b, t, s, h, kv, causal, q_offset,
                        window, st);
    case 32:
      return launch<32>(q, k, v, o, lse, b, t, s, h, kv, causal, q_offset,
                        window, st);
    case 64:
      return launch<64>(q, k, v, o, lse, b, t, s, h, kv, causal, q_offset,
                        window, st);
    case 128:
      return launch<128>(q, k, v, o, lse, b, t, s, h, kv, causal, q_offset,
                         window, st);
    case 256:
      return launch<256>(q, k, v, o, lse, b, t, s, h, kv, causal, q_offset,
                         window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
