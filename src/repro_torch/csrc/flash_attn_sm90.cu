// flash_attention, bf16: the attention forward pass on Hopper's tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_fwd :76, pallas_call at :97) for bf16 inputs and computes
// the function of repro.models.attention._blocked_attn for window = 0:
//
//   o[b,t,h] = softmax_s(q[b,t,h] . k[b,s,h/g] * hd^-1/2, masked) . v[b,s,h/g]
//
// with g = H / KV (each query head reads its KV head in place), the mask
// ``s < S`` and, when causal, ``s <= q_offset + t`` (top-left alignment
// shifted by q_offset).  q, o: (B, T, H, hd); k, v: (B, S, KV, hd); bf16,
// contiguous; hd in {16, 32, 64, 128}; any T and S below 2^31.  Q.K^T is
// bf16 x bf16 summed in f32 (as the Pallas kernel computes it); logits, the
// running max and sum and the accumulator are f32; P is rounded to bf16 for
// the P.V product; the output is bf16.  float32 inputs go to the CUDA-core
// kernel of flash_attn.cu: TF32 would not hold f32's 1e-4.
//
// Bound on the card: operations.  A head does 4*T*S*hd flops (halved when
// causal) on 2*(T+S)*hd bf16 values, ~1000 flops per byte at T = S = 4096
// and hd = 128, far above the ~295 bf16 flops per byte of HBM at which the
// tensor cores (989 TFLOP/s dense) become the limit.  So the design keeps
// the tensor cores fed and everything else off their path:
//
//  * One CTA of 384 threads per (b*H + h, tile of 128 query rows): a
//    producer warpgroup that gives its registers away (setmaxnreg 24) and
//    two consumer warpgroups (setmaxnreg 240), each owning 64 query rows.
//  * TMA.  One 4-D tensor map per operand over (hd, heads, length, B); a
//    box of (min(hd, 64), 1, 128, 1) picks the head by coordinate and
//    zero-fills rows past T or S inside each batch, so a ragged tail never
//    reads the next batch's rows and no thread computes an address.  One
//    thread of the producer loads the Q tile once, then K and V tiles of
//    128 keys into a ring of 2 stages; mbarriers mark each stage full
//    (TMA transaction bytes) or empty (one arrival per consumer warp).
//  * Swizzle matching a row's bytes (32 B at hd = 16, 64 B at hd = 32,
//    128 B from hd = 64; at hd = 128 a tile is two 64-column boxes), the
//    same pattern on both sides: TMA writes it, wgmma's descriptors read it.
//  * S = Q.K^T: wgmma m64n128k16, both operands K-major from shared
//    memory, hd/16 k-steps; scale * log2(e) is applied to the f32 scores.
//  * Online softmax in registers on the accumulator's fragment layout: a
//    thread holds 2 rows x 32 columns, a row spans the 4 lanes of a quad
//    (shfl_xor 1 and 2).  A row with no visible key yet keeps a -inf max
//    and a zero base, so no inf - inf appears.
//  * O += P.V: wgmma m64n{hd}k16 with P as bf16 A fragments in registers
//    (the S accumulator's layout is the A operand's, no shuffle) and V read
//    from shared memory as an MN-major (transposed) B operand, so V needs
//    no transpose copy.
//  * Causal: tiles above a warpgroup's diagonal are skipped, only tiles
//    that cross it are masked; the last query tile runs first.
//
// Shared memory at hd = 128: Q 32 KB + 2 stages x (K 32 KB + V 32 KB) =
// 160 KB (+1 KB for alignment), one CTA per SM; at hd = 64 it is 80 KB.
// Registers: 168 a thread at launch (384 x 168 = 64,512 of the SM's 65,536),
// redistributed to 24 (producer) and 240 (consumers) by setmaxnreg; the
// build log (`-Xptxas -v`) prints the figure and any spill.
// When ``lse`` is not null the epilogue also stores each row's log-sum-exp
// of the scaled logits, (B, H, T) float32, for the backward
// (flash_attn_bwd_sm90.cu): one lane of each quad, from the m and l it holds.
// Not in this kernel yet: ping-pong scheduling of the two consumer
// warpgroups, overlap of the softmax with the next wgmma, persistent CTAs.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace adhash::sm90;

constexpr int kBM = 128;       // query rows per CTA
constexpr int kBN = 128;       // keys per KV tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;

// Shared memory of a CTA: the Q tile and kStages (K, V) tiles of 128 rows,
// + barriers, + alignment.
template <int HD>
constexpr size_t kSmem =
    (1 + 2 * kStages) * (size_t)Tile<HD, 128>::kBytes + 64 + 1024;

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_sm90(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int t_len, int s_len,
                int n_heads, int n_kv, int causal, int64_t q_offset,
                float scale_log2) {
  using L = Tile<HD, 128>;
  extern __shared__ uint8_t smem_raw[];
  // swizzle patterns repeat every 1024 bytes: align the tiles to that
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sq = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* sk = sq + L::kBytes;             // [kStages] tiles
  uint8_t* sv = sk + kStages * L::kBytes;   // [kStages] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kStages * L::kBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;               // [kStages]
  uint64_t* empty = bars + 1 + kStages;    // [kStages]

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int kh = h / (n_heads / n_kv);
  const int n_qt = (t_len + kBM - 1) / kBM;
  const int qt = causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int m0 = qt * kBM;
  int n_tiles = (s_len + kBN - 1) / kBN;
  if (causal) {
    const int64_t last = q_offset + min(m0 + kBM, t_len) - 1;
    n_tiles = (int)min((int64_t)n_tiles, last / kBN + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    mbar_expect_tx(q_full, L::kBytes);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      tma_load(sq + c * L::kChunkBytes, &tm_q, q_full, c * L::kCols, h, m0,
               b);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], 2 * L::kBytes);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load(sk + s * L::kBytes + c * L::kChunkBytes, &tm_k, &full[s],
                 c * L::kCols, kh, i * kBN, b);
        tma_load(sv + s * L::kBytes + c * L::kChunkBytes, &tm_v, &full[s],
                 c * L::kCols, kh, i * kBN, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int g = wg - 1;                  // rows [64g, 64g + 64) of the tile
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int cq = 2 * (lane & 3);           // its columns in each block of 8
  const int row0 = m0 + 64 * g;            // the warpgroup's first row
  // tiles this warpgroup reads: none past T, none above its diagonal
  int wg_tiles = row0 < t_len ? n_tiles : 0;
  if (causal && wg_tiles > 0) {
    const int64_t last = q_offset + min(row0 + 64, t_len) - 1;
    wg_tiles = (int)min((int64_t)wg_tiles, last / kBN + 1);
  }
  const int64_t qpos[2] = {q_offset + row0 + r0, q_offset + row0 + r0 + 8};

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};  // this thread's columns; reduced at the end

  const uint32_t q_addr = smem_u32(sq) + 64 * g * L::kRowBytes;
  const uint32_t k_addr = smem_u32(sk);
  const uint32_t v_addr = smem_u32(sv);
  constexpr uint32_t kSbo = 8 * L::kRowBytes;  // 8-row group stride
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    if (i < wg_tiles) {
      const int n0 = i * kBN;
      // ---- S = Q . K^T (64 x 128, f32)
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 / L::kCols;
        const uint32_t off = c * L::kChunkBytes + (kk * 16 % L::kCols) * 2;
        wgmma_ss<128>(sc, make_desc(q_addr + off, 16, kSbo, L::kLayout),
                      make_desc(k_addr + s * L::kBytes + off, 16, kSbo,
                                L::kLayout),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<64>(sc);

      // ---- mask: keys past S, and keys right of the diagonal
      if (n0 + kBN > s_len || (causal && n0 + kBN - 1 > q_offset + row0)) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t kpos = n0 + 8 * j + cq + (e & 1);
            const bool ok =
                kpos < s_len && (!causal || kpos <= qpos[e >> 1]);
            if (!ok) sc[4 * j + e] = -CUDART_INF_F;
          }
      }

      // ---- online softmax, rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(ADHASH_FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(ADHASH_FULL_MASK, mx, 2));
        const float m_new = fmaxf(m_run[r], mx * scale_log2);
        const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
        const float corr = exp2f(m_run[r] - base);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(sc[4 * j + 2 * r + e], scale_log2,
                                       -base));
            sc[4 * j + 2 * r + e] = p;
            sum += p;
          }
        l_run[r] = l_run[r] * corr + sum;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[4 * j + 2 * r] *= corr;
          acc[4 * j + 2 * r + 1] *= corr;
        }
      }

      // ---- O += P . V: P as bf16 A fragments, V MN-major from smem
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
      fence_regs<HD / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<HD>(acc, pa[kk],
                     make_desc(v_addr + s * L::kBytes + kk * 16 * L::kRowBytes,
                               L::kChunkBytes, kSbo, L::kLayout));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<HD / 2>(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- normalise and store this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(ADHASH_FULL_MASK, l, 1);
    l += __shfl_xor_sync(ADHASH_FULL_MASK, l, 2);
    const int t = row0 + r0 + 8 * r;
    if (wg_tiles == 0 || t >= t_len) continue;
    if (lse != nullptr && (lane & 3) == 0)  // m and l are in log2 units
      lse[((int64_t)b * n_heads + h) * t_len + t] =
          (m_run[r] + log2f(fmaxf(l, 1e-30f))) * 0.6931471805599453f;
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = o + (((int64_t)b * t_len + t) * n_heads + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv_l,
                                acc[4 * j + 2 * r + 1] * inv_l);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int64_t t, int64_t s, int h, int kv, int causal,
           int64_t q_offset, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map<HD, 128>(&tq, encode, q, b, t, h) ||
      !make_map<HD, 128>(&tk, encode, k, b, s, kv) ||
      !make_map<HD, 128>(&tv, encode, v, b, s, kv))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem<HD>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((t + kBM - 1) / kBM), (unsigned)(b * h));
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  flash_attn_sm90<HD><<<grid, kThreads, kSmem<HD>, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, (float*)lse, (int)t, (int)s, h, kv,
      causal, q_offset, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (b, t, h, hd) bf16; k, v: (b, s, kv, hd) bf16; all contiguous with
// 16-byte aligned storage; h a multiple of kv; t, s < 2^31; hd in
// {16, 32, 64, 128}; lse (b, h, t) float32 or null.
extern "C" int adhash_flash_attn_bf16(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int b, int64_t t, int64_t s, int h,
                                      int kv,
                                      int hd, int causal, int64_t q_offset,
                                      void* stream) {
  if (b == 0 || t == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, lse, b, t, s, h, kv, causal, q_offset,
                          st);
    case 32:
      return launch<32>(q, k, v, o, lse, b, t, s, h, kv, causal, q_offset,
                          st);
    case 64:
      return launch<64>(q, k, v, o, lse, b, t, s, h, kv, causal, q_offset,
                          st);
    case 128:
      return launch<128>(q, k, v, o, lse, b, t, s, h, kv, causal, q_offset,
                          st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
