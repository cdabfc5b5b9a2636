// flash_attention, bf16: the attention forward pass on Hopper's tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_fwd :76, pallas_call at :97) for bf16 inputs and computes
// the function of repro.models.attention._blocked_attn:
//
//   o[b,t,h] = softmax_s(q[b,t,h] . k[b,s,h/g] * hd^-1/2, masked) . v[b,s,h/g]
//
// with g = H / KV (each query head reads its KV head in place), the mask
// ``s < S``, when causal ``s <= q_offset + t`` (top-left alignment shifted
// by q_offset), and with a window w > 0 ``s > q_offset + t - w`` (the
// hybrid family's local attention, _blocked_attn's mask at
// src/repro/models/attention.py:117-118).  q, o: (B, T, H, hd); k, v: (B,
// S, KV, hd); bf16, contiguous; hd in {16, 32, 64, 128, 256}; any T and S
// below 2^31.  Q.K^T is
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
//  * Window: the key tiles wholly left of a CTA's first row's window are
//    never loaded (the producer starts at tile (q_offset + m0 - w + 1) /
//    kBN), a warpgroup skips those left of its own first row's, and only
//    the tiles that cross a row's left edge are masked.  A window of at
//    least q_offset + T hides nothing and runs the unwindowed schedule, so
//    it gives the same bits.
//  * hd = 256 (recurrentgemma-2b's heads): K/V tiles of 64 keys, S by
//    wgmma m64n64k16 (32 floats a thread) and O by m64n256k16 (128 floats
//    a thread); a tile row is four 64-column TMA boxes.
//
// Shared memory at hd = 128: Q 32 KB + 2 stages x (K 32 KB + V 32 KB) =
// 160 KB (+1 KB for alignment), one CTA per SM; at hd = 64 it is 80 KB; at
// hd = 256, Q 64 KB + 2 x (32 KB + 32 KB) = 192 KB.
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
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;

// Keys per K/V tile: 128, or 64 at hd = 256, where two stages of 128-key K
// and V tiles beside the 128-row Q tile would need 320 KB of shared memory
// and an S tile of 64 floats a thread beside O's 128.
template <int HD>
constexpr int kBN = HD == 256 ? 64 : 128;

// Shared memory of a CTA: the Q tile of kBM rows and kStages (K, V) tiles
// of kBN rows, + barriers, + alignment.
template <int HD>
constexpr size_t kSmem = (size_t)Tile<HD, kBM>::kBytes +
                         2 * kStages * (size_t)Tile<HD, kBN<HD>>::kBytes +
                         64 + 1024;

// First key tile a run of query rows starting at ``qpos0`` reads: none
// wholly left of the window (every key s <= qpos0 - window is hidden from
// all of them).
__device__ __forceinline__ int first_tile(int64_t qpos0, int64_t window,
                                          int bn) {
  if (window <= 0) return 0;
  const int64_t lo = qpos0 - window + 1;
  return lo > 0 ? (int)(lo / bn) : 0;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_sm90(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int t_len, int s_len,
                int n_heads, int n_kv, int causal, int64_t q_offset,
                int64_t window, float scale_log2) {
  constexpr int BN = kBN<HD>;
  using LQ = Tile<HD, kBM>;  // the Q tile
  using LK = Tile<HD, BN>;   // a K or V tile
  extern __shared__ uint8_t smem_raw[];
  // swizzle patterns repeat every 1024 bytes: align the tiles to that
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sq = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* sk = sq + LQ::kBytes;             // [kStages] tiles
  uint8_t* sv = sk + kStages * LK::kBytes;   // [kStages] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kStages * LK::kBytes);
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
  // the CTA's key tiles [i0, n_tiles): none past S, none right of its last
  // row's diagonal, none left of its first row's window
  int n_tiles = (s_len + BN - 1) / BN;
  if (causal) {
    const int64_t last = q_offset + min(m0 + kBM, t_len) - 1;
    n_tiles = (int)min((int64_t)n_tiles, last / BN + 1);
  }
  const int i0 = min(first_tile(q_offset + m0, window, BN), n_tiles);

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
    mbar_expect_tx(q_full, LQ::kBytes);
#pragma unroll
    for (int c = 0; c < LQ::kChunks; ++c)
      tma_load(sq + c * LQ::kChunkBytes, &tm_q, q_full, c * LQ::kCols, h,
               m0, b);
    for (int i = i0; i < n_tiles; ++i) {
      const int j = i - i0;
      const int s = j % kStages;
      mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], 2 * LK::kBytes);
#pragma unroll
      for (int c = 0; c < LK::kChunks; ++c) {
        tma_load(sk + s * LK::kBytes + c * LK::kChunkBytes, &tm_k, &full[s],
                 c * LK::kCols, kh, i * BN, b);
        tma_load(sv + s * LK::kBytes + c * LK::kChunkBytes, &tm_v, &full[s],
                 c * LK::kCols, kh, i * BN, b);
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
  // tiles this warpgroup reads, [wg_first, wg_tiles): none past T, none
  // above its diagonal, none left of its window
  int wg_tiles = row0 < t_len ? n_tiles : 0;
  if (causal && wg_tiles > 0) {
    const int64_t last = q_offset + min(row0 + 64, t_len) - 1;
    wg_tiles = (int)min((int64_t)wg_tiles, last / BN + 1);
  }
  const int wg_first = first_tile(q_offset + row0, window, BN);
  const int64_t qpos[2] = {q_offset + row0 + r0, q_offset + row0 + r0 + 8};

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};  // this thread's columns; reduced at the end

  const uint32_t q_addr = smem_u32(sq) + 64 * g * LQ::kRowBytes;
  const uint32_t k_addr = smem_u32(sk);
  const uint32_t v_addr = smem_u32(sv);
  constexpr uint32_t kSbo = 8 * LQ::kRowBytes;  // 8-row group stride
  mbar_wait(q_full, 0);

  for (int i = i0; i < n_tiles; ++i) {
    const int j = i - i0;
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    if (i >= wg_first && i < wg_tiles) {
      const int n0 = i * BN;
      // ---- S = Q . K^T (64 x BN, f32)
      float sc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 / LQ::kCols;
        const uint32_t col = (kk * 16 % LQ::kCols) * 2;
        wgmma_ss<BN>(sc,
                     make_desc(q_addr + c * LQ::kChunkBytes + col, 16, kSbo,
                               LQ::kLayout),
                     make_desc(k_addr + s * LK::kBytes + c * LK::kChunkBytes +
                                   col,
                               16, kSbo, LK::kLayout),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BN / 2>(sc);

      // ---- mask: keys past S, keys right of the diagonal, keys left of
      // the window (kpos <= qpos - window)
      if (n0 + BN > s_len || (causal && n0 + BN - 1 > q_offset + row0) ||
          (window > 0 && n0 + window <= q_offset + row0 + 63)) {
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t kpos = n0 + 8 * jj + cq + (e & 1);
            const int64_t qp = qpos[e >> 1];
            const bool ok = kpos < s_len && (!causal || kpos <= qp) &&
                            (window <= 0 || kpos > qp - window);
            if (!ok) sc[4 * jj + e] = -CUDART_INF_F;
          }
      }

      // ---- online softmax, rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
          mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * r], sc[4 * jj + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(ADHASH_FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(ADHASH_FULL_MASK, mx, 2));
        const float m_new = fmaxf(m_run[r], mx * scale_log2);
        const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
        const float corr = exp2f(m_run[r] - base);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(sc[4 * jj + 2 * r + e], scale_log2,
                                       -base));
            sc[4 * jj + 2 * r + e] = p;
            sum += p;
          }
        l_run[r] = l_run[r] * corr + sum;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj) {
          acc[4 * jj + 2 * r] *= corr;
          acc[4 * jj + 2 * r + 1] *= corr;
        }
      }

      // ---- O += P . V: P as bf16 A fragments, V MN-major from smem
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
      fence_regs<HD / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<HD>(acc, pa[kk],
                     make_desc(v_addr + s * LK::kBytes +
                                   kk * 16 * LK::kRowBytes,
                               LK::kChunkBytes, kSbo, LK::kLayout));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<HD / 2>(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- normalise and store this thread's two rows (a row that sees no
  // key -- possible only with a window -- gets zeros and an LSE of -inf)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(ADHASH_FULL_MASK, l, 1);
    l += __shfl_xor_sync(ADHASH_FULL_MASK, l, 2);
    const int t = row0 + r0 + 8 * r;
    if (t >= t_len) continue;
    if (lse != nullptr && (lane & 3) == 0)  // m and l are in log2 units
      lse[((int64_t)b * n_heads + h) * t_len + t] =
          (m_run[r] + log2f(fmaxf(l, 1e-30f))) * 0.6931471805599453f;
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = o + (((int64_t)b * t_len + t) * n_heads + h) * HD;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + cq) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * r] * inv_l,
                                acc[4 * jj + 2 * r + 1] * inv_l);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int64_t t, int64_t s, int h, int kv, int causal,
           int64_t q_offset, int64_t window, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map<HD, kBM>(&tq, encode, q, b, t, h) ||
      !make_map<HD, kBN<HD>>(&tk, encode, k, b, s, kv) ||
      !make_map<HD, kBN<HD>>(&tv, encode, v, b, s, kv))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem<HD>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((t + kBM - 1) / kBM), (unsigned)(b * h));
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  flash_attn_sm90<HD><<<grid, kThreads, kSmem<HD>, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, (float*)lse, (int)t, (int)s, h, kv,
      causal, q_offset, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (b, t, h, hd) bf16; k, v: (b, s, kv, hd) bf16; all contiguous with
// 16-byte aligned storage; h a multiple of kv; t, s < 2^31; hd in
// {16, 32, 64, 128, 256}; window 0 (none) or the number of keys a query
// sees, itself included; lse (b, h, t) float32 or null.
extern "C" int adhash_flash_attn_bf16(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int b, int64_t t, int64_t s, int h,
                                      int kv,
                                      int hd, int causal, int64_t q_offset,
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
