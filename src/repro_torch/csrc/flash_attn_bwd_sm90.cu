// flash_attention backward, bf16: dq, dk and dv on Hopper's tensor cores.
//
// No TPU kernel to replace: the JAX package differentiates
// src/repro/models/attention.py:_blocked_attn (:62) by autodiff.  This
// computes what that autodiff computes, from the forward's output O and
// per-row log-sum-exp L (flash_attn_sm90.cu stores it):
//
//   P  = exp(Q K^T * hd^-1/2 - L)   (masked: s < S; s <= q_offset + t
//                                    when causal, top-left aligned; with a
//                                    window w > 0 also s > q_offset + t - w)
//   D  = rowsum(dO o O)
//   dS = P o (dO V^T - D)
//   dQ = hd^-1/2 dS K,   dK = hd^-1/2 dS^T Q,   dV = P^T dO
//
// with dK and dV summed over the H / KV query heads of each KV head (GQA).
// q, o, dO, dq: (B, T, H, hd); k, v, dk, dv: (B, S, KV, hd); bf16,
// contiguous; L (B, H, T) float32; hd in {16, 32, 64, 128, 256}; any T and
// S below 2^31, any q_offset >= 0, window 0 (none) or the keys a query
// sees, itself included.  A window of at least q_offset + T hides nothing
// and gives the unwindowed launch's bits; a query row that sees no key
// (only a window can make one) is outside the contract, as in the forward.
// Every product is bf16 x bf16 summed in f32.  P and dS enter the dV, dK
// and dQ products as two bf16 A operands each, hi = bf16(x) and lo =
// bf16(x - hi), one product each: with P as one bf16 operand, the
// rounding of one large P among 1,500 keys moves a dV entry by up to a
// bf16 ulp of its row before the store's rounding, two ulps in all, past
// what the outputs' one rounding allows.  So the outputs are the f32
// gradient rounded to bf16 once, at the store.  float32 inputs go to the
// CUDA-core kernel of flash_attn_bwd.cu.
//
// Bound on the card: operations.  The five products (S, dP, dV, dK, dQ)
// are 2.5x the forward's work on the same bytes, far above the ~295 bf16
// flops per byte at which the tensor cores (989 TFLOP/s dense) bind.  With
// P and dP recomputed in the dQ pass and the split operands, the kernels
// run 10 products of 64 x 64 x hd per (64-query, 64-key) pair, so the
// design keeps all of them on wgmma and everything else off the tensor
// cores' path:
//
//  1. ``bwd_prep``: one warp per (b * H + h, t) of rows padded to a
//     multiple of 128 computes D and stores L * log2(e); padded rows get
//     L = +inf and D = 0, so their P is 0.  Padded rows let a stage's L
//     and D arrive by one 16-byte-aligned bulk copy each.
//  2. ``bwd_dkdv``: one CTA of 384 threads per (b, KV head, tile of 128
//     keys), tile 0 first (it walks every query tile when causal): a
//     producer warpgroup (setmaxnreg 24) and two consumer warpgroups
//     (setmaxnreg 240) of 64 keys each.  K and V arrive once by TMA (box
//     of 128 rows); one producer thread then streams the (Q, dO) tiles of
//     64 rows of each query head of the group, with their L and D, into a
//     2-stage mbarrier ring.  Per tile a consumer computes
//       S^T = K Q^T and dP^T = V dO^T   (wgmma m64n64k16, SS, K-major),
//       P^T, dS^T in registers on the accumulator's layout,
//       dV += P^T dO and dK += dS^T Q   (wgmma m64n{hd}k16, RS: P^T and
//                                        dS^T as bf16 A fragments, hi and
//                                        lo, dO and Q read MN-major from
//                                        the tiles the SS products read
//                                        K-major).
//     dK and dV stay in registers (64 + 64 f32 a thread at hd = 128) and
//     are stored once.
//  3. ``bwd_dq``: one CTA per (b * H + h, tile of 128 queries), the last
//     tile first when causal.  Q and dO arrive once (box of 128 rows), the
//     producer streams (K, V) tiles of 64 keys up to the diagonal; per tile
//       S = Q K^T and dP = dO V^T       (SS, K-major),
//       dQ += dS K                      (RS, K read MN-major).
// TMA zero-fills rows past T or S inside a batch, so a ragged tail reads
// nothing of the next batch; causal tiles that see no key are skipped and
// only tiles that cross the diagonal or a ragged edge are masked.  Each
// pass owns its outputs: no atomics, and two launches on the same inputs
// give the same bits.  Swizzles, descriptors and the mbarrier ring are the
// forward's (sm90.cuh).  A stuck mbarrier wait traps instead of hanging.
//
// Window: the dK/dV pass walks only the query tiles whose rows' windows
// reach its key tile (up to the last row t with q_offset + t < n0 + tile +
// w - 1), the dQ pass only the key tiles from the one its first row's
// window starts in; tiles that cross a window's left edge are masked like
// the diagonal's.  Ring slots count the tiles walked, so a window changes
// the trip counts and nothing else.  Each pass is compiled with and
// without the window's tests (kWindow), and a launch without a window runs
// the kernels that have none.
//
// hd 256: 128 rows of two resident tensors and a two-stage ring of two
// 64-row tiles would take 257 KB, over the 227 KB a CTA may have, so both
// passes take 64-row CTA tiles (193 KB), and the two consumer warpgroups
// split hd instead of the rows: each owns 128 columns of dK and dV (or of
// dQ) for the same 64 rows -- 64 + 64 f32 a thread, as at hd = 128, where
// one warpgroup holding all 256 columns of dK and dV would need 256.  Both
// warpgroups compute the same S^T and dP^T (the full hd contraction):
// 1.5x the dK/dV pass's tensor work (4/3x the dQ pass's) for no exchange
// through shared memory and no barrier between them; the same instructions
// on the same tiles give both the same bits.
//
// Shared memory at hd = 128: dK/dV 2 x 32 KB (K, V) + 2 stages x (16 KB Q
// + 16 KB dO + 512 B L, D) = 129 KB; dQ 2 x 32 KB (Q, dO) + 2 stages x
// (16 KB K + 16 KB V) = 128 KB; one CTA per SM.  The build log
// (`-Xptxas -v`) prints registers and any spill.
// Not in these kernels yet: overlap of one tile's softmax with the next
// tile's products, a persistent scheduler, S^T and dP^T shared between the
// warpgroups at hd 256.
#include <cuda.h>
#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace adhash::sm90;

constexpr int kBM = 64;        // queries of a dK/dV step; keys of a dQ step
constexpr int kStages = 2;     // ring depth
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kPad = 128;  // T padded in the L and D rows (build.BWD_T_PAD)
constexpr int kPrepThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Rows of a CTA's resident tiles (keys of a dK/dV CTA, queries of a dQ
// CTA): 128, split over the two consumer warpgroups; 64 at hd 256, where
// the warpgroups split hd instead (kSplitHd).
template <int HD>
constexpr bool kSplitHd = HD > 128;
template <int HD>
constexpr int kRows = kSplitHd<HD> ? 64 : 128;
// Columns of dK, dV or dQ a consumer warpgroup owns.
template <int HD>
constexpr int kOwn = kSplitHd<HD> ? HD / 2 : HD;

// Bytes of shared memory of each pass (+ barriers, + 1024 for alignment).
template <int HD>
constexpr size_t kDkdvSmem = 2 * (size_t)Tile<HD, kRows<HD>>::kBytes +
                             kStages * (2 * (size_t)Tile<HD, kBM>::kBytes +
                                        2 * kBM * sizeof(float)) +
                             64 + 1024;
template <int HD>
constexpr size_t kDqSmem = 2 * (size_t)Tile<HD, kRows<HD>>::kBytes +
                           kStages * 2 * (size_t)Tile<HD, kBM>::kBytes + 64 +
                           1024;
static_assert(kDkdvSmem<256> <= 227 * 1024 && kDqSmem<256> <= 227 * 1024,
              "hd 256 tiles exceed a CTA's shared memory");

// Shared memory aligned to 1024 bytes, where the swizzle patterns repeat.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// 1. lp[r] = L * log2(e) and dp[r] = D of row r = (b * H + h) * t_pad + t;
// rows t >= T get +inf and 0.  One warp a row.
template <int HD>
__global__ void __launch_bounds__(kPrepThreads)
bwd_prep(const __nv_bfloat16* __restrict__ o,
         const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ lse, float* __restrict__ lp,
         float* __restrict__ dp, int64_t rows, int64_t t_len, int64_t t_pad,
         int n_heads) {
  const int64_t row =
      (int64_t)blockIdx.x * (kPrepThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int64_t bh = row / t_pad;
  const int64_t t = row % t_pad;
  if (t >= t_len) {
    if (lane == 0) {
      lp[row] = CUDART_INF_F;
      dp[row] = 0.f;
    }
    return;
  }
  const int64_t b = bh / n_heads;
  const int64_t h = bh % n_heads;
  const int64_t base = ((b * t_len + t) * n_heads + h) * HD;
  float s = 0.f;
  for (int d = lane * 4; d < HD; d += 128) {
    const uint2 a = *reinterpret_cast<const uint2*>(o + base + d);
    const uint2 g = *reinterpret_cast<const uint2*>(dout + base + d);
    const float2 a0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&a.x));
    const float2 a1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&a.y));
    const float2 g0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&g.x));
    const float2 g1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&g.y));
    s += a0.x * g0.x + a0.y * g0.y + a1.x * g1.x + a1.y * g1.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(ADHASH_FULL_MASK, s, off);
  if (lane == 0) {
    lp[row] = lse[bh * t_len + t] * kLog2e;
    dp[row] = s;
  }
}

// Two SS products of one warpgroup over hd: acc0 = A0 . B0^T and acc1 =
// A1 . B1^T, 64 x 64 each; A rows at a0/a1 (in a tile of RA rows), B rows
// at b0/b1 (a tile of 64 rows); committed as one group and waited for.
template <int HD, int RA>
__device__ __forceinline__ void ss_pair(float (&acc0)[32], float (&acc1)[32],
                                        uint32_t a0, uint32_t b0, uint32_t a1,
                                        uint32_t b1) {
  using LA = Tile<HD, RA>;
  using LB = Tile<HD, kBM>;
  constexpr uint32_t kSbo = 8 * LA::kRowBytes;  // 8-row group stride
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 / LA::kCols;
    const uint32_t col = (kk * 16 % LA::kCols) * 2;
    wgmma_ss<64>(acc0,
                 make_desc(a0 + c * LA::kChunkBytes + col, 16, kSbo,
                           LA::kLayout),
                 make_desc(b0 + c * LB::kChunkBytes + col, 16, kSbo,
                           LB::kLayout),
                 kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 / LA::kCols;
    const uint32_t col = (kk * 16 % LA::kCols) * 2;
    wgmma_ss<64>(acc1,
                 make_desc(a1 + c * LA::kChunkBytes + col, 16, kSbo,
                           LA::kLayout),
                 make_desc(b1 + c * LB::kChunkBytes + col, 16, kSbo,
                           LB::kLayout),
                 kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<32>(acc0);
  fence_regs<32>(acc1);
}

// acc (64 x N) += A . B over 64 rows of B: A as bf16 fragments (4 k-steps
// of 16), B read MN-major from N columns of a 64-row tile of hd HD, from
// column ``col0`` (a multiple of the tile's chunk width) of the tile at
// ``b``.  Not waited for.
template <int HD, int N>
__device__ __forceinline__ void rs_acc(float (&acc)[N / 2],
                                       const uint32_t (&a)[4][4], uint32_t b,
                                       int col0) {
  using LB = Tile<HD, kBM>;
  b += col0 / LB::kCols * LB::kChunkBytes;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<N>(acc, a[kk],
                make_desc(b + kk * 16 * LB::kRowBytes, LB::kChunkBytes,
                          8 * LB::kRowBytes, LB::kLayout));
}

// Columns 16 kk .. 16 kk + 15 of a 64 x 64 accumulator as the bf16 A
// fragments of k-step kk, split in two: hi = bf16(x) and lo = bf16(x -
// hi), so hi + lo holds x to ~2^-17 of itself.
__device__ __forceinline__ void to_frags(const float (&acc)[32],
                                         uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float a = acc[8 * kk + 2 * x], b = acc[8 * kk + 2 * x + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][x] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][x] = pack_bf16(a - hf.x, b - hf.y);
    }
}

// Two rows r0, r0 + 8 of a 64 x N accumulator, times ``mul``, as bf16
// into rows whose starts ``rows[r]`` gives (null: not stored).
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* (&rows)[2],
                                           const float (&acc)[N / 2],
                                           float mul, int cq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(rows[r] + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul,
                                acc[4 * j + 2 * r + 1] * mul);
  }
}

// The first of ``n_tiles`` key tiles of 64 that a row at absolute position
// ``qpos`` sees through a window (0 without one): keys s <= qpos - window
// are hidden.
__device__ __forceinline__ int first_tile(int64_t qpos, int64_t window,
                                          int n_tiles) {
  if (window <= 0 || qpos - window + 1 <= 0) return 0;
  return (int)min((int64_t)n_tiles, (qpos - window + 1) / kBM);
}

// 2. dK and dV of one tile of kRows keys of one KV head.  kWindow: the
// launch has a window (without one, no window test is compiled in).
template <int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv(const __grid_constant__ CUtensorMap tm_q,   // box of 64 rows
         const __grid_constant__ CUtensorMap tm_do,  // box of 64 rows
         const __grid_constant__ CUtensorMap tm_k,   // box of kRows rows
         const __grid_constant__ CUtensorMap tm_v,   // box of kRows rows
         const float* __restrict__ lp, const float* __restrict__ dp,
         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
         int t_len, int s_len, int n_heads, int n_kv, int64_t t_pad,
         int causal, int64_t q_offset, int64_t window, float scale_log2,
         float scale) {
  constexpr int kBN = kRows<HD>;
  constexpr int NC = kOwn<HD>;
  using LQ = Tile<HD, kBM>;
  using LK = Tile<HD, kBN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = aligned_smem(smem_raw);
  uint8_t* sv = sk + LK::kBytes;
  uint8_t* sq = sv + LK::kBytes;             // [kStages] tiles
  uint8_t* sdo = sq + kStages * LQ::kBytes;  // [kStages] tiles
  float* sl = reinterpret_cast<float*>(sdo + kStages * LQ::kBytes);
  float* sd = sl + kStages * kBM;            // [kStages][kBM] each
  uint64_t* bars = reinterpret_cast<uint64_t*>(sd + kStages * kBM);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;               // [kStages]
  uint64_t* empty = bars + 1 + kStages;    // [kStages]

  // key tiles in ascending order across all (b, KV head): tile 0 first
  const int n_kt = (s_len + kBN - 1) / kBN;
  const int n_bkv = gridDim.x / n_kt;
  const int kt = blockIdx.x / n_bkv;
  const int bkv = blockIdx.x % n_bkv;
  const int b = bkv / n_kv;
  const int kh = bkv % n_kv;
  const int group = n_heads / n_kv;
  const int n0 = kt * kBN;
  // query tiles of each head: when causal, from the first that sees key n0;
  // with a window, up to the last whose rows' windows reach the tile's last
  // key (rows t with q_offset + t - window < n0 + kBN - 1)
  const int n_qt = (t_len + kBM - 1) / kBM;
  const int m_first =
      causal && n0 > q_offset ? (int)min((n0 - q_offset) / kBM, (int64_t)n_qt)
                              : 0;
  int m_end = n_qt;
  if (kWindow) {
    const int64_t t_end = n0 + kBN + window - 1 - q_offset;  // rows < t_end
    m_end = (int)max((int64_t)0, min((int64_t)n_qt, (t_end + kBM - 1) / kBM));
  }
  const int per_head = max(0, m_end - m_first);
  const int n_steps = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
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
    mbar_expect_tx(kv_full, 2 * LK::kBytes);
#pragma unroll
    for (int c = 0; c < LK::kChunks; ++c) {
      tma_load(sk + c * LK::kChunkBytes, &tm_k, kv_full, c * LK::kCols, kh,
               n0, b);
      tma_load(sv + c * LK::kChunkBytes, &tm_v, kv_full, c * LK::kCols, kh,
               n0, b);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int h = kh * group + i / per_head;
      const int m0 = (m_first + i % per_head) * kBM;
      const int s = i % kStages;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], 2 * LQ::kBytes + 2 * kBM * sizeof(float));
#pragma unroll
      for (int c = 0; c < LQ::kChunks; ++c) {
        tma_load(sq + s * LQ::kBytes + c * LQ::kChunkBytes, &tm_q, &full[s],
                 c * LQ::kCols, h, m0, b);
        tma_load(sdo + s * LQ::kBytes + c * LQ::kChunkBytes, &tm_do,
                 &full[s], c * LQ::kCols, h, m0, b);
      }
      const int64_t r = ((int64_t)b * n_heads + h) * t_pad + m0;
      bulk_load(sl + s * kBM, lp + r, kBM * sizeof(float), &full[s]);
      bulk_load(sd + s * kBM, dp + r, kBM * sizeof(float), &full[s]);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  // warpgroup g: keys [64g, 64g + 64) of the tile, every column of hd; at
  // hd 256 all 64 keys, columns [128g, 128g + 128)
  const int g = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's keys: r0, r0 + 8
  const int cq = 2 * (lane & 3);           // its columns in each block of 8
  const int rows_g = kSplitHd<HD> ? 0 : 64 * g;
  const int col0 = kSplitHd<HD> ? NC * g : 0;
  const int key0 = n0 + rows_g;            // the warpgroup's first key
  const bool active = key0 < s_len;
  const int64_t kpos[2] = {key0 + r0, key0 + r0 + 8};

  float dv_acc[NC / 2], dk_acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;

  const uint32_t k_addr = smem_u32(sk) + rows_g * LK::kRowBytes;
  const uint32_t v_addr = smem_u32(sv) + rows_g * LK::kRowBytes;
  mbar_wait(kv_full, 0);

  for (int i = 0; i < n_steps; ++i) {
    const int m0 = (m_first + i % per_head) * kBM;
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    // skip a tile none of whose queries sees the warpgroup's first key
    // (causal) or its last (window)
    if (active && (!causal || key0 <= q_offset + min(m0 + kBM, t_len) - 1) &&
        (!kWindow || q_offset + m0 - window < key0 + 63)) {
      const uint32_t q_addr = smem_u32(sq + s * LQ::kBytes);
      const uint32_t do_addr = smem_u32(sdo + s * LQ::kBytes);
      // ---- S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries, f32)
      float st[32], dpt[32];
      ss_pair<HD, kBN>(st, dpt, k_addr, q_addr, v_addr, do_addr);

      // ---- P^T and dS^T; masked: keys past S, queries past T, and
      // (key, query) pairs right of the diagonal or left of the window
      const bool edge =
          key0 + 64 > s_len || m0 + kBM > t_len ||
          (causal && key0 + 63 > q_offset + m0) ||
          (kWindow && key0 <= q_offset + m0 + kBM - 1 - window);
      const float* ls = sl + s * kBM;
      const float* ds = sd + s * kBM;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
        const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(st[4 * j + e], scale_log2,
                               -((e & 1) ? l2.y : l2.x)));
          if (edge) {
            const int64_t t = m0 + 8 * j + cq + (e & 1);
            const int64_t kp = kpos[e >> 1];
            if (!(kp < s_len && t < t_len && (!causal || kp <= q_offset + t) &&
                  (!kWindow || kp > q_offset + t - window)))
              p = 0.f;
          }
          st[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
      }

      // ---- dV += P^T dO, dK += dS^T Q: bf16 A fragments (hi and lo
      // parts), dO and Q MN-major from the tiles the S^T and dP^T
      // products read K-major
      uint32_t pa[4][4], pl[4][4], da[4][4], dl[4][4];
      to_frags(st, pa, pl);
      to_frags(dpt, da, dl);
      fence_regs<NC / 2>(dv_acc);
      fence_regs<NC / 2>(dk_acc);
      wgmma_fence();
      rs_acc<HD, NC>(dv_acc, pa, do_addr, col0);
      rs_acc<HD, NC>(dv_acc, pl, do_addr, col0);
      rs_acc<HD, NC>(dk_acc, da, q_addr, col0);
      rs_acc<HD, NC>(dk_acc, dl, q_addr, col0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NC / 2>(dv_acc);
      fence_regs<NC / 2>(dk_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- store this thread's two keys' rows of dK (scaled) and dV
  __nv_bfloat16* dk_rows[2];
  __nv_bfloat16* dv_rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t off =
        (((int64_t)b * s_len + kpos[r]) * n_kv + kh) * HD + col0;
    const bool ok = kpos[r] < s_len;
    dk_rows[r] = ok ? dk + off : nullptr;
    dv_rows[r] = ok ? dv + off : nullptr;
  }
  store_rows<NC>(dk_rows, dk_acc, scale, cq);
  store_rows<NC>(dv_rows, dv_acc, 1.f, cq);
}

// 3. dQ of one tile of kRows queries of one query head.
template <int HD, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq(const __grid_constant__ CUtensorMap tm_q,   // box of kRows rows
       const __grid_constant__ CUtensorMap tm_do,  // box of kRows rows
       const __grid_constant__ CUtensorMap tm_k,   // box of 64 rows
       const __grid_constant__ CUtensorMap tm_v,   // box of 64 rows
       const float* __restrict__ lp, const float* __restrict__ dp,
       __nv_bfloat16* __restrict__ dq, int t_len, int s_len, int n_heads,
       int n_kv, int64_t t_pad, int causal, int64_t q_offset, int64_t window,
       float scale_log2, float scale) {
  constexpr int kBN = kRows<HD>;
  constexpr int NC = kOwn<HD>;
  using LQ = Tile<HD, kBN>;
  using LK = Tile<HD, kBM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = aligned_smem(smem_raw);
  uint8_t* sdo = sq + LQ::kBytes;
  uint8_t* sk = sdo + LQ::kBytes;            // [kStages] tiles
  uint8_t* sv = sk + kStages * LK::kBytes;   // [kStages] tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kStages * LK::kBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;               // [kStages]
  uint64_t* empty = bars + 1 + kStages;    // [kStages]

  // query tiles across all (b, head): when causal the last tile first
  const int n_qt = (t_len + kBN - 1) / kBN;
  const int n_bh = gridDim.x / n_qt;
  const int j = blockIdx.x / n_bh;
  const int bh = blockIdx.x % n_bh;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int kh = h / (n_heads / n_kv);
  const int m0 = (causal ? n_qt - 1 - j : j) * kBN;
  int n_tiles = (s_len + kBM - 1) / kBM;
  if (causal) {
    const int64_t last = q_offset + min(m0 + kBN, t_len) - 1;
    n_tiles = (int)min((int64_t)n_tiles, last / kBM + 1);
  }
  // with a window, from the key tile the first row's window starts in
  const int i_first =
      kWindow ? first_tile(q_offset + m0, window, n_tiles) : 0;

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
    mbar_expect_tx(q_full, 2 * LQ::kBytes);
#pragma unroll
    for (int c = 0; c < LQ::kChunks; ++c) {
      tma_load(sq + c * LQ::kChunkBytes, &tm_q, q_full, c * LQ::kCols, h, m0,
               b);
      tma_load(sdo + c * LQ::kChunkBytes, &tm_do, q_full, c * LQ::kCols, h,
               m0, b);
    }
    for (int i = i_first; i < n_tiles; ++i) {
      const int s = (i - i_first) % kStages;
      mbar_wait(&empty[s], (((i - i_first) / kStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], 2 * LK::kBytes);
#pragma unroll
      for (int c = 0; c < LK::kChunks; ++c) {
        tma_load(sk + s * LK::kBytes + c * LK::kChunkBytes, &tm_k, &full[s],
                 c * LK::kCols, kh, i * kBM, b);
        tma_load(sv + s * LK::kBytes + c * LK::kChunkBytes, &tm_v, &full[s],
                 c * LK::kCols, kh, i * kBM, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  // warpgroup g: rows [64g, 64g + 64) of the tile, every column of hd; at
  // hd 256 all 64 rows, columns [128g, 128g + 128)
  const int g = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2);  // this thread's rows: r0, r0 + 8
  const int cq = 2 * (lane & 3);           // its columns in each block of 8
  const int rows_g = kSplitHd<HD> ? 0 : 64 * g;
  const int col0 = kSplitHd<HD> ? NC * g : 0;
  const int row0 = m0 + rows_g;            // the warpgroup's first row
  // tiles this warpgroup reads: none past T, none right of its diagonal,
  // none left of its first row's window
  int wg_tiles = row0 < t_len ? n_tiles : 0;
  if (causal && wg_tiles > 0) {
    const int64_t last = q_offset + min(row0 + 64, t_len) - 1;
    wg_tiles = (int)min((int64_t)wg_tiles, last / kBM + 1);
  }
  const int wg_first =
      kWindow ? first_tile(q_offset + row0, window, n_tiles) : 0;
  const int t[2] = {row0 + r0, row0 + r0 + 8};
  // rows up to m0 + 128 <= t_pad are in the padded L and D rows
  const int64_t lrow = (int64_t)bh * t_pad;
  const float l_row[2] = {lp[lrow + t[0]], lp[lrow + t[1]]};
  const float d_row[2] = {dp[lrow + t[0]], dp[lrow + t[1]]};

  float dq_acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) dq_acc[i] = 0.f;

  const uint32_t q_addr = smem_u32(sq) + rows_g * LQ::kRowBytes;
  const uint32_t do_addr = smem_u32(sdo) + rows_g * LQ::kRowBytes;
  mbar_wait(q_full, 0);

  for (int i = i_first; i < n_tiles; ++i) {
    const int s = (i - i_first) % kStages;
    mbar_wait(&full[s], ((i - i_first) / kStages) & 1);
    if (i >= wg_first && i < wg_tiles) {
      const int n0 = i * kBM;
      const uint32_t k_addr = smem_u32(sk + s * LK::kBytes);
      const uint32_t v_addr = smem_u32(sv + s * LK::kBytes);
      // ---- S = Q K^T and dP = dO V^T (64 queries x 64 keys, f32)
      float sc[32], dpv[32];
      ss_pair<HD, kBN>(sc, dpv, q_addr, k_addr, do_addr, v_addr);

      // ---- P and dS; masked: keys past S, rows past T, and keys right
      // of the diagonal or left of the window
      const bool edge = n0 + kBM > s_len || row0 + 64 > t_len ||
                        (causal && n0 + kBM - 1 > q_offset + row0) ||
                        (kWindow && n0 <= q_offset + row0 + 63 - window);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2f(fmaf(sc[4 * jj + e], scale_log2, -l_row[r]));
          if (edge) {
            const int64_t kp = n0 + 8 * jj + cq + (e & 1);
            if (!(kp < s_len && t[r] < t_len &&
                  (!causal || kp <= q_offset + t[r]) &&
                  (!kWindow || kp > q_offset + t[r] - window)))
              p = 0.f;
          }
          dpv[4 * jj + e] = p * (dpv[4 * jj + e] - d_row[r]);
        }

      // ---- dQ += dS K: dS as bf16 A fragments (hi and lo parts), K
      // MN-major
      uint32_t da[4][4], dl[4][4];
      to_frags(dpv, da, dl);
      fence_regs<NC / 2>(dq_acc);
      wgmma_fence();
      rs_acc<HD, NC>(dq_acc, da, k_addr, col0);
      rs_acc<HD, NC>(dq_acc, dl, k_addr, col0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NC / 2>(dq_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- store this thread's two rows of dQ (scaled)
  __nv_bfloat16* rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    rows[r] = t[r] < t_len
                  ? dq + (((int64_t)b * t_len + t[r]) * n_heads + h) * HD +
                        col0
                  : nullptr;
  store_rows<NC>(rows, dq_acc, scale, cq);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* scratch, void* dq,
           void* dk, void* dv, int b, int64_t t, int64_t s, int h, int kv,
           int causal, int64_t q_offset, int64_t window,
           cudaStream_t stream) {
  constexpr int kBN = kRows<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // dK/dV reads Q and dO in tiles of 64 rows, K and V in tiles of kRows;
  // dQ the other way round
  CUtensorMap q64, do64, k_cta, v_cta, q_cta, do_cta, k64, v64;
  if (!make_map<HD, kBM>(&q64, encode, q, b, t, h) ||
      !make_map<HD, kBM>(&do64, encode, dout, b, t, h) ||
      !make_map<HD, kBN>(&k_cta, encode, k, b, s, kv) ||
      !make_map<HD, kBN>(&v_cta, encode, v, b, s, kv) ||
      !make_map<HD, kBN>(&q_cta, encode, q, b, t, h) ||
      !make_map<HD, kBN>(&do_cta, encode, dout, b, t, h) ||
      !make_map<HD, kBM>(&k64, encode, k, b, s, kv) ||
      !make_map<HD, kBM>(&v64, encode, v, b, s, kv))
    return (int)cudaErrorInvalidValue;
  const auto dkdv_kernel =
      window > 0 ? bwd_dkdv<HD, true> : bwd_dkdv<HD, false>;
  const auto dq_kernel = window > 0 ? bwd_dq<HD, true> : bwd_dq<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDkdvSmem<HD>);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDqSmem<HD>);
  if (err != cudaSuccess) return (int)err;
  const int64_t t_pad = (t + kPad - 1) / kPad * kPad;
  const int64_t rows = (int64_t)b * h * t_pad;
  const int64_t n_kt = (s + kBN - 1) / kBN;
  const int64_t n_qt = (t + kBN - 1) / kBN;
  if (n_kt * b * kv >= (1ll << 31) || n_qt * b * h >= (1ll << 31))
    return (int)cudaErrorInvalidConfiguration;
  float* lp = (float*)scratch;
  float* dp = lp + rows;
  const float scale = 1.f / sqrtf((float)HD);
  const float scale_log2 = scale * kLog2e;
  constexpr int kRowsPerBlock = kPrepThreads / 32;
  bwd_prep<HD><<<(unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock),
                 kPrepThreads, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
      (const float*)lse, lp, dp, rows, t, t_pad, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<<<(unsigned)(n_kt * b * kv), kThreads, kDkdvSmem<HD>,
                stream>>>(q64, do64, k_cta, v_cta, lp, dp, (__nv_bfloat16*)dk,
                          (__nv_bfloat16*)dv, (int)t, (int)s, h, kv, t_pad,
                          causal, q_offset, window, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<(unsigned)(n_qt * b * h), kThreads, kDqSmem<HD>, stream>>>(
      q_cta, do_cta, k64, v64, lp, dp, (__nv_bfloat16*)dq, (int)t, (int)s, h,
      kv, t_pad, causal, q_offset, window, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (b, t, h, hd); k, v, dk, dv: (b, s, kv, hd); bf16,
// contiguous with 16-byte aligned storage; lse (b, h, t) float32; scratch:
// at least 2 * b * h * roundup(t, 128) float32, 16-byte aligned (L and D
// in padded rows); h a multiple of kv; hd in {16, 32, 64, 128, 256}; t, s <
// 2^31; window 0 (none) or the number of keys a query sees, itself
// included.
extern "C" int adhash_flash_attn_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int b, int64_t t, int64_t s, int h, int kv, int hd, int causal,
    int64_t q_offset, int64_t window, void* stream) {
  if (b == 0 || t == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, dout, lse, scratch, dq, dk, dv, b, t, s,
                        h, kv, causal, q_offset, window, st);
    case 32:
      return launch<32>(q, k, v, o, dout, lse, scratch, dq, dk, dv, b, t, s,
                        h, kv, causal, q_offset, window, st);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, scratch, dq, dk, dv, b, t, s,
                        h, kv, causal, q_offset, window, st);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, scratch, dq, dk, dv, b, t, s,
                         h, kv, causal, q_offset, window, st);
    case 256:
      return launch<256>(q, k, v, o, dout, lse, scratch, dq, dk, dv, b, t, s,
                         h, kv, causal, q_offset, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
