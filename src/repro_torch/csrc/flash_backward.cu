// K4's backward on Hopper: the gradient of the flash prefill in the
// recomputing (FlashAttention-2) form, for the training path, in the shape
// of K4's forward (flash_attention.cu's prefill_kernel, FlashAttention-3's
// shape): wgmma products fed by a TMA ring through a producer warpgroup.
//
// The reference defines no backward kernel (its flash_attention_pallas,
// src/repro/kernels/flash_attention.py:331, is differentiated by XLA
// through the plain attention); this is the port's own, held to
// kernels/ref.py::flash_attention_bwd_ref.  Inputs: q, the forward's
// output o and its gradient do [B, Sq, H, hd], k and v [B, Skv, KV, hd]
// (bf16, KV | H; Skv != Sq under 'full' only, cross-attention), and the
// forward's row log-sum-exp lse [B, H, Sq] (fp32, k4_flash_prefill_lse).  Three launches, no atomics: every output element
// is written once, by one block, after a fixed order of sums, so two calls
// are bitwise equal.
//
//   1. rows: D = rowsum(do * o) at fp32 (one warp a row) and lse * log2(e),
//      into a workspace [2][B * H][S_pad] whose rows are padded with 0 to a
//      multiple of ROW_PAD, so the passes below copy whole 64- or 128-row
//      runs of them with one bulk copy each and read 0 past Sq.
//   2. dK/dV: one block per (128-key tile, kv head, batch; 64 keys at hd
//      256), the longest key tiles (the first) first.  A producer
//      warpgroup (its registers handed to the consumers by setmaxnreg)
//      loads the K and V tiles once by TMA,
//      then streams, for each of the kv head's G query heads in ascending
//      order and each 64-row q tile from the first that attends the block's
//      keys, the Q and dO tiles and their lse and D rows through a ring of
//      full/empty mbarriers.  Two consumer warpgroups of 64 keys each
//      compute S^T = K Q^T and dP^T = V dO^T (wgmma, all four K-major from
//      shared memory), form P^T = exp2(S^T scale log2e - lse log2e) and dS^T
//      = P^T (dP^T - D) in registers on the accumulator fragments, round
//      both to bf16 register A fragments and accumulate dV += P^T dO and dK
//      += dS^T Q (wgmma with A in registers, dO and Q MN-major: the
//      transpose bit).  dK is scaled once; rows >= Skv are never written.
//   3. dQ: one block per (128-row q tile, q head, batch; 64 rows at hd
//      256), the longest first: the producer loads Q, dO and their lse and
//      D rows once and streams K and V tiles of the rows' keys; each
//      consumer warpgroup (64 rows) computes S = Q K^T and dP = dO V^T, dS
//      in registers, and dQ += dS K (K MN-major), scaled once at the end.
//
// Masks: every kind is Mask's interval (attention_mask.cuh): 'global',
// 'local' and 'chunked' (with their window), 'prefix' (with its length)
// and 'full' (whisper's encoder, and at Skv != Sq its cross-attention:
// the dK/dV grid runs over the Skv keys, the dQ grid and the workspace
// rows over the Sq queries; every other kind takes Skv == Sq).  The dQ
// pass bounds its
// kv loop by [lo, hi] of its rows, as the forward does; the dK/dV pass
// bounds its q loop by [qlo, qhi] of its keys.  A tile is masked only
// where some pair of it is not live (an edge tile: the diagonal, the end
// of the sequence, a window's or a chunk's edge, the prefix's end), found
// from the interval of its first and last row or key, which both bounds
// are nondecreasing in; a warpgroup skips the products of a tile none of
// whose pairs is live (it still takes its turn on the ring).  Q and dO rows
// past Sq and K and V rows past Skv are zero-filled by the TMA box and the
// lse and D rows past Sq read 0, so such a query would give p = exp2(0) =
// 1: the edge masks make it 0, `q < Sq` in the dK/dV pass and `k < Skv` in
// the dQ pass.
//
// The softcap (gemma2): each score is recapped with the forward's own
// softcap_score (attention_softcap.cuh, the same reciprocal), so P =
// exp2(capped log2e - lse log2e) meets the forward's lse, and dS takes the
// cap's derivative 1 - tanh^2 before the dQ and dK products.
//
// Tiles and what bounds them: at hd 128 the dK/dV consumer holds dK and dV
// (64 + 64 fp32 a thread), S^T and dP^T of a 64-row q tile (32 + 32) and
// their bf16 fragments (16 + 16) in the 240 registers setmaxnreg gives it,
// which is why the q tile is 64 rows (FlashAttention-3's choice); the dQ
// consumer holds dQ (64), S and dP of a 128-key tile (64 + 64) and dS's
// fragments (32).  Shared memory at hd 128: K and V resident (64 KB)
// beside a ring of 4 Q + dO stages (32 KB each); Q and dO resident (64 KB)
// beside 2 K + V stages (64 KB each: 128-key tiles ran 2% faster than
// 64-key tiles in 4 stages, launch/bwd_ab.py on the card).  Issuing dV's
// product before dS is formed, so that the exps overlap the tensor cores,
// ran 1-5% slower.  Seven products (S and dP are computed in both passes,
// against the five the bound counts): at long S it is bound by the tensor
// cores and the exps of the recomputed scores.
//
// Under the softcap the dK/dV pass computes S^T and dP^T in two halves of
// 32 queries (DkvLayout's PARTS), packing each half's P^T and dS^T before
// the next half's products: the softcap's arithmetic beside both 64-query
// score tiles, dK and dV spilled 8-32 bytes a thread.
//
// Head dim 256 (gemma3): dK and dV of 64 keys x 256 columns would take 256
// fp32 a thread of one warpgroup, and K and V of 128 keys (128 KB) leave
// no room for two Q + dO stages (64 KB each).  So the dK/dV block takes 64
// keys, and its two consumer warpgroups split the head dim: each computes
// the same S^T and dP^T of the 64 keys (the full 256-deep products) and
// holds dK and dV of its 128 columns, the registers of the hd-128 path;
// K and V (64 KB) sit beside two stages.  Computing S^T and dP^T in both
// warpgroups spends 1.5x the products of the pass (FlashAttention-3
// shares P^T and dS^T through shared memory instead), a cost taken for
// the simpler form.  The dQ pass takes 64-row q tiles (Q and dO 64 KB) and
// 64-key K/V tiles (two stages of 64 KB) on one consumer warpgroup holding
// dQ [64 x 256] (128 fp32 a thread) with no register rebalancing: its 256
// threads may each take 255.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mask.cuh"
#include "attention_softcap.cuh"
#include "hopper.cuh"

using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

// two consumer warpgroups and a producer warpgroup, whose registers go to
// the consumers (240 a thread)
constexpr int THREADS = 3 * 128;
constexpr int BOX_ROWS = 64;   // rows of a TMA box; a wgmma's M
constexpr int ROW_PAD = 128;   // the workspace's rows: a multiple of this
constexpr int SMEM_MAX = 232448;
constexpr int STAGES_MAX = 4;
constexpr float LOG2E = 1.4426950408889634f;

// Rows of HD bf16 in shared memory: CH column boxes of SPAN bytes a row (the
// swizzle span, at most 128), as K4's forward lays them out
template <int HD>
struct Rows {
  static constexpr int SPAN = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int CH = HD * 2 / SPAN;
  static constexpr int COLS = SPAN / 2;
};

// the dK/dV pass: K and V tiles of BKV keys resident, a ring of Q + dO
// tiles of BQ rows, and per stage the tile's lse and D rows.  Up to hd 128
// each consumer warpgroup owns 64 of the 128 keys and all HD columns; at
// hd 256 (SPLIT) both own the same 64 keys and HDW = 128 columns each.
// S^T and dP^T of a tile are computed in PARTS column slices of BQP
// queries: two under the softcap, whose arithmetic leaves no room for
// both 64-column score tiles beside dK and dV (ptxas spilled 8-32 bytes)
template <int HD, bool SOFTCAP>
struct DkvLayout {
  static constexpr bool SPLIT = HD > 128;
  static constexpr int BKV = SPLIT ? BOX_ROWS : 2 * BOX_ROWS, BQ = BOX_ROWS;
  static constexpr int HDW = SPLIT ? HD / 2 : HD;
  static constexpr int PARTS = SOFTCAP ? 2 : 1, BQP = BQ / PARTS;
  static constexpr int KV_BYTES = BKV * HD * 2;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int STAGE = 2 * Q_BYTES;
  static constexpr int STATS = 2 * BQ * 4;
  static constexpr int FIXED = 1024 + 2 * KV_BYTES + 8;
  static constexpr int FIT = (SMEM_MAX - FIXED) / (STAGE + STATS + 16);
  static constexpr int STAGES = FIT < STAGES_MAX ? FIT : STAGES_MAX;
  static_assert(STAGES >= 2, "the Q/dO ring needs two stages to overlap");
  static constexpr int SMEM = FIXED + STAGES * (STAGE + STATS + 16);
};

// the dQ pass: Q and dO tiles of BQ rows and their lse and D rows
// resident, a ring of K + V tiles of BKV keys; WGS consumer warpgroups of
// 64 rows (two, whose producer hands them its registers; one at hd 256)
template <int HD>
struct DqLayout {
  static constexpr int WGS = HD > 128 ? 1 : 2;
  static constexpr int THREADS = (WGS + 1) * 128;
  static constexpr int BQ = WGS * BOX_ROWS;
  static constexpr int BKV = HD > 128 ? BOX_ROWS : 2 * BOX_ROWS;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int FIXED = 1024 + 2 * Q_BYTES + 2 * BQ * 4 + 8;
  static constexpr int FIT = (SMEM_MAX - FIXED) / (STAGE + 16);
  static constexpr int STAGES = FIT < STAGES_MAX ? FIT : STAGES_MAX;
  static_assert(STAGES >= 2, "the K/V ring needs two stages to overlap");
  static constexpr int SMEM = FIXED + STAGES * (STAGE + 16);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D [64 x N] = A [64 x HD] . B^T: A the 64 rows from `a_row0` of a tile of
// A_ROWS rows, B the N rows from `b_row0` of a tile of B_ROWS rows, both
// K-major in shared memory (K4's issue_scores); issued and committed, not
// waited for
template <int HD, int A_ROWS, int N, int B_ROWS = N>
__device__ __forceinline__ void issue_nt(float (&d)[N / 2], const uint8_t* a,
                                         int a_row0, const uint8_t* b,
                                         int b_row0 = 0) {
  constexpr int SPAN = Rows<HD>::SPAN;
  constexpr int KSTEPS_PER_BOX = SPAN / 32;  // k16 steps along one row
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / KSTEPS_PER_BOX, w = kk % KSTEPS_PER_BOX;
    const uint64_t da = make_desc(
        a + c * A_ROWS * SPAN + a_row0 * SPAN + w * 32, 16, 8 * SPAN, SPAN);
    const uint64_t db = make_desc(
        b + c * B_ROWS * SPAN + b_row0 * SPAN + w * 32, 16, 8 * SPAN, SPAN);
    wgmma_ss<0, 0>(d, da, db, kk > 0);
  }
  wgmma_commit();
}

// D [64 x N] += X [64 x K] . B: X in registers (bf16 pairs in the
// accumulator's fragment layout, which is the A operand's), B the N
// columns from `b` of a tile of K rows of HD columns, MN-major (column
// boxes of K rows, K * SPAN bytes apart: K4's issue_pv); issued and
// committed, not waited for
template <int HD, int N, int K>
__device__ __forceinline__ void issue_nn(float (&d)[N / 2],
                                         const uint32_t (&x)[K / 16][4],
                                         const uint8_t* b) {
  constexpr int SPAN = Rows<HD>::SPAN;
  wgmma_fence();
  fence_regs(d);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = make_desc(b + kk * 16 * SPAN, K * SPAN, 8 * SPAN,
                                  SPAN);
    wgmma_rs<1>(d, x[kk], db, 1);
  }
  wgmma_commit();
}

// Accumulator fragments [64 x N] are rounded to bf16 pairs as the A
// fragments of the next products: the A fragment of k16 step kk is the
// accumulator's elements 8 kk .. 8 kk + 7, so elements 4 j .. 4 j + 3 (an
// 8-column block j) are pairs 2 (j % 2) and 2 (j % 2) + 1 of step j / 2.
// The grad functions below pack each block as soon as it is formed, so
// the fp32 fragments die block by block.
__device__ __forceinline__ void pack_block(uint32_t (&x)[4], int j,
                                           float c0, float c1, float c2,
                                           float c3) {
  x[2 * (j % 2)] = pack_bf16(c0, c1);
  x[2 * (j % 2) + 1] = pack_bf16(c2, c3);
}

// The scores' scale and the softcap, a kernel parameter (read from the
// constant bank, no register held): scale2 = scale log2(e) and rcp =
// 1 / softcap, both rounded once on the host as the device would round
// them (the forward's __frcp_rn).  Without a softcap, p = exp2(s scale2 -
// lse2) and dS = p (dp - D); with it, the forward's capped score c tanh(s
// scale / c) (softcap_score's arithmetic) in place of s scale, and dS
// times 1 - tanh^2.
struct Cap {
  float scale, scale2, softcap, rcp;
};

template <bool SOFTCAP>
__device__ __forceinline__ float grad_one(float s, float& dp, float lse2,
                                          float dsum, const Cap& cap,
                                          bool live) {
  float p, d = 1.0f;
  if (SOFTCAP) {
    const float t = softcap_tanh(s * cap.scale, cap.softcap, cap.rcp);
    p = exp2f(fmaf(cap.softcap * t, LOG2E, -lse2));
    d = 1.0f - t * t;
  } else {
    p = exp2f(fmaf(s, cap.scale2, -lse2));
  }
  if (!live) p = 0.0f;
  dp = SOFTCAP ? p * (dp - dsum) * d : p * (dp - dsum);
  return p;
}

// The dK/dV pass's P^T and dS^T from S^T and dP^T [64 keys x N queries],
// as bf16 A fragments pa and dsa: element 4 j + e is at key row r0 + 8 (e
// >> 1) and query column 8 j + cq + (e & 1) of the tile, whose lse log2(e)
// and D rows are lse2 and dsum (shared memory).  p = exp2(s scale2 -
// lse2) where live (EDGE tiles only: live(column, e >> 1)), else 0; ds = p
// (dp - D) (grad_one).
// S^T and dP^T hold the N columns from c0 of the tile's pa and dsa (c0 a
// multiple of 16).
template <bool EDGE, bool SOFTCAP, int N, int BQ, class Live>
__device__ __forceinline__ void grad_cols(const float (&s)[N / 2],
                                          float (&dp)[N / 2],
                                          uint32_t (&pa)[BQ / 16][4],
                                          uint32_t (&dsa)[BQ / 16][4],
                                          int c0, const float* lse2,
                                          const float* dsum, int cq,
                                          const Cap& cap, const Live& live) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = c0 + 8 * j + cq, jt = c0 / 8 + j;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
    const float2 dd = *reinterpret_cast<const float2*>(dsum + col);
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = grad_one<SOFTCAP>(s[4 * j + e], dp[4 * j + e],
                               e & 1 ? l2.y : l2.x, e & 1 ? dd.y : dd.x, cap,
                               !EDGE || live(col + (e & 1), e >> 1));
    pack_block(pa[jt / 2], jt, p[0], p[1], p[2], p[3]);
    pack_block(dsa[jt / 2], jt, dp[4 * j], dp[4 * j + 1], dp[4 * j + 2],
               dp[4 * j + 3]);
  }
}

// The dQ pass's dS from S and dP [64 queries x N keys], as bf16 A
// fragments dsa: element 4 j + e is at query row r0 + 8 (e >> 1), whose
// lse log2(e) and D are lse2[e >> 1] and dsum[e >> 1], and key k0 + 8 j +
// (e & 1); the same p and ds.
template <bool EDGE, bool SOFTCAP, int N, class Live>
__device__ __forceinline__ void grad_rows(const float (&s)[N / 2],
                                          float (&dp)[N / 2],
                                          uint32_t (&dsa)[N / 16][4],
                                          const float (&lse2)[2],
                                          const float (&dsum)[2], int k0,
                                          const Cap& cap, const Live& live) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      grad_one<SOFTCAP>(s[4 * j + e], dp[4 * j + e], lse2[r], dsum[r], cap,
                        !EDGE || live(k0 + 8 * j + (e & 1), r));
    }
    pack_block(dsa[j / 2], j, dp[4 * j], dp[4 * j + 1], dp[4 * j + 2],
               dp[4 * j + 3]);
  }
}

// 64 x N fp32 fragments times `mul` into bf16 rows r0 and r0 + 8 (those
// below S) of the N columns at `g` (rows `stride` elements apart)
template <int N>
__device__ __forceinline__ void store_rows(bf16* g, const float (&c)[N / 2],
                                           int r0, int S, size_t stride,
                                           int cq, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    bf16* p = g + (size_t)row * stride + cq;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          c[4 * j + 2 * r] * mul, c[4 * j + 2 * r + 1] * mul);
  }
}

// ws[0][b H + h][r] = sum_d do[b, r, h, d] * o[b, r, h, d] at fp32 and
// ws[1][b H + h][r] = lse[b, h, r] * log2(e), both 0 for Sq <= r < S_pad; one
// warp a row: lane l sums the pairs at 2 l, 2 l + 64, ..., then the lanes
// fold by shuffles
__global__ void __launch_bounds__(256)
rows_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ ws, int B,
            int Sq, int S_pad, int H, int hd) {
  const int n = B * H * S_pad;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n) return;
  const int r = row % S_pad, bh = row / S_pad, h = bh % H, b = bh / H;
  float s = 0.0f, l2 = 0.0f;
  if (r < Sq) {  // a whole warp's row
    const size_t base = (((size_t)b * Sq + r) * H + h) * hd;
    for (int i = 2 * lane; i < hd; i += 64) {
      const float2 of = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + base + i));
      const float2 df = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dout + base + i));
      s = fmaf(df.x, of.x, s);
      s = fmaf(df.y, of.y, s);
    }
#pragma unroll
    for (int off = 16; off; off /= 2)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    l2 = lse[(size_t)bh * Sq + r] * LOG2E;
  }
  if (lane == 0) {
    ws[row] = s;
    ws[(size_t)n + row] = l2;
  }
}

template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap map_q,
           const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v,
           const __grid_constant__ CUtensorMap map_do,
           const float* __restrict__ ws, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int B, int Sq, int Skv, int S_pad, int H,
           int KV, Mask mask, const Cap cap) {
  using L = DkvLayout<HD, SOFTCAP>;
  constexpr int SPAN = Rows<HD>::SPAN, COLS = Rows<HD>::COLS;
  constexpr int BQ = L::BQ, BKV = L::BKV, NS = L::STAGES, HDW = L::HDW;
  constexpr int BQP = L::BQP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + L::KV_BYTES;
  uint8_t* ring = Vs + L::KV_BYTES;  // stage s: Q, then dO
  float* stats = reinterpret_cast<float*>(ring + NS * L::STAGE);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(stats + NS * 2 * BQ);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + NS;

  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KV;
  const int kv0 = blockIdx.x * BKV;
  // the q tiles that attend a key of the block: from the first key's first
  // query to the last key's last one
  const int q_first = mask.qlo(kv0);
  const int q_last = min(mask.qhi(min(kv0 + BKV, Skv) - 1), Sq - 1);
  const int qt_begin = q_first / BQ;
  const int n_qt = q_last >= q_first ? q_last / BQ + 1 - qt_begin : 0;
  const int n_iter = G * n_qt;  // head g's tiles, g ascending
  const size_t lse_rows = (size_t)B * H * S_pad;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer: K and V once, then Q, dO, lse, D tiles
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(kvbar, 2 * L::KV_BYTES);
#pragma unroll
      for (int c = 0; c < Rows<HD>::CH; ++c)
#pragma unroll
        for (int half = 0; half < BKV / BOX_ROWS; ++half) {
          const int off = c * BKV * SPAN + half * BOX_ROWS * SPAN;
          tma_load_3d(Ks + off, &map_k, kvbar, kvh * HD + c * COLS,
                      kv0 + half * BOX_ROWS, b);
          tma_load_3d(Vs + off, &map_v, kvbar, kvh * HD + c * COLS,
                      kv0 + half * BOX_ROWS, b);
        }
      for (int i = 0; i < n_iter; ++i) {
        const int h = kvh * G + i / n_qt, q0 = (qt_begin + i % n_qt) * BQ;
        const int s = i % NS;
        mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE + L::STATS);
        uint8_t* qs = ring + s * L::STAGE;
#pragma unroll
        for (int c = 0; c < Rows<HD>::CH; ++c) {
          tma_load_3d(qs + c * BQ * SPAN, &map_q, &full[s],
                      h * HD + c * COLS, q0, b);
          tma_load_3d(qs + L::Q_BYTES + c * BQ * SPAN, &map_do, &full[s],
                      h * HD + c * COLS, q0, b);
        }
        const float* row = ws + ((size_t)b * H + h) * S_pad + q0;
        bulk_load(stats + s * 2 * BQ, row + lse_rows, BQ * 4, &full[s]);
        bulk_load(stats + s * 2 * BQ + BQ, row, BQ * 4, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys [kw0, kw0 + 64) and dK/dV columns
  // [col0, col0 + HDW); in the accumulator fragments this thread holds keys
  // r0 and r0 + 8, and of each 8-column block j the queries 8 j + cq + {0,
  // 1} of the tile
  setmaxnreg_inc<240>();
  const int wg = warp / 4;
  const int kw0 = kv0 + (L::SPLIT ? 0 : wg * 64);
  const int col0 = L::SPLIT ? wg * HDW : 0;
  // the column boxes of this warpgroup's columns in a Q or dO tile
  const int qcols = col0 / COLS * BQ * SPAN;
  const int r0 = kw0 + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // the queries of this thread's keys (none for a key past Skv), the
  // queries every key of the warpgroup is attended by (a tile inside them
  // is interior), and those some key is
  int q_lo[2], q_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + 8 * r;
    q_lo[r] = mask.qlo(key);
    q_hi[r] = key < Skv ? min(mask.qhi(key), Sq - 1) : -1;
  }
  const int all_lo = mask.qlo(kw0 + 63);
  const int all_hi = kw0 + 63 < Skv ? min(mask.qhi(kw0), Sq - 1) : -1;
  const int any_lo = mask.qlo(kw0);
  const int any_hi =
      kw0 < Skv ? min(mask.qhi(min(kw0 + 63, Skv - 1)), Sq - 1) : -1;
  float dka[HDW / 2], dva[HDW / 2];
#pragma unroll
  for (int i = 0; i < HDW / 2; ++i) dka[i] = dva[i] = 0.0f;

  mbar_wait(kvbar, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int q0 = (qt_begin + i % n_qt) * BQ, s = i % NS;
    // every consumer waits for every tile, so no warp runs a round ahead
    // on the empty barrier
    mbar_wait(&full[s], (i / NS) & 1);
    if (q0 <= any_hi && q0 + BQ - 1 >= any_lo) {
      const uint8_t* qs = ring + s * L::STAGE;
      const float* lse2 = stats + s * 2 * BQ;
      const auto live = [&](int col, int r) {
        return q0 + col >= q_lo[r] && q0 + col <= q_hi[r];
      };
      const bool edge = q0 < all_lo || q0 + BQ - 1 > all_hi;
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int part = 0; part < L::PARTS; ++part) {
        const int c0 = part * BQP;
        float st[BQP / 2], dpt[BQP / 2];
        issue_nt<HD, BKV, BQP, BQ>(st, Ks, kw0 - kv0, qs, c0);      // S^T
        issue_nt<HD, BKV, BQP, BQ>(dpt, Vs, kw0 - kv0, qs + L::Q_BYTES,
                                   c0);                             // dP^T
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        if (edge)
          grad_cols<true, SOFTCAP, BQP, BQ>(st, dpt, pa, dsa, c0, lse2,
                                            lse2 + BQ, cq, cap, live);
        else
          grad_cols<false, SOFTCAP, BQP, BQ>(st, dpt, pa, dsa, c0, lse2,
                                             lse2 + BQ, cq, cap, live);
      }
      issue_nn<HD, HDW, BQ>(dva, pa, qs + L::Q_BYTES + qcols);  // dV += P^T dO
      issue_nn<HD, HDW, BQ>(dka, dsa, qs + qcols);              // dK += dS^T Q
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t stride = (size_t)KV * HD;
  const size_t head = (size_t)b * Skv * stride + kvh * HD + col0;
  store_rows<HDW>(dk + head, dka, r0, Skv, stride, cq, cap.scale);
  store_rows<HDW>(dv + head, dva, r0, Skv, stride, cq, 1.0f);
}

template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(DqLayout<HD>::THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap map_q,
          const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v,
          const __grid_constant__ CUtensorMap map_do,
          const float* __restrict__ ws, bf16* __restrict__ dq, int B, int Sq,
          int Skv, int S_pad, int H, int KV, int n_qt, Mask mask,
          const Cap cap) {
  using L = DqLayout<HD>;
  constexpr int SPAN = Rows<HD>::SPAN, COLS = Rows<HD>::COLS;
  constexpr int BQ = L::BQ, BKV = L::BKV, NS = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* Ds = Qs + L::Q_BYTES;  // the dO tile
  uint8_t* ring = Ds + L::Q_BYTES;  // stage s: K, then V
  float* stats = reinterpret_cast<float*>(ring + NS * L::STAGE);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(stats + 2 * BQ);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + NS;

  // the longest q tiles (most kv tiles under the causal mask) first
  const int qt = n_qt - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV), q0 = qt * BQ;
  // no tile past the last row's keys, none before the first row's
  const int kv_end = min(Skv, mask.hi(min(q0 + BQ, Sq) - 1) + 1);
  const int kv_begin = max(0, mask.lo(q0)) / BKV * BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV
                                        : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * L::WGS);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * L::WGS) {  // producer: Q, dO, lse, D once, then K, V
    if constexpr (L::WGS == 2) setmaxnreg_dec<24>();
    if (warp == 4 * L::WGS && lane == 0) {
      mbar_expect_tx(qbar, 2 * L::Q_BYTES + 2 * BQ * 4);
#pragma unroll
      for (int c = 0; c < Rows<HD>::CH; ++c)
#pragma unroll
        for (int half = 0; half < BQ / BOX_ROWS; ++half) {
          const int off = c * BQ * SPAN + half * BOX_ROWS * SPAN;
          tma_load_3d(Qs + off, &map_q, qbar, h * HD + c * COLS,
                      q0 + half * BOX_ROWS, b);
          tma_load_3d(Ds + off, &map_do, qbar, h * HD + c * COLS,
                      q0 + half * BOX_ROWS, b);
        }
      const float* row = ws + ((size_t)b * H + h) * S_pad + q0;
      bulk_load(stats, row + (size_t)B * H * S_pad, BQ * 4, qbar);
      bulk_load(stats + BQ, row, BQ * 4, qbar);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS, kv0 = kv_begin + i * BKV;
        mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        uint8_t* ks = ring + s * L::STAGE;
#pragma unroll
        for (int c = 0; c < Rows<HD>::CH; ++c)
#pragma unroll
          for (int half = 0; half < BKV / BOX_ROWS; ++half) {
            const int off = c * BKV * SPAN + half * BOX_ROWS * SPAN;
            tma_load_3d(ks + off, &map_k, &full[s], kvh * HD + c * COLS,
                        kv0 + half * BOX_ROWS, b);
            tma_load_3d(ks + L::KV_BYTES + off, &map_v, &full[s],
                        kvh * HD + c * COLS, kv0 + half * BOX_ROWS, b);
          }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [qw0, qw0 + 64); this thread holds
  // rows r0 and r0 + 8 and, of each 8-column block j, the keys 8 j + cq +
  // {0, 1} of the tile
  if constexpr (L::WGS == 2) setmaxnreg_inc<240>();
  const int wg = warp / 4;
  const int qw0 = q0 + wg * 64;
  const int r0 = qw0 + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // the keys of this thread's rows, the keys every row of the warpgroup
  // attends (a tile inside them is interior), and those some row does
  const int key_lo[2] = {mask.lo(r0), mask.lo(r0 + 8)};
  const int key_hi[2] = {min(mask.hi(r0), Skv - 1),
                         min(mask.hi(r0 + 8), Skv - 1)};
  const int all_lo = mask.lo(qw0 + 63), all_hi = min(mask.hi(qw0), Skv - 1);
  const int any_lo = mask.lo(qw0);
  const int any_hi =
      qw0 < Sq ? min(mask.hi(min(qw0 + 63, Sq - 1)), Skv - 1) : -1;
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.0f;

  mbar_wait(qbar, 0);
  const float lse2[2] = {stats[r0 - q0], stats[r0 + 8 - q0]};
  const float dsum[2] = {stats[BQ + r0 - q0], stats[BQ + r0 + 8 - q0]};
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % NS, kv0 = kv_begin + i * BKV;
    mbar_wait(&full[s], (i / NS) & 1);
    if (kv0 <= any_hi && kv0 + BKV - 1 >= any_lo) {
      const uint8_t* ks = ring + s * L::STAGE;
      float sc[BKV / 2], dp[BKV / 2];
      issue_nt<HD, BQ, BKV>(sc, Qs, wg * 64, ks);               // S
      issue_nt<HD, BQ, BKV>(dp, Ds, wg * 64, ks + L::KV_BYTES);  // dP
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const auto live = [&](int key, int r) {
        return key >= key_lo[r] && key <= key_hi[r];
      };
      uint32_t dsa[BKV / 16][4];
      if (kv0 < all_lo || kv0 + BKV - 1 > all_hi)
        grad_rows<true, SOFTCAP, BKV>(sc, dp, dsa, lse2, dsum, kv0 + cq, cap,
                                      live);
      else
        grad_rows<false, SOFTCAP, BKV>(sc, dp, dsa, lse2, dsum, kv0 + cq,
                                       cap, live);
      issue_nn<HD, HD, BKV>(dqa, dsa, ks);  // dQ += dS K
      wgmma_wait<0>();
      fence_regs(dqa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t stride = (size_t)H * HD;
  store_rows<HD>(dq + (size_t)b * Sq * stride + h * HD, dqa, r0, Sq, stride,
                 cq, cap.scale);
}

template <int HD, bool SOFTCAP>
int launch_backward(const bf16* Q, const bf16* K, const bf16* V,
                    const bf16* O, const bf16* dO, const float* L, bf16* dq,
                    bf16* dk, bf16* dv, float* ws, int B, int Sq, int Skv,
                    int H, int KV, float scale, Mask mask, float softcap,
                    cudaStream_t st) {
  using Dkv = DkvLayout<HD, SOFTCAP>;
  using Dq = DqLayout<HD>;
  // q, do [B, Sq, H * HD] and k, v [B, Skv, KV * HD] as 3-D maps of 64-row
  // boxes (a 128-row tile is two), so a box past a sequence's end is
  // zero-filled rather than read from the next
  CUtensorMap mq, mk, mv, mdo;
  const uint32_t box[3] = {Rows<HD>::COLS, BOX_ROWS, 1};
  const uint64_t dims_q[3] = {(uint64_t)H * HD, (uint64_t)Sq, (uint64_t)B};
  const uint64_t strides_q[2] = {(uint64_t)H * HD * 2,
                                 (uint64_t)Sq * H * HD * 2};
  const uint64_t dims_kv[3] = {(uint64_t)KV * HD, (uint64_t)Skv,
                               (uint64_t)B};
  const uint64_t strides_kv[2] = {(uint64_t)KV * HD * 2,
                                  (uint64_t)Skv * KV * HD * 2};
  constexpr int SPAN = Rows<HD>::SPAN;
  int e = make_map(&mq, Q, 3, dims_q, strides_q, box, SPAN);
  if (!e) e = make_map(&mdo, dO, 3, dims_q, strides_q, box, SPAN);
  if (!e) e = make_map(&mk, K, 3, dims_kv, strides_kv, box, SPAN);
  if (!e) e = make_map(&mv, V, 3, dims_kv, strides_kv, box, SPAN);
  if (e) return e;
  static int smem_set = 0;
  if (!smem_set) {
    e = (int)cudaFuncSetAttribute(
        dkv_kernel<HD, SOFTCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Dkv::SMEM);
    if (!e)
      e = (int)cudaFuncSetAttribute(
          dq_kernel<HD, SOFTCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          Dq::SMEM);
    if (e) return e;
    smem_set = 1;
  }
  const int S_pad = (Sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  rows_kernel<<<(B * H * S_pad + 7) / 8, 256, 0, st>>>(O, dO, L, ws, B, Sq,
                                                       S_pad, H, HD);
  const int n_kt = (Skv + Dkv::BKV - 1) / Dkv::BKV;
  const Cap cap{scale, scale * LOG2E, softcap,
                SOFTCAP ? 1.0f / softcap : 0.0f};
  dkv_kernel<HD, SOFTCAP><<<dim3(n_kt, KV, B), THREADS, Dkv::SMEM, st>>>(
      mq, mk, mv, mdo, ws, dk, dv, B, Sq, Skv, S_pad, H, KV, mask, cap);
  const int n_qt = (Sq + Dq::BQ - 1) / Dq::BQ;
  dq_kernel<HD, SOFTCAP><<<dim3(n_qt, H, B), Dq::THREADS, Dq::SMEM, st>>>(
      mq, mk, mv, mdo, ws, dq, B, Sq, Skv, S_pad, H, KV, n_qt, mask, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// K4's backward (every MaskKind with its window and prefix length, the
// softcap when > 0, head dims 16 to 256; Skv == Sq, or any Skv under
// 'full'): q, o, do, dq [B, Sq, H, hd] and k, v, dk, dv [B, Skv, KV, hd]
// bf16, lse [B, H, Sq] fp32 (k4_flash_prefill_lse's), ws [2, B, H, S_pad]
// fp32 scratch for D and lse log2(e), S_pad = Sq rounded up to a multiple
// of 128 (kernels/flash_attention.py's BWD_ROW_PAD); three launches on
// `stream`.
extern "C" int k4_flash_backward(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* dq, void* dk,
                                 void* dv, void* ws, int B, int Sq, int Skv,
                                 int H, int KV, int hd, float scale,
                                 int mask_kind,
                                 int window, int prefix_len, float softcap,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mask{mask_kind, window, prefix_len};
  const int kinds = 1 << MASK_GLOBAL | 1 << MASK_LOCAL | 1 << MASK_FULL |
                    1 << MASK_CHUNKED | 1 << MASK_PREFIX;
  if (!mask_ok(mask, kinds) || !(softcap >= 0.0f) || KV < 1 || H % KV ||
      B < 1 || Sq < 1 || Skv < 1 || (Skv != Sq && mask_kind != MASK_FULL))
    return (int)cudaErrorInvalidValue;
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* O = static_cast<const bf16*>(o);
  const bf16* dO = static_cast<const bf16*>(dout);
  const float* L = static_cast<const float*>(lse);
  bf16* DQ = static_cast<bf16*>(dq);
  bf16* DK = static_cast<bf16*>(dk);
  bf16* DV = static_cast<bf16*>(dv);
  float* W = static_cast<float*>(ws);
  switch (hd) {
#define BWD_CASE(HD)                                                       \
    case HD:                                                               \
      return softcap > 0.0f                                                \
                 ? launch_backward<HD, true>(Q, K, V, O, dO, L, DQ, DK, DV, \
                                             W, B, Sq, Skv, H, KV, scale,  \
                                             mask, softcap, st)            \
                 : launch_backward<HD, false>(Q, K, V, O, dO, L, DQ, DK,   \
                                              DV, W, B, Sq, Skv, H, KV,    \
                                              scale, mask, 0.0f, st);
    BWD_CASE(16) BWD_CASE(32) BWD_CASE(64) BWD_CASE(128) BWD_CASE(256)
#undef BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
