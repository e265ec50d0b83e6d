// K4's backward on Hopper: the gradient of the flash prefill in the
// recomputing (FlashAttention-2) form, for the training path, in the shape
// of K4's forward (flash_attention.cu's prefill_kernel, FlashAttention-3's
// shape): wgmma products fed by a TMA ring through a producer warpgroup.
//
// The reference defines no backward kernel (its flash_attention_pallas,
// src/repro/kernels/flash_attention.py:331, is differentiated by XLA
// through the plain attention); this is the port's own, held to
// kernels/ref.py::flash_attention_bwd_ref.  Inputs: q, the forward's
// output o and its gradient do [B, S, H, hd], k and v [B, S, KV, hd] (bf16,
// KV | H), and the forward's row log-sum-exp lse [B, H, S] (fp32,
// k4_flash_prefill_lse).  Three launches, no atomics: every output element
// is written once, by one block, after a fixed order of sums, so two calls
// are bitwise equal.
//
//   1. rows: D = rowsum(do * o) at fp32 (one warp a row) and lse * log2(e),
//      into a workspace [2][B * H][S_pad] whose rows are padded with 0 to a
//      multiple of ROW_PAD, so the passes below copy whole 64- or 128-row
//      runs of them with one bulk copy each and read 0 past S.
//   2. dK/dV: one block per (128-key tile, kv head, batch), the longest key
//      tiles (the first) first.  A producer warpgroup (its registers handed
//      to the consumers by setmaxnreg) loads the K and V tiles once by TMA,
//      then streams, for each of the kv head's G query heads in ascending
//      order and each 64-row q tile from the first that attends the block's
//      keys, the Q and dO tiles and their lse and D rows through a ring of
//      full/empty mbarriers.  Two consumer warpgroups of 64 keys each
//      compute S^T = K Q^T and dP^T = V dO^T (wgmma, all four K-major from
//      shared memory), form P^T = exp2(S^T scale log2e - lse log2e) and dS^T
//      = P^T (dP^T - D) in registers on the accumulator fragments, round
//      both to bf16 register A fragments and accumulate dV += P^T dO and dK
//      += dS^T Q (wgmma with A in registers, dO and Q MN-major: the
//      transpose bit).  dK is scaled once; rows >= S are never written.
//   3. dQ: one block per (128-row q tile, q head, batch), the longest first:
//      the producer loads Q, dO and their lse and D rows once and streams
//      K and V tiles up to the diagonal; each consumer warpgroup (64 rows)
//      computes S = Q K^T and dP = dO V^T, dS in registers, and dQ += dS K
//      (K MN-major), scaled once at the end.
//
// Masks: every kind is Mask's interval (attention_mask.cuh).  The dQ pass
// bounds its kv loop by [lo, hi] of its rows, as the forward does; the
// dK/dV pass bounds its q loop by [qlo, qhi] of its keys.  A tile is masked
// only where it meets the diagonal or the end of the sequence (an edge
// tile); a warpgroup skips the products of a tile none of whose pairs is
// live (it still takes its turn on the ring).  Q, dO, K and V rows past S
// are zero-filled by the TMA box and their lse and D rows read 0, so such
// a query would give p = exp2(0) = 1: the edge mask's `q < S` makes it 0.
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
// cores and the exps of the recomputed scores.  It covers the
// 'global' (causal) kind at head dims 16 to 128 with no softcap; the
// wrapper refuses the rest.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mask.cuh"
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
// tiles of BQ rows, and per stage the tile's lse and D rows
template <int HD>
struct DkvLayout {
  static constexpr int BKV = 2 * BOX_ROWS, BQ = BOX_ROWS;
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
// resident, a ring of K + V tiles of BKV keys
template <int HD>
struct DqLayout {
  static constexpr int BQ = 2 * BOX_ROWS, BKV = 2 * BOX_ROWS;
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
// A_ROWS rows, B a tile of N rows, both K-major in shared memory (K4's
// issue_scores); issued and committed, not waited for
template <int HD, int A_ROWS, int N>
__device__ __forceinline__ void issue_nt(float (&d)[N / 2], const uint8_t* a,
                                         int a_row0, const uint8_t* b) {
  constexpr int SPAN = Rows<HD>::SPAN;
  constexpr int KSTEPS_PER_BOX = SPAN / 32;  // k16 steps along one row
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / KSTEPS_PER_BOX, w = kk % KSTEPS_PER_BOX;
    const uint64_t da = make_desc(
        a + c * A_ROWS * SPAN + a_row0 * SPAN + w * 32, 16, 8 * SPAN, SPAN);
    const uint64_t db = make_desc(b + c * N * SPAN + w * 32, 16, 8 * SPAN,
                                  SPAN);
    wgmma_ss<0, 0>(d, da, db, kk > 0);
  }
  wgmma_commit();
}

// D [64 x HD] += X [64 x K] . B: X in registers (bf16 pairs in the
// accumulator's fragment layout, which is the A operand's), B a tile of K
// rows, MN-major (CH column boxes of K rows, K * SPAN bytes apart: K4's
// issue_pv); issued and committed, not waited for
template <int HD, int K>
__device__ __forceinline__ void issue_nn(float (&d)[HD / 2],
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

// an accumulator fragment [64 x N] rounded to bf16 pairs: the A fragment
// of k16 step kk is the accumulator's elements 8 kk .. 8 kk + 7
template <int N>
__device__ __forceinline__ void pack(uint32_t (&x)[N / 16][4],
                                     const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x[kk][q] = pack_bf16(c[8 * kk + 2 * q], c[8 * kk + 2 * q + 1]);
}

// The dK/dV pass's P^T and dS^T in place of S^T and dP^T [64 keys x N
// queries]: element 4 j + e is at key row r0 + 8 (e >> 1) and query column
// 8 j + cq + (e & 1) of the tile, whose lse log2(e) and D rows are lse2 and
// dsum (shared memory).  p = exp2(s scale2 - lse2) where live (EDGE tiles
// only: live(column, e >> 1)), else 0; ds = p (dp - D).
template <bool EDGE, int N, class Live>
__device__ __forceinline__ void grad_cols(float (&s)[N / 2],
                                          float (&dp)[N / 2],
                                          const float* lse2,
                                          const float* dsum, int cq,
                                          float scale2, const Live& live) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + cq);
    const float2 dd = *reinterpret_cast<const float2*>(dsum + 8 * j + cq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lv = e & 1 ? l2.y : l2.x, dv = e & 1 ? dd.y : dd.x;
      float p = exp2f(fmaf(s[4 * j + e], scale2, -lv));
      if (EDGE && !live(8 * j + cq + (e & 1), e >> 1)) p = 0.0f;
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - dv);
    }
  }
}

// The dQ pass's dS in place of dP [64 queries x N keys] (S in s): element
// 4 j + e is at query row r0 + 8 (e >> 1), whose lse log2(e) and D are
// lse2[e >> 1] and dsum[e >> 1], and key k0 + 8 j + (e & 1); the same p and
// ds.
template <bool EDGE, int N, class Live>
__device__ __forceinline__ void grad_rows(const float (&s)[N / 2],
                                          float (&dp)[N / 2],
                                          const float (&lse2)[2],
                                          const float (&dsum)[2], int k0,
                                          float scale2, const Live& live) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2f(fmaf(s[4 * j + e], scale2, -lse2[r]));
      if (EDGE && !live(k0 + 8 * j + (e & 1), r)) p = 0.0f;
      dp[4 * j + e] = p * (dp[4 * j + e] - dsum[r]);
    }
}

// 64 x HD fp32 fragments times `mul` into bf16 rows r0 and r0 + 8 (those
// below S) of the head at `g` (rows `stride` elements apart)
template <int HD>
__device__ __forceinline__ void store_rows(bf16* g, const float (&c)[HD / 2],
                                           int r0, int S, size_t stride,
                                           int cq, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    bf16* p = g + (size_t)row * stride + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          c[4 * j + 2 * r] * mul, c[4 * j + 2 * r + 1] * mul);
  }
}

// ws[0][b H + h][r] = sum_d do[b, r, h, d] * o[b, r, h, d] at fp32 and
// ws[1][b H + h][r] = lse[b, h, r] * log2(e), both 0 for S <= r < S_pad; one
// warp a row: lane l sums the pairs at 2 l, 2 l + 64, ..., then the lanes
// fold by shuffles
__global__ void __launch_bounds__(256)
rows_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ ws, int B,
            int S, int S_pad, int H, int hd) {
  const int n = B * H * S_pad;
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n) return;
  const int r = row % S_pad, bh = row / S_pad, h = bh % H, b = bh / H;
  float s = 0.0f, l2 = 0.0f;
  if (r < S) {  // a whole warp's row
    const size_t base = (((size_t)b * S + r) * H + h) * hd;
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
    l2 = lse[(size_t)bh * S + r] * LOG2E;
  }
  if (lane == 0) {
    ws[row] = s;
    ws[(size_t)n + row] = l2;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap map_q,
           const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v,
           const __grid_constant__ CUtensorMap map_do,
           const float* __restrict__ ws, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int B, int S, int S_pad, int H, int KV,
           float scale, Mask mask) {
  using L = DkvLayout<HD>;
  constexpr int SPAN = Rows<HD>::SPAN, COLS = Rows<HD>::COLS;
  constexpr int BQ = L::BQ, BKV = L::BKV, NS = L::STAGES;
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
  const int q_last = min(mask.qhi(min(kv0 + BKV, S) - 1), S - 1);
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

  // consumers: warpgroup wg owns keys [kw0, kw0 + 64); in the accumulator
  // fragments this thread holds keys r0 and r0 + 8, and of each 8-column
  // block j the queries 8 j + cq + {0, 1} of the tile
  setmaxnreg_inc<240>();
  const int wg = warp / 4;
  const int kw0 = kv0 + wg * 64;
  const int r0 = kw0 + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // the queries of this thread's keys (none for a key past S), the
  // queries every key of the warpgroup is attended by (a tile inside them
  // is interior), and those some key is
  int q_lo[2], q_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + 8 * r;
    q_lo[r] = mask.qlo(key);
    q_hi[r] = key < S ? min(mask.qhi(key), S - 1) : -1;
  }
  const int all_lo = mask.qlo(kw0 + 63);
  const int all_hi = kw0 + 63 < S ? min(mask.qhi(kw0), S - 1) : -1;
  const int any_lo = mask.qlo(kw0);
  const int any_hi = kw0 < S ? min(mask.qhi(min(kw0 + 63, S - 1)), S - 1)
                             : -1;
  const float scale2 = scale * LOG2E;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.0f;

  mbar_wait(kvbar, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int q0 = (qt_begin + i % n_qt) * BQ, s = i % NS;
    // every consumer waits for every tile, so no warp runs a round ahead
    // on the empty barrier
    mbar_wait(&full[s], (i / NS) & 1);
    if (q0 <= any_hi && q0 + BQ - 1 >= any_lo) {
      const uint8_t* qs = ring + s * L::STAGE;
      const float* lse2 = stats + s * 2 * BQ;
      float st[BQ / 2], dpt[BQ / 2];
      issue_nt<HD, BKV, BQ>(st, Ks, wg * 64, qs);               // S^T
      issue_nt<HD, BKV, BQ>(dpt, Vs, wg * 64, qs + L::Q_BYTES);  // dP^T
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      const auto live = [&](int col, int r) {
        return q0 + col >= q_lo[r] && q0 + col <= q_hi[r];
      };
      if (q0 < all_lo || q0 + BQ - 1 > all_hi)
        grad_cols<true, BQ>(st, dpt, lse2, lse2 + BQ, cq, scale2, live);
      else
        grad_cols<false, BQ>(st, dpt, lse2, lse2 + BQ, cq, scale2, live);
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
      pack<BQ>(pa, st);
      pack<BQ>(dsa, dpt);
      issue_nn<HD, BQ>(dva, pa, qs + L::Q_BYTES);  // dV += P^T dO
      issue_nn<HD, BQ>(dka, dsa, qs);              // dK += dS^T Q
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t stride = (size_t)KV * HD;
  const size_t head = (size_t)b * S * stride + kvh * HD;
  store_rows<HD>(dk + head, dka, r0, S, stride, cq, scale);
  store_rows<HD>(dv + head, dva, r0, S, stride, cq, 1.0f);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap map_q,
          const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v,
          const __grid_constant__ CUtensorMap map_do,
          const float* __restrict__ ws, bf16* __restrict__ dq, int B, int S,
          int S_pad, int H, int KV, int n_qt, float scale, Mask mask) {
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
  const int kv_end = min(S, mask.hi(min(q0 + BQ, S) - 1) + 1);
  const int kv_begin = max(0, mask.lo(q0)) / BKV * BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV
                                        : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer: Q, dO, lse, D once, then K and V tiles
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
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
  setmaxnreg_inc<240>();
  const int wg = warp / 4;
  const int qw0 = q0 + wg * 64;
  const int r0 = qw0 + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // the keys of this thread's rows, the keys every row of the warpgroup
  // attends (a tile inside them is interior), and those some row does
  const int key_lo[2] = {mask.lo(r0), mask.lo(r0 + 8)};
  const int key_hi[2] = {min(mask.hi(r0), S - 1), min(mask.hi(r0 + 8), S - 1)};
  const int all_lo = mask.lo(qw0 + 63), all_hi = min(mask.hi(qw0), S - 1);
  const int any_lo = mask.lo(qw0);
  const int any_hi = qw0 < S ? min(mask.hi(min(qw0 + 63, S - 1)), S - 1)
                             : -1;
  const float scale2 = scale * LOG2E;
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
      if (kv0 < all_lo || kv0 + BKV - 1 > all_hi)
        grad_rows<true, BKV>(sc, dp, lse2, dsum, kv0 + cq, scale2, live);
      else
        grad_rows<false, BKV>(sc, dp, lse2, dsum, kv0 + cq, scale2, live);
      uint32_t dsa[BKV / 16][4];
      pack<BKV>(dsa, dp);
      issue_nn<HD, BKV>(dqa, dsa, ks);  // dQ += dS K
      wgmma_wait<0>();
      fence_regs(dqa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t stride = (size_t)H * HD;
  store_rows<HD>(dq + (size_t)b * S * stride + h * HD, dqa, r0, S, stride,
                 cq, scale);
}

template <int HD>
int launch_backward(const bf16* Q, const bf16* K, const bf16* V,
                    const bf16* O, const bf16* dO, const float* L, bf16* dq,
                    bf16* dk, bf16* dv, float* ws, int B, int S, int H,
                    int KV, float scale, Mask mask, cudaStream_t st) {
  using Dkv = DkvLayout<HD>;
  using Dq = DqLayout<HD>;
  // q, do [B, S, H * HD] and k, v [B, S, KV * HD] as 3-D maps of 64-row
  // boxes (a 128-row tile is two), so a box past a sequence's end is
  // zero-filled rather than read from the next
  CUtensorMap mq, mk, mv, mdo;
  const uint32_t box[3] = {Rows<HD>::COLS, BOX_ROWS, 1};
  const uint64_t dims_q[3] = {(uint64_t)H * HD, (uint64_t)S, (uint64_t)B};
  const uint64_t strides_q[2] = {(uint64_t)H * HD * 2,
                                 (uint64_t)S * H * HD * 2};
  const uint64_t dims_kv[3] = {(uint64_t)KV * HD, (uint64_t)S, (uint64_t)B};
  const uint64_t strides_kv[2] = {(uint64_t)KV * HD * 2,
                                  (uint64_t)S * KV * HD * 2};
  constexpr int SPAN = Rows<HD>::SPAN;
  int e = make_map(&mq, Q, 3, dims_q, strides_q, box, SPAN);
  if (!e) e = make_map(&mdo, dO, 3, dims_q, strides_q, box, SPAN);
  if (!e) e = make_map(&mk, K, 3, dims_kv, strides_kv, box, SPAN);
  if (!e) e = make_map(&mv, V, 3, dims_kv, strides_kv, box, SPAN);
  if (e) return e;
  static int smem_set = 0;
  if (!smem_set) {
    e = (int)cudaFuncSetAttribute(
        dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Dkv::SMEM);
    if (!e)
      e = (int)cudaFuncSetAttribute(
          dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          Dq::SMEM);
    if (e) return e;
    smem_set = 1;
  }
  const int S_pad = (S + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  rows_kernel<<<(B * H * S_pad + 7) / 8, 256, 0, st>>>(O, dO, L, ws, B, S,
                                                       S_pad, H, HD);
  const int n_kt = (S + Dkv::BKV - 1) / Dkv::BKV;
  dkv_kernel<HD><<<dim3(n_kt, KV, B), THREADS, Dkv::SMEM, st>>>(
      mq, mk, mv, mdo, ws, dk, dv, B, S, S_pad, H, KV, scale, mask);
  const int n_qt = (S + Dq::BQ - 1) / Dq::BQ;
  dq_kernel<HD><<<dim3(n_qt, H, B), THREADS, Dq::SMEM, st>>>(
      mq, mk, mv, mdo, ws, dq, B, S, S_pad, H, KV, n_qt, scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace

// K4's backward ('global', head dims 16 to 128, no softcap; Sq == Skv ==
// S): q, o, do, dq [B, S, H, hd] and k, v, dk, dv [B, S, KV, hd] bf16, lse
// [B, H, S] fp32 (k4_flash_prefill_lse's), ws [2, B, H, S_pad] fp32 scratch
// for D and lse log2(e), S_pad = S rounded up to a multiple of 128
// (kernels/flash_attention.py's BWD_ROW_PAD); three launches on `stream`.
extern "C" int k4_flash_backward(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* dq, void* dk,
                                 void* dv, void* ws, int B, int S, int H,
                                 int KV, int hd, float scale, int mask_kind,
                                 float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mask{mask_kind, 0, 0};
  if (!mask_ok(mask, 1 << MASK_GLOBAL) || softcap != 0.0f || KV < 1 ||
      H % KV || B < 1 || S < 1)
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
#define BWD_CASE(HD)                                                      \
    case HD: return launch_backward<HD>(Q, K, V, O, dO, L, DQ, DK, DV, W, \
                                        B, S, H, KV, scale, mask, st);
    BWD_CASE(16) BWD_CASE(32) BWD_CASE(64) BWD_CASE(128)
#undef BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
