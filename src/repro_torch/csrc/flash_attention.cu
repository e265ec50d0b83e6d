// K4, K5 and K6 on Hopper: online-softmax flash prefill, split-K flash
// decode over a dense KV cache with its deterministic fold in the same
// launch, and the same decode over a paged KV cache.
//
// K4 replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (_prefill_kernel), in the shape of FlashAttention-3.  One block per
// (q head, batch, 128-row q tile), the longest tiles first: a producer
// warpgroup (one thread issuing TMA, its registers handed to the
// consumers by setmaxnreg) loads the Q tile once and streams 128-slot K
// and V tiles (64-slot at hd 256) through a TMA ring (full/empty
// mbarriers; 2 stages at hd 256, 3 at 128, 4 below, as many as fit beside
// Q in shared memory); two consumer
// warpgroups of 64 q rows each compute S = Q K^T with wgmma (Q and K
// K-major from shared memory), run the online softmax in registers on the
// accumulator's fragments (row max and sum over the four threads of a
// quad), round P to bf16 in registers and feed it as wgmma's register A
// operand against V (MN-major, the transpose bit), rescaling the running
// output by alpha in registers; the output is written once.  Under the
// causal mask query row i attends slots <= i; q head h reads kv head h /
// (H / KV), so the grouped K/V are never repeated.  Swizzled rows of 32,
// 64 or 128 bytes serve head dims 16, 32, 64, 128 and 256 (four 64-column
// boxes a row; P.V one m64n256k16 product per 16 slots).  What bounds it:
// at S = 256 the causal work is small, so launch and latency dominate; at
// long S it is bound by tensor-core operations and the softmax's exps.
// The S x S scores never reach device memory and the kv loop stops at the
// diagonal, so no tile past it is loaded; masks are evaluated only on
// tiles that meet the diagonal, the end of the keys or the window's edge.
// Variants (gemma2): the 'local' kind (a window), query row i
// attending keys i - window < k <= i, and the kv loop starts at the first
// K/V tile that meets the window of the q tile's first row, so a
// tile before every row's window is never loaded; a later row whose first
// visited tile is wholly masked adds exactly nothing (p = 0 there, and
// alpha = exp(min(m - m_new, 0)) keeps o and l at 0 until its first live
// key).  `softcap` > 0 caps the scaled scores, s = softcap * tanh(s /
// softcap) with an IEEE division, before the mask.  The 'full' kind
// (whisper's encoder self-attention and cross-attention prefill) drops
// the causal term: every q tile streams all Skv keys, which may differ
// from Sq (64 decoder positions against 1500 frames) and need not fill a
// tile (the TMA box past Skv is zero-filled and its keys masked).  llama4's
// 'chunked' kind attends the causal keys of the query's own chunk of
// `window` positions (q / W == k / W), so the kv loop starts at the chunk
// of the q tile's first row and no tile of an earlier chunk is loaded; the
// 'prefix' kind (the reference's prefix-LM mask, reached only through
// ops.flash_attention) adds every key before `prefix_len`, so the loop
// runs to max(diagonal, prefix end).  Every kind is one interval of keys a
// query position attends (struct Mask, attention_mask.cuh, which K4's
// backward shares), one mask code at run time: the
// interval bounds the loop, decides which tiles are edges, and masks
// those only.
//
// K5 replaces flash_decode_pallas (_decode_kernel) and
// combine_tile_partials, in one launch (k5_flash_decode): one block per
// (batch, kv head, split); the 32-slot tiles anchored at slot 0 that hold
// a key of the row go to the splits in contiguous ranges, each tile yields
// an independent partial (m_t, l_t, acc_t) that the G query heads of the
// kv head share a K/V tile for, and the last split of a row to arrive
// folds the row (a global max, alpha_t = exp(m_t - m) and an ASCENDING
// fp32 fold over its tiles; an arrival counter per row, no value atomics;
// a row with one split folds in its own block).  A partial depends only on
// its tile, and the fold never sees the splits, so the output is bitwise
// the same for every split count.  K and V stream through a 3-stage
// cp.async ring, the scores are warp dots reduced by shuffles, the
// softmax's max and sum warp reductions, P.V fp32 FMAs.  What bounds it:
// the bytes of the live cache (each K/V row read once); a tile past the
// position is neither read, written nor folded, and slots past it are not
// read.  `softcap` > 0 caps the scores, softcap * tanhf(s / softcap).
// A block holds at most G_MAX query heads: with more, each kv head's G
// query heads are served as `rep` rows of G / rep heads each (the caller
// picks rep), rows that read the same K/V.  A query head's arithmetic
// never depends on the heads beside it, so the grouping changes no bit.
// Each live tile's record stays in the workspace after the fold, which is
// how the partials are checked.  The 'full' kind (whisper's
// cross-attention decode, every stored slot live) is this kernel at
// position cache_len - 1, passed by the wrapper.
//
// K6 replaces paged_flash_decode_pallas (_paged_decode_kernel) and, for
// prefill chunks (S > 1), its tiled XLA mirror paged_flash_decode_xla,
// with two bodies chosen by the shape (kernels/flash_attention.py's
// paged_body).  Decode, k6_paged_decode: the K5 kernel instantiated on a
// paged slot address, each row (lane, kv head) with its lane's position
// (-1 = idle, no tile live, output exactly 0.0); slot j of a lane lives at
// pool[table[lane, j / PS], j % PS]; an unmapped page (-1) is masked and
// never read.  Tiles are the same 32 slots anchored at logical position 0
// as the dense path, not one page per tile, and the fold is K5's, so a
// paged lane is bitwise the same history decoded from a dense cache and a
// neighbour's page mapping changes no bit of it.  'local' rows (`window`
// > 0) also mask keys at or before pos - window, and a tile wholly before
// the window is skipped as a tile past the position is.  What bounds it:
// the bytes of each row's live pages.  'chunked' rows (llama4) mask keys
// before the chunk of their position and skip the tiles before it.
// Prefill chunks, k6_paged_chunk:
// K4's body over the page table (chunk_kernel below), one block holding a
// lane's S x G query rows of a kv head, so each K/V tile of the lane is
// loaded once per block instead of once per query row, and both products
// run on the tensor cores.  What bounds it: the bytes of the lanes' live
// pages at short histories, the tensor cores and the softmax past a few
// thousand positions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mask.cuh"
#include "hopper.cuh"

using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 128;

// ---------------------------------------------------------------------------
// K4: prefill, wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int BQ = 128;  // q rows per block: two consumer warpgroups of 64
// two consumer warpgroups and a producer warpgroup, whose registers go to
// the consumers (240 a thread; 168 without the rebalancing)
constexpr int PREFILL_THREADS = 3 * 128;
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory plan for head dim HD: rows of SPAN bytes (the swizzle
// span, at most 128), CH column boxes of SPAN / 2 elements per row, K/V
// tiles of BKV slots.  BKV is 128 up to hd 128.  At hd 256 the Q tile is
// 64 KB and a 128-slot K+V stage 128 KB, so one stage would fit and no
// load would overlap the math, and each consumer thread would hold a
// 64-float score fragment beside its o[128]; 64-slot tiles fit two stages
// (Q 64 KB + 2 x 64 KB) and halve the fragment, and P.V becomes one
// m64n256k16 product per 16 slots.
template <int HD>
struct PrefillLayout {
  static constexpr int BKV = HD > 128 ? 64 : 128;
  static constexpr int SPAN = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int CH = HD * 2 / SPAN;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BKV * HD * 2;
  static constexpr int STAGE = 2 * KV_BYTES;  // K, then V
  // as many K/V stages as fit beside Q (3 at HD 128, 2 at 256), at most 4
  static constexpr int STAGES_FIT = (232448 - 2048 - Q_BYTES) / STAGE;
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static_assert(STAGES >= 2, "the K/V ring needs two stages to overlap");
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE +
                              (1 + 2 * STAGES) * 8;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// softcap * tanh(x / softcap).  The division is IEEE-rounded without the
// division routine: with r = RN(1 / softcap) rounded once per thread, q0 =
// RN(x r) and the exact residual x - softcap q0 (an fma), RN(q0 + residual
// r) is the correctly rounded x / softcap for every x of normal magnitude
// (Markstein's theorem), in three FMA-pipe instructions.  tanh(y) = 1 - 2
// / (exp(2 y) + 1) with the fast exp and division (absolute error about
// 1e-7, far inside the bf16 rounding of P).  The softcap is on every
// score, and tanhf and the division routine would triple the special-
// function work of the tile.
__device__ __forceinline__ float softcap_score(float x, float softcap,
                                               float rcp) {
  const float q0 = __fmul_rn(x, rcp);
  const float y = fmaf(fmaf(-softcap, q0, x), rcp, q0);
  return softcap * (1.0f - __fdividef(2.0f, __expf(2.0f * y) + 1.0f));
}

// S [64 x BKV] = Q_wg [64 x HD] . K^T for warpgroup wg, both operands
// K-major in shared memory; issued and committed, not waited for
template <int HD>
__device__ __forceinline__ void issue_scores(
    float (&sc)[PrefillLayout<HD>::BKV / 2], const uint8_t* Qs,
    const uint8_t* ks, int wg) {
  constexpr int SPAN = PrefillLayout<HD>::SPAN;
  constexpr int BKV = PrefillLayout<HD>::BKV;
  constexpr int KSTEPS_PER_BOX = SPAN / 32;  // k16 steps along one row
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / KSTEPS_PER_BOX, w = kk % KSTEPS_PER_BOX;
    const uint64_t dq = make_desc(
        Qs + c * BQ * SPAN + wg * 64 * SPAN + w * 32, 16, 8 * SPAN, SPAN);
    const uint64_t dk = make_desc(ks + c * BKV * SPAN + w * 32, 16, 8 * SPAN,
                                  SPAN);
    wgmma_ss<0, 0>(sc, dq, dk, kk > 0);
  }
  wgmma_commit();
}

// O [64 x HD] += P [64 x BKV] . V with P in registers (bf16 pairs in the
// accumulator's fragment layout, which is the A operand's) and V MN-major
// (CH column boxes of BKV slots, LBO apart); issued and committed, not
// waited for
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[HD / 2], const uint32_t (&pa)[PrefillLayout<HD>::BKV / 16][4],
    const uint8_t* vs) {
  constexpr int SPAN = PrefillLayout<HD>::SPAN;
  constexpr int BKV = PrefillLayout<HD>::BKV;
  wgmma_fence();
  fence_regs(o);
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint64_t dv = make_desc(vs + kk * 16 * SPAN, BKV * SPAN, 8 * SPAN,
                                  SPAN);
    wgmma_rs<1>(o, pa[kk], dv, 1);
  }
  wgmma_commit();
}

// P rounded to bf16 pairs: the A fragment of k16 step kk is the
// accumulator's elements 8 kk .. 8 kk + 7
template <int BKV>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BKV / 16][4],
                                       const float (&sc)[BKV / 2]) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pa[kk][q] = pack_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
}

// One kv tile's online softmax on this thread's accumulator fragments
// (rows r0 and r0 + 8; element 4 j + e at key k0 + 8 j + (e & 1) of row
// r0 + 8 (e >> 1)): scale, softcap, mask (EDGE tiles only: live(key, e >>
// 1) says whether the key is attended by the row), the row max over the
// quad, alpha, p = exp(s - m_new) in place, and the running m and l.
// Masked keys give p = 0 exactly.
template <bool EDGE, bool SOFTCAP, int N, class Live>
__device__ __forceinline__ void tile_softmax(float (&sc)[N], float (&alpha)[2],
                                             float (&m_run)[2],
                                             float (&l_run)[2], int k0,
                                             const Live& live_key,
                                             float scale, float softcap,
                                             float softcap_rcp) {
  uint64_t live = ~0ull;  // bit 4 j + e: fragment element 4 j + e
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale;
      if (SOFTCAP) x = softcap_score(x, softcap, softcap_rcp);
      if (EDGE && !live_key(k0 + 8 * j + (e & 1), e >> 1)) {
        x = NEG;
        live &= ~(1ull << (4 * j + e));
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float mneg[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    // guard fully masked rows: exp(_NEG - _NEG) would be 1
    alpha[r] = expf(fminf(m_run[r] - m_new, 0.0f));
    m_run[r] = m_new;
    mneg[r] = -m_new * LOG2E;
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2f(fmaf(sc[4 * j + e], LOG2E, mneg[e >> 1]));
      if (EDGE && !((live >> (4 * j + e)) & 1)) p = 0.0f;
      psum[e >> 1] += p;
      sc[4 * j + e] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
    l_run[r] = l_run[r] * alpha[r] + psum[r];
  }
}

template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(PREFILL_THREADS, 1)
prefill_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               bf16* __restrict__ out, int Sq, int Skv, int H, int KV,
               int n_qt, float scale, Mask mask, float softcap,
               float* __restrict__ lse) {
  using L = PrefillLayout<HD>;
  constexpr int SPAN = L::SPAN, COLS = SPAN / 2, BKV = L::BKV;
  constexpr int KV_STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + L::Q_BYTES;
  uint64_t* qbar =
      reinterpret_cast<uint64_t*>(KVs + KV_STAGES * L::STAGE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + KV_STAGES;

  // the longest q tiles (most kv tiles under the causal mask) start first
  const int qt = n_qt - 1 - blockIdx.z, h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  // no tile past the last row's keys (the diagonal; the prefix's end for
  // 'prefix'; every stored key for 'full'), none before the first row's
  // (the window of 'local', the chunk of 'chunked')
  const int kv_end = min(Skv, mask.hi(q0 + BQ - 1) + 1);
  const int kv_begin = max(0, mask.lo(q0)) / BKV * BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV
                                        : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer: Q once, then K and V tiles into the ring
    setmaxnreg_dec<24>();
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::CH; ++c)
        tma_load_3d(Qs + c * BQ * SPAN, &map_q, qbar, h * HD + c * COLS, q0,
                    b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % KV_STAGES, kv0 = kv_begin + i * BKV;
        mbar_wait(&empty[s], ((i / KV_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        uint8_t* ks = KVs + s * L::STAGE;
#pragma unroll
        for (int c = 0; c < L::CH; ++c) {
          tma_load_3d(ks + c * BKV * SPAN, &map_k, &full[s],
                      kvh * HD + c * COLS, kv0, b);
          tma_load_3d(ks + L::KV_BYTES + c * BKV * SPAN, &map_v, &full[s],
                      kvh * HD + c * COLS, kv0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64); in
  // the accumulator fragments this thread holds rows r0 and r0 + 8, and of
  // each 8-column block j the columns 8 j + 2 (lane % 4) + {0, 1}
  setmaxnreg_inc<240>();
  const int wg = warp / 4;
  const int qw0 = q0 + wg * 64;
  const int r0 = qw0 + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // the keys of this thread's rows r0 and r0 + 8, and the keys every row
  // of the warpgroup attends (a tile inside them is interior)
  const int key_lo[2] = {mask.lo(r0), mask.lo(r0 + 8)};
  const int key_hi[2] = {min(mask.hi(r0), Skv - 1),
                         min(mask.hi(r0 + 8), Skv - 1)};
  const int wg_lo = mask.lo(qw0 + 63), wg_hi = min(mask.hi(qw0), Skv - 1);
  const float softcap_rcp = SOFTCAP ? __frcp_rn(softcap) : 0.0f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.0f, 0.0f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;

  // per kv tile: S = Q K^T, the online softmax in registers, P rounded to
  // bf16 in registers, O += P V.  (Issuing tile i + 1's scores before tile
  // i's P.V, FlashAttention-3's overlap within a warpgroup, keeps S, P and
  // O live at once; ptxas serialized the products (C7514), with the
  // registers rebalanced too, and the kernel ran slower.)
  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % KV_STAGES, kv0 = kv_begin + i * BKV;
    mbar_wait(&full[s], (i / KV_STAGES) & 1);
    const uint8_t* ks = KVs + s * L::STAGE;
    float sc[BKV / 2];
    issue_scores<HD>(sc, Qs, ks, wg);
    wgmma_wait<0>();
    fence_regs(sc);

    // masks only on tiles that some row of this warpgroup does not attend
    // whole: tiles that meet the diagonal, the end of the keys, the
    // window's lower edge, a chunk boundary or the prefix's end
    const bool edge = kv0 < wg_lo || kv0 + BKV - 1 > wg_hi;
    float alpha[2];
    const auto live_key = [&](int key, int r) {
      return key >= key_lo[r] && key <= key_hi[r];
    };
    if (edge)
      tile_softmax<true, SOFTCAP>(sc, alpha, m_run, l_run, kv0 + cq, live_key,
                                  scale, softcap, softcap_rcp);
    else
      tile_softmax<false, SOFTCAP>(sc, alpha, m_run, l_run, kv0 + cq,
                                   live_key, scale, softcap, softcap_rcp);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    uint32_t pa[BKV / 16][4];
    pack_p<BKV>(pa, sc);
    issue_pv<HD>(o, pa, ks + L::KV_BYTES);
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t q_stride = (size_t)H * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.0f / fmaxf(l_run[r], 1e-30f);
    bf16* orow = out + ((size_t)b * Sq + row) * q_stride + h * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
    // the row's log-sum-exp of its scaled scores (every thread of the
    // quad holds the reduced m and l), the backward's second input
    if (lse != nullptr && lane % 4 == 0)
      lse[((size_t)b * H + h) * Sq + row] =
          m_run[r] + logf(fmaxf(l_run[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// K6, prefill chunks (S > 1): K4's body over the page table
// ---------------------------------------------------------------------------

// Shared memory of the chunk body: K4's Q tile, K/V ring and barriers,
// then per stage the mask of the tile's K/V boxes that were loaded, and
// the q tile's positions.  Threads: two consumer warpgroups and a producer
// warp.  ptxas caps the kernel at 168 registers a thread; up to hd 128
// rebalancing them to the consumers with setmaxnreg (K4's way) spilled
// more, not less.  At hd 256 a consumer's o[128], scores and P exceed
// 168 (1.3 KB of spills a thread), so there the producer is a whole
// warpgroup, one warp of it working, whose registers go to the consumers
// (232 a thread).
template <int HD>
struct ChunkLayout {
  static constexpr bool REBALANCE = HD > 128;
  static constexpr int THREADS = REBALANCE ? 3 * 128 : 2 * 128 + 32;
  using P = PrefillLayout<HD>;
  // byte offsets from the 1024-aligned base
  static constexpr int BARS = P::Q_BYTES + P::STAGES * P::STAGE;
  static constexpr int MASKS = BARS + (1 + 2 * P::STAGES) * 8;
  static constexpr int POS = MASKS + P::STAGES * 4;
  static constexpr int SMEM = 1024 + POS + (BQ + 2) * 4;
};

// One block per (q tile, kv head, lane).  The q tile is QS of the lane's
// chunk positions times the kv head's G query heads, rows in (s, g) order
// (QS = 128 / G, at most S), loaded by one 4-D TMA box per 64 columns.
// The producer warp streams the lane's K/V tiles (BKV slots: 128, or 64 at
// hd 256) from the first slot any row of the tile can see to the last
// row's position: each tile is BKV / BR boxes of BR = min(PS, BKV) slots
// (a page, or the tile's part of a larger page), each box one TMA load per
// 64 columns of K and of V, at the physical page from one table lookup by
// one lane of the warp.  A box that holds no key of the tile's rows
// (unmapped, past the table, or outside [first, last]) is not read: it is
// issued past the pool's last row, which TMA zero-fills, and its bit in
// the stage's box mask is clear.  Consumers run K4's arithmetic: S = Q
// K^T and O += P V on wgmma, the online softmax in registers, each row
// masked by its own position (causal; 'local' keys at or before position
// - window; the box mask) on tiles that meet an edge.  Rows at position
// -1 (idle lanes, a short chunk's padded tail) store exactly 0.0.  No
// atomics: a row's keys are summed in one fixed order, and a block reads
// its lane's pages only.
template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(ChunkLayout<HD>::THREADS, 1)
chunk_kernel(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             const int* __restrict__ table, const int* __restrict__ positions,
             bf16* __restrict__ out, int S, int KV, int G, int QS, int P,
             int ps_shift, int pool_rows, float scale, Mask mask,
             float softcap) {
  using L = PrefillLayout<HD>;
  using C = ChunkLayout<HD>;
  constexpr int SPAN = L::SPAN, COLS = SPAN / 2, BKV = L::BKV;
  constexpr int KV_STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + L::Q_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + KV_STAGES;
  uint32_t* box_mask = reinterpret_cast<uint32_t*>(smem + C::MASKS);
  int* spos = reinterpret_cast<int*>(smem + C::POS);

  const int qt = blockIdx.x, kvh = blockIdx.y, ln = blockIdx.z;
  const int s0 = qt * QS, n_s = min(QS, S - s0), rows = n_s * G;
  // a K/V box: 2^br_shift = min(PS, BKV) slots, nbox of them a tile: a
  // page (always, for 128-slot tiles: PS <= 128), or at hd 256 with
  // 128-slot pages the tile's half of one
  const int br_shift = BKV == 128 ? ps_shift : min(ps_shift, 6);
  const int nbox = BKV >> br_shift;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the tile's positions (-1 past the chunk) and the live rows' range
  if (threadIdx.x < BQ)
    spos[threadIdx.x] =
        threadIdx.x < n_s ? positions[(size_t)ln * S + s0 + threadIdx.x] : -1;
  __syncthreads();
  if (warp == 0) {
    int lo = 0x7fffffff, hi = -1;
    for (int t = lane; t < n_s; t += 32) {
      const int p = spos[t];
      if (p >= 0) {
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      spos[BQ] = lo;
      spos[BQ + 1] = hi;
      mbar_init(qbar, 1);
      for (int s = 0; s < KV_STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 8);  // one arrival per consumer warp
      }
      mbar_fence_init();
    }
  }
  __syncthreads();
  const int min_pos = spos[BQ], max_pos = spos[BQ + 1];
  const size_t row_stride = (size_t)KV * G * HD;  // one chunk position
  bf16* const out_tile = out + ((size_t)ln * S + s0) * row_stride +
                         (size_t)kvh * G * HD;
  if (max_pos < 0) {  // every row idle: exactly 0.0
    for (int i = threadIdx.x; i < rows * (HD / 8); i += C::THREADS) {
      const int r = i / (HD / 8), c = i % (HD / 8);
      *reinterpret_cast<uint4*>(out_tile + (size_t)(r / G) * row_stride +
                                (r % G) * HD + c * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  // the slots any row of the tile attends: [first, max_pos]
  const int first = max(0, mask.lo(min_pos));
  const int t_lo = first / BKV;
  const int n_tiles = max_pos / BKV - t_lo + 1;

  if (warp >= 8) {  // producer (warp 8): Q once, then the K/V pages
    if constexpr (C::REBALANCE) setmaxnreg_dec<40>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_expect_tx(qbar, G * QS * HD * 2);
#pragma unroll
      for (int c = 0; c < L::CH; ++c)
        tma_load_4d(Qs + c * BQ * SPAN, &map_q, qbar, c * COLS, 0, kvh,
                    ln * S + s0);
    }
    const int items = nbox * L::CH * 2;  // (box, column box, K or V)
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % KV_STAGES, kv0 = (t_lo + i) * BKV;
      // box p of the tile is loaded when it holds a slot of [first,
      // max_pos] and its page is mapped
      bool ok = false;
      if (lane < nbox) {
        const int lo = kv0 + (lane << br_shift);
        const int gp = lo >> ps_shift;
        ok = gp < P && lo + (1 << br_shift) > first && lo <= max_pos &&
             table[(size_t)ln * P + gp] >= 0;
      }
      const uint32_t mask = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) {
        mbar_wait(&empty[s], ((i / KV_STAGES) & 1) ^ 1);
        box_mask[s] = mask;
        mbar_expect_tx(&full[s], L::STAGE);
      }
      __syncwarp();
      uint8_t* ks = KVs + s * L::STAGE;
      for (int it = lane; it < items; it += 32) {
        const int p = it / (2 * L::CH), c = it / 2 % L::CH, is_v = it % 2;
        const int lo = kv0 + (p << br_shift);
        // a box not loaded: past the pool's end, zero-filled
        const int in_page = BKV == 128 ? 0 : lo & ((1 << ps_shift) - 1);
        const int row = (mask >> p) & 1
                            ? (table[(size_t)ln * P + (lo >> ps_shift)]
                               << ps_shift) + in_page
                            : pool_rows;
        tma_load_3d(ks + is_v * L::KV_BYTES + c * BKV * SPAN +
                        (p << br_shift) * SPAN,
                    is_v ? &map_v : &map_k, &full[s], c * COLS, kvh, row);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64); this
  // thread holds rows tr0 and tr0 + 8 of the accumulator fragments
  if constexpr (C::REBALANCE) setmaxnreg_inc<232>();
  const int wg = warp / 4;
  const int tr0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  // rows r of this thread attend keys [mask.lo(p), p], p = pos_r[r] (none
  // at -1); the lower bound is worked out on edge tiles only, so that it
  // holds no register through the products
  int pos_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = tr0 + 8 * r;
    pos_r[r] = tr < rows ? spos[tr / G] : -1;
  }
  const uint32_t all_boxes = nbox == 32 ? 0xffffffffu : (1u << nbox) - 1;
  const float softcap_rcp = SOFTCAP ? __frcp_rn(softcap) : 0.0f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.0f, 0.0f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % KV_STAGES, kv0 = (t_lo + i) * BKV;
    mbar_wait(&full[s], (i / KV_STAGES) & 1);
    const uint32_t pm = box_mask[s];
    const uint8_t* ks = KVs + s * L::STAGE;
    float sc[BKV / 2];
    issue_scores<HD>(sc, Qs, ks, wg);
    wgmma_wait<0>();
    fence_regs(sc);

    // masks only on tiles that meet the causal edge, the window's lower
    // edge or a chunk's start of some live row of the tile, or hold a box
    // not loaded; rows at position -1 compute unmasked and store zeros
    const bool edge = pm != all_boxes || kv0 + BKV - 1 > min_pos ||
                      kv0 < mask.lo(max_pos);
    float alpha[2];
    const auto live_key = [&](int key, int r) {
      return key >= mask.lo(pos_r[r]) && key <= pos_r[r] &&
             ((pm >> ((key - kv0) >> br_shift)) & 1);
    };
    if (edge)
      tile_softmax<true, SOFTCAP>(sc, alpha, m_run, l_run, kv0 + cq, live_key,
                                  scale, softcap, softcap_rcp);
    else
      tile_softmax<false, SOFTCAP>(sc, alpha, m_run, l_run, kv0 + cq,
                                   live_key, scale, softcap, softcap_rcp);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    uint32_t pa[BKV / 16][4];
    pack_p<BKV>(pa, sc);
    issue_pv<HD>(o, pa, ks + L::KV_BYTES);
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = tr0 + 8 * r;
    if (tr >= rows) continue;
    const float inv = 1.0f / fmaxf(l_run[r], 1e-30f);
    const bool idle = pos_r[r] < 0;
    bf16* orow = out_tile + (size_t)(tr / G) * row_stride + (tr % G) * HD + cq;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          idle ? __floats2bfloat162_rn(0.0f, 0.0f)
               : __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                       o[4 * j + 2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// K5 / K6: split-K flash decode and its fold, one launch
// ---------------------------------------------------------------------------

constexpr int TILE = 32;       // DEFAULT_KV_TILE of the reference
constexpr int G_MAX = 8;       // query rows per kv head
// K/V tiles in the ring: 48 KB at hd 128 (4 blocks an SM), 96 KB at 256 (2)
constexpr int DEC_STAGES = 3;

// Where a decode row's K/V slots live.  slot_row returns the index of the
// slot's [hd] row in the K and V arrays, or -1 when the slot holds nothing
// (past a dense cache's end, or an unmapped page); position gives the
// row's query position (-1: an idle row).  The decode kernel is written
// once against this interface, so K6 runs K5's dot order, exp, mask and
// fold on every tile, and a paged lane is bitwise the same history in a
// dense cache.  A row is (..., kv head, r) with r < rep: the rep rows of
// a kv head each hold G / rep of its query heads.
struct DenseKV {
  static constexpr bool ARITHMETIC = true;  // slot_row reads no memory
  const bf16* k;
  const bf16* v;
  int KV, rep, cache_len, pos;
  __device__ int position(int) const { return pos; }
  __device__ long long slot_row(int row, int slot) const {
    if (slot >= cache_len) return -1;
    const int kr = row / rep, b = kr / KV, kvh = kr % KV;
    return ((long long)b * cache_len + slot) * KV + kvh;
  }
};

// Rows are (lane, kv head, r) of a decode step; pools [NP + 1, PS, KV,
// hd] with the trash page last; table [L, P] (-1 = unmapped); positions
// [L, 1] (-1 = idle).  An unmapped slot is never read: it is masked, so
// what the trash page holds cannot reach the output.
struct PagedKV {
  static constexpr bool ARITHMETIC = false;  // slot_row reads the table
  const bf16* k;
  const bf16* v;
  const int* table;
  const int* positions;
  int KV, rep, P, PS;
  __device__ int position(int row) const {
    return positions[row / (KV * rep)];
  }
  __device__ long long slot_row(int row, int slot) const {
    const int page = slot / PS;
    if (page >= P) return -1;
    const int lane = row / (KV * rep), kvh = row / rep % KV;
    const int phys = table[lane * P + page];
    if (phys < 0) return -1;
    return ((long long)phys * PS + slot % PS) * KV + kvh;
  }
};

template <int HD>
struct DecodeLayout {
  static constexpr int KV_BYTES = TILE * HD * 2;  // one tile of K (or V)
  static constexpr int STAGE = 2 * KV_BYTES;      // K, then V
  static constexpr int SMEM = DEC_STAGES * STAGE;
  static constexpr int LG = HD / 8;    // scores: lanes per slot, 8 dims each
  static constexpr int SPW = 32 / LG;  // scores: slots per warp and pass
  static constexpr int PAIRS = HD / 2;        // P.V and fold: dims d, d + 1
  static constexpr int NG = THREADS / PAIRS;  // query rows side by side
  static constexpr int GPT = (G_MAX + NG - 1) / NG;  // query rows a thread
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Floats of one tile's record in the workspace: acc [G][HD], then m [G]
// and l [G], padded to 16 bytes so that a run of records is copied in
// 16-byte pieces.
__host__ __device__ constexpr int record_floats(int G, int HD) {
  return (G * (HD + 2) + 3) / 4 * 4;
}

// One block per (row, split), gridDim.y splits.  A row's live tiles, the
// 32-slot tiles from slot 0 that hold a key of the row, are lo..hi: a
// tile past the position, wholly before the window or the chunk (the
// mask's lower bound, 'local' and 'chunked' rows of K6) or of an idle row is
// neither read, written nor folded.  The splits take contiguous ranges of
// the live tiles.  Per tile: its K and V arrive through a DEC_STAGES-deep
// cp.async ring (a masked slot is zero-filled, never read); the scores
// are warp dots, HD / 8 lanes of 8 dims (one 16-byte shared load) per
// slot, reduced by shuffles; one warp per query row takes the scale, the
// softcap, the mask, the max and the sum over the 32 slots by shuffles;
// P.V runs at fp32, a thread per (query row, pair of dims), ascending
// slots.  The tile's partial (m_t, l_t, acc_t) is its record in the row's
// workspace.  The last block of the row to arrive (an int32 counter per
// row, taken after a __threadfence and reset by the block that folds; no
// counter with one split) folds the row's live tiles: the max over them
// from NEG, then the records stream back through the ring (cp.async, two
// halves, one folded while the next arrives) into alpha = exp(m_t - m)
// and an ascending fp32 fold, a / max(l, 1e-30).  A partial depends on its
// tile alone and the fold sees no split, so the output is bitwise the same
// for every split count; a row with no key writes exactly 0.0.
template <int HD, class Rows>
__global__ void __launch_bounds__(THREADS)
decode_kernel(Rows kv, const bf16* __restrict__ q, float* __restrict__ ws,
              bf16* __restrict__ out, int* __restrict__ counters, int G,
              int n_tiles, float scale, Mask mask, float softcap) {
  using L = DecodeLayout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float sp[G_MAX][TILE];           // a tile's scores, then p
  __shared__ uint8_t live[DEC_STAGES][TILE];  // slot stored and in the mask
  __shared__ float m_row[G_MAX];
  __shared__ int last;

  const int row = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int pos = kv.position(row);
  const int hi = pos < 0 ? -1 : min(pos / TILE, n_tiles - 1);
  // the row's first key (the window's or the chunk's start) and its tile
  const int first = max(0, mask.lo(pos));
  const int lo = first / TILE;
  const int n_live = hi - lo + 1;
  if (n_live <= 0) {  // no key: exactly 0.0
    if (blockIdx.y == 0)
      for (int i = tid; i < G * HD; i += THREADS)
        out[(size_t)row * G * HD + i] = __float2bfloat16(0.0f);
    return;
  }
  const int per = (n_live + gridDim.y - 1) / gridDim.y;
  const int b_lo = lo + blockIdx.y * per;
  const int b_n = max(0, min(hi + 1, b_lo + per) - b_lo);
  const int rec = record_floats(G, HD);
  float* const recs = ws + (size_t)row * n_tiles * rec;  // the row's tile 0

  // this lane's 8 dims of each query row, for the scores
  const int li = lane % L::LG;
  float qf[G_MAX][8];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g)
    if (g < G && b_n > 0)
      unpack8(*reinterpret_cast<const uint4*>(q + ((size_t)row * G + g) * HD +
                                              li * 8),
              qf[g]);

  // tile b_lo + i into stage i % DEC_STAGES.  Dense rows (a slot's row is
  // arithmetic): HD / 8 threads copy a slot's K row, then its V row, 16
  // contiguous bytes each, so a warp copies whole rows.  Paged rows (a
  // slot's row is a page-table load): 4 threads per slot, one lookup each,
  // each taking every 4th 16-byte chunk of the slot's K row, then its V
  // row.
  auto issue = [&](int i) {
    const int s = i % DEC_STAGES;
    unsigned char* st = smem + s * L::STAGE;
    if constexpr (Rows::ARITHMETIC) {
      constexpr int CPR = HD / 8;          // 16-byte chunks a row
      constexpr int RPP = THREADS / CPR;   // rows a pass
      const int c = tid % CPR;
#pragma unroll
      for (int j = tid / CPR; j < TILE; j += RPP) {
        const int slot = (b_lo + i) * TILE + j;
        const bool in_mask = slot <= pos && slot >= first;
        const long long sr = in_mask ? kv.slot_row(row, slot) : -1;
        if (c == 0) live[s][j] = sr >= 0;
        const long long o = sr >= 0 ? sr * HD + c * 8 : 0;
        cp_async16(st + (j * HD + c * 8) * 2, kv.k + o, sr >= 0);
        cp_async16(st + L::KV_BYTES + (j * HD + c * 8) * 2, kv.v + o,
                   sr >= 0);
      }
    } else {
      const int j = tid / 4, part = tid % 4;
      const int slot = (b_lo + i) * TILE + j;
      const bool in_mask = slot <= pos && slot >= first;
      const long long sr = in_mask ? kv.slot_row(row, slot) : -1;
      if (part == 0) live[s][j] = sr >= 0;
#pragma unroll
      for (int c = part; c < 2 * (HD / 8); c += 4) {
        const bool is_v = c >= HD / 8;
        const int d = (is_v ? c - HD / 8 : c) * 8;
        const bf16* src = is_v ? kv.v : kv.k;
        cp_async16(st + (is_v ? L::KV_BYTES : 0) + (j * HD + d) * 2,
                   sr >= 0 ? src + sr * HD + d : src, sr >= 0);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < DEC_STAGES - 1; ++i) {
    if (i < b_n) issue(i);
    cp_async_commit();
  }

  const int dp = tid % L::PAIRS, g0 = tid / L::PAIRS;
  for (int i = 0; i < b_n; ++i) {
    cp_async_wait<DEC_STAGES - 2>();
    __syncthreads();  // tile i landed; tile i - 1's stage and sp are free
    if (i + DEC_STAGES - 1 < b_n) issue(i + DEC_STAGES - 1);
    cp_async_commit();
    const int s = i % DEC_STAGES;
    float* const r = recs + (size_t)(b_lo + i) * rec;
    const bf16* Ks = reinterpret_cast<const bf16*>(smem + s * L::STAGE);
    const bf16* Vs = Ks + TILE * HD;

    for (int j = warp * L::SPW + lane / L::LG; j < TILE; j += 4 * L::SPW) {
      float kf[8];
      unpack8(*reinterpret_cast<const uint4*>(Ks + j * HD + li * 8), kf);
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g >= G) break;
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int o = L::LG / 2; o > 0; o /= 2)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        if (li == 0) sp[g][j] = d;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += 4) {
      const bool ok = live[s][lane];
      float x = sp[g][lane] * scale;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      x = ok ? x : NEG;
      const float mx = warp_max(x);
      const float p = ok ? expf(x - mx) : 0.0f;
      const float sum = warp_sum(p);
      sp[g][lane] = p;
      if (lane == 0) {
        r[G * HD + g] = mx;
        r[G * HD + G + g] = sum;
      }
    }
    __syncthreads();

    float a[L::GPT][2];
#pragma unroll
    for (int u = 0; u < L::GPT; ++u) a[u][0] = a[u][1] = 0.0f;
#pragma unroll 8
    for (int j = 0; j < TILE; ++j) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Vs + j * HD + 2 * dp));
#pragma unroll
      for (int u = 0; u < L::GPT; ++u) {
        const int g = g0 + u * L::NG;
        if (g < G) {
          const float p = sp[g][j];
          a[u][0] = fmaf(p, v.x, a[u][0]);
          a[u][1] = fmaf(p, v.y, a[u][1]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < L::GPT; ++u) {
      const int g = g0 + u * L::NG;
      if (g < G)
        *reinterpret_cast<float2*>(r + g * HD + 2 * dp) =
            make_float2(a[u][0], a[u][1]);
    }
  }

  // the last split of the row to arrive folds it
  if (gridDim.y > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&counters[row], 1) == (int)gridDim.y - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (tid == 0) counters[row] = 0;
  } else {
    __threadfence();  // the records reach L2, where the fold reads them
    __syncthreads();  // and the ring is free
  }
  // the live records, a chunk of whole records per half of the ring (L2
  // reads: cp.async.cg does not allocate in L1)
  float* const stage = reinterpret_cast<float*>(smem);
  constexpr int HALF = L::SMEM / 2 / 4;  // floats
  const int per_chunk = HALF / rec;
  const int n_chunks = (n_live + per_chunk - 1) / per_chunk;
  auto fetch = [&](int c) {
    const int t0 = lo + c * per_chunk;
    const int n4 = min(per_chunk, hi + 1 - t0) * rec / 4;
    const float* src = recs + (size_t)t0 * rec;
    float* dst = stage + (c % 2) * HALF;
    for (int i = tid; i < n4; i += THREADS)
      cp_async16(dst + 4 * i, src + 4 * i, true);
  };
  fetch(0);
  cp_async_commit();
  if (n_chunks > 1) fetch(1);
  cp_async_commit();
  for (int g = warp; g < G; g += 4) {
    float mx = NEG;
    for (int t = lo + lane; t <= hi; t += 32)
      mx = fmaxf(mx, __ldcg(recs + (size_t)t * rec + G * HD + g));
    mx = warp_max(mx);
    if (lane == 0) m_row[g] = mx;
  }
  // ascending rank-order fold at fp32 (core/maxeva_matmul.rank_order_sum)
  float l[L::GPT] = {}, ax[L::GPT] = {}, ay[L::GPT] = {};
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();
    __syncthreads();  // chunk c landed (and m_row is set)
    const int t0 = lo + c * per_chunk, nt = min(per_chunk, hi + 1 - t0);
    const float* base = stage + (c % 2) * HALF;
#pragma unroll
    for (int u = 0; u < L::GPT; ++u) {
      const int g = g0 + u * L::NG;
      if (g >= G) break;
      const float m = m_row[g];
      for (int k = 0; k < nt; ++k) {
        const float* r = base + k * rec;
        const float alpha = expf(r[G * HD + g] - m);
        const float lt = r[G * HD + G + g];
        const float2 at = *reinterpret_cast<const float2*>(r + g * HD +
                                                           2 * dp);
        if (c == 0 && k == 0) {
          l[u] = lt * alpha;
          ax[u] = at.x * alpha;
          ay[u] = at.y * alpha;
        } else {
          l[u] = l[u] + lt * alpha;
          ax[u] = ax[u] + at.x * alpha;
          ay[u] = ay[u] + at.y * alpha;
        }
      }
    }
    __syncthreads();  // half c % 2 is free
    if (c + 2 < n_chunks) fetch(c + 2);
    cp_async_commit();
  }
#pragma unroll
  for (int u = 0; u < L::GPT; ++u) {
    const int g = g0 + u * L::NG;
    if (g >= G) break;
    const float den = fmaxf(l[u], 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)row * G + g) * HD +
                                       2 * dp) =
        __floats2bfloat162_rn(ax[u] / den, ay[u] / den);
  }
}

template <int HD>
int launch_prefill(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KV, float scale,
                   Mask mask, float softcap, cudaStream_t st,
                   float* lse) {
  using L = PrefillLayout<HD>;
  // q [B, Sq, H * HD] and k, v [B, Skv, KV * HD] as 3-D maps, so a box
  // past a sequence's end is zero-filled rather than read from the next
  CUtensorMap mq, mk, mv;
  const uint32_t box_q[3] = {L::SPAN / 2, BQ, 1};
  const uint32_t box_kv[3] = {L::SPAN / 2, L::BKV, 1};
  const uint64_t dims_q[3] = {(uint64_t)H * HD, (uint64_t)Sq, (uint64_t)B};
  const uint64_t strides_q[2] = {(uint64_t)H * HD * 2,
                                 (uint64_t)Sq * H * HD * 2};
  const uint64_t dims_kv[3] = {(uint64_t)KV * HD, (uint64_t)Skv,
                               (uint64_t)B};
  const uint64_t strides_kv[2] = {(uint64_t)KV * HD * 2,
                                  (uint64_t)Skv * KV * HD * 2};
  int e = make_map(&mq, q, 3, dims_q, strides_q, box_q, L::SPAN);
  if (!e) e = make_map(&mk, k, 3, dims_kv, strides_kv, box_kv, L::SPAN);
  if (!e) e = make_map(&mv, v, 3, dims_kv, strides_kv, box_kv, L::SPAN);
  if (e) return e;
  static int smem_set = 0;
  if (!smem_set) {
    e = (int)cudaFuncSetAttribute(prefill_kernel<HD, false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  L::SMEM);
    if (!e)
      e = (int)cudaFuncSetAttribute(
          prefill_kernel<HD, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e) return e;
    smem_set = 1;
  }
  const int n_qt = (Sq + BQ - 1) / BQ;
  dim3 grid(H, B, n_qt);
  if (softcap > 0.0f)
    prefill_kernel<HD, true><<<grid, PREFILL_THREADS, L::SMEM, st>>>(
        mq, mk, mv, static_cast<bf16*>(out), Sq, Skv, H, KV, n_qt, scale,
        mask, softcap, lse);
  else
    prefill_kernel<HD, false><<<grid, PREFILL_THREADS, L::SMEM, st>>>(
        mq, mk, mv, static_cast<bf16*>(out), Sq, Skv, H, KV, n_qt, scale,
        mask, softcap, lse);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_chunk(const void* q, const void* k_pool, const void* v_pool,
                 const int* table, const int* positions, void* out, int L,
                 int S, int KV, int G, int P, int ps_shift, int n_pool,
                 float scale, Mask mask, float softcap, cudaStream_t st) {
  using Lay = PrefillLayout<HD>;
  const int PS = 1 << ps_shift;
  if (G < 1 || G > BQ || PS < 4 || PS > 128) return (int)cudaErrorInvalidValue;
  const int QS = min(BQ / G, S);
  // q [L * S, KV, G, HD] as a 4-D map whose box is QS chunk positions x G
  // heads x 64 columns, rows in (s, g) order; the pools [n_pool * PS, KV,
  // HD] as 3-D maps whose box is min(PS, BKV) slots of one kv head
  CUtensorMap mq, mk, mv;
  const uint64_t dims_q[4] = {(uint64_t)HD, (uint64_t)G, (uint64_t)KV,
                              (uint64_t)L * S};
  const uint64_t strides_q[3] = {(uint64_t)HD * 2, (uint64_t)G * HD * 2,
                                 (uint64_t)KV * G * HD * 2};
  const uint32_t box_q[4] = {Lay::SPAN / 2, (uint32_t)G, 1, (uint32_t)QS};
  const uint64_t dims_kv[3] = {(uint64_t)HD, (uint64_t)KV,
                               (uint64_t)n_pool * PS};
  const uint64_t strides_kv[2] = {(uint64_t)HD * 2, (uint64_t)KV * HD * 2};
  const uint32_t box_kv[3] = {Lay::SPAN / 2, 1,
                              (uint32_t)(PS < Lay::BKV ? PS : Lay::BKV)};
  int e = make_map(&mq, q, 4, dims_q, strides_q, box_q, Lay::SPAN);
  if (!e) e = make_map(&mk, k_pool, 3, dims_kv, strides_kv, box_kv, Lay::SPAN);
  if (!e) e = make_map(&mv, v_pool, 3, dims_kv, strides_kv, box_kv, Lay::SPAN);
  if (e) return e;
  static int smem_set = 0;
  if (!smem_set) {
    e = (int)cudaFuncSetAttribute(chunk_kernel<HD, false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  ChunkLayout<HD>::SMEM);
    if (!e)
      e = (int)cudaFuncSetAttribute(
          chunk_kernel<HD, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          ChunkLayout<HD>::SMEM);
    if (e) return e;
    smem_set = 1;
  }
  dim3 grid((S + QS - 1) / QS, KV, L);
  bf16* o = static_cast<bf16*>(out);
  if (softcap > 0.0f)
    chunk_kernel<HD, true><<<grid, ChunkLayout<HD>::THREADS,
                             ChunkLayout<HD>::SMEM,
                             st>>>(mq, mk, mv, table, positions, o, S, KV, G,
                                   QS, P, ps_shift, n_pool * PS, scale,
                                   mask, softcap);
  else
    chunk_kernel<HD, false><<<grid, ChunkLayout<HD>::THREADS,
                              ChunkLayout<HD>::SMEM,
                              st>>>(mq, mk, mv, table, positions, o, S, KV,
                                    G, QS, P, ps_shift, n_pool * PS, scale,
                                    mask, softcap);
  return (int)cudaGetLastError();
}

template <int HD, class Rows>
int launch_decode(const Rows& kv, const void* q, void* ws, void* out,
                  void* counters, int rows, int G, int n_tiles, int n_splits,
                  float scale, Mask mask, float softcap, cudaStream_t st) {
  using L = DecodeLayout<HD>;
  if (G < 1 || G > G_MAX || kv.rep < 1 || n_splits < 1 ||
      (n_splits > 1 && counters == nullptr))
    return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // once per instantiation, not per launch
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<HD, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = 1;
  }
  dim3 grid(rows, n_splits);
  decode_kernel<HD, Rows><<<grid, THREADS, L::SMEM, st>>>(
      kv, static_cast<const bf16*>(q), static_cast<float*>(ws),
      static_cast<bf16*>(out), static_cast<int*>(counters), G, n_tiles,
      scale, mask, softcap);
  return (int)cudaGetLastError();
}

template <class Rows>
int launch_decode_hd(const Rows& kv, int hd, const void* q, void* ws,
                     void* out, void* counters, int rows, int G, int n_tiles,
                     int n_splits, float scale, Mask mask, float softcap,
                     cudaStream_t st) {
  switch (hd) {
#define K5_CASE(HD)                                                       \
    case HD: return launch_decode<HD, Rows>(                              \
        kv, q, ws, out, counters, rows, G, n_tiles, n_splits, scale,      \
        mask, softcap, st);
    K5_CASE(16) K5_CASE(32) K5_CASE(64) K5_CASE(128) K5_CASE(256)
#undef K5_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

constexpr int PAGED_MASKS =
    (1 << MASK_GLOBAL) | (1 << MASK_LOCAL) | (1 << MASK_CHUNKED);

// K4 and K4 with its lse output (lse null: none)
int k4_dispatch(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Skv, int H, int KV, int hd,
                float scale, int mask_kind, int window, int prefix_len,
                float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mask{mask_kind, window, prefix_len};
  if (!mask_ok(mask, 0x1f)) return (int)cudaErrorInvalidValue;
  switch (hd) {
#define K4_CASE(HD)                                                        \
    case HD: return launch_prefill<HD>(q, k, v, out, B, Sq, Skv, H, KV,    \
                                       scale, mask, softcap, st, lse);
    K4_CASE(16) K4_CASE(32) K4_CASE(64) K4_CASE(128) K4_CASE(256)
#undef K4_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K4: mask_kind is a MaskKind; window for 'local' and 'chunked' (else 0),
// prefix_len for 'prefix' (else 0).
extern "C" int k4_flash_prefill(const void* q, const void* k, const void* v,
                                void* out, int B, int Sq, int Skv, int H,
                                int KV, int hd, float scale, int mask_kind,
                                int window, int prefix_len, float softcap,
                                void* stream) {
  return k4_dispatch(q, k, v, out, nullptr, B, Sq, Skv, H, KV, hd, scale,
                     mask_kind, window, prefix_len, softcap, stream);
}

// K4 with its second output: lse [B, H, Sq] fp32, each query row's
// log-sum-exp of its scaled (softcapped) scores, for the backward; the
// first output is k4_flash_prefill's, bit for bit.
extern "C" int k4_flash_prefill_lse(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int B, int Sq, int Skv, int H, int KV,
                                    int hd, float scale, int mask_kind,
                                    int window, int prefix_len,
                                    float softcap, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return k4_dispatch(q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, H,
                     KV, hd, scale, mask_kind, window, prefix_len, softcap,
                     stream);
}

// K5: partials and fold in one launch.  A kv head's G * rep query heads
// are rep rows of G; ws holds B*KV*rep x n_tiles records of
// record_floats(G, hd) fp32 (acc [G][hd], m [G], l [G]), and the live
// tiles' records are left there; counters (B*KV*rep int32, zero) are
// needed when n_splits > 1.
extern "C" int k5_flash_decode(const void* q, const void* k, const void* v,
                               void* ws, void* out, void* counters, int B,
                               int KV, int rep, int G, int hd, int cache_len,
                               int pos, int n_tiles, int n_splits,
                               float scale, float softcap, void* stream) {
  DenseKV kv{static_cast<const bf16*>(k), static_cast<const bf16*>(v), KV,
             rep, cache_len, pos};
  return launch_decode_hd(kv, hd, q, ws, out, counters, B * KV * rep, G,
                          n_tiles, n_splits, scale, Mask{MASK_GLOBAL, 0, 0},
                          softcap, static_cast<cudaStream_t>(stream));
}

// K6 at decode (S == 1): K5's kernel on the page table, rows (lane, kv
// head, r); mask_kind 'global', 'local' or 'chunked' (window >= 1 for the
// last two).
extern "C" int k6_paged_decode(const void* q, const void* k_pool,
                               const void* v_pool, const void* table,
                               const void* positions, void* ws, void* out,
                               void* counters, int L, int KV, int rep, int G,
                               int hd, int P, int PS, int n_tiles,
                               int n_splits, float scale, int mask_kind,
                               int window, float softcap, void* stream) {
  const Mask mask{mask_kind, window, 0};
  if (!mask_ok(mask, PAGED_MASKS)) return (int)cudaErrorInvalidValue;
  PagedKV kv{static_cast<const bf16*>(k_pool),
             static_cast<const bf16*>(v_pool),
             static_cast<const int*>(table),
             static_cast<const int*>(positions), KV, rep, P, PS};
  return launch_decode_hd(kv, hd, q, ws, out, counters, L * KV * rep, G,
                          n_tiles, n_splits, scale, mask, softcap,
                          static_cast<cudaStream_t>(stream));
}

// K6's prefill-chunk body (S > 1): one block per (q tile, kv head, lane),
// K4's arithmetic over the page table.  q and out [L, S, KV, G, hd]; pools
// [n_pool, PS, KV, hd] (the trash page included), PS a power of two from 4
// to 128; table [L, P]; positions [L, S] (-1 = idle row, output 0.0);
// mask_kind and window as k6_paged_decode's.
extern "C" int k6_paged_chunk(const void* q, const void* k_pool,
                              const void* v_pool, const void* table,
                              const void* positions, void* out, int L, int S,
                              int KV, int G, int hd, int P, int ps_shift,
                              int n_pool, float scale, int mask_kind,
                              int window, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mask{mask_kind, window, 0};
  if (!mask_ok(mask, PAGED_MASKS)) return (int)cudaErrorInvalidValue;
  const int* T = static_cast<const int*>(table);
  const int* Pos = static_cast<const int*>(positions);
  switch (hd) {
#define K6C_CASE(HD)                                                        \
    case HD: return launch_chunk<HD>(q, k_pool, v_pool, T, Pos, out, L, S,  \
                                     KV, G, P, ps_shift, n_pool, scale,     \
                                     mask, softcap, st);
    K6C_CASE(16) K6C_CASE(32) K6C_CASE(64) K6C_CASE(128) K6C_CASE(256)
#undef K6C_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
