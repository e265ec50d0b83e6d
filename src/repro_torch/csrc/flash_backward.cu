// K4's backward on Hopper: the gradient of the flash prefill in the
// recomputing (FlashAttention-2) form, for the training path.
//
// The reference defines no backward kernel (its flash_attention_pallas,
// src/repro/kernels/flash_attention.py:331, is differentiated by XLA
// through the plain attention); this is the port's own, held to
// kernels/ref.py::flash_attention_bwd_ref.  Inputs: q, the forward's
// output o and its gradient do [B, S, H, hd], k and v [B, S, KV, hd] (bf16,
// KV | H), and the forward's row log-sum-exp lse [B, H, S] (fp32,
// k4_flash_prefill_lse).  Three launches, no atomics:
//
//   1. rowdot: D = rowsum(do * o) [B, H, S] at fp32, one warp a row.
//   2. dkv: one block per (64-key tile, kv head, batch), four warps of 16
//      keys each.  For each of the kv head's G query heads in ascending
//      order, and each 64-row q tile from the diagonal on, the block loads
//      the Q and dO tiles and every warp recomputes its scores S^T = K Q^T
//      and dP^T = V dO^T on the tensor cores (mma.sync m16n8k16, bf16 in,
//      fp32 accumulators), P^T = exp(S^T scale - lse) with the causal mask
//      on the diagonal tile, dS^T = P^T (dP^T - D), and accumulates dV +=
//      P^T dO and dK += dS^T Q in registers, P and dS rounded to bf16 as
//      the A operands straight from the accumulator fragments.  GQA's G
//      heads are summed inside the block in a fixed order, so dK and dV are
//      deterministic.  dK is scaled once at the end.
//   3. dq: one block per (64-row q tile, q head, batch), four warps of 16
//      rows: for each 64-key tile up to the diagonal, S = Q K^T and dP =
//      dO V^T again, dS = P (dP - D), dQ += dS K, scaled once at the end.
//
// Operands are tiles in shared memory in row-major rows padded by 16 bytes
// (conflict-free 16-byte rows for ldmatrix); an operand needed transposed
// (Q and dO as the B of dK and dV, K as the B of dQ) is read by
// ldmatrix.trans from the same tile.  What bounds it: the tensor cores and
// the exps of the recomputed scores at long S; this simple form loads each
// tile synchronously (no cp.async ring), recomputes S and dP in both
// passes (7 products against the forward's 2), and is the first version,
// not a tuned one.  It covers the 'global' (causal) kind at head dims 16 to
// 128 with no softcap; the wrapper refuses the rest.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 64;             // q rows and keys a tile
constexpr int THREADS = 128;       // four warps of 16 rows (or keys)
constexpr float LOG2E = 1.4426950408889634f;

// a tile of 64 rows of HD bf16, each row padded by 16 bytes (rows of 48
// to 272 bytes: 16-byte aligned for ldmatrix, and eight consecutive rows
// on distinct banks); a block holds four (two operands of each product
// pair) and the rows' lse and D
template <int HD>
struct Tile {
  static constexpr int LD = HD + 8;
  static constexpr int ELEMS = BT * LD;
  static constexpr int SMEM = 4 * ELEMS * 2 + 2 * BT * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A fragment of a 16 x 16 block at (m0, k0) of a row-major [m][k] tile
template <int LD>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* t,
                                       int m0, int k0, int lane) {
  const int mat = lane / 8, r = lane % 8;
  const bf16* p = t + (m0 + r + (mat & 1) * 8) * LD + k0 + (mat >> 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// B fragments of two n-tiles (n0, n0 + 8) at k-step k0 of a tile stored
// [n][k] (b[0], b[1]: n-tile n0; b[2], b[3]: n-tile n0 + 8)
template <int LD>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const bf16* t,
                                       int n0, int k0, int lane) {
  const int mat = lane / 8, r = lane % 8;
  const bf16* p = t + (n0 + r + (mat >> 1) * 8) * LD + k0 + (mat & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

// the same two n-tiles from a tile stored [k][n] (transposed on load)
template <int LD>
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const bf16* t,
                                        int k0, int n0, int lane) {
  const int mat = lane / 8, r = lane % 8;
  const bf16* p = t + (k0 + r + (mat & 1) * 8) * LD + n0 + (mat >> 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

// c += a . b, m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[8][4] (16 rows x 64 columns) = rows [m0, m0 + 16) of tile `ta`
// (row-major [m][d]) times the 64 rows of tile `tb` (row-major [n][d])
// transposed: a 16 x 64 block of scores
template <int HD>
__device__ __forceinline__ void scores(float (&acc)[8][4], const bf16* ta,
                                       const bf16* tb, int m0, int lane) {
  constexpr int LD = Tile<HD>::LD;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_a<LD>(a, ta, m0, 16 * kk, lane);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_b<LD>(b, tb, 16 * jp, 16 * kk, lane);
      mma(acc[2 * jp], a, b[0], b[1]);
      mma(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// out[HD / 8][4] (16 rows x HD) += X (16 x 64, bf16 A fragments of four
// k-steps of 16 columns) times the 64-row tile `tb` (row-major [k][d])
template <int HD>
__device__ __forceinline__ void accumulate(float (&out)[HD / 8][4],
                                           const uint32_t (&x)[4][4],
                                           const bf16* tb, int lane) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldsm_bt<Tile<HD>::LD>(b, tb, 16 * kk, 16 * np, lane);
      mma(out[2 * np], x[kk], b[0], b[1]);
      mma(out[2 * np + 1], x[kk], b[2], b[3]);
    }
}

// 64 rows of one head (row stride `stride` elements, rows >= `rows`
// zero-filled) into a padded tile, 16-byte vectors, coalesced
template <int HD>
__device__ __forceinline__ void load_tile(bf16* t, const bf16* g, int row0,
                                          int rows, size_t stride) {
  constexpr int LD = Tile<HD>::LD;
  for (int idx = threadIdx.x; idx < BT * HD / 8; idx += THREADS) {
    const int r = idx / (HD / 8), c = idx % (HD / 8) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      v = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(t + r * LD + c) = v;
  }
}

// D[b, h, r] = sum_d do[b, r, h, d] * o[b, r, h, d] at fp32, one warp a
// row: lane l sums the pairs at 2 l, 2 l + 64, ..., then the lanes fold
// by shuffles
__global__ void __launch_bounds__(256)
rowdot_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
              float* __restrict__ D, int B, int S, int H, int hd) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= B * S * H) return;
  const int h = row % H, r = row / H % S, b = row / H / S;
  float s = 0.0f;
  for (int i = 2 * lane; i < hd; i += 64) {
    const size_t e = (size_t)row * hd + i;
    const float2 of = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + e));
    const float2 df = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + e));
    s = fmaf(df.x, of.x, s);
    s = fmaf(df.y, of.y, s);
  }
#pragma unroll
  for (int off = 16; off; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) D[((size_t)b * H + h) * S + r] = s;
}

// P and dS (16 x 64, the accumulator fragments of S and dP) in place:
// p = exp(s scale - lse) where key <= query (both inside the sequence),
// else 0; ds = p (dp - D).  Element (j, e) is at row row0 + lane / 4 + 8
// (e >> 1), column col0 + 8 j + 2 (lane % 4) + (e & 1) of the block;
// TRANSPOSED: rows are keys and columns query rows (the dK/dV pass), else
// the reverse.  lse2 and dsum are indexed by the query's place in its
// block (its column under TRANSPOSED, else its row).
template <bool TRANSPOSED>
__device__ __forceinline__ void softmax_grad(
    float (&s)[8][4], float (&dp)[8][4], const float* lse2,
    const float* dsum, int row0, int col0, int lane, float scale2,
    int limit) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = lane / 4 + 8 * (e >> 1);
      const int cc = 8 * j + 2 * (lane % 4) + (e & 1);
      const int key = TRANSPOSED ? row0 + rr : col0 + cc;
      const int q = TRANSPOSED ? col0 + cc : row0 + rr;
      const int qi = TRANSPOSED ? cc : rr;
      const bool live = key <= q && q < limit;
      const float p =
          live ? exp2f(fmaf(s[j][e], scale2, -lse2[qi])) : 0.0f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - dsum[qi]);
    }
}

// the accumulator fragments of a 16 x 64 block as bf16 A fragments of four
// k-steps of 16 columns
__device__ __forceinline__ void to_a(uint32_t (&x)[4][4],
                                     const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    x[kk][0] = pack(c[2 * kk][0], c[2 * kk][1]);
    x[kk][1] = pack(c[2 * kk][2], c[2 * kk][3]);
    x[kk][2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    x[kk][3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// 16 x HD fp32 fragments, times `mul`, stored as bf16 rows [row0, row0 +
// 16) of a [rows, stride] tensor
template <int HD>
__device__ __forceinline__ void store_rows(bf16* g,
                                           const float (&c)[HD / 8][4],
                                           int row0, int rows, size_t stride,
                                           int lane, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + lane / 4 + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(g + (size_t)r * stride + 8 * n +
                                         2 * (lane % 4)) =
          __floats2bfloat162_rn(c[n][2 * h] * mul, c[n][2 * h + 1] * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ D,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
           int KV, float scale) {
  constexpr int TILE = Tile<HD>::ELEMS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;
  bf16* Ds = Qs + TILE;  // the dO tile
  float* lse2 = reinterpret_cast<float*>(Ds + TILE);
  float* dsum = lse2 + BT;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, kv0 = kt * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t kv_stride = (size_t)KV * HD, q_stride = (size_t)H * HD;
  const float scale2 = scale * LOG2E;

  load_tile<HD>(Ks, k + (size_t)b * S * kv_stride + kvh * HD, kv0, S,
                kv_stride);
  load_tile<HD>(Vs, v + (size_t)b * S * kv_stride + kvh * HD, kv0, S,
                kv_stride);

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  const int n_qt = (S + BT - 1) / BT;
  for (int g = 0; g < G; ++g) {  // the group's heads in ascending order
    const int h = kvh * G + g;
    const size_t head = (size_t)b * S * q_stride + h * HD;
    const size_t row = ((size_t)b * H + h) * S;
    for (int qt = kt; qt < n_qt; ++qt) {  // causal: rows from the diagonal
      const int q0 = qt * BT;
      __syncthreads();  // the previous tiles are consumed
      load_tile<HD>(Qs, q + head, q0, S, q_stride);
      load_tile<HD>(Ds, dout + head, q0, S, q_stride);
      if (threadIdx.x < BT) {
        const int r = q0 + threadIdx.x;
        lse2[threadIdx.x] = r < S ? lse[row + r] * LOG2E : 0.0f;
        dsum[threadIdx.x] = r < S ? D[row + r] : 0.0f;
      }
      __syncthreads();
      float st[8][4], dpt[8][4];
      scores<HD>(st, Ks, Qs, 16 * warp, lane);   // S^T = K Q^T
      scores<HD>(dpt, Vs, Ds, 16 * warp, lane);  // dP^T = V dO^T
      softmax_grad<true>(st, dpt, lse2, dsum, kv0 + 16 * warp, q0, lane,
                         scale2, S);
      uint32_t x[4][4];
      to_a(x, st);                               // P^T
      accumulate<HD>(dva, x, Ds, lane);          // dV += P^T dO
      to_a(x, dpt);                              // dS^T
      accumulate<HD>(dka, x, Qs, lane);          // dK += dS^T Q
    }
  }
  const size_t out = (size_t)b * S * kv_stride + kvh * HD;
  store_rows<HD>(dk + out, dka, kv0 + 16 * warp, S, kv_stride, lane, scale);
  store_rows<HD>(dv + out, dva, kv0 + 16 * warp, S, kv_stride, lane, 1.0f);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          bf16* __restrict__ dq, int S, int H, int KV, int n_qt,
          float scale) {
  constexpr int TILE = Tile<HD>::ELEMS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + TILE;  // the dO tile
  bf16* Ks = Ds + TILE;
  bf16* Vs = Ks + TILE;
  float* lse2 = reinterpret_cast<float*>(Vs + TILE);
  float* dsum = lse2 + BT;

  // the longest q tiles (most kv tiles under the causal mask) first
  const int qt = n_qt - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV), q0 = qt * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t kv_stride = (size_t)KV * HD, q_stride = (size_t)H * HD;
  const size_t head = (size_t)b * S * q_stride + h * HD;
  const size_t row = ((size_t)b * H + h) * S;
  const float scale2 = scale * LOG2E;

  load_tile<HD>(Qs, q + head, q0, S, q_stride);
  load_tile<HD>(Ds, dout + head, q0, S, q_stride);
  if (threadIdx.x < BT) {
    const int r = q0 + threadIdx.x;
    lse2[threadIdx.x] = r < S ? lse[row + r] * LOG2E : 0.0f;
    dsum[threadIdx.x] = r < S ? D[row + r] : 0.0f;
  }
  float dqa[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.0f;

  const size_t kvb = (size_t)b * S * kv_stride + kvh * HD;
  for (int kt = 0; kt <= qt; ++kt) {  // causal: keys up to the diagonal
    const int kv0 = kt * BT;
    __syncthreads();  // the previous K and V tiles are consumed
    load_tile<HD>(Ks, k + kvb, kv0, S, kv_stride);
    load_tile<HD>(Vs, v + kvb, kv0, S, kv_stride);
    __syncthreads();
    float s[8][4], dp[8][4];
    scores<HD>(s, Qs, Ks, 16 * warp, lane);    // S = Q K^T
    scores<HD>(dp, Ds, Vs, 16 * warp, lane);   // dP = dO V^T
    softmax_grad<false>(s, dp, lse2 + 16 * warp, dsum + 16 * warp,
                        q0 + 16 * warp, kv0, lane, scale2, S);
    uint32_t x[4][4];
    to_a(x, dp);                               // dS
    accumulate<HD>(dqa, x, Ks, lane);          // dQ += dS K
  }
  store_rows<HD>(dq + head, dqa, q0 + 16 * warp, S, q_stride, lane, scale);
}

template <int HD>
int launch_backward(const bf16* Q, const bf16* K, const bf16* V,
                    const bf16* O, const bf16* dO, const float* L, bf16* dq,
                    bf16* dk, bf16* dv, float* Dw, int B, int S, int H,
                    int KV, float scale, cudaStream_t st) {
  constexpr int SMEM = Tile<HD>::SMEM;
  static int smem_set = 0;
  if (!smem_set) {
    int e = (int)cudaFuncSetAttribute(
        dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (!e)
      e = (int)cudaFuncSetAttribute(
          dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e) return e;
    smem_set = 1;
  }
  const int rows = B * S * H;
  rowdot_kernel<<<(rows + 7) / 8, 256, 0, st>>>(O, dO, Dw, B, S, H, HD);
  const int n_t = (S + BT - 1) / BT;
  dkv_kernel<HD><<<dim3(n_t, KV, B), THREADS, SMEM, st>>>(
      Q, K, V, dO, L, Dw, dk, dv, S, H, KV, scale);
  dq_kernel<HD><<<dim3(n_t, H, B), THREADS, SMEM, st>>>(
      Q, K, V, dO, L, Dw, dq, S, H, KV, n_t, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K4's backward ('global', head dims 16 to 128, no softcap; Sq == Skv ==
// S): q, o, do, dq [B, S, H, hd] and k, v, dk, dv [B, S, KV, hd] bf16, lse
// [B, H, S] fp32 (k4_flash_prefill_lse's), ws [B, H, S] fp32 scratch for
// D; three launches on `stream`.
extern "C" int k4_flash_backward(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* dq, void* dk,
                                 void* dv, void* ws, int B, int S, int H,
                                 int KV, int hd, float scale, int mask_kind,
                                 float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mask_kind != 0 || softcap != 0.0f || KV < 1 || H % KV || B < 1 ||
      S < 1)
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
  float* Dw = static_cast<float*>(ws);
  switch (hd) {
#define BWD_CASE(HD)                                                      \
    case HD: return launch_backward<HD>(Q, K, V, O, dO, L, DQ, DK, DV,   \
                                        Dw, B, S, H, KV, scale, st);
    BWD_CASE(16) BWD_CASE(32) BWD_CASE(64) BWD_CASE(128)
#undef BWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
