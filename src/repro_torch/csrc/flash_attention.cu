// K4, K5 and K6 on Hopper: online-softmax flash prefill, split-K flash
// decode over a dense KV cache with its deterministic combine, and the
// same decode over a paged KV cache.
//
// K4 replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (_prefill_kernel).  One block per (batch, q head, 64-row q tile), four
// warps of 16 q rows each, looping over 64-slot KV tiles with the running
// (m, l, acc) in fp32, under the causal mask (query row i attends slots
// <= i).  q head h reads kv head h / (H / KV): the grouped K/V are never
// repeated.  Scores and P.V run on the tensor cores (WMMA
// bf16, fp32 accumulation); P is rounded to bf16 for P.V, the usual flash
// trade, which the tests and chip_smoke.py bound by a stated tolerance.
// What bounds it: at S = 256 the causal work is small and each K/V tile
// is re-read by the 4 q tiles of a head, so launch and latency dominate;
// at long S it is bound by tensor-core operations.  The design keeps the
// S x S scores out of device memory and the causal tile loop stops at the
// diagonal, so no masked-out tile is loaded.
// Variants (gemma2): `window` > 0 is the 'local' kind, query row i
// attending keys i - window < k <= i, and the kv loop starts at the first
// 64-slot tile that meets the window of the q tile's first row, so a tile
// before every row's window is never loaded; a later row whose first
// visited tile is wholly masked adds exactly nothing (p = 0 there, and
// alpha = exp(min(m - m_new, 0)) keeps o and l at 0 until its first live
// key).  `softcap` > 0 caps the scaled scores, s = softcap * tanh(s /
// softcap) with an IEEE division, before the mask.
//
// K5 replaces flash_decode_pallas (_decode_kernel) and
// combine_tile_partials.  k5_decode_partials: one block per (batch, kv
// head, tile group); each fixed 32-slot tile anchored at slot 0 yields an
// independent partial (m_t, l_t, acc_t) that the G query heads of the kv
// head share a K/V tile for.  A tile past the current position is fully
// masked and is written as (_NEG, 0, 0) without reading the cache.
// k5_decode_combine: a global max, alpha_t = exp(m_t - m) and an ASCENDING
// fp32 fold over tiles.  A partial depends only on its tile index, and the
// combine never sees the grouping, so the output is bitwise identical for
// every n_splits.  What bounds it: the bytes of the live cache (each K/V
// row read once), so tiles past the position are skipped and slots past it
// are not read.  `softcap` > 0 caps the scores as in K4.
//
// K6 replaces paged_flash_decode_pallas (_paged_decode_kernel) and, for
// prefill chunks (S > 1), its tiled XLA mirror paged_flash_decode_xla.
// k6_paged_partials is the K5 partials kernel instantiated on a paged
// slot address: each row is (lane, s, kv head) with its own position
// (-1 = idle, every tile masked, output exactly 0.0); slot j of a lane
// lives at pool[table[lane, j / PS], j % PS]; an unmapped page (-1) is
// masked and never read.  Tiles are the same 32 slots anchored at logical
// position 0 as the dense path, not one page per tile, and the partials go
// through k5_decode_combine unchanged, so a paged lane is bitwise the same
// history decoded from a dense cache and a neighbour's page mapping
// changes no bit of it.  What bounds it: the bytes of each row's live
// pages at decode; at a prefill chunk the fp32 partials of every tile.
// 'local' rows (`window` > 0) also mask keys at or before pos - window,
// and a tile wholly before the window is written as (_NEG, 0, 0) without
// reading the cache, as a tile past the position is.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 128;

// ---------------------------------------------------------------------------
// K4: prefill
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BKV = 64;

template <int HD>
struct PrefillSmem {
  static constexpr int QLD = HD + 8;                   // bf16 rows, 16 B mult
  static constexpr int SLD = (HD > BKV ? HD : BKV) + 4;  // fp32 scratch
  static constexpr int PLD = BKV + 8;
  static constexpr size_t Q = BQ * QLD * sizeof(bf16);
  static constexpr size_t KV = BKV * QLD * sizeof(bf16);
  static constexpr size_t S = 4 * 16 * SLD * sizeof(float);
  static constexpr size_t P = 4 * 16 * PLD * sizeof(bf16);
  static constexpr size_t BYTES = Q + 2 * KV + S + P;
};

// copy `rows` rows of HD bf16 (row r at src + r * stride) into shared rows
// of ld elements, zero-filling rows at or past `valid`
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          size_t stride, int rows,
                                          int valid) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CH; c += THREADS) {
    int r = c / CH, cc = (c % CH) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * stride + cc);
    *reinterpret_cast<uint4*>(dst + r * ld + cc) = v;
  }
}

// key kpos is attended by query row qrow: stored, causal, and inside the
// window ('local', window > 0)
__device__ __forceinline__ bool prefill_live(int kpos, int qrow, int Skv,
                                             int window) {
  return kpos < Skv && kpos <= qrow && (window == 0 || qrow - kpos < window);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
               int Skv, int H, int KV, float scale, int window,
               float softcap) {
  using L = PrefillSmem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::Q + L::KV);
  float* Ss = reinterpret_cast<float*>(smem + L::Q + 2 * L::KV);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::Q + 2 * L::KV + L::S);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;  // this lane's row and half
  const int qrow = q0 + warp * 16 + r;  // also its position (causal)
  float* Sw = Ss + warp * 16 * L::SLD;
  bf16* Pw = Ps + warp * 16 * L::PLD;

  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  load_rows<HD>(Qs, L::QLD, q + ((size_t)b * Sq + q0) * q_stride + h * HD,
                q_stride, BQ, Sq - q0);

  float m = NEG, l = 0.0f;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;

  const int kv_end = min(Skv, q0 + BQ);  // no tile past the diagonal
  // no tile before the window of the q tile's first row
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BKV * BKV : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // previous tile fully consumed
    const bf16* kb = k + ((size_t)b * Skv + kv0) * kv_stride + kvh * HD;
    const bf16* vb = v + ((size_t)b * Skv + kv0) * kv_stride + kvh * HD;
    load_rows<HD>(Ks, L::QLD, kb, kv_stride, BKV, Skv - kv0);
    load_rows<HD>(Vs, L::QLD, vb, kv_stride, BKV, Skv - kv0);
    __syncthreads();

    // S_w [16 x 64] = Q_w [16 x HD] . K^T
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + (warp * 16) * L::QLD + kk, L::QLD);
        wmma::load_matrix_sync(fb, Ks + (j * 16) * L::QLD + kk, L::QLD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Sw + j * 16, acc, L::SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on this lane's 32 columns of its row
    float s[BKV / 2];
    float mx = NEG;
#pragma unroll
    for (int c = 0; c < BKV / 2; ++c) {
      const int kpos = kv0 + half * (BKV / 2) + c;
      float x = Sw[r * L::SLD + half * (BKV / 2) + c] * scale;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      s[c] = prefill_live(kpos, qrow, Skv, window) ? x : NEG;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    // guard fully masked rows: exp(_NEG - _NEG) would be 1
    const float alpha = expf(fminf(m - m_new, 0.0f));
    float psum = 0.0f;
#pragma unroll
    for (int c = 0; c < BKV / 2; ++c) {
      const int kpos = kv0 + half * (BKV / 2) + c;
      const float p =
          prefill_live(kpos, qrow, Skv, window) ? expf(s[c] - m_new) : 0.0f;
      psum += p;
      Pw[r * L::PLD + half * (BKV / 2) + c] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    // PV_w [16 x HD] = P_w [16 x 64] . V, then o = o * alpha + PV_w
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Pw + kk, L::PLD);
        wmma::load_matrix_sync(fb, Vs + kk * L::QLD + n * 16, L::QLD);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Sw + n * 16, acc, L::SLD, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < HD / 2; ++i)
      o[i] = o[i] * alpha + Sw[r * L::SLD + half * (HD / 2) + i];
    __syncwarp();
  }

  if (qrow < Sq) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    bf16* orow = out + ((size_t)b * Sq + qrow) * q_stride + h * HD +
                 half * (HD / 2);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) orow[i] = __float2bfloat16(o[i] * inv);
  }
}

// ---------------------------------------------------------------------------
// K5: split-K decode partials and combine
// ---------------------------------------------------------------------------

constexpr int TILE = 32;  // DEFAULT_KV_TILE of the reference

// Where a decode row's K/V slots live.  slot_row returns the index of the
// slot's [hd] row in the K and V arrays, or -1 when the slot holds nothing
// (past a dense cache's end, or an unmapped page); position gives the
// row's query position (-1: an idle row).  The partials kernel is written
// once against this interface, so K6 runs K5's dot order, exp and mask on
// every tile, and a paged lane is bitwise the same history in a dense
// cache.
struct DenseKV {
  const bf16* k;
  const bf16* v;
  int KV, cache_len, pos;
  __device__ int position(int) const { return pos; }
  __device__ long long slot_row(int row, int slot) const {
    if (slot >= cache_len) return -1;
    const int b = row / KV, kvh = row % KV;
    return ((long long)b * cache_len + slot) * KV + kvh;
  }
};

// Rows are (lane, s, kv head); pools [NP + 1, PS, KV, hd] with the trash
// page last; table [L, P] (-1 = unmapped); positions [L, S] (-1 = idle).
// An unmapped slot is never read: it is masked, so what the trash page
// holds cannot reach the output.
struct PagedKV {
  const bf16* k;
  const bf16* v;
  const int* table;
  const int* positions;
  int KV, S, P, PS;
  __device__ int position(int row) const { return positions[row / KV]; }
  __device__ long long slot_row(int row, int slot) const {
    const int page = slot / PS;
    if (page >= P) return -1;
    const int lane = row / (S * KV), kvh = row % KV;
    const int phys = table[lane * P + page];
    if (phys < 0) return -1;
    return ((long long)phys * PS + slot % PS) * KV + kvh;
  }
};

template <int HD, class Rows>
__global__ void __launch_bounds__(THREADS)
decode_partials_kernel(Rows kv, const bf16* __restrict__ q,
                       float* __restrict__ m_t, float* __restrict__ l_t,
                       float* __restrict__ acc_t, int G, int n_tiles,
                       int tiles_per_split, float scale, int window,
                       float softcap) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE * HD;
  float* qs = reinterpret_cast<float*>(Vs + TILE * HD);
  float* ps = qs + G * HD;
  __shared__ int live[TILE];  // slot stored, <= pos and in the window

  const int row = blockIdx.x;  // one query row's kv head
  const int pos = kv.position(row);
  for (int i = threadIdx.x; i < G * HD; i += THREADS)
    qs[i] = __bfloat162float(q[(size_t)row * G * HD + i]);

  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  for (int t = t_begin; t < t_end; ++t) {
    const int t0 = t * TILE;
    const size_t pm = ((size_t)row * n_tiles + t) * G;
    // fully masked tile (past the position, or wholly before the window):
    // exact (_NEG, 0, 0)
    if (t0 > pos || (window > 0 && pos - (t0 + TILE - 1) >= window)) {
      for (int i = threadIdx.x; i < G; i += THREADS) {
        m_t[pm + i] = NEG;
        l_t[pm + i] = 0.0f;
      }
      for (int i = threadIdx.x; i < G * HD; i += THREADS)
        acc_t[pm * HD + i] = 0.0f;
      continue;
    }
    __syncthreads();  // qs loaded / previous tile consumed
    // K is stored transposed (slot fastest) so the threads of a warp,
    // one slot each, read neighbouring shared-memory words.  A masked
    // slot is not read: its K and V are zero in shared memory.
    constexpr int CH = HD / 8;
    for (int c = threadIdx.x; c < TILE * CH; c += THREADS) {
      const int j = c / CH, cc = (c % CH) * 8;
      const int slot = t0 + j;
      const bool in_mask = slot <= pos && (window == 0 || pos - slot < window);
      const long long sr = in_mask ? kv.slot_row(row, slot) : -1;
      uint4 wk = make_uint4(0, 0, 0, 0), wv = make_uint4(0, 0, 0, 0);
      if (sr >= 0) {
        wk = *reinterpret_cast<const uint4*>(kv.k + sr * HD + cc);
        wv = *reinterpret_cast<const uint4*>(kv.v + sr * HD + cc);
      }
      if (cc == 0) live[j] = sr >= 0;
      const bf16* e = reinterpret_cast<const bf16*>(&wk);
#pragma unroll
      for (int x = 0; x < 8; ++x) Ks[(cc + x) * TILE + j] = e[x];
      *reinterpret_cast<uint4*>(Vs + j * HD + cc) = wv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * TILE; i += THREADS) {
      const int g = i / TILE, j = i % TILE;
      float dot = 0.0f;
      for (int d = 0; d < HD; ++d)
        dot += qs[g * HD + d] * __bfloat162float(Ks[d * TILE + j]);
      float x = dot * scale;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      ps[i] = live[j] ? x : NEG;
    }
    __syncthreads();
    for (int g = threadIdx.x; g < G; g += THREADS) {
      float mx = NEG;
      for (int j = 0; j < TILE; ++j) mx = fmaxf(mx, ps[g * TILE + j]);
      float sum = 0.0f;
      for (int j = 0; j < TILE; ++j) {
        const float p = live[j] ? expf(ps[g * TILE + j] - mx) : 0.0f;
        ps[g * TILE + j] = p;
        sum += p;
      }
      m_t[pm + g] = mx;
      l_t[pm + g] = sum;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * HD; i += THREADS) {
      const int g = i / HD, d = i % HD;
      float a = 0.0f;
      for (int j = 0; j < TILE; ++j)
        a += ps[g * TILE + j] * __bfloat162float(Vs[j * HD + d]);
      acc_t[pm * HD + i] = a;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ m_t,
                      const float* __restrict__ l_t,
                      const float* __restrict__ acc_t, bf16* __restrict__ out,
                      int n_tiles, int G, int HD) {
  const int row = blockIdx.x;
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    const size_t base = (size_t)row * n_tiles * G + g;  // tile 0, head g
    float m = NEG;
    for (int t = 0; t < n_tiles; ++t) m = fmaxf(m, m_t[base + t * G]);
    // ascending rank-order fold at fp32 (core/maxeva_matmul._rank_order_sum)
    float alpha = expf(m_t[base] - m);
    float l = l_t[base] * alpha;
    float a = acc_t[base * HD + d] * alpha;
    for (int t = 1; t < n_tiles; ++t) {
      alpha = expf(m_t[base + t * G] - m);
      l = l + l_t[base + t * G] * alpha;
      a = a + acc_t[(base + t * G) * HD + d] * alpha;
    }
    out[((size_t)row * G + g) * HD + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  }
}

template <int HD>
int launch_prefill(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KV, float scale,
                   int window, float softcap, cudaStream_t st) {
  const size_t bytes = PrefillSmem<HD>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  prefill_kernel<HD><<<grid, THREADS, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, H, KV,
      scale, window, softcap);
  return (int)cudaGetLastError();
}

template <int HD, class Rows>
int launch_partials(const Rows& kv, const void* q, void* m, void* l,
                    void* acc, int rows, int G, int n_tiles,
                    int tiles_per_split, int n_splits, float scale,
                    int window, float softcap, cudaStream_t st) {
  const size_t bytes =
      2 * TILE * HD * sizeof(bf16) + (size_t)G * (HD + TILE) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decode_partials_kernel<HD, Rows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(rows, n_splits);
  decode_partials_kernel<HD, Rows><<<grid, THREADS, bytes, st>>>(
      kv, static_cast<const bf16*>(q), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc), G, n_tiles,
      tiles_per_split, scale, window, softcap);
  return (int)cudaGetLastError();
}

template <class Rows>
int launch_partials_hd(const Rows& kv, int hd, const void* q, void* m,
                       void* l, void* acc, int rows, int G, int n_tiles,
                       int tiles_per_split, int n_splits, float scale,
                       int window, float softcap, cudaStream_t st) {
  switch (hd) {
#define K5_CASE(HD)                                                         \
    case HD: return launch_partials<HD>(kv, q, m, l, acc, rows, G, n_tiles, \
                                        tiles_per_split, n_splits, scale,   \
                                        window, softcap, st);
    K5_CASE(16) K5_CASE(32) K5_CASE(64) K5_CASE(128)
#undef K5_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int k4_flash_prefill(const void* q, const void* k, const void* v,
                                void* out, int B, int Sq, int Skv, int H,
                                int KV, int hd, float scale, int window,
                                float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define K4_CASE(HD)                                                        \
    case HD: return launch_prefill<HD>(q, k, v, out, B, Sq, Skv, H, KV,    \
                                       scale, window, softcap, st);
    K4_CASE(16) K4_CASE(32) K4_CASE(64) K4_CASE(128)
#undef K4_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int k5_decode_partials(const void* q, const void* k, const void* v,
                                  void* m, void* l, void* acc, int B, int KV,
                                  int G, int hd, int cache_len, int pos,
                                  int n_tiles, int tiles_per_split,
                                  int n_splits, float scale, float softcap,
                                  void* stream) {
  DenseKV kv{static_cast<const bf16*>(k), static_cast<const bf16*>(v), KV,
             cache_len, pos};
  return launch_partials_hd(kv, hd, q, m, l, acc, B * KV, G, n_tiles,
                            tiles_per_split, n_splits, scale, 0, softcap,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int k6_paged_partials(const void* q, const void* k_pool,
                                 const void* v_pool, const void* table,
                                 const void* positions, void* m, void* l,
                                 void* acc, int L, int S, int KV, int G,
                                 int hd, int P, int PS, int n_tiles,
                                 int tiles_per_split, int n_splits,
                                 float scale, int window, float softcap,
                                 void* stream) {
  PagedKV kv{static_cast<const bf16*>(k_pool),
             static_cast<const bf16*>(v_pool),
             static_cast<const int*>(table),
             static_cast<const int*>(positions), KV, S, P, PS};
  return launch_partials_hd(kv, hd, q, m, l, acc, L * S * KV, G, n_tiles,
                            tiles_per_split, n_splits, scale, window, softcap,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int k5_decode_combine(const void* m, const void* l,
                                 const void* acc, void* out, int rows,
                                 int n_tiles, int G, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_combine_kernel<<<rows, THREADS, 0, st>>>(
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(acc), static_cast<bf16*>(out), n_tiles, G,
      hd);
  return (int)cudaGetLastError();
}
