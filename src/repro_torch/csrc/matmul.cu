// K1 on Hopper: bf16 GEMM with a fused epilogue, and the fixed-order
// row-norm pass that completes its rmsnorm output.
//
// Replaces: src/repro/kernels/matmul.py::matmul_pallas (_matmul_kernel),
// float path — C = epilogue(A @ B) with an fp32 accumulator, the epilogue
// applied in the store phase so the accumulator never reaches device
// memory.  A [M, K] and B [K, N] are row-major bf16, K % 8 == 0 and N % 8
// == 0 (TMA needs 16-byte row strides); the wrapper checks this and
// raises otherwise.  Tiles past an edge are zero-filled by TMA.
//
// The regime is chosen by the shape alone (kernels/matmul.py::k1_plan
// mirrors it and picks the split count):
//
// Operations regime (M >= 64: prefill, scheduler chunks).  Bound by the
// tensor cores.  One block per 128 x BN output tile (BN 128, 192 or 256,
// the width of least estimated time for the shape), in groups of 8 row
// tiles so that a wave of blocks shares its A and B tiles in L2.  A
// producer warp keeps TMA loads of A [128 x 64] and B [64 x BN] in flight
// in a ring of 4 to 7 stages (full/empty mbarrier pairs); two consumer
// warpgroups each issue wgmma m64nBNk16 on 64 rows, keeping one product
// group in flight while the next stage lands.  B is [K, N] with N
// contiguous, so it is read MN-major (the descriptor's transpose bit).
// The width changes no element's summation order: every element sums the
// same k16 products in the same order.  The epilogue runs from the
// accumulator registers: silu(g) * x with g from operand2, then the
// residual, then the bf16 store, the gate and residual pairs of 8 column
// blocks loaded ahead of their stores.
//
// Bytes regime (M < 64: decode).  Bound by the weight stream, so the
// operands are swapped: C^T = B^T A^T, with weight columns on wgmma's
// 64-row side (MN-major A) and the few activation rows as its n (8, 16,
// 32 or 64, zero-filled past M), so no tensor-core row is wasted on
// padding the weight.  Each block streams 128 columns (two 64-column
// boxes, 256 contiguous bytes of each weight row) x a range of K through
// a 4-stage TMA ring of 16 KB weight tiles (plus the activation tile).  K
// is split so that the grid reaches at least two blocks per SM at every
// decode projection; each split writes its fp32 partial to a workspace,
// and the last split of a column block to arrive (an arrival counter per
// block, reset by that block) folds the partials in ascending split order
// (the reference's _rank_order_sum, K7's rule) before the epilogue.  No
// value atomics: an element's summation order depends only on (regime,
// N, K), and a row's result never depends on the other rows.
//
// rmsnorm: a full row of N = 4096 does not fit one block at a useful
// tile height, so the GEMM stores the value (residual already added) and
// k1_rmsnorm_rows normalizes the STORED rows with a fixed-order
// reduction.  The standalone rmsnorm of the port uses the same routine,
// so a fused (value, normed) is bitwise store-then-rmsnorm on the card by
// construction.
//
// K2 on Hopper: the int8 path of the same matmul_pallas (a_scale,
// b_scale): int8 A [M, K] x int8 B into an int32 accumulator on the s8
// tensor cores (wgmma m64nNk32.s32.s8.s8), then in the store phase x =
// (float(acc) * a_scale[m]) * b_scale[n] -- the reference's order, with
// explicit round-to-nearest multiplies so the compiler cannot fuse a stage
// into its neighbour -- then the gate or the residual, then a bf16 or fp32
// store.  The s8 wgmma reads both operands K-major from shared memory, so
// the weight arrives as [N, K] (QuantizedWeight stores it so, transposed
// once when the model is quantized); a K-major int8 row of 128 values is
// 128 bytes, the swizzle span, so the tiles, descriptors and TMA boxes are
// K1's with 128 k a stage (and one k32 step where K1 takes a k16 one).
// Both of K1's regimes, by the shape alone (k2_plan): M >= 64, tensor-core
// operations, K1's 128 x {128, 192, 256} tiles, producer warp and two
// consumer warpgroups, the epilogue stored from the registers; M < 64, the
// int8 weight stream (half of K1's bytes), swapped operands with the
// weight's N on wgmma's 64-row side and the rows as n (8 to 64), a
// 6-stage ring, K split until the grid holds a block per two SMs (longer
// splits than K1's: a split streams enough stages to amortize filling its
// ring), int32 partials folded ascending by the last split to arrive.
// TMA zero-fills a ragged edge: K and N need only be multiples of 16 (the
// 16-byte row stride TMA needs).  Integer sums are exact in any order, so
// the fp32-out product is bitwise its plain version.  The
// up GEMM's (q, scale) output needs the absmax of the whole row (N =
// 12800): the GEMM stores the gated value at fp32 in a workspace and
// k3_quantize_rows finishes the rows (split-N, as for the rmsnorm), so the
// handoff is bitwise the reference's fused quantize of the same fp32
// values (max is exact in any order).  The down GEMM's (value, normed)
// output reuses k1_rmsnorm_rows.
//
// K3 on Hopper: src/repro/kernels/quantize.py::quantize_rowwise_pallas
// (_quantize_kernel): one block per row, absmax by a shared-memory tree,
// scale = max(absmax, 1e-12) * fl(1/127) (XLA turns the reference's
// division by the constant 127 into that multiply), q = clip(rint(x /
// scale), +-127) with an IEEE division and round-half-even, so it is
// bitwise its plain version and the reference.  Bound by bytes: each
// element read twice from L2-resident rows, written once as int8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

#include "hopper.cuh"

using namespace hopper;
typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------------------
// K1: bf16 GEMM, wgmma + TMA
// ---------------------------------------------------------------------------

// silu(g) = g / (1 + exp(-g)) with the fast exp and division (relative
// error about 1e-6, far inside the bf16 store, in a fraction of the
// instructions of expf and an IEEE division on every gated element)
__device__ __forceinline__ float silu(float g) {
  return __fdividef(g, 1.0f + __expf(-g));
}

// x -> silu(g) * x (gate), then + r (residual), at fp32
__device__ __forceinline__ float k1_epilogue(float x, const bf16* residual,
                                             const bf16* operand2, size_t o,
                                             int gate_silu) {
  if (gate_silu) x = silu(__bfloat162float(operand2[o])) * x;
  if (residual) x += __bfloat162float(residual[o]);
  return x;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// operations regime: 128 x BN tiles, BN in {128, 192, 256} (k1_plan
// picks the width)
constexpr int OPS_BM = 128, OPS_BK = 64;
constexpr int OPS_GROUP_M = 8;              // row tiles per raster group
constexpr int OPS_THREADS = 2 * 128 + 32;   // two consumer warpgroups + a
                                            // producer warp
constexpr int OPS_A_BYTES = OPS_BM * OPS_BK * 2;     // 16 KB
constexpr int OPS_B_CHUNK = OPS_BK * 64 * 2;         // 8 KB: 64 columns

template <int BN>
struct OpsLayout {
  static constexpr int STAGE = OPS_A_BYTES + BN / 64 * OPS_B_CHUNK;
  // as many stages as fit beside the barriers (4 at BN 256, 7 at 128)
  static constexpr int STAGES_FIT = (232448 - 2048) / STAGE;
  static constexpr int STAGES = STAGES_FIT < 8 ? STAGES_FIT : 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE + (2 * STAGES + 1) * 8;
};

// the operations regime's epilogue tiles: [128 x BN] bf16 as BN / 64
// boxes of [128 rows x 64 columns], 128-byte swizzled like every TMA tile
template <int BN>
struct OpsEpilogue {
  static constexpr int BOX = OPS_BM * 128;
  static constexpr int TILE = BN / 64 * BOX;
  // byte offset of columns (c, c + 1), c = 8 j + 2 q, of tile row r
  static __device__ __forceinline__ uint32_t offset(int r, int j, int q) {
    return (j / 8) * BOX + r * 128 + (((j % 8) ^ (r % 8)) << 4) + 4 * q;
  }
};

template <int BN>
__global__ void __launch_bounds__(OPS_THREADS, 1)
k1_ops_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              const __grid_constant__ CUtensorMap map_out,
              const __grid_constant__ CUtensorMap map_gate,
              const __grid_constant__ CUtensorMap map_res, int M, int N,
              int K, int gate_silu, int has_residual) {
  using L = OpsLayout<BN>;
  using E = OpsEpilogue<BN>;
  constexpr int STAGES = L::STAGES;
  static_assert(3 * E::TILE <= STAGES * L::STAGE,
                "the epilogue tiles reuse the ring");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * L::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* epi = empty + STAGES;

  // grouped raster: consecutive blocks walk OPS_GROUP_M row tiles, then
  // the next BN columns
  const int tiles_m = (M + OPS_BM - 1) / OPS_BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int per_group = OPS_GROUP_M * tiles_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * OPS_GROUP_M;
  const int group_m = min(tiles_m - first_m, OPS_GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * OPS_BM;
  const int n0 = (in_group / group_m) * BN;
  const int ktiles = (K + OPS_BK - 1) / OPS_BK;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(epi, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      tma_prefetch_map(&map_a);
      tma_prefetch_map(&map_b);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        uint8_t* st = smem + s * L::STAGE;
        tma_load_2d(st, &map_a, &full[s], kt * OPS_BK, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(st + OPS_A_BYTES + c * OPS_B_CHUNK, &map_b, &full[s],
                      n0 + 64 * c, kt * OPS_BK);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* st = smem + s * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < OPS_BK / 16; ++kk) {
      // A: K-major rows of 128 B; B: MN-major, 64-column blocks 8 KB apart
      const uint64_t da = make_desc(st + wg * 64 * 128 + kk * 32, 16, 1024,
                                    128);
      const uint64_t db = make_desc(st + OPS_A_BYTES + kk * 16 * 128,
                                    OPS_B_CHUNK, 1024, 128);
      wgmma_ss<0, 1>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue through shared memory: once both warpgroups are done with
  // the ring, it holds the output tile, and the gate and residual tiles,
  // loaded by TMA; the output leaves by TMA stores, so no global access
  // of the epilogue is scattered
  named_sync(1, 256);
  uint8_t* t_out = smem;
  const uint8_t* t_gate = smem + E::TILE;
  const uint8_t* t_res = smem + 2 * E::TILE;
  if (gate_silu || has_residual) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(epi, ((gate_silu != 0) + (has_residual != 0)) *
                              E::TILE);
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) {
        if (gate_silu)
          tma_load_2d(smem + E::TILE + c * E::BOX, &map_gate, epi,
                      n0 + 64 * c, m0);
        if (has_residual)
          tma_load_2d(smem + 2 * E::TILE + c * E::BOX, &map_res, epi,
                      n0 + 64 * c, m0);
      }
    }
    mbar_wait(epi, 0);
  }
  // fragment 4 j + 2 h + c holds tile row r0 + 8 h, column 8 j + 2 (lane %
  // 4) + c
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = E::offset(r0 + 8 * h, j, q);
      float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
      if (gate_silu) {
        const __nv_bfloat162 g =
            *reinterpret_cast<const __nv_bfloat162*>(t_gate + off);
        x0 = silu(__low2float(g)) * x0;
        x1 = silu(__high2float(g)) * x1;
      }
      if (has_residual) {
        const __nv_bfloat162 r =
            *reinterpret_cast<const __nv_bfloat162*>(t_res + off);
        x0 += __low2float(r);
        x1 += __high2float(r);
      }
      *reinterpret_cast<__nv_bfloat162*>(t_out + off) =
          __floats2bfloat162_rn(x0, x1);
    }
  fence_async_shared();
  named_sync(1, 256);
  if (threadIdx.x == 0) {  // rows past M and columns past N are clipped
#pragma unroll
    for (int c = 0; c < BN / 64; ++c)
      tma_store_2d(&map_out, t_out + c * E::BOX, n0 + 64 * c, m0);
    tma_store_wait();
  }
}

// bytes regime: blocks of 128 weight columns (two 64-column TMA boxes, so
// each weight row is read 256 contiguous bytes at a time) and 64 k per
// stage
constexpr int DEC_BN = 128, DEC_BK = 64, DEC_STAGES = 4;
constexpr int DEC_THREADS = 128 + 32;  // one consumer warpgroup + producer
constexpr int DEC_W_BOX = DEC_BK * 64 * 2;        // 8 KB: 64 columns
constexpr int DEC_W_BYTES = DEC_BN / 64 * DEC_W_BOX;  // 16 KB of weight

template <int NR>
struct DecLayout {
  static constexpr int X_BOX = NR * 128;  // [NR rows x 64 k] bf16
  static constexpr int STAGE = DEC_W_BYTES + X_BOX;
  static constexpr int SMEM = 1024 + DEC_STAGES * STAGE + 2 * DEC_STAGES * 8;
};

// first k tile of split s of `ktiles` tiles in `splits` contiguous ranges
__host__ __device__ __forceinline__ int split_begin(int s, int ktiles,
                                                    int splits) {
  return (int)((long long)s * ktiles / splits);
}

template <int NR>
__global__ void __launch_bounds__(DEC_THREADS)
k1_bytes_kernel(const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_x,
                float* __restrict__ partial, int* __restrict__ counters,
                bf16* __restrict__ out, const bf16* __restrict__ residual,
                const bf16* __restrict__ operand2, int M, int N, int K,
                int splits, int gate_silu) {
  __shared__ int last_split;
  using L = DecLayout<NR>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DEC_STAGES * L::STAGE);
  uint64_t* empty = full + DEC_STAGES;

  const int n0 = blockIdx.x * DEC_BN, split = blockIdx.y;
  const int ktiles = (K + DEC_BK - 1) / DEC_BK;
  const int t0 = split_begin(split, ktiles, splits);
  const int t1 = split_begin(split + 1, ktiles, splits);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < DEC_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      tma_prefetch_map(&map_w);
      tma_prefetch_map(&map_x);
      for (int t = t0; t < t1; ++t) {
        const int i = t - t0, s = i % DEC_STAGES;
        mbar_wait(&empty[s], ((i / DEC_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        uint8_t* st = smem + s * L::STAGE;
#pragma unroll
        for (int c = 0; c < DEC_BN / 64; ++c)
          tma_load_2d(st + c * DEC_W_BOX, &map_w, &full[s], n0 + 64 * c,
                      t * DEC_BK);
        tma_load_2d(st + DEC_W_BYTES, &map_x, &full[s], t * DEC_BK, 0);
      }
    }
    return;
  }

  // D^T [64 weight columns x NR rows] = W^T [64 x k] . X^T [k x NR] for
  // each 64-column box c
  float acc[DEC_BN / 64][NR / 2];
#pragma unroll
  for (int c = 0; c < DEC_BN / 64; ++c)
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[c][i] = 0.0f;
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, s = i % DEC_STAGES;
    mbar_wait(&full[s], (i / DEC_STAGES) & 1);
    const uint8_t* st = smem + s * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DEC_BK / 16; ++kk) {
      // X box [NR rows x 64 k]: K-major B
      const uint64_t db = make_desc(st + DEC_W_BYTES + kk * 32, 16, 1024,
                                    128);
#pragma unroll
      for (int c = 0; c < DEC_BN / 64; ++c) {
        // W box [64 k rows x 64 columns]: MN-major A
        const uint64_t da = make_desc(st + c * DEC_W_BOX + kk * 16 * 128,
                                      DEC_W_BOX, 1024, 128);
        wgmma_ss<1, 0>(acc[c], da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % DEC_STAGES]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < DEC_BN / 64; ++c) fence_regs(acc[c]);

  // fragment 4 j + 2 h + e of box c: weight column 64 c + 16 warp + lane
  // / 4 + 8 h, activation row 8 j + 2 (lane % 4) + e
#pragma unroll
  for (int c = 0; c < DEC_BN / 64; ++c)
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 64 * c + warp * 16 + lane / 4 + 8 * h;
          const int m = 8 * j + 2 * (lane % 4) + e;
          if (n >= N || m >= M) continue;
          const size_t o = (size_t)m * N + n;
          const float x = acc[c][4 * j + 2 * h + e];
          if (splits > 1)
            partial[(size_t)split * M * N + o] = x;
          else
            out[o] = __float2bfloat16(
                k1_epilogue(x, residual, operand2, o, gate_silu));
        }
  if (splits == 1) return;

  // the last split of this column block to arrive folds the partials of
  // all splits in ascending split order, applies the epilogue and stores;
  // it resets the block's arrival counter for the next call
  __threadfence();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warps
  if (threadIdx.x == 0)
    last_split = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (!last_split) return;
  __threadfence();
  // FE elements per thread at once, FS splits of each loaded together, so
  // FE * FS loads from L2 are in flight per round
  constexpr int FE = 8, FS = 4;
  const int cols = min(DEC_BN, N - n0), count = M * cols;
  const size_t mn = (size_t)M * N;
  for (int base = threadIdx.x; base < count; base += 128 * FE) {
    size_t o[FE];
    float x[FE];
#pragma unroll
    for (int u = 0; u < FE; ++u) {
      const int idx = min(base + 128 * u, count - 1);
      o[u] = (size_t)(idx / cols) * N + n0 + idx % cols;
      x[u] = 0.0f;
    }
    for (int s0 = 0; s0 < splits; s0 += FS) {
      float v[FS][FE];
#pragma unroll
      for (int t = 0; t < FS; ++t)
#pragma unroll
        for (int u = 0; u < FE; ++u)
          v[t][u] = s0 + t < splits ? __ldcg(partial + (s0 + t) * mn + o[u])
                                    : 0.0f;
#pragma unroll
      for (int t = 0; t < FS; ++t)
#pragma unroll
        for (int u = 0; u < FE; ++u)
          if (s0 + t < splits) x[u] = s0 + t == 0 ? v[t][u] : x[u] + v[t][u];
    }
#pragma unroll
    for (int u = 0; u < FE; ++u)
      if (base + 128 * u < count)
        out[o[u]] = __float2bfloat16(
            k1_epilogue(x[u], residual, operand2, o[u], gate_silu));
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

template <class F>
int set_smem(F* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int NR>
int launch_bytes(const bf16* A, const bf16* B, float* partial, int* counters,
                 bf16* C, const bf16* R, const bf16* G, int M, int N, int K,
                 int splits, int gate_silu, cudaStream_t st) {
  CUtensorMap map_w, map_x;
  int e = make_map_2d(&map_w, B, K, N, DEC_BK, 64);
  if (e) return e;
  e = make_map_2d(&map_x, A, M, K, NR, 64);
  if (e) return e;
  static int smem_set = 0;
  if (!smem_set) {
    e = set_smem(k1_bytes_kernel<NR>, DecLayout<NR>::SMEM);
    if (e) return e;
    smem_set = 1;
  }
  dim3 grid((N + DEC_BN - 1) / DEC_BN, splits);
  k1_bytes_kernel<NR><<<grid, DEC_THREADS, DecLayout<NR>::SMEM, st>>>(
      map_w, map_x, partial, counters, C, R, G, M, N, K, splits, gate_silu);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_ops(const bf16* A, const bf16* B, bf16* C, const bf16* R,
               const bf16* G, int M, int N, int K, int gate_silu,
               cudaStream_t st) {
  // the output, gate and residual tiles move as [128 x 64] boxes; an
  // absent operand's map is the output's, never read
  CUtensorMap map_a, map_b, map_out, map_gate, map_res;
  int e = make_map_2d(&map_a, A, M, K, OPS_BM, OPS_BK);
  if (!e) e = make_map_2d(&map_b, B, K, N, OPS_BK, 64);
  if (!e) e = make_map_2d(&map_out, C, M, N, OPS_BM, 64);
  if (!e) e = make_map_2d(&map_gate, gate_silu ? G : C, M, N, OPS_BM, 64);
  if (!e) e = make_map_2d(&map_res, R ? R : C, M, N, OPS_BM, 64);
  if (e) return e;
  static int smem_set = 0;
  if (!smem_set) {
    e = set_smem(k1_ops_kernel<BN>, OpsLayout<BN>::SMEM);
    if (e) return e;
    smem_set = 1;
  }
  const int tiles = ((M + OPS_BM - 1) / OPS_BM) * ((N + BN - 1) / BN);
  k1_ops_kernel<BN><<<tiles, OPS_THREADS, OpsLayout<BN>::SMEM, st>>>(
      map_a, map_b, map_out, map_gate, map_res, M, N, K, gate_silu,
      R != nullptr);
  return (int)cudaGetLastError();
}

constexpr int NORM_THREADS = 256;

// One block per row: each thread sums the squares of its strided elements
// in index order, then a fixed shared-memory tree folds the 256 partials.
// The order never depends on the data or the launch, so the result is
// bitwise reproducible.
__global__ void __launch_bounds__(NORM_THREADS)
rmsnorm_rows_kernel(const bf16* __restrict__ x,
                    const float* __restrict__ scale, bf16* __restrict__ out,
                    int N, float eps) {
  __shared__ float red[NORM_THREADS];
  const bf16* xr = x + (size_t)blockIdx.x * N;
  bf16* outr = out + (size_t)blockIdx.x * N;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < N; i += NORM_THREADS) {
    float v = __bfloat162float(xr[i]);
    ss += v * v;
  }
  red[threadIdx.x] = ss;
  __syncthreads();
  for (int s = NORM_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float ms = red[0] / (float)N;  // sum / n, not a mean op
  const float r = 1.0f / sqrtf(ms + eps);
  for (int i = threadIdx.x; i < N; i += NORM_THREADS) {
    float v = __bfloat162float(xr[i]);
    outr[i] = __float2bfloat16((v * r) * (1.0f + scale[i]));
  }
}


// ---------------------------------------------------------------------------
// K2: int8 GEMM, s8 wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int I8_BK = 128;  // k per stage: one 128-byte swizzled row of int8
constexpr int I8_A_BYTES = OPS_BM * I8_BK;  // 16 KB

template <int BN>
struct I8OpsLayout {
  static constexpr int STAGE = I8_A_BYTES + BN * I8_BK;
  // as many stages as fit beside the barriers (4 at BN 256, 7 at 128)
  static constexpr int STAGES_FIT = (232448 - 2048) / STAGE;
  static constexpr int STAGES = STAGES_FIT < 8 ? STAGES_FIT : 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

// the store phase of output element o = (m, n) from its int32 sum: the
// reference's order, each product and sum rounded on its own, so the
// compiler cannot fuse a stage into its neighbour
__device__ __forceinline__ float k2_value(int acc, float sa, float sb,
                                          size_t o, const bf16* residual,
                                          const bf16* operand2,
                                          int gate_silu) {
  float x = __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sb);
  if (gate_silu) {
    const float g = __bfloat162float(operand2[o]);
    x = __fmul_rn(g / (1.0f + expf(-g)), x);
  }
  if (residual) x = __fadd_rn(x, __bfloat162float(residual[o]));
  return x;
}

__device__ __forceinline__ void k2_store(float x, size_t o, float* out_f32,
                                         bf16* out_bf16) {
  if (out_f32)
    out_f32[o] = x;
  else
    out_bf16[o] = __float2bfloat16(x);
}

// operations regime: K1's grid, raster and ring; A [128 x 128 k] and B
// [BN n x 128 k] both K-major (B is the [N, K] weight), four k32 steps a
// stage; the epilogue stores from the accumulator registers
template <int BN>
__global__ void __launch_bounds__(OPS_THREADS, 1)
k2_ops_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              const float* __restrict__ a_scale,
              const float* __restrict__ b_scale, float* __restrict__ out_f32,
              bf16* __restrict__ out_bf16, const bf16* __restrict__ residual,
              const bf16* __restrict__ operand2, int M, int N, int K,
              int gate_silu) {
  using L = I8OpsLayout<BN>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * L::STAGE);
  uint64_t* empty = full + STAGES;

  const int tiles_m = (M + OPS_BM - 1) / OPS_BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int per_group = OPS_GROUP_M * tiles_n;
  const int group = blockIdx.x / per_group;
  const int first_m = group * OPS_GROUP_M;
  const int group_m = min(tiles_m - first_m, OPS_GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % group_m) * OPS_BM;
  const int n0 = (in_group / group_m) * BN;
  const int ktiles = (K + I8_BK - 1) / I8_BK;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      tma_prefetch_map(&map_a);
      tma_prefetch_map(&map_b);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        uint8_t* st = smem + s * L::STAGE;
        tma_load_2d(st, &map_a, &full[s], kt * I8_BK, m0);
        tma_load_2d(st + I8_A_BYTES, &map_b, &full[s], kt * I8_BK, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* st = smem + s * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < I8_BK / 32; ++kk) {
      const uint64_t da = make_desc(st + wg * 64 * 128 + kk * 32, 16, 1024,
                                    128);
      const uint64_t db = make_desc(st + I8_A_BYTES + kk * 32, 16, 1024,
                                    128);
      wgmma_s8(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // fragment 4 j + 2 h + e holds tile row r0 + 8 h, column 8 j + 2 (lane %
  // 4) + e; N % 16 == 0, so a pair of columns is in or out together
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4, q = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r0 + 8 * h;
    if (m >= M) continue;
    const float sa = a_scale[m];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n >= N) continue;
      const float2 sb = *reinterpret_cast<const float2*>(b_scale + n);
      const size_t o = (size_t)m * N + n;
      const float x0 = k2_value(acc[4 * j + 2 * h], sa, sb.x, o, residual,
                                operand2, gate_silu);
      const float x1 = k2_value(acc[4 * j + 2 * h + 1], sa, sb.y, o + 1,
                                residual, operand2, gate_silu);
      if (out_f32)
        *reinterpret_cast<float2*>(out_f32 + o) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(out_bf16 + o) =
            __floats2bfloat162_rn(x0, x1);
    }
  }
}

// bytes regime: K1's swapped operands, split and fold with int32
// partials; blocks of 128 weight rows of [N, K] (one 16 KB TMA box of
// 128 x 128 k) and the activation rows as wgmma's n
constexpr int I8_DEC_STAGES = 6;  // 104 KB at NR 8: two blocks an SM
constexpr int I8_DEC_W_BYTES = DEC_BN * I8_BK;  // 16 KB of weight

template <int NR>
struct I8DecLayout {
  static constexpr int X_BOX = NR * I8_BK;  // [NR rows x 128 k] int8
  static constexpr int STAGE = I8_DEC_W_BYTES + X_BOX;
  static constexpr int SMEM = 1024 + I8_DEC_STAGES * STAGE +
                              2 * I8_DEC_STAGES * 8;
};

template <int NR>
__global__ void __launch_bounds__(DEC_THREADS)
k2_bytes_kernel(const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_x,
                int* __restrict__ partial, int* __restrict__ counters,
                const float* __restrict__ a_scale,
                const float* __restrict__ b_scale, float* __restrict__ out_f32,
                bf16* __restrict__ out_bf16, const bf16* __restrict__ residual,
                const bf16* __restrict__ operand2, int M, int N, int K,
                int splits, int gate_silu) {
  __shared__ int last_split;
  using L = I8DecLayout<NR>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + I8_DEC_STAGES * L::STAGE);
  uint64_t* empty = full + I8_DEC_STAGES;

  const int n0 = blockIdx.x * DEC_BN, split = blockIdx.y;
  const int ktiles = (K + I8_BK - 1) / I8_BK;
  const int t0 = split_begin(split, ktiles, splits);
  const int t1 = split_begin(split + 1, ktiles, splits);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < I8_DEC_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      tma_prefetch_map(&map_w);
      tma_prefetch_map(&map_x);
      for (int t = t0; t < t1; ++t) {
        const int i = t - t0, s = i % I8_DEC_STAGES;
        mbar_wait(&empty[s], ((i / I8_DEC_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        uint8_t* st = smem + s * L::STAGE;
        tma_load_2d(st, &map_w, &full[s], t * I8_BK, n0);
        tma_load_2d(st + I8_DEC_W_BYTES, &map_x, &full[s], t * I8_BK, 0);
      }
    }
    return;
  }

  // D^T [64 weight rows x NR activation rows] = W [64 x k] . X^T [k x NR]
  // for each 64-row half c of the weight box, both K-major
  int acc[DEC_BN / 64][NR / 2];
#pragma unroll
  for (int c = 0; c < DEC_BN / 64; ++c)
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[c][i] = 0;
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, s = i % I8_DEC_STAGES;
    mbar_wait(&full[s], (i / I8_DEC_STAGES) & 1);
    const uint8_t* st = smem + s * L::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < I8_BK / 32; ++kk) {
      const uint64_t db = make_desc(st + I8_DEC_W_BYTES + kk * 32, 16, 1024,
                                    128);
#pragma unroll
      for (int c = 0; c < DEC_BN / 64; ++c) {
        const uint64_t da = make_desc(st + c * 64 * 128 + kk * 32, 16, 1024,
                                      128);
        wgmma_s8(acc[c], da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % I8_DEC_STAGES]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < DEC_BN / 64; ++c) fence_regs(acc[c]);

  // fragment 4 j + 2 h + e of half c: weight row (output column) 64 c + 16
  // warp + lane / 4 + 8 h, activation row 8 j + 2 (lane % 4) + e
#pragma unroll
  for (int c = 0; c < DEC_BN / 64; ++c)
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 64 * c + warp * 16 + lane / 4 + 8 * h;
          const int m = 8 * j + 2 * (lane % 4) + e;
          if (n >= N || m >= M) continue;
          const size_t o = (size_t)m * N + n;
          const int x = acc[c][4 * j + 2 * h + e];
          if (splits > 1)
            partial[(size_t)split * M * N + o] = x;
          else
            k2_store(k2_value(x, a_scale[m], b_scale[n], o, residual,
                              operand2, gate_silu),
                     o, out_f32, out_bf16);
        }
  if (splits == 1) return;

  // the last split of this column block to arrive folds the partials of
  // all splits in ascending split order (exact in int32), applies the
  // store phase and resets the block's arrival counter
  __threadfence();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warps
  if (threadIdx.x == 0)
    last_split = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (!last_split) return;
  __threadfence();
  constexpr int FE = 8, FS = 4;
  const int cols = min(DEC_BN, N - n0), count = M * cols;
  const size_t mn = (size_t)M * N;
  for (int base = threadIdx.x; base < count; base += 128 * FE) {
    size_t o[FE];
    int x[FE];
#pragma unroll
    for (int u = 0; u < FE; ++u) {
      const int idx = min(base + 128 * u, count - 1);
      o[u] = (size_t)(idx / cols) * N + n0 + idx % cols;
      x[u] = 0;
    }
    for (int s0 = 0; s0 < splits; s0 += FS) {
      int v[FS][FE];
#pragma unroll
      for (int t = 0; t < FS; ++t)
#pragma unroll
        for (int u = 0; u < FE; ++u)
          v[t][u] = s0 + t < splits ? __ldcg(partial + (s0 + t) * mn + o[u])
                                    : 0;
#pragma unroll
      for (int t = 0; t < FS; ++t)
#pragma unroll
        for (int u = 0; u < FE; ++u) x[u] += v[t][u];
    }
#pragma unroll
    for (int u = 0; u < FE; ++u)
      if (base + 128 * u < count) {
        const int m = (int)(o[u] / N), n = (int)(o[u] % N);
        k2_store(k2_value(x[u], a_scale[m], b_scale[n], o[u], residual,
                          operand2, gate_silu),
                 o[u], out_f32, out_bf16);
      }
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

template <int NR>
int launch_k2_bytes(const int8_t* A, const int8_t* B, int* partial,
                    int* counters, const float* SA, const float* SB,
                    float* OF, bf16* OB, const bf16* R, const bf16* G, int M,
                    int N, int K, int splits, int gate_silu,
                    cudaStream_t st) {
  CUtensorMap map_w, map_x;
  int e = make_map_2d(&map_w, B, N, K, DEC_BN, I8_BK, 1);
  if (!e) e = make_map_2d(&map_x, A, M, K, NR, I8_BK, 1);
  if (e) return e;
  static int smem_set = 0;
  if (!smem_set) {
    e = set_smem(k2_bytes_kernel<NR>, I8DecLayout<NR>::SMEM);
    if (e) return e;
    smem_set = 1;
  }
  dim3 grid((N + DEC_BN - 1) / DEC_BN, splits);
  k2_bytes_kernel<NR><<<grid, DEC_THREADS, I8DecLayout<NR>::SMEM, st>>>(
      map_w, map_x, partial, counters, SA, SB, OF, OB, R, G, M, N, K,
      splits, gate_silu);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_k2_ops(const int8_t* A, const int8_t* B, const float* SA,
                  const float* SB, float* OF, bf16* OB, const bf16* R,
                  const bf16* G, int M, int N, int K, int gate_silu,
                  cudaStream_t st) {
  CUtensorMap map_a, map_b;
  int e = make_map_2d(&map_a, A, M, K, OPS_BM, I8_BK, 1);
  if (!e) e = make_map_2d(&map_b, B, N, K, BN, I8_BK, 1);
  if (e) return e;
  static int smem_set = 0;
  if (!smem_set) {
    e = set_smem(k2_ops_kernel<BN>, I8OpsLayout<BN>::SMEM);
    if (e) return e;
    smem_set = 1;
  }
  const int tiles = ((M + OPS_BM - 1) / OPS_BM) * ((N + BN - 1) / BN);
  k2_ops_kernel<BN><<<tiles, OPS_THREADS, I8OpsLayout<BN>::SMEM, st>>>(
      map_a, map_b, SA, SB, OF, OB, R, G, M, N, K, gate_silu);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3: rowwise symmetric int8 quantize (also K2's (q, scale) row pass)
// ---------------------------------------------------------------------------

constexpr int QUANT_THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int N) {
  __shared__ float red[QUANT_THREADS];
  const T* xr = x + (size_t)blockIdx.x * N;
  int8_t* qr = q + (size_t)blockIdx.x * N;
  float mx = 0.0f;
  for (int i = threadIdx.x; i < N; i += QUANT_THREADS)
    mx = fmaxf(mx, fabsf(to_float(xr[i])));
  red[threadIdx.x] = mx;
  __syncthreads();
  for (int s = QUANT_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  // the reference's "/ 127.0" as XLA compiles it: a multiply by the
  // rounded reciprocal
  const float sc = __fmul_rn(fmaxf(red[0], 1e-12f), 1.0f / 127.0f);
  if (threadIdx.x == 0) scale[blockIdx.x] = sc;
  for (int i = threadIdx.x; i < N; i += QUANT_THREADS) {
    const float r = rintf(__fdiv_rn(to_float(xr[i]), sc));
    qr[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  }
}

}  // namespace

// M >= 64: the operations regime, 128 x tile_n output tiles (tile_n 128,
// 192 or 256; splits must be 1); M < 64: the bytes regime (tile_n 128),
// K split `splits` ways: with splits > 1 a [splits, M, N] fp32 workspace
// for the partials and one zeroed int32 arrival counter per 128-column
// block (left zeroed).  kernels/matmul.py's k1_plan chooses tile_n and
// splits.
extern "C" int k1_matmul(const void* a, const void* b, void* out,
                         const void* residual, const void* operand2,
                         void* workspace, void* counters, int M, int N,
                         int K, int splits, int tile_n, int gate_silu,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  const bf16* R = static_cast<const bf16*>(residual);
  const bf16* G = static_cast<const bf16*>(operand2);
  bf16* C = static_cast<bf16*>(out);
  float* P = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  if (splits < 1 || (splits > 1 && (P == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (M >= 64) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    switch (tile_n) {
      case 128: return launch_ops<128>(A, B, C, R, G, M, N, K, gate_silu, st);
      case 192: return launch_ops<192>(A, B, C, R, G, M, N, K, gate_silu, st);
      case 256: return launch_ops<256>(A, B, C, R, G, M, N, K, gate_silu, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (tile_n != DEC_BN) return (int)cudaErrorInvalidValue;
  if (M <= 8)
    return launch_bytes<8>(A, B, P, cnt, C, R, G, M, N, K, splits,
                           gate_silu, st);
  if (M <= 16)
    return launch_bytes<16>(A, B, P, cnt, C, R, G, M, N, K, splits,
                            gate_silu, st);
  if (M <= 32)
    return launch_bytes<32>(A, B, P, cnt, C, R, G, M, N, K, splits,
                            gate_silu, st);
  return launch_bytes<64>(A, B, P, cnt, C, R, G, M, N, K, splits, gate_silu,
                          st);
}

extern "C" int k1_rmsnorm_rows(const void* x, const void* scale, void* out,
                               int M, int N, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rmsnorm_rows_kernel<<<M, NORM_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<bf16*>(out), N, eps);
  return static_cast<int>(cudaGetLastError());
}

// M >= 64: the operations regime, 128 x tile_n output tiles (tile_n 128,
// 192 or 256; splits must be 1); M < 64: the bytes regime (tile_n 128),
// K split `splits` ways: with splits > 1 a [splits, M, N] int32 workspace
// for the partials and one zeroed int32 arrival counter per 128-column
// block (left zeroed).  b is the [N, K] weight, K-major.
// kernels/matmul.py's k2_plan chooses tile_n and splits.
extern "C" int k2_int8_matmul(const void* a, const void* b,
                              const void* a_scale, const void* b_scale,
                              void* out_f32, void* out_bf16,
                              const void* residual, const void* operand2,
                              void* workspace, void* counters, int M, int N,
                              int K, int splits, int tile_n, int gate_silu,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  const float* SA = static_cast<const float*>(a_scale);
  const float* SB = static_cast<const float*>(b_scale);
  float* OF = static_cast<float*>(out_f32);
  bf16* OB = static_cast<bf16*>(out_bf16);
  const bf16* R = static_cast<const bf16*>(residual);
  const bf16* G = static_cast<const bf16*>(operand2);
  int* P = static_cast<int*>(workspace);
  int* cnt = static_cast<int*>(counters);
  if (splits < 1 || (splits > 1 && (P == nullptr || cnt == nullptr)) ||
      (OF == nullptr) == (OB == nullptr))
    return (int)cudaErrorInvalidValue;
  if (M >= 64) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    switch (tile_n) {
      case 128: return launch_k2_ops<128>(A, B, SA, SB, OF, OB, R, G, M, N,
                                          K, gate_silu, st);
      case 192: return launch_k2_ops<192>(A, B, SA, SB, OF, OB, R, G, M, N,
                                          K, gate_silu, st);
      case 256: return launch_k2_ops<256>(A, B, SA, SB, OF, OB, R, G, M, N,
                                          K, gate_silu, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (tile_n != DEC_BN) return (int)cudaErrorInvalidValue;
  if (M <= 8)
    return launch_k2_bytes<8>(A, B, P, cnt, SA, SB, OF, OB, R, G, M, N, K,
                              splits, gate_silu, st);
  if (M <= 16)
    return launch_k2_bytes<16>(A, B, P, cnt, SA, SB, OF, OB, R, G, M, N, K,
                               splits, gate_silu, st);
  if (M <= 32)
    return launch_k2_bytes<32>(A, B, P, cnt, SA, SB, OF, OB, R, G, M, N, K,
                               splits, gate_silu, st);
  return launch_k2_bytes<64>(A, B, P, cnt, SA, SB, OF, OB, R, G, M, N, K,
                             splits, gate_silu, st);
}

extern "C" int k3_quantize_rows(const void* x, void* q, void* scale, int M,
                                int N, int x_is_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_f32)
    quantize_rows_kernel<float><<<M, QUANT_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), N);
  else
    quantize_rows_kernel<bf16><<<M, QUANT_THREADS, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), N);
  return static_cast<int>(cudaGetLastError());
}
