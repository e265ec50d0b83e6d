// K1 on Hopper: blocked bf16 GEMM with a fused epilogue, and the
// fixed-order row-norm pass that completes its rmsnorm output.
//
// Replaces: src/repro/kernels/matmul.py::matmul_pallas (_matmul_kernel),
// float path — C = epilogue(A @ B) with an fp32 accumulator, the epilogue
// applied in the store phase so the accumulator never reaches device
// memory.
//
// What bounds it: at decode (M = 4) every weight byte is read once and
// used for 4 rows, far below the ~295 flop/byte the card needs to be
// compute bound, so it is bound by the bytes of B.  At prefill (M = 1024)
// the big projections are bound by tensor-core operations.
//
// Design: one block per (64-column, BM-row) output tile, four warps, the
// K loop inside the block (blocks run in parallel, so the TPU's
// sequential K grid axis becomes a loop).  A and B tiles stream through
// shared memory in a two-stage cp.async ring so the next tile's loads
// overlap this tile's tensor-core work (WMMA bf16 16x16x16 with fp32
// accumulation).  Small M takes BM = 16 so decode wastes less of each
// tensor-core tile.  The epilogue runs on the fp32 accumulator tile in
// shared memory before the single store: silu(g) * u with g read from
// operand2, then the residual add, then the cast to bf16 (the one output
// type the serving path stores).
//
// rmsnorm: a full row of N = 4096 does not fit one block at a useful
// tile height, so the GEMM stores the value (residual already added) and
// k1_rmsnorm_rows normalizes the STORED rows with a fixed-order
// reduction.  The standalone rmsnorm of the port uses the same routine,
// so a fused (value, normed) is bitwise store-then-rmsnorm on the card by
// construction.
//
// Shapes it takes: A [M, K], B [K, N] row-major bf16, K % 8 == 0 and
// N % 8 == 0 (every 16-byte chunk is wholly inside or outside the matrix);
// the wrapper checks this and raises otherwise.
//
// K2 on Hopper: the int8 path of the same matmul_pallas (a_scale,
// b_scale): int8 A [M, K] x int8 B [K, N] into an int32 accumulator on the
// int8 tensor cores (WMMA signed char 16x16x16), then in the store phase
// x = (float(acc) * a_scale[m]) * b_scale[n] -- the reference's order,
// with explicit round-to-nearest multiplies so the compiler cannot fuse a
// stage into its neighbour -- then the gate or the residual, then a bf16
// or fp32 store.  Integer accumulation is exact, so the fp32-out product
// is bitwise equal to its plain version.  The same cp.async two-stage
// ring as K1; shared tiles are cut in 16-byte chunks (A along k, B along
// n) so every fragment pointer is 256-bit aligned.  What bounds it: at
// decode the int8 weight bytes (half of K1's); at M = 512 the tensor-core
// operations.  The up GEMM's (q, scale) output needs the absmax of the
// whole row (N = 12800): the GEMM stores the gated value at fp32 in a
// workspace and k3_quantize_rows finishes the rows (split-N, as for the
// rmsnorm), so the handoff is bitwise the reference's fused quantize of
// the same fp32 values (max is exact in any order).  The down GEMM's
// (value, normed) output reuses k1_rmsnorm_rows.
//
// K3 on Hopper: src/repro/kernels/quantize.py::quantize_rowwise_pallas
// (_quantize_kernel): one block per row, absmax by a shared-memory tree,
// scale = max(absmax, 1e-12) * fl(1/127) (XLA turns the reference's
// division by the constant 127 into that multiply), q = clip(rint(x /
// scale), +-127) with an IEEE division and round-half-even, so it is
// bitwise its plain version and the reference.  Bound by bytes: each element read twice
// from L2-resident rows, written once as int8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int A_LD = BK + 8;  // padded rows: 80 B, a multiple of 16 B
constexpr int B_LD = BN + 8;  // 144 B
constexpr int C_LD = BN + 4;  // fp32 accumulator tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM>
__device__ __forceinline__ void load_tiles(bf16 (*As)[A_LD], bf16 (*Bs)[B_LD],
                                           const bf16* A, const bf16* B,
                                           int M, int N, int K, int m0,
                                           int n0, int k0) {
  const int tid = threadIdx.x;
  for (int c = tid; c < BM * BK / 8; c += THREADS) {
    int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
    int gr = m0 + r, gc = k0 + cc;
    bool ok = gr < M && gc < K;
    cp_async16(&As[r][cc], ok ? A + (size_t)gr * K + gc : A, ok);
  }
  for (int c = tid; c < BK * BN / 8; c += THREADS) {
    int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
    int gr = k0 + r, gc = n0 + cc;
    bool ok = gr < K && gc < N;
    cp_async16(&Bs[r][cc], ok ? B + (size_t)gr * N + gc : B, ok);
  }
}

template <int BM, int WARPS_M>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
              bf16* __restrict__ out, const bf16* __restrict__ residual,
              const bf16* __restrict__ operand2, int M, int N, int K,
              int gate_silu) {
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int AB_BYTES = 2 * (BM * A_LD + BK * B_LD) * sizeof(bf16);
  constexpr int C_BYTES = BM * C_LD * sizeof(float);
  constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16(*As)[BM][A_LD] = reinterpret_cast<bf16(*)[BM][A_LD]>(smem);
  bf16(*Bs)[BK][B_LD] = reinterpret_cast<bf16(*)[BK][B_LD]>(
      smem + 2 * BM * A_LD * sizeof(bf16));
  float(*Cs)[C_LD] = reinterpret_cast<float(*)[C_LD]>(smem);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = (K + BK - 1) / BK;
  load_tiles<BM>(As[0], Bs[0], A, B, M, N, K, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles)
      load_tiles<BM>(As[st ^ 1], Bs[st ^ 1], A, B, M, N, K, m0, n0,
                     (kt + 1) * BK);
    cp_async_commit();  // possibly empty group keeps the count uniform
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &As[st][wm * WM + i * 16][kk], A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[st][kk][wn * WN + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }
  cp_async_wait<0>();
  __syncthreads();

  // store phase: accumulator tile -> shared memory -> epilogue -> one store
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&Cs[wm * WM + i * 16][wn * WN + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const size_t o = (size_t)gm * N + gn;
    float x = Cs[r][c];
    if (gate_silu) {
      float g = __bfloat162float(operand2[o]);
      x = (g / (1.0f + expf(-g))) * x;
    }
    if (residual) x += __bfloat162float(residual[o]);
    out[o] = __float2bfloat16(x);
  }
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
// K2: int8 GEMM
// ---------------------------------------------------------------------------

constexpr int I8_BK = 64;   // k per tile: four 16-byte chunks
constexpr int I8_C_LD = BN + 4;

// A tile: [I8_BK / 16][BM][16] (chunk kc holds k in [16 kc, 16 kc + 16));
// B tile: [BN / 16][I8_BK][16] (chunk nc holds n in [16 nc, 16 nc + 16)).
template <int BM>
__device__ __forceinline__ void load_tiles_i8(int8_t* As, int8_t* Bs,
                                              const int8_t* A,
                                              const int8_t* B, int M, int N,
                                              int K, int m0, int n0,
                                              int k0) {
  const int tid = threadIdx.x;
  for (int c = tid; c < BM * (I8_BK / 16); c += THREADS) {
    const int r = c / (I8_BK / 16), kc = c % (I8_BK / 16);
    const int gr = m0 + r, gk = k0 + kc * 16;
    const bool ok = gr < M && gk < K;
    cp_async16(As + (kc * BM + r) * 16, ok ? A + (size_t)gr * K + gk : A,
               ok);
  }
  for (int c = tid; c < I8_BK * (BN / 16); c += THREADS) {
    const int r = c / (BN / 16), nc = c % (BN / 16);
    const int gk = k0 + r, gn = n0 + nc * 16;
    const bool ok = gk < K && gn < N;
    cp_async16(Bs + (nc * I8_BK + r) * 16, ok ? B + (size_t)gk * N + gn : B,
               ok);
  }
}

template <int BM, int WARPS_M>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ A,
                   const int8_t* __restrict__ B,
                   const float* __restrict__ a_scale,
                   const float* __restrict__ b_scale,
                   float* __restrict__ out_f32, bf16* __restrict__ out_bf16,
                   const bf16* __restrict__ residual,
                   const bf16* __restrict__ operand2, int M, int N, int K,
                   int gate_silu) {
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int A_BYTES = BM * I8_BK, B_BYTES = I8_BK * BN;
  constexpr int AB_BYTES = 2 * (A_BYTES + B_BYTES);
  constexpr int C_BYTES = BM * I8_C_LD * sizeof(int);
  constexpr int SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  int8_t* As[2] = {reinterpret_cast<int8_t*>(smem),
                   reinterpret_cast<int8_t*>(smem + A_BYTES)};
  int8_t* Bs[2] = {reinterpret_cast<int8_t*>(smem + 2 * A_BYTES),
                   reinterpret_cast<int8_t*>(smem + 2 * A_BYTES + B_BYTES)};
  int(*Cs)[I8_C_LD] = reinterpret_cast<int(*)[I8_C_LD]>(smem);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int ktiles = (K + I8_BK - 1) / I8_BK;
  load_tiles_i8<BM>(As[0], Bs[0], A, B, M, N, K, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles)
      load_tiles_i8<BM>(As[st ^ 1], Bs[st ^ 1], A, B, M, N, K, m0, n0,
                        (kt + 1) * I8_BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < I8_BK / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                     wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                     wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(
            fa[i], As[st] + (kc * BM + wm * WM + i * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(
            fb[j], Bs[st] + (((wn * WN + j * 16) / 16) * I8_BK + kc * 16) * 16,
            16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&Cs[wm * WM + i * 16][wn * WN + j * 16],
                              acc[i][j], I8_C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const size_t o = (size_t)gm * N + gn;
    // (acc * row) * col, each product rounded on its own
    float x = __fmul_rn(__fmul_rn(__int2float_rn(Cs[r][c]), a_scale[gm]),
                        b_scale[gn]);
    if (gate_silu) {
      const float g = __bfloat162float(operand2[o]);
      x = __fmul_rn(g / (1.0f + expf(-g)), x);
    }
    if (residual) x = __fadd_rn(x, __bfloat162float(residual[o]));
    if (out_f32)
      out_f32[o] = x;
    else
      out_bf16[o] = __float2bfloat16(x);
  }
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

extern "C" int k1_matmul(const void* a, const void* b, void* out,
                         const void* residual, const void* operand2, int M,
                         int N, int K, int gate_silu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* B = static_cast<const bf16*>(b);
  const bf16* R = static_cast<const bf16*>(residual);
  const bf16* G = static_cast<const bf16*>(operand2);
  bf16* C = static_cast<bf16*>(out);
  if (M <= 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    matmul_kernel<16, 1><<<grid, THREADS, 0, st>>>(A, B, C, R, G, M, N,
                                                    K, gate_silu);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    matmul_kernel<64, 2><<<grid, THREADS, 0, st>>>(A, B, C, R, G, M, N,
                                                    K, gate_silu);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k1_rmsnorm_rows(const void* x, const void* scale, void* out,
                               int M, int N, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rmsnorm_rows_kernel<<<M, NORM_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(scale),
      static_cast<bf16*>(out), N, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k2_int8_matmul(const void* a, const void* b,
                              const void* a_scale, const void* b_scale,
                              void* out_f32, void* out_bf16,
                              const void* residual, const void* operand2,
                              int M, int N, int K, int gate_silu,
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
  if (M <= 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    int8_matmul_kernel<16, 1><<<grid, THREADS, 0, st>>>(
        A, B, SA, SB, OF, OB, R, G, M, N, K, gate_silu);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    int8_matmul_kernel<64, 2><<<grid, THREADS, 0, st>>>(
        A, B, SA, SB, OF, OB, R, G, M, N, K, gate_silu);
  }
  return static_cast<int>(cudaGetLastError());
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
