// K7 on Hopper: the adder tree, out[i] = sum_s partials[s][i].
//
// Replaces src/repro/kernels/addertree.py::addertree_pallas
// (_addertree_kernel), the paper's Add kernel: the Y partial products of
// an (x, z) group reduced with one accumulator, walking s in order.  Each
// element folds s = 0, 1, ..., S-1 in ascending order at 32 bits (fp32 for
// fp32 and bf16 partials, int32 for int8), then casts once: the
// association of the plain version (core/maxeva_matmul.rank_order_sum), so
// the output is bitwise the plain version's (additions only, so no
// contraction into an FMA can reorder them).  What bounds it: bytes, each
// partial read once and each output written once.  So each thread owns
// 16-byte vectors of output elements (4 fp32, 8 bf16 or 16 int8
// partials), two at a time, and issues the loads of all S partials of
// both before the first add where S <= 8 (unrolled, in registers sized
// to S: 2, 4 or 8 a round; rounds of 8 beyond that), so 2 x S x 16 bytes
// are in flight per thread; the grid is at most 16 blocks of 256 threads
// per SM, the SMs counted from the device.  Where the partials are not
// 16-byte aligned (a base off 16 bytes, or n not a multiple of the vector
// width, which shifts every partial after the first), a scalar kernel
// loads the S partials of one element at a time, 8 a round, in the same
// order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 16;  // grid cap: twice the threads an SM holds
constexpr int ROUND = 8;  // the scalar kernel's partials a round
constexpr int VPT = 2;    // vectors a thread folds side by side

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int widen(int8_t x) { return x; }

__device__ __forceinline__ void put(float* o, float a) { *o = a; }
__device__ __forceinline__ void put(bf16* o, float a) {
  *o = __float2bfloat16(a);  // round to nearest even, as torch casts
}
__device__ __forceinline__ void put(int* o, int a) { *o = a; }
__device__ __forceinline__ void put(int8_t* o, int a) {
  *o = static_cast<int8_t>(a);  // wraps, as torch casts int32 to int8
}

// VEC outputs cast into registers, stored 16 (or 8) bytes at a time
template <class Out, class Acc, int VEC>
__device__ __forceinline__ void put_vec(Out* o, const Acc (&a)[VEC]) {
  alignas(16) Out v[VEC];
#pragma unroll
  for (int x = 0; x < VEC; ++x) put(v + x, a[x]);
  constexpr int BYTES = sizeof(Out) * VEC;
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(o)[i] = reinterpret_cast<const uint4*>(v)[i];
  } else {
#pragma unroll
    for (int i = 0; i < BYTES / 8; ++i)
      reinterpret_cast<uint2*>(o)[i] = reinterpret_cast<const uint2*>(v)[i];
  }
}

// vectors of VEC = 16 / sizeof(In) elements; p and n * sizeof(In) are
// 16-byte aligned, n_vec = n / VEC.  A thread takes VPT vectors a
// stride apart (each warp's loads contiguous) and loads R partials of
// each before their adds (R = 2, 4 or 8, the least that holds S, so the
// registers follow S; rounds of 8 beyond S = 8).
template <class In, class Acc, class Out, int R>
__global__ void __launch_bounds__(THREADS)
addertree_vec_kernel(const In* __restrict__ p, Out* __restrict__ out, int S,
                     long long n, long long n_vec) {
  constexpr int VEC = 16 / sizeof(In);
  const long long stride = (long long)gridDim.x * THREADS;
  const long long step = n / VEC;  // one partial, in vectors
  for (long long v0 = (long long)blockIdx.x * THREADS + threadIdx.x;
       v0 < n_vec; v0 += VPT * stride) {
    Acc a[VPT][VEC];
    for (int s0 = 0; s0 < S; s0 += R) {
      uint4 w[R][VPT];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < VPT; ++u)
          if (s0 + r < S && v0 + u * stride < n_vec)
            w[r][u] = __ldcs(reinterpret_cast<const uint4*>(p) + v0 +
                             u * stride + (s0 + r) * step);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (s0 + r >= S) break;
#pragma unroll
        for (int u = 0; u < VPT; ++u) {
          const In* e = reinterpret_cast<const In*>(&w[r][u]);
#pragma unroll
          for (int x = 0; x < VEC; ++x)
            a[u][x] = s0 + r == 0 ? widen(e[x]) : a[u][x] + widen(e[x]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < VPT; ++u)
      if (v0 + u * stride < n_vec)
        put_vec(out + (v0 + u * stride) * VEC, a[u]);
  }
}

template <class In, class Acc, class Out>
__global__ void __launch_bounds__(THREADS)
addertree_scalar_kernel(const In* __restrict__ p, Out* __restrict__ out,
                        int S, long long n) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    Acc a = 0;
    for (int s0 = 0; s0 < S; s0 += ROUND) {
      In w[ROUND];
#pragma unroll
      for (int r = 0; r < ROUND; ++r)
        if (s0 + r < S) w[r] = p[(s0 + r) * n + i];
#pragma unroll
      for (int r = 0; r < ROUND; ++r) {
        if (s0 + r >= S) break;
        a = s0 + r == 0 ? widen(w[r]) : a + widen(w[r]);
      }
    }
    put(out + i, a);
  }
}

int grid_for(long long items) {
  static int sms = 0;  // the current device's SM count, read once
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 1;
  }
  const long long blocks = (items + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  return (int)(blocks < cap ? blocks : cap);
}

template <class In, class Acc, class Out>
int launch(const void* p, void* out, int S, long long n, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(In);
  const In* src = static_cast<const In*>(p);
  Out* dst = static_cast<Out*>(out);
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0 && n % VEC == 0) {
    const long long n_vec = n / VEC;
    const int grid = grid_for((n_vec + VPT - 1) / VPT);
    if (S <= 2)
      addertree_vec_kernel<In, Acc, Out, 2><<<grid, THREADS, 0, st>>>(
          src, dst, S, n, n_vec);
    else if (S <= 4)
      addertree_vec_kernel<In, Acc, Out, 4><<<grid, THREADS, 0, st>>>(
          src, dst, S, n, n_vec);
    else
      addertree_vec_kernel<In, Acc, Out, 8><<<grid, THREADS, 0, st>>>(
          src, dst, S, n, n_vec);
  } else {
    addertree_scalar_kernel<In, Acc, Out><<<grid_for(n), THREADS, 0, st>>>(
        src, dst, S, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// in_kind: 0 fp32, 1 bf16, 2 int8; out_kind: 0 fp32, 1 bf16, 2 int32,
// 3 int8.  Float partials take a float output, int8 partials an integer
// one; any other pair is refused.
extern "C" int k7_addertree(const void* partials, void* out, int S,
                            long long n, int in_kind, int out_kind,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || n < 1) return (int)cudaErrorInvalidValue;
  switch (in_kind * 4 + out_kind) {
    case 0: return launch<float, float, float>(partials, out, S, n, st);
    case 1: return launch<float, float, bf16>(partials, out, S, n, st);
    case 4: return launch<bf16, float, float>(partials, out, S, n, st);
    case 5: return launch<bf16, float, bf16>(partials, out, S, n, st);
    case 10: return launch<int8_t, int, int>(partials, out, S, n, st);
    case 11: return launch<int8_t, int, int8_t>(partials, out, S, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
