// K7 on Hopper: the adder tree, out[i] = sum_s partials[s][i].
//
// Replaces src/repro/kernels/addertree.py::addertree_pallas
// (_addertree_kernel), the paper's Add kernel: the Y partial products of
// an (x, z) group reduced with one accumulator, walking s in order.  Here
// one thread owns one output element and folds s = 0, 1, ..., S-1 in
// ascending order at 32 bits (fp32 for fp32 and bf16 partials, int32 for
// int8), then casts once: the association of the plain version
// (core/maxeva_matmul.rank_order_sum), so the output is bitwise the plain
// version's (additions only, so no contraction into an FMA can reorder
// them).  What bounds it: bytes, each partial read once and each output
// written once; neighbouring threads read neighbouring elements of one
// partial, so every load is coalesced, and the loop over s needs no
// shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;

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

template <class In, class Acc, class Out>
__global__ void __launch_bounds__(THREADS)
addertree_kernel(const In* __restrict__ p, Out* __restrict__ out, int S,
                 long long n) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    Acc a = widen(p[i]);
    for (int s = 1; s < S; ++s) a = a + widen(p[s * n + i]);
    put(out + i, a);
  }
}

template <class In, class Acc, class Out>
int launch(const void* p, void* out, int S, long long n, cudaStream_t st) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  addertree_kernel<In, Acc, Out><<<grid, THREADS, 0, st>>>(
      static_cast<const In*>(p), static_cast<Out*>(out), S, n);
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
