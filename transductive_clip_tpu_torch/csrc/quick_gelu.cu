// QuickGELU for Hopper (sm_90a), bound with ctypes by ops/cuda_gelu.py.
//
// tclip_quick_gelu — out = x * sigmoid(1.702 x), elementwise over n
// contiguous elements, in fp32, bf16 or fp16: the activation between the
// CLIP transformers' c_fc and c_proj (models/clip/layers.py, QuickGELU).
//
// It replaces no Pallas kernel: the JAX package's QuickGELU
// (transductive_clip_tpu/models/clip/layers.py) is plain XLA, which fuses
// the chain into one loop. PyTorch runs x * torch.sigmoid(1.702 * x) as
// three kernels (the scaling, the sigmoid, the product) and seven tensor
// passes over the MLP's hidden activations: 14 bytes an element in bf16,
// against 4 for one read and one write. Each of the three ran near its
// bytes bound, so the loss was the number of passes.
//
// What bounds it: bytes. One read of x and one write of out; at 3.35 TB/s
// the [512, 577, 4096] bf16 hidden of a ViT-L/14@336px layer takes 1.45 ms.
// The arithmetic (an expf, an IEEE division, three roundings an element)
// is about as much as the SMs issue at that rate, so the design keeps
// memory busy with little else:
// * a thread moves 16 bytes at a time, kUnroll packs of them, all loads
//   issued before the first is used (64 bytes a thread in flight);
//   neighbouring threads take neighbouring packs, so a warp's load is 512
//   contiguous bytes;
// * one pass over the grid, no grid-stride loop: a block takes kThreads x
//   kUnroll packs; the n % (16 / element size) elements past the last whole
//   pack are done one a thread by the last block;
// * offsets are 64-bit (the ViT-L/14@336px hidden at batch 512 is 1.21e9
//   elements);
// * where either pointer is not on 16 bytes, the same kernel runs one
//   element a pack (V = 1), chosen here from the pointers alone.
//
// Arithmetic: PyTorch's chain, so that the output is bit-equal to it on the
// card. Each op computes in fp32 (opmath) and rounds to the element type to
// nearest even:
//   t = round(1.702f * x)                    (mul by a scalar: the double
//                                             1.702 taken as a float)
//   s = round(1.0f / (1.0f + expf(-t)))      (sigmoid: IEEE division, the
//                                             accurate expf)
//   y = round(x * s)
// In fp32 the rounding is the identity. No __expf, no __fdividef.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math (as PyTorch is built).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tclip {
namespace gelu {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kVectorBytes = 16;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}

// the chain's three ops, each rounded to T as PyTorch stores it
template <typename T>
__device__ __forceinline__ T quick_gelu(T x) {
  const float xf = widen(x);
  const float t = widen(narrow<T>(1.702f * xf));
  const float s = widen(narrow<T>(1.0f / (1.0f + expf(-t))));
  return narrow<T>(xf * s);
}

// V elements of T a pack (16 bytes, or 1)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    quick_gelu_kernel(const T* __restrict__ x, T* __restrict__ out,
                      long long n) {
  using P = Pack<T, V>;
  const long long packs = n / V;
  const long long first =
      static_cast<long long>(blockIdx.x) * (kThreads * kUnroll) + threadIdx.x;
  const P* xp = reinterpret_cast<const P*>(x);
  P* op = reinterpret_cast<P*>(out);
  P in[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long p = first + static_cast<long long>(u) * kThreads;
    if (p < packs) in[u] = xp[p];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long p = first + static_cast<long long>(u) * kThreads;
    if (p < packs) {
      P o;
#pragma unroll
      for (int e = 0; e < V; ++e) o.v[e] = quick_gelu<T>(in[u].v[e]);
      op[p] = o;
    }
  }
  if constexpr (V > 1) {
    // the n % V elements past the last whole pack
    if (blockIdx.x == gridDim.x - 1) {
      const long long e = packs * V + threadIdx.x;
      if (e < n) out[e] = quick_gelu<T>(x[e]);
    }
  }
}

template <typename T, int V>
int launch_vector(const void* x, void* out, long long n, cudaStream_t st) {
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  long long blocks = (n / V + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;  // the tail alone, when n < V
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  quick_gelu_kernel<T, V><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_type(const void* x, void* out, long long n, cudaStream_t st) {
  constexpr int kWide = kVectorBytes / sizeof(T);
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
       kVectorBytes) == 0)
    return launch_vector<T, kWide>(x, out, n, st);
  return launch_vector<T, 1>(x, out, n, st);
}

}  // namespace gelu
}  // namespace tclip

// x and out: n contiguous elements each; dtype 0 fp32, 1 bf16, 2 fp16.
// Returns the CUDA error of the launch (0 on success); n = 0 launches
// nothing.
extern "C" int tclip_quick_gelu(const void* x, void* out, long long n,
                                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  switch (dtype) {
    case 0:
      return tclip::gelu::launch_type<float>(x, out, n, st);
    case 1:
      return tclip::gelu::launch_type<__nv_bfloat16>(x, out, n, st);
    case 2:
      return tclip::gelu::launch_type<__half>(x, out, n, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
