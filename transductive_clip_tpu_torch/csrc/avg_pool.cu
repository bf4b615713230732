// The ResNet towers' average pool for Hopper (sm_90a), bound with ctypes by
// ops/cuda_pool.py.
//
// tclip_avg_pool — a k x k, stride-k, unpadded, floor-mode average pool over
// NHWC (channels_last) activations x [N, H, W, C] into out [N, H/k, W/k, C],
// in fp32, bf16 or fp16.
//
// It replaces no Pallas kernel: the JAX package pools with flax's
// nn.avg_pool (transductive_clip_tpu/models/clip/resnet.py, avg_pool) and
// leaves it to XLA. It was added because PyTorch's own NHWC kernel
// (avg_pool2d_out_cuda_frame_nhwc) ran the RN50 tower's seven 2 x 2 pools
// at ~11% of their bytes bound, about a third of the card's time in a bf16
// extraction: one thread an output element, 2-byte loads, four integer
// divisions an element.
//
// What bounds it: bytes. A 2 x 2 pool reads each input byte once and writes
// a quarter as many, with one add an input element; at 3.35 TB/s the RN50
// pools of a 50,000-image pass take ~0.11 s. The design keeps the memory
// system busy:
// * one thread an (output pixel, 16-byte channel group); neighbouring
//   threads take neighbouring groups, so each input row a warp reads is one
//   coalesced run of whole 128-byte lines, and each thread stores 16 bytes;
// * at the compiled window (K = 2) all K^2 loads of a thread are issued
//   before its first add: 64 bytes a thread in flight;
// * the (pixel, group) index is decoded once an item, in 32-bit unsigned
//   arithmetic when the items fit, and the element offsets are 64-bit (an
//   RN50x64 stem output at batch 512 has more than 2^31 elements);
// * a grid-stride loop.
// Where C times the element size is not a multiple of 16 bytes, or either
// pointer is not 16-byte aligned, the same kernel runs one element a thread
// (vector = 1); ops/cuda_pool.vector_width picks it from the shape, the
// dtype and the pointers alone.
//
// Arithmetic: PyTorch's, so that the output is bit-equal to F.avg_pool2d
// on the card: the window summed in fp32 from 0, rows outer and columns
// inner, divided by k^2 (IEEE division: no fast math), rounded to the
// element type once, to nearest even.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace tclip {
namespace pool {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;
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

// V elements of T a thread (16 bytes, or 1); K > 0 the window at compile
// time, K == 0 the window k at run time; Index the type of the item index.
template <typename T, int V, int K, typename Index>
__global__ void __launch_bounds__(kThreads)
    avg_pool_kernel(const T* __restrict__ x, T* __restrict__ out, Index items,
                    int groups, int wo_n, int ho_n, int h, int w, int c,
                    int k_run) {
  using P = Pack<T, V>;
  const int k = K > 0 ? K : k_run;
  const float divisor = static_cast<float>(k * k);
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index i = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < items; i += stride) {
    const Index pixel = i / groups;
    const int g = static_cast<int>(i - pixel * groups);
    const Index row = pixel / wo_n;
    const int wo = static_cast<int>(pixel - row * wo_n);
    const long long n = static_cast<long long>(row / ho_n);
    const int ho = static_cast<int>(row - static_cast<Index>(n) * ho_n);
    const T* top = x + ((n * h + static_cast<long long>(ho) * k) * w +
                        static_cast<long long>(wo) * k) *
                           c +
                   static_cast<long long>(g) * V;
    float s[V];
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] = 0.0f;
    if constexpr (K > 0) {
      P in[K * K];
#pragma unroll
      for (int dh = 0; dh < K; ++dh)
#pragma unroll
        for (int dw = 0; dw < K; ++dw)
          in[dh * K + dw] = *reinterpret_cast<const P*>(
              top + (static_cast<long long>(dh) * w + dw) * c);
#pragma unroll
      for (int j = 0; j < K * K; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e) s[e] += widen(in[j].v[e]);
    } else {
      for (int dh = 0; dh < k; ++dh)
        for (int dw = 0; dw < k; ++dw) {
          const P p = *reinterpret_cast<const P*>(
              top + (static_cast<long long>(dh) * w + dw) * c);
#pragma unroll
          for (int e = 0; e < V; ++e) s[e] += widen(p.v[e]);
        }
    }
    P o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.v[e] = narrow<T>(s[e] / divisor);
    // out is [N, H/k, W/k, C] with C = groups V: item i starts at i V
    *reinterpret_cast<P*>(out + static_cast<long long>(i) * V) = o;
  }
}

template <typename T, int V, int K>
int launch_window(const T* x, T* out, long long items, int groups, int wo_n,
                  int ho_n, int h, int w, int c, int k, cudaStream_t st) {
  const long long blocks =
      std::min((items + kThreads - 1) / kThreads, kMaxBlocks);
  if (items <= 0x7fffffffLL)
    avg_pool_kernel<T, V, K, unsigned><<<(unsigned)blocks, kThreads, 0, st>>>(
        x, out, (unsigned)items, groups, wo_n, ho_n, h, w, c, k);
  else
    avg_pool_kernel<T, V, K, unsigned long long>
        <<<(unsigned)blocks, kThreads, 0, st>>>(
            x, out, (unsigned long long)items, groups, wo_n, ho_n, h, w, c,
            k);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_vector(const void* xv, void* outv, int n, int h, int w, int c,
                  int k, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  if (c % V != 0) return (int)cudaErrorInvalidValue;
  if (V > 1 && ((reinterpret_cast<uintptr_t>(x) |
                 reinterpret_cast<uintptr_t>(out)) %
                kVectorBytes) != 0)
    return (int)cudaErrorInvalidValue;
  const int ho_n = h / k, wo_n = w / k, groups = c / V;
  const long long items = (long long)n * ho_n * wo_n * groups;
  if (k == 2)
    return launch_window<T, V, 2>(x, out, items, groups, wo_n, ho_n, h, w, c,
                                  k, st);
  return launch_window<T, V, 0>(x, out, items, groups, wo_n, ho_n, h, w, c, k,
                                st);
}

template <typename T>
int launch_type(const void* x, void* out, int n, int h, int w, int c, int k,
                int vector, cudaStream_t st) {
  constexpr int kWide = kVectorBytes / sizeof(T);
  if (vector == kWide)
    return launch_vector<T, kWide>(x, out, n, h, w, c, k, st);
  if (vector == 1) return launch_vector<T, 1>(x, out, n, h, w, c, k, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace pool
}  // namespace tclip

// x [N, H, W, C] and out [N, H / k, W / k, C], contiguous; dtype 0 fp32,
// 1 bf16, 2 fp16; vector: the elements a thread loads at once, 16 bytes'
// worth (C a multiple of it, both pointers on 16 bytes) or 1. Returns the
// CUDA error of the launch (0 on success).
extern "C" int tclip_avg_pool(const void* x, void* out, int n, int h, int w,
                              int c, int k, int dtype, int vector,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || c <= 0 || k <= 0 || h < k || w < k)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return tclip::pool::launch_type<float>(x, out, n, h, w, c, k, vector,
                                             st);
    case 1:
      return tclip::pool::launch_type<__nv_bfloat16>(x, out, n, h, w, c, k,
                                                     vector, st);
    case 2:
      return tclip::pool::launch_type<__half>(x, out, n, h, w, c, k, vector,
                                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
