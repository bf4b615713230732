// Residual add and LayerNorm for Hopper (sm_90a), bound with ctypes by
// ops/cuda_add_norm.py.
//
// tclip_add_layer_norm — over `rows` rows of width w, in fp32, bf16 or fp16:
//   s = x + y                                   (written over y)
//   h = gamma * ((s - mean(s)) * rsqrt(var(s) + eps)) + beta
// the residual add of a CLIP transformer block and the LayerNorm that
// follows it (models/clip/layers.py, Transformer.forward: each block's
// first add with its ln_2, its second add with the next block's ln_1).
//
// It replaces no Pallas kernel: the JAX package's blocks
// (transductive_clip_tpu/models/clip/layers.py, ResidualAttentionBlock) are
// plain XLA, which fuses the add into the LayerNorm's loops. PyTorch runs
// them as two kernels: the add reads x and y and writes s (3 tensor
// passes), the LayerNorm reads s and writes h (2 more), and its Welford
// kernel ran at ~44% of its bytes bound at ViT-L/14@336px's width.
//
// What bounds it: bytes. x and y read once, s and h written once: 4 tensor
// passes, 2.42 GB for the [512 x 577, 1024] bf16 stream of a ViT-L/14@336px
// batch, 0.72 ms at 3.35 TB/s. The design keeps the row on chip:
// * one warp a row, kWarps rows a block; a lane takes the row's 16-byte
//   packs lane, lane + 32, ... (P of them: 4 at w = 1024 bf16, 3 at 768,
//   2 at 512), so a warp's load is 512 contiguous bytes;
// * all of a lane's loads of x and y are issued before the first is used;
//   the row stays in registers (as the rounded s), the mean and the
//   variance are warp-shuffle sums, with no shared memory and no second
//   read of device memory;
// * gamma and beta are read with the same 16-byte packs; every row of the
//   grid reads them, so they stay in L1;
// * element offsets are 64-bit (rows x w is 3.0e8 at ViT-L/14@336px's batch
//   of 512, and passes 2^31 at a larger one);
// * where w is not a whole number of packs or a pointer is not on 16 bytes
//   the same kernel runs one element a step (V = 1), chosen here from the
//   width and the pointers; a row of more than kRowBytes is refused.
//
// Arithmetic:
//   s = round(float(x) + float(y))   PyTorch's add: the fp32 sum, rounded
//                                    once to nearest even, so s is
//                                    bit-equal to x + y;
//   mean = sum(s) / w, var = sum((s - mean)^2) / w, both in fp32 from the
//   rounded s, as the LayerNorm of x + y sees it: two passes over the
//   registers (PyTorch's kernel takes Welford's one pass, so h is not
//   bit-equal to it; tests/test_torch_clip_add_layer_norm.py states the
//   tolerance against an fp32 LayerNorm of s);
//   rstd = rsqrtf(var + eps), the reciprocal square root PyTorch's kernel
//   takes (c10::cuda::compat::rsqrt of a float);
//   h = round(gamma * ((s - mean) * rstd) + beta), PyTorch's expression,
//   rounded once.
// In fp32 the rounding is the identity.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math (as PyTorch is built).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tclip {
namespace addnorm {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVectorBytes = 16;
// the widest row a warp holds in registers: 8 packs a lane, 1024 elements
// of fp32 or 2048 of bf16 and fp16
constexpr int kRowBytes = 32 * 8 * kVectorBytes;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V elements of T a pack (16 bytes, or 1), at most P packs a lane; pack j of
// a row lies with lane j % 32. ys holds y on entry and s on exit.
template <typename T, int V, int P>
__global__ void __launch_bounds__(kThreads)
    add_layer_norm_kernel(const T* __restrict__ x, T* ys,
                          const T* __restrict__ gamma,
                          const T* __restrict__ beta, T* __restrict__ h,
                          long long rows, int w, float eps) {
  using Pk = Pack<T, V>;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves: the shuffles stay full
  const int packs = w / V;
  const long long first = row * w;
  const Pk* xp = reinterpret_cast<const Pk*>(x + first);
  Pk* sp = reinterpret_cast<Pk*>(ys + first);
  Pk a[P], b[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = lane + 32 * p;
    if (j < packs) {
      a[p] = xp[j];
      b[p] = sp[j];
    }
  }
  // s, rounded to T, kept in a (the registers of x)
  float sum = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = lane + 32 * p;
    if (j < packs) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        a[p].v[e] = narrow<T>(widen(a[p].v[e]) + widen(b[p].v[e]));
        sum += widen(a[p].v[e]);
      }
      sp[j] = a[p];
    }
  }
  const float inv_w = 1.0f / static_cast<float>(w);
  const float mean = warp_sum(sum) * inv_w;
  float sq = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = lane + 32 * p;
    if (j < packs) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = widen(a[p].v[e]) - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_w + eps);
  const Pk* gp = reinterpret_cast<const Pk*>(gamma);
  const Pk* bp = reinterpret_cast<const Pk*>(beta);
  Pk* hp = reinterpret_cast<Pk*>(h + first);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = lane + 32 * p;
    if (j < packs) {
      const Pk g = gp[j], bb = bp[j];
      Pk o;
#pragma unroll
      for (int e = 0; e < V; ++e)
        o.v[e] = narrow<T>(widen(g.v[e]) *
                               ((widen(a[p].v[e]) - mean) * rstd) +
                           widen(bb.v[e]));
      hp[j] = o;
    }
  }
}

template <typename T, int V, int P>
int launch_geometry(const void* x, void* ys, const void* gamma,
                    const void* beta, void* h, long long rows, int w,
                    float eps, cudaStream_t st) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  add_layer_norm_kernel<T, V, P><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(ys),
      static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(h), rows, w, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_type(const void* x, void* ys, const void* gamma, const void* beta,
                void* h, long long rows, int w, float eps, cudaStream_t st) {
  constexpr int kWide = kVectorBytes / sizeof(T);
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(ys) |
                        reinterpret_cast<uintptr_t>(gamma) |
                        reinterpret_cast<uintptr_t>(beta) |
                        reinterpret_cast<uintptr_t>(h);
  if (w % kWide == 0 && any % kVectorBytes == 0) {
    switch ((w / kWide + 31) / 32) {  // 16-byte packs a lane
#define TCLIP_PACKS(P) \
  case P:              \
    return launch_geometry<T, kWide, P>(x, ys, gamma, beta, h, rows, w, eps, st);
      TCLIP_PACKS(1)
      TCLIP_PACKS(2)
      TCLIP_PACKS(3)
      TCLIP_PACKS(4)
      TCLIP_PACKS(5)
      TCLIP_PACKS(6)
      TCLIP_PACKS(7)
      TCLIP_PACKS(8)
#undef TCLIP_PACKS
    }
  }
  // one element a step: up to 8 a lane, else as many as the widest row
  if (w <= 32 * 8)
    return launch_geometry<T, 1, 8>(x, ys, gamma, beta, h, rows, w, eps, st);
  return launch_geometry<T, 1, kRowBytes / sizeof(T) / 32>(
      x, ys, gamma, beta, h, rows, w, eps, st);
}

}  // namespace addnorm
}  // namespace tclip

// x, y and h: rows x w contiguous elements each; gamma and beta: w each; all
// of one dtype, 0 fp32, 1 bf16, 2 fp16. s = x + y is written over y, the
// LayerNorm of s into h. Returns the CUDA error of the launch (0 on
// success); rows = 0 launches nothing; a row wider than kRowBytes is
// refused.
extern "C" int tclip_add_layer_norm(const void* x, void* y, const void* gamma,
                                    const void* beta, void* h, long long rows,
                                    int w, float eps, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 0 || w < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  switch (dtype) {
    case 0:
      if (w > tclip::addnorm::kRowBytes / 4) return (int)cudaErrorInvalidValue;
      return tclip::addnorm::launch_type<float>(x, y, gamma, beta, h, rows, w,
                                                eps, st);
    case 1:
      if (w > tclip::addnorm::kRowBytes / 2) return (int)cudaErrorInvalidValue;
      return tclip::addnorm::launch_type<__nv_bfloat16>(x, y, gamma, beta, h,
                                                        rows, w, eps, st);
    case 2:
      if (w > tclip::addnorm::kRowBytes / 2) return (int)cudaErrorInvalidValue;
      return tclip::addnorm::launch_type<__half>(x, y, gamma, beta, h, rows, w,
                                                 eps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
