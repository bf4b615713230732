// The fused ResNet identity bottleneck for Hopper (sm_90a), bound with
// ctypes by ops/cuda_bottleneck.py.
//
// K5 tclip_bottleneck replaces _kernel (fused_identity_bottleneck) of
//    transductive_clip_tpu/ops/pallas_bottleneck.py. For x [B, H, W, C] (NHWC),
//    w1 [C, Cm], w2 [3, 3, Cm, Cm] (HWIO), w3 [Cm, C] and the biases of the
//    folded BatchNorms, in the TPU kernel's roundings (T is x's dtype):
//      h1  = T(relu(x . w1 + b1))                 fp32 sums and bias
//      h2  = T(relu(conv3x3(h1, pad 1) . w2 + b2))
//      out = relu(T(T(T(h2 . w3) + T(b3)) + x))   the adds in T
//    Products of two T values are exact in fp32, and every sum is fp32, as
//    the TPU's bf16 x bf16 -> fp32 dots.
//
// Design. The TPU instance holds one whole image in VMEM. Here layer1's
// zero-padded hidden block alone is [58, 58, 64] bf16 = 420 KB and layer4's
// w2 is 4.5 MB, over a block's 227 KB of shared memory. So one block of 256
// threads owns an (image, strip of R output rows):
//   1. conv1 over the strip's rows plus a one-row halo above and below
//      ((R + 2) W pixels), + b1, relu, rounded to T, into shared memory as
//      h1 [R + 2][W + 2][Cm] with zero columns left and right; halo rows
//      outside the image are zero (conv2's padding);
//   2. conv2 as a 9-tap sum over h1, + b2, relu, rounded to T, into shared
//      memory as h2 [R W][Cm];
//   3. conv3 over h2 streaming the output channels, then the T roundings and
//      adds of the formula, straight to out.
// Each convolution is a product M x K times K x N (pixels x input channels
// times input x output channels; conv2's K is 9 Cm, tap-major as w2's HWIO
// layout) walked in 64 x 64 output tiles, 16 deep: the A slice and the weight
// slice are staged in shared memory as fp32, and each thread sums a 4 x 4
// register tile in FFMA. The weights come from device memory and L2 (they
// are shared by every block), in the layout above, made once at load by
// models/clip/resnet.py. The strip height R is the largest that fits the
// shared-memory budget of ops/cuda_bottleneck.py (two blocks an SM); the
// last strip of an image may be shorter, and ragged tiles are masked, so
// any H, W, C and Cm work. The conv1 halo rows are computed twice, by the
// two strips that share them.
//
// Bound. At the RN50 identity blocks and batch 512 a launch is 2.2e11
// operations (the three convolutions; the same at every stage), 0.23 ms at
// 989 TFLOP/s of bf16 tensor cores, against 1.6, 0.8, 0.4 and 0.2 GB of x,
// out and weights in bf16 (layer1 to layer4; 0.49 and 0.25 ms at 3.35 TB/s
// for layer1 and layer2): bound by bytes in the first two stages and by
// operations in the last two. This first kernel runs FFMA in both types,
// without tensor cores (fp32 FFMA peaks at 67 TFLOP/s: 3.3 ms a launch).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tclip {

constexpr int kThreads = 256;
constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kAPitch = kTileK + 1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// C[M, N] = A[M, K] . B[K, N] in 64 x 64 tiles; a_at(m, k) reads A (m < M,
// k < K), B is row-major [K][N] in device memory, epi(m, n, sum) takes each
// output. Every thread of the block must call it.
template <typename T, typename AFn, typename Epi>
__device__ void block_gemm(int M, int N, int K, const AFn& a_at,
                           const T* __restrict__ B, const Epi& epi, float* As,
                           float* Bs) {
  const int t = threadIdx.x;
  const int tn = t & 15;   // output columns tn*4 .. tn*4+3
  const int tm = t >> 4;   // output rows tm + 16 i
  for (int n0 = 0; n0 < N; n0 += kTileN) {
    for (int m0 = 0; m0 < M; m0 += kTileM) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kTileK) {
        for (int e = t; e < kTileM * kTileK; e += kThreads) {
          const int mm = e >> 4, kk = e & 15;
          const int m = m0 + mm, k = k0 + kk;
          As[mm * kAPitch + kk] = (m < M && k < K) ? a_at(m, k) : 0.f;
        }
        for (int e = t; e < kTileK * kTileN; e += kThreads) {
          const int kk = e >> 6, nn = e & 63;
          const int k = k0 + kk, n = n0 + nn;
          Bs[e] = (k < K && n < N) ? to_float(B[(size_t)k * N + n]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kTileK; ++kk) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[(tm + 16 * i) * kAPitch + kk];
          const float4 b =
              *reinterpret_cast<const float4*>(Bs + kk * kTileN + tn * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
            acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
            acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
            acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + tm + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tn * 4 + j;
          if (n < N) epi(m, n, acc[i][j]);
        }
      }
    }
  }
}

// bytes of shared memory for strips of R rows
__host__ __device__ inline size_t smem_bytes(int W, int Cm, int R,
                                             size_t item) {
  return sizeof(float) * (kTileM * kAPitch + kTileK * kTileN)
         + item * ((size_t)(R + 2) * (W + 2) * Cm + (size_t)R * W * Cm);
}

// grid (B * ceil(H / R))
template <typename T>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ w2,
                  const float* __restrict__ b2, const T* __restrict__ w3,
                  const T* __restrict__ b3, T* __restrict__ out, int H, int W,
                  int C, int Cm, int R) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kTileM * kAPitch;   // 1088 floats: 16-byte aligned
  T* h1 = reinterpret_cast<T*>(Bs + kTileK * kTileN);
  const int Wp = W + 2;
  T* h2 = h1 + (size_t)(R + 2) * Wp * Cm;
  const int strips = (H + R - 1) / R;
  const int img = blockIdx.x / strips;
  const int y0 = (blockIdx.x % strips) * R;
  const int rows = min(R, H - y0);
  const T* xi = x + (size_t)img * H * W * C;
  T* oi = out + (size_t)img * H * W * C;

  // the zero columns left and right of h1
  for (int e = threadIdx.x; e < (rows + 2) * 2 * Cm; e += kThreads) {
    const int hr = e / (2 * Cm), rem = e % (2 * Cm);
    const int col = rem < Cm ? 0 : W + 1;
    h1[((size_t)hr * Wp + col) * Cm + rem % Cm] = from_float<T>(0.f);
  }

  // 1. conv1 + b1, relu, over rows y0 - 1 .. y0 + rows
  block_gemm<T>(
      (rows + 2) * W, Cm, C,
      [&](int m, int k) -> float {
        const int hr = m / W, col = m - hr * W, y = y0 - 1 + hr;
        return (y >= 0 && y < H)
            ? to_float(xi[((size_t)y * W + col) * C + k]) : 0.f;
      },
      w1,
      [&](int m, int n, float s) {
        const int hr = m / W, col = m - hr * W, y = y0 - 1 + hr;
        const float v = (y >= 0 && y < H) ? fmaxf(s + b1[n], 0.f) : 0.f;
        h1[((size_t)hr * Wp + col + 1) * Cm + n] = from_float<T>(v);
      },
      As, Bs);
  __syncthreads();

  // 2. conv2 (3 x 3, the 9 taps tap-major) + b2, relu
  block_gemm<T>(
      rows * W, Cm, 9 * Cm,
      [&](int m, int k) -> float {
        const int r = m / W, col = m - r * W;
        const int tap = k / Cm, ci = k - tap * Cm;
        const int dh = tap / 3, dw = tap - dh * 3;
        return to_float(h1[((size_t)(r + dh) * Wp + col + dw) * Cm + ci]);
      },
      w2,
      [&](int m, int n, float s) {
        h2[(size_t)m * Cm + n] = from_float<T>(fmaxf(s + b2[n], 0.f));
      },
      As, Bs);
  __syncthreads();

  // 3. conv3, + b3 and + x in T, relu
  block_gemm<T>(
      rows * W, C, Cm,
      [&](int m, int k) -> float { return to_float(h2[(size_t)m * Cm + k]); },
      w3,
      [&](int m, int n, float s) {
        const size_t off = ((size_t)y0 * W + m) * C + n;
        float v = round_to<T>(s);
        v = round_to<T>(v + to_float(b3[n]));
        v = round_to<T>(v + to_float(xi[off]));
        oi[off] = from_float<T>(fmaxf(v, 0.f));
      },
      As, Bs);
}

template <typename T>
int launch(const void* x, const void* w1, const float* b1, const void* w2,
           const float* b2, const void* w3, const void* b3, void* out, int B,
           int H, int W, int C, int Cm, int R, cudaStream_t stream) {
  const size_t smem = smem_bytes(W, Cm, R, sizeof(T));
  auto kernel = bottleneck_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int strips = (H + R - 1) / R;
  kernel<<<B * strips, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<const T*>(w3),
      static_cast<const T*>(b3), static_cast<T*>(out), H, W, C, Cm, R);
  return (int)cudaGetLastError();
}

}  // namespace tclip

extern "C" {

// K5. x and out [B, H, W, C], w1 [C, Cm], w2 [3, 3, Cm, Cm], w3 [Cm, C] and
// b3 [C] in T (fp32: bf16 = 0, bf16: bf16 = 1); b1 and b2 [Cm] fp32; all
// contiguous. R: output rows a block (ops/cuda_bottleneck.strip_rows).
// Returns the CUDA error of the launch (0 on success).
int tclip_bottleneck(const void* x, const void* w1, const float* b1,
                     const void* w2, const float* b2, const void* w3,
                     const void* b3, void* out, int B, int H, int W, int C,
                     int Cm, int R, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tclip::launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, B, H,
                                        W, C, Cm, R, st);
  return tclip::launch<float>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, C, Cm,
                              R, st);
}

const char* tclip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
