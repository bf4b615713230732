// The alpha-TIM support-side cross-entropy gradient for Hopper (sm_90a),
// bound with ctypes by ops/cuda_tim.py.
//
// K3 tclip_tim_support_grad replaces the TPU kernel _support_grad_kernel of
//    transductive_clip_tpu/ops/pallas_tim.py (pallas_tim_support_grad_prepared).
//    Per task, over the support rows x_n [s, d] with labels y_n and the class
//    weights W [K, d]:
//      L[n, k] = temp * (x_n . w_k - 0.5 ||w_k||^2)
//      lse_n   = logsumexp_k L[n, k]
//      z_n     = L[n, y_n] - lse_n                     (log p_label)
//      log_p   = logaddexp(z_n, log TIM_EPS)           (log(p_label + eps))
//      sigma   = exp(z_n - log_p)
//      coef_n  = scale * sigma                         (Shannon)
//              = scale * -exp((1 - alpha) log_p) sigma (alpha)
//      G[n, k] = coef_n * (exp(L[n, k] - lse_n) - [k == y_n])
//    and returns gs_x = G^T x [K, d] and col = sum_n G[n, :] [K]. The
//    per-row shift -0.5 ||x_n||^2 of TIM's logits is left out, as on the TPU:
//    it cancels in the softmax and in z.
//
// Design. The TPU kernel walks the support rows in a sequential grid axis and
// adds every row block's G^T x into one [Kp, dp] accumulator kept in VMEM (4
// MB at the protocol). A Hopper grid has no order and a block has 227 KB of
// shared memory, so the work is split in two passes, with no atomics (the
// bits do not change from run to run):
//   (0) half_sq_norm_kernel: 0.5 ||w_k||^2 per (task, class), one warp a row,
//       from the unrounded fp32 weights in both precisions (pallas_tim.py
//       computes them in fp32 outside its kernel);
//   (a) support_logits_kernel: one block per (task, 128 support rows) walks
//       all K in 128-column tiles; each tile is a 128 x 128 x d product in
//       FFMA (8 x 8 outputs a thread, 16-deep slices of x and W staged in
//       shared memory). It writes L to an fp32 scratch [N, s, K] and keeps a
//       per-row online max and sum of exp and the label's logit in
//       registers (the 16 threads of a row combine theirs by shuffles); at the
//       end it writes lse_n and coef_n;
//   (b) support_grad_kernel: one block per (task, 128 classes, 128 features)
//       owns its output tile in registers and walks every support row in
//       16-row slices, forming G from L, lse and coef as it stages them, so G
//       never goes to device memory; the blocks of the first feature tile also
//       sum G over the rows for col.
//   Padding is replaced by masks: the ragged row, class and feature edges are
//   cut at s, K and d; labels are any int32 (a label outside [0, K) matches
//   no class, as the TPU kernel's iota comparison does).
//
// Precision. 'highest' (bf16 = 0): x and W fp32. 'default' (bf16 = 1): x
// arrives bf16, W is rounded to bf16 as it is staged, and G is rounded to
// bf16 before the second product (pallas_tim.py casts G to x's dtype); the
// products of two bf16 values are exact in fp32 and every sum is fp32, so
// FFMA gives the TPU's bf16 x bf16 -> fp32 products. The softmax and the
// coefficient are fp32 with IEEE expf and logf (no --use_fast_math).
//
// Bound. At the protocol (N = 100, s = 4000, K = d = 1000) a call is two
// products of 2 N s K d = 8e11 operations each, about 1.6e12; its bytes (x,
// W, gs_x once) are ~1 GB. So it is bound by operations: ~24 ms at the
// card's 67 TFLOP/s of fp32 FFMA ('highest'), ~1.6 ms at 989 TFLOP/s of bf16
// tensor cores ('default'). This first kernel runs both precisions in FFMA
// and writes and re-reads the 1.6 GB logits scratch; wgmma for 'default',
// TMA staging and one fused pass are the next steps (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace tclip {

constexpr int kTile = 128;   // rows and columns of a block's tile
constexpr int kDepth = 16;   // depth of a shared-memory slice
constexpr int kPad = 4;      // keeps a slice row 16-byte aligned
constexpr int kThreads = 256;
// log(TIM_EPS), TIM_EPS = 1e-12 (ops/common.py)
constexpr float kLogTimEps = -27.631021115928547f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the i-th of a thread's 8 rows (or columns) in a 128-wide tile: two groups
// of 4 at t*4 and 64 + t*4, so that a warp's float4 reads of a slice row
// cover contiguous 256-byte spans
__device__ __forceinline__ int tile_index(int t, int i) {
  return (i < 4 ? 0 : 64 - 4) + t * 4 + i;
}

__device__ __forceinline__ void load8(float (&v)[8], const float* row, int t) {
  const float4 lo = *reinterpret_cast<const float4*>(row + t * 4);
  const float4 hi = *reinterpret_cast<const float4*>(row + 64 + t * 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// over the 16 lanes that share a tile row (lanes 0-15 or 16-31 of a warp);
// every lane of the warp must call them
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// log(exp(a) + exp(b)) in the stable form jnp.logaddexp uses
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void half_sq_norm_kernel(const float* __restrict__ w,
                                    float* __restrict__ w2, int rows, int d) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;  // warp-uniform
  const float* row = w + (size_t)warp * d;
  float s = 0.0f;
  for (int j = lane; j < d; j += 32) s = fmaf(row[j], row[j], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) w2[warp] = 0.5f * s;
}

// one block an SM: the row statistics (32 registers) ride beside the 8 x 8
// accumulator, so the register cap of two blocks (128) would spill
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
support_logits_kernel(const T* __restrict__ x, const int* __restrict__ y,
                      const float* __restrict__ w, const float* __restrict__ w2,
                      float* __restrict__ logits, float* __restrict__ lse_out,
                      float* __restrict__ coef_out, int n_support, int k,
                      int d, float temp, float scale, float alpha,
                      int ce_alpha, int round_w) {
  __shared__ __align__(16) float xs[kDepth][kTile + kPad];
  __shared__ __align__(16) float ws[kDepth][kTile + kPad];
  const int task = blockIdx.y;
  const int row0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* xt = x + (size_t)task * n_support * d;
  const float* wt = w + (size_t)task * k * d;
  const float* w2t = w2 + (size_t)task * k;
  const int* yt = y + (size_t)task * n_support;
  float* lt = logits + (size_t)task * n_support * k;

  int label[8];
  float run_max[8], run_sum[8], lab[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + tile_index(ty, i);
    label[i] = r < n_support ? yt[r] : -1;
    run_max[i] = -INFINITY;
    run_sum[i] = 0.0f;
    lab[i] = 0.0f;
  }

  for (int k0 = 0; k0 < k; k0 += kTile) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

    for (int d0 = 0; d0 < d; d0 += kDepth) {
      for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
        const int r = e / kDepth;
        const int j = e % kDepth;
        const int gd = d0 + j;
        const int gr = row0 + r;
        xs[j][r] = (gr < n_support && gd < d) ? to_float(xt[(size_t)gr * d + gd])
                                              : 0.0f;
        const int gk = k0 + r;
        float wv = 0.0f;
        if (gk < k && gd < d) {
          wv = wt[(size_t)gk * d + gd];
          if (round_w) wv = round_bf16(wv);
        }
        ws[j][r] = wv;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kDepth; ++j) {
        float a[8], b[8];
        load8(a, &xs[j][0], ty);
        load8(b, &ws[j][0], tx);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
      }
      __syncthreads();
    }

    // epilogue: logits of this tile, written out and folded into the rows'
    // online max / sum of exp and label logit
    int col[8];
    float w2v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      col[c] = k0 + tile_index(tx, c);
      w2v[c] = col[c] < k ? w2t[col[c]] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + tile_index(ty, i);
      float tile_max = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (col[c] < k) {
          const float l = temp * (acc[i][c] - w2v[c]);
          acc[i][c] = l;
          tile_max = fmaxf(tile_max, l);
          if (r < n_support) lt[(size_t)r * k + col[c]] = l;
          if (col[c] == label[i]) lab[i] = l;
        }
      }
      const float m_new = fmaxf(run_max[i], half_warp_max(tile_max));
      float tile_sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (col[c] < k) tile_sum += expf(acc[i][c] - m_new);
      tile_sum = half_warp_sum(tile_sum);
      run_sum[i] = run_sum[i] * expf(run_max[i] - m_new) + tile_sum;
      run_max[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // one lane of the 16 holds the label's logit, the others 0
    const float l_lab = half_warp_sum(lab[i]);
    const int r = row0 + tile_index(ty, i);
    if (tx == 0 && r < n_support) {
      const float lse = run_max[i] + logf(run_sum[i]);
      const float z = l_lab - lse;
      const float log_p = logaddexp(z, kLogTimEps);
      const float sigma = expf(z - log_p);
      const float coef = ce_alpha ? -expf((1.0f - alpha) * log_p) * sigma : sigma;
      lse_out[(size_t)task * n_support + r] = lse;
      coef_out[(size_t)task * n_support + r] = scale * coef;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
support_grad_kernel(const T* __restrict__ x, const int* __restrict__ y,
                    const float* __restrict__ logits,
                    const float* __restrict__ lse,
                    const float* __restrict__ coef, float* __restrict__ gs_x,
                    float* __restrict__ col, int n_support, int k, int d,
                    int round_g) {
  __shared__ __align__(16) float gsm[kDepth][kTile + kPad];
  __shared__ __align__(16) float xsm[kDepth][kTile + kPad];
  const int task = blockIdx.z;
  const int k0 = blockIdx.y * kTile;
  const int d0 = blockIdx.x * kTile;
  const bool with_col = blockIdx.x == 0;  // block-uniform
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t row_base = (size_t)task * n_support;

  float acc[8][8], csum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    csum[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }

  for (int n0 = 0; n0 < n_support; n0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int j = e / kTile;
      const int c = e % kTile;
      const int n = n0 + j;
      float g = 0.0f, xv = 0.0f;
      if (n < n_support) {
        const size_t row = row_base + n;
        const int kc = k0 + c;
        if (kc < k) {
          const float p = expf(logits[row * k + kc] - lse[row]);
          g = coef[row] * (p - (y[row] == kc ? 1.0f : 0.0f));
          if (round_g) g = round_bf16(g);
        }
        const int dc = d0 + c;
        if (dc < d) xv = to_float(x[row * d + dc]);
      }
      gsm[j][c] = g;
      xsm[j][c] = xv;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      float a[8], b[8];
      load8(a, &gsm[j][0], ty);
      load8(b, &xsm[j][0], tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
        if (with_col) csum[i] += a[i];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kr = k0 + tile_index(ty, i);
    if (kr >= k) continue;
    float* out_row = gs_x + ((size_t)task * k + kr) * d;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int dc = d0 + tile_index(tx, c);
      if (dc < d) out_row[dc] = acc[i][c];
    }
    if (with_col && tx == 0) col[(size_t)task * k + kr] = csum[i];
  }
}

template <typename T>
int launch(const T* x, const int* y, const float* w, float* gs_x, float* col,
           float* logits, float* lse, float* coef, float* w2, int n_task,
           int n_support, int k, int d, float temp, float scale, float alpha,
           int ce_alpha, int bf16, cudaStream_t stream) {
  const int rows = n_task * k;
  half_sq_norm_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(w, w2, rows, d);
  support_logits_kernel<T>
      <<<dim3((n_support + kTile - 1) / kTile, n_task), kThreads, 0, stream>>>(
          x, y, w, w2, logits, lse, coef, n_support, k, d, temp, scale, alpha,
          ce_alpha, bf16);
  support_grad_kernel<T>
      <<<dim3((d + kTile - 1) / kTile, (k + kTile - 1) / kTile, n_task),
         kThreads, 0, stream>>>(x, y, logits, lse, coef, gs_x, col, n_support,
                                k, d, bf16);
  return (int)cudaGetLastError();
}

}  // namespace tclip

extern "C" const char* tclip_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Enqueues the three passes on `stream`, never synchronises, and returns
// cudaGetLastError() (0 on success). x is __nv_bfloat16 when bf16 != 0, else
// float; logits [N, s, K], lse and coef [N, s] and w2 [N, K] are fp32 scratch
// the caller allocates.
extern "C" int tclip_tim_support_grad(const void* x, const int* y, const float* w,
                                      float* gs_x, float* col, float* logits,
                                      float* lse, float* coef, float* w2,
                                      int n_task, int n_support, int k, int d,
                                      float temp, float scale, float alpha,
                                      int ce_alpha, int bf16, void* stream) {
  if (n_task <= 0 || n_task > 65535 || n_support <= 0 || k <= 0 || d <= 0 ||
      (long long)n_task * k > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return tclip::launch(static_cast<const __nv_bfloat16*>(x), y, w, gs_x, col,
                         logits, lse, coef, w2, n_task, n_support, k, d, temp,
                         scale, alpha, ce_alpha, 1, s);
  return tclip::launch(static_cast<const float*>(x), y, w, gs_x, col, logits,
                       lse, coef, w2, n_task, n_support, k, d, temp, scale,
                       alpha, ce_alpha, 0, s);
}
