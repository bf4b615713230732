// CLIP multi-head self-attention over a fused qkv projection, for Hopper
// (sm_90a), bound with ctypes by ops/cuda_attention.py.
//
// K4a tclip_attention_rows replaces _attn_kernel (fused_attention) of
//     transductive_clip_tpu/ops/pallas_attention.py: one program per sequence.
// K4b tclip_attention_blocked replaces _attn_kernel_blocked
//     (_fused_attention_blocked) of the same file: one program per (sequence,
//     block of q rows).
//
// Both compute, for every sequence and head h of a fused qkv [b, n, 3w]
// (q | k | v, the heads contiguous inside each third, head_dim 64), in the
// TPU kernel's order of operations:
//   1. s = q_h . k_h^T, the dot in fp32 from the qkv dtype (bf16 x bf16
//      products are exact in fp32);
//   2. s = s * scale;
//   3. s = s + mask (the optional additive [n, n] mask, as fp32);
//   4. m = max_j s, e = exp(s - m), p = e / sum_j e, all fp32;
//   5. p rounded to the qkv dtype;
//   6. o = p . v_h accumulated in fp32;
//   7. o rounded to the qkv dtype, written to out[b, n, h*64 : h*64 + 64].
// The softmax normalises every row before p is rounded (step 5 after step
// 4). An online softmax (a running max and sum, the division at the end)
// would round the unnormalised exp instead and give other bf16 values, so
// both kernels hold a whole row of scores: a row group's [64, n] fp32
// scores live in shared memory, never in device memory. A causal row always
// has its diagonal unmasked, so its max is finite; all -inf rows are not
// special-cased.
//
// Design. A block of 256 threads works on row groups of 64 q rows of one
// (sequence, head). Keys and values are staged in chunks of 64 rows, as fp32
// (the bf16 values are exact in fp32). The q . k^T and p . v products are
// FFMA with register tiles: warp w owns rows 8w..8w+7 of the group and lane
// l owns columns l and l + 32 (16 sums a thread); q and p are read as
// broadcast float4s, k and v rows at an odd pitch (65) so that the 32 lanes
// of a warp read 32 banks.
//   K4a (rows): one block per (sequence, head) keeps that head's k and v in
//     shared memory for the whole sequence and walks its row groups. Used
//     where they fit the budget in ops/cuda_attention.py (two blocks an SM):
//     text n = 77, ViT-B/32 n = 50.
//   K4b (blocked): one block per (sequence, head, row group) streams k and
//     v through one 64-row tile. Used for the longer sequences (ViT-B/16
//     n = 197, ViT-L/14 n = 257, ViT-L/14@336px n = 577: 181.5 KB of shared
//     memory, one block an SM).
// The TPU kernel keeps the whole [n, 3w] row block of an image in VMEM and
// loops over the heads; at ViT-B/16 bf16 that is 908 KB, so here a head, not
// an image, is a block's unit of work.
//
// Bound. 4 b heads n^2 64 operations (two products) against the bytes of
// qkv and out: at the text tower's [1000, 77, 3 x 512] bf16, 1.2e10
// operations (0.012 ms at 989 TFLOP/s of bf16 tensor cores) against 0.32 GB
// (0.094 ms at 3.35 TB/s): bound by bytes; at ViT-L/14@336px fp32
// [64, 577, 3 x 1024], 8.7e10 operations at 67 TFLOP/s of fp32 (1.3 ms)
// against 0.6 GB (0.18 ms): bound by operations. This first kernel runs
// FFMA in both types, without tensor cores, and recomputes nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math (IEEE expf and division).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace tclip {

constexpr int kHeadDim = 64;
constexpr int kRows = 64;              // q rows of a row group
constexpr int kKeys = 64;              // rows of a k / v chunk
constexpr int kThreads = 256;
constexpr int kKvPitch = kHeadDim + 1;

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

// q rows [row0, row0 + 64) of head h into q [64][64] as fp32; rows past n
// are zero
template <typename T>
__device__ void load_q(float* q, const T* __restrict__ qkv, size_t seq_off,
                       int n, int width, int h, int row0) {
  const int w3 = 3 * width;
  for (int e = threadIdx.x; e < kRows * kHeadDim; e += kThreads) {
    const int r = e >> 6, d = e & 63, row = row0 + r;
    q[e] = row < n
        ? to_float(qkv[seq_off + (size_t)row * w3 + h * kHeadDim + d]) : 0.f;
  }
}

// rows [j0, j0 + count) of the k (which = 1) or v (which = 2) third of head h
// into dst [.][65] as fp32, then zero rows up to the next multiple of 4
template <typename T>
__device__ void load_kv(float* dst, const T* __restrict__ qkv, size_t seq_off,
                        int width, int h, int which, int j0, int count) {
  const int w3 = 3 * width;
  const int padded = (count + 3) & ~3;
  for (int e = threadIdx.x; e < padded * kHeadDim; e += kThreads) {
    const int j = e >> 6, d = e & 63;
    dst[j * kKvPitch + d] = j < count
        ? to_float(qkv[seq_off + (size_t)(j0 + j) * w3 + which * width
                       + h * kHeadDim + d])
        : 0.f;
  }
}

// scores of the group's rows against one chunk of nk keys (kt: its first
// row), steps 1-3, into s[row][col0 + j]
__device__ void scores(const float* q, const float* kt, int nk, float* s,
                       int sp, int col0, int rows, int row0, int n,
                       const float* __restrict__ mask, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // lanes past the chunk read its last row; their sums are not stored
  const float* k0 = kt + min(lane, nk - 1) * kKvPitch;
  const float* k1 = kt + min(lane + 32, nk - 1) * kKvPitch;
  float acc[8][2];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kHeadDim; d += 4) {
    const float a0 = k0[d], a1 = k0[d + 1], a2 = k0[d + 2], a3 = k0[d + 3];
    const float c0 = k1[d], c1 = k1[d + 1], c2 = k1[d + 2], c3 = k1[d + 3];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 qv =
          *reinterpret_cast<const float4*>(q + (warp * 8 + r) * kHeadDim + d);
      acc[r][0] = fmaf(qv.x, a0, acc[r][0]);
      acc[r][0] = fmaf(qv.y, a1, acc[r][0]);
      acc[r][0] = fmaf(qv.z, a2, acc[r][0]);
      acc[r][0] = fmaf(qv.w, a3, acc[r][0]);
      acc[r][1] = fmaf(qv.x, c0, acc[r][1]);
      acc[r][1] = fmaf(qv.y, c1, acc[r][1]);
      acc[r][1] = fmaf(qv.z, c2, acc[r][1]);
      acc[r][1] = fmaf(qv.w, c3, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = warp * 8 + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j >= nk) continue;
      float v = acc[r][c] * scale;
      if (mask != nullptr) v += mask[(size_t)(row0 + row) * n + col0 + j];
      s[row * sp + col0 + j] = v;
    }
  }
}

// step 4 and 5 on the group's valid rows, one warp a row
template <typename T>
__device__ void softmax_rows(float* s, int sp, int rows, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < rows; row += kThreads / 32) {
    float* sr = s + row * sp;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sr[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < n; j += 32) sr[j] = round_to<T>(sr[j] / sum);
  }
}

// step 6 over one chunk of nk values (vt: its first row; rows up to the next
// multiple of 4 are zero, as are the score columns past n)
__device__ void pv(const float* s, int sp, const float* vt, int nk, int col0,
                   float (&acc)[8][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int padded = (nk + 3) & ~3;
  for (int j = 0; j < padded; j += 4) {
    float v0[4], v1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v0[i] = vt[(j + i) * kKvPitch + lane];
      v1[i] = vt[(j + i) * kKvPitch + lane + 32];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 p =
          *reinterpret_cast<const float4*>(s + (warp * 8 + r) * sp + col0 + j);
      acc[r][0] = fmaf(p.x, v0[0], acc[r][0]);
      acc[r][0] = fmaf(p.y, v0[1], acc[r][0]);
      acc[r][0] = fmaf(p.z, v0[2], acc[r][0]);
      acc[r][0] = fmaf(p.w, v0[3], acc[r][0]);
      acc[r][1] = fmaf(p.x, v1[0], acc[r][1]);
      acc[r][1] = fmaf(p.y, v1[1], acc[r][1]);
      acc[r][1] = fmaf(p.z, v1[2], acc[r][1]);
      acc[r][1] = fmaf(p.w, v1[3], acc[r][1]);
    }
  }
}

// step 7
template <typename T>
__device__ void store_rows(T* __restrict__ out, size_t seq_off_out, int width,
                           int h, int row0, int rows,
                           const float (&acc)[8][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = warp * 8 + r;
    if (row >= rows) continue;
    T* o = out + seq_off_out + (size_t)(row0 + row) * width + h * kHeadDim;
    o[lane] = from_float<T>(acc[r][0]);
    o[lane + 32] = from_float<T>(acc[r][1]);
  }
}

// the score row pitch: n rounded up to a multiple of 4 (float4 reads of p)
__host__ __device__ inline int score_pitch(int n) { return (n + 3) & ~3; }

// the columns [n, sp) of every score row are zero for the p . v reads
__device__ void zero_score_padding(float* s, int sp, int n) {
  const int pad = sp - n;
  for (int e = threadIdx.x; e < kRows * pad; e += kThreads)
    s[(e / pad) * sp + n + e % pad] = 0.f;
}

// K4a: grid (b * heads); shared memory q [64][64], s [64][sp], k and v of
// the head [sp][65] each
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_rows_kernel(const T* __restrict__ qkv,
                      const float* __restrict__ mask, T* __restrict__ out,
                      int n, int heads, float scale) {
  extern __shared__ float4 smem4[];
  float* q = reinterpret_cast<float*>(smem4);
  const int sp = score_pitch(n);
  float* s = q + kRows * kHeadDim;
  float* kh = s + kRows * sp;
  float* vh = kh + sp * kKvPitch;
  const int width = heads * kHeadDim;
  const int seq = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t seq_off = (size_t)seq * n * 3 * width;
  load_kv(kh, qkv, seq_off, width, h, 1, 0, n);
  load_kv(vh, qkv, seq_off, width, h, 2, 0, n);
  zero_score_padding(s, sp, n);
  for (int row0 = 0; row0 < n; row0 += kRows) {
    const int rows = min(kRows, n - row0);
    __syncthreads();   // the previous group is done with q and s
    load_q(q, qkv, seq_off, n, width, h, row0);
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += kKeys)
      scores(q, kh + j0 * kKvPitch, min(kKeys, n - j0), s, sp, j0, rows,
             row0, n, mask, scale);
    __syncthreads();
    softmax_rows<T>(s, sp, rows, n);
    __syncthreads();
    float acc[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int j0 = 0; j0 < n; j0 += kKeys)
      pv(s, sp, vh + j0 * kKvPitch, min(kKeys, n - j0), j0, acc);
    store_rows(out, (size_t)seq * n * width, width, h, row0, rows, acc);
  }
}

// K4b: grid (b * heads, ceil(n / 64)); shared memory q [64][64], s [64][sp],
// one k / v tile [64][65]
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_blocked_kernel(const T* __restrict__ qkv,
                         const float* __restrict__ mask, T* __restrict__ out,
                         int n, int heads, float scale) {
  extern __shared__ float4 smem4[];
  float* q = reinterpret_cast<float*>(smem4);
  const int sp = score_pitch(n);
  float* s = q + kRows * kHeadDim;
  float* tile = s + kRows * sp;
  const int width = heads * kHeadDim;
  const int seq = blockIdx.x / heads, h = blockIdx.x % heads;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, n - row0);
  const size_t seq_off = (size_t)seq * n * 3 * width;
  load_q(q, qkv, seq_off, n, width, h, row0);
  zero_score_padding(s, sp, n);
  for (int j0 = 0; j0 < n; j0 += kKeys) {
    const int nk = min(kKeys, n - j0);
    __syncthreads();
    load_kv(tile, qkv, seq_off, width, h, 1, j0, nk);
    __syncthreads();
    scores(q, tile, nk, s, sp, j0, rows, row0, n, mask, scale);
  }
  __syncthreads();
  softmax_rows<T>(s, sp, rows, n);
  float acc[8][2];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kKeys) {
    const int nk = min(kKeys, n - j0);
    __syncthreads();
    load_kv(tile, qkv, seq_off, width, h, 2, j0, nk);
    __syncthreads();
    pv(s, sp, tile, nk, j0, acc);
  }
  store_rows(out, (size_t)seq * n * width, width, h, row0, rows, acc);
}

size_t rows_smem_bytes(int n) {
  const int sp = score_pitch(n);
  return sizeof(float) * ((size_t)kRows * kHeadDim + (size_t)kRows * sp
                          + 2 * (size_t)sp * kKvPitch);
}

size_t blocked_smem_bytes(int n) {
  const int sp = score_pitch(n);
  return sizeof(float) * ((size_t)kRows * kHeadDim + (size_t)kRows * sp
                          + (size_t)kKeys * kKvPitch);
}

}  // namespace tclip

using tclip::kThreads;

extern "C" {

// K4a. qkv [b, n, 3 heads 64] and out [b, n, heads 64] contiguous, fp32
// (bf16 = 0) or bf16 (bf16 = 1); mask [n, n] fp32 or null. Returns the CUDA
// error of the launch (0 on success).
int tclip_attention_rows(const void* qkv, const float* mask, void* out, int b,
                         int n, int heads, float scale, int bf16,
                         void* stream) {
  const size_t smem = tclip::rows_smem_bytes(n);
  const dim3 grid(b * heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    auto k = tclip::attention_rows_kernel<__nv_bfloat16>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(qkv), mask,
        static_cast<__nv_bfloat16*>(out), n, heads, scale);
  } else {
    auto k = tclip::attention_rows_kernel<float>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kThreads, smem, st>>>(static_cast<const float*>(qkv), mask,
                                    static_cast<float*>(out), n, heads, scale);
  }
  return (int)cudaGetLastError();
}

// K4b, same arguments
int tclip_attention_blocked(const void* qkv, const float* mask, void* out,
                            int b, int n, int heads, float scale, int bf16,
                            void* stream) {
  const size_t smem = tclip::blocked_smem_bytes(n);
  const dim3 grid(b * heads, (n + tclip::kRows - 1) / tclip::kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    auto k = tclip::attention_blocked_kernel<__nv_bfloat16>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(qkv), mask,
        static_cast<__nv_bfloat16*>(out), n, heads, scale);
  } else {
    auto k = tclip::attention_blocked_kernel<float>;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kThreads, smem, st>>>(static_cast<const float*>(qkv), mask,
                                    static_cast<float*>(out), n, heads, scale);
  }
  return (int)cudaGetLastError();
}

const char* tclip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
