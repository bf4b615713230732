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
// Bound. At the protocol (N = 100, s = 4000, K = d = 1000) a call is two
// products of 2 N s K d = 8e11 operations each; its bytes (x, W, gs_x once)
// are ~1 GB. So it is bound by operations: ~24 ms at the card's 67 TFLOP/s
// of fp32 FFMA ('highest'; TF32 stays off), ~1.6 ms at 989 TFLOP/s of bf16
// tensor cores ('default').
//
// Design. The TPU kernel holds a [128, Kp] block of logits, the softmax and
// G in VMEM between its two products and adds every row block's G^T x into
// one [Kp, dp] accumulator in a sequential grid. An SM has neither the 512
// KB for a row block of logits nor an order among its blocks, and the
// softmax needs a whole row of L before any of G. So a call is four passes
// on one stream, without atomics (the bits do not change from run to run),
// and both products are plain tiled products with one-line epilogues:
//   (0) prep_weights_kernel: 0.5 ||w_k||^2 per (task, class), one warp a
//       row, from the unrounded fp32 weights in both precisions; the same
//       read rounds W to bf16 once a call ('default') or copies it to a
//       16-byte row pitch ('highest', only when d is not a multiple of 4);
//   (1) logits_*_kernel: L = temp (x . W^T - w2), one block per (task, 128
//       rows, 128 classes), to an fp32 scratch [N, s, Kp];
//   (2) support_rows_kernel: one warp a support row reads its row of L once,
//       16 bytes a lane, into registers (up to 1024 classes; a longer row is
//       swept three times through L1), takes max, sum of exp, the label's
//       logit and the coefficient, and writes G once: rounded to bf16 into
//       its own scratch ('default'), or in fp32 over L itself ('highest'). G
//       is formed once (the first kernel formed it eight times, in every
//       feature tile of the second product);
//   (3) grad_*_kernel: gs_x = G^T x, one block per (task, 128 classes, 128
//       features) walks every support row; the blocks of the first feature
//       tile also sum G's columns for col (the sum of the rounded G in
//       'default').
//   Every product stages 16-byte cp.async copies through a ring of three
//   slices in shared memory: two slices load while one is multiplied, one
//   barrier a slice; two blocks of 8 warps an SM. A thread's copies of a
//   slice are one add apart (fill_slice): working each address out from the
//   thread's index cost 5% of a call.
//   'default', both products on tensor cores: mma.sync m16n8k16 (bf16 x
//     bf16 -> fp32, the TPU's products), fragments by ldmatrix, slices 64
//     deep (32-deep ones ran 1.2x slower: a barrier every 32 mma a warp). 8
//     warps as 2 x 4, a warp owns 64 x 32 of the tile: 6 ldmatrix.x4 for 16
//     mma a 16-step. The second product contracts over the support rows, the
//     slow axis of both G [s, Kp] and x [s, dp]: both operands are staged as
//     they lie and read with ldmatrix.trans. col is one more mma against a
//     fragment of ones. mma.sync and not wgmma: it is the route this
//     repository already runs (attention.cu); it leaves the products at
//     ~270 TFLOP/s, and a call still pays the trip of L and G through device
//     memory (4 GB, the row pass and a share of the first product's time).
//   'highest', fp32 FFMA (no TF32) with an 8 x 8 register tile a thread, 4
//     LDS.128 per 64 FMAs. The first product's operands are both contiguous
//     along d, so they are staged as [row][16 of d] (pitch 20 floats) and
//     read as float4 along d, rows and columns interleaved across the lanes
//     (4 row slots x 8 column slots a warp) so that no read conflicts; the
//     second product's operands are both contiguous across the contraction,
//     staged as [16 rows][128] and read as float4 across the tile. The first
//     form holds four steps of a thread's rows at once (32 registers) and
//     runs at 35 TFLOP/s, the second at 44.
//   Ragged edges are cut by masks: rows past s, classes past K and features
//   past d are zero in shared memory and never stored. The contraction over
//   d ends in a partial slice that is zero-filled. x comes padded to a
//   16-byte row pitch dp by ops/cuda_tim.prepare_support (no padding at
//   d = 1000); Kp is K rounded up to 8. Labels are any int32 (a label outside
//   [0, K) matches no class, as the TPU kernel's iota comparison does).
//
// Precision. 'highest' (bf16 = 0): x, W and G fp32. 'default' (bf16 = 1): x
// arrives bf16, W and G are rounded to bf16 once (pallas_tim.py casts G to
// x's dtype); the sums are fp32. The norms, the softmax and the coefficient
// are fp32 with IEEE expf and logf (no --use_fast_math).
//
// ptxas (-Xptxas -v, sm_90a): the four product kernels take 124 to 128
// registers, the cap of two blocks an SM. logits_f32_kernel sits on it with
// 216 bytes of spill stores, all outside its inner loop: with the 246
// registers it asks for (one block an SM, no spills) it ran the same 21.4
// ms. The others spill nothing. Shared memory 110,592 and 104,448 bytes a
// block ('default'), 61,440 and 50,688 ('highest'); the row pass 64 to 68
// registers, the weights' pass 24.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace tclip {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 128;     // rows and columns of a block's output tile
constexpr int kThreads = 256;
constexpr int kStages = 3;     // slices in the ring
// bf16 slices: 64 deep; [128][72] with the contraction contiguous (first
// product), [64][136] with the contraction across rows (second product)
constexpr int kDepthB = 64;
constexpr int kPitchKB = kDepthB + 8;
constexpr int kPitchMB = kTile + 8;
// fp32 slices: 16 deep; [128][20] and [16][132]
constexpr int kDepthF = 16;
constexpr int kPitchKF = kDepthF + 4;
constexpr int kPitchMF = kTile + 4;
// log(TIM_EPS), TIM_EPS = 1e-12 (ops/common.py)
constexpr float kLogTimEps = -27.631021115928547f;
// bf16 1.0 twice: the B fragment that sums G's columns
constexpr uint32_t kOnesBf16 = 0x3F803F80u;

// log(exp(a) + exp(b)) in the stable form jnp.logaddexp uses
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes from src when live, else zeros
__device__ __forceinline__ void copy_or_zero(void* dst, const void* src,
                                             bool live) {
  if (live)
    cp_async16(dst, src);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// A [ROWS][COLS] slice, its rows `ld` values apart in device memory, into
// [ROWS][PITCH] in shared memory, 16 bytes a copy. A thread takes one column
// piece of every kThreads / (pieces a row)-th row, so a copy's addresses are
// one add from the copy before; rows from live_rows on and pieces from
// column live_cols on are zero.
template <typename T, int ROWS, int COLS, int PITCH>
__device__ __forceinline__ void fill_slice(T* dst, const T* src, size_t ld,
                                           int live_rows, int live_cols) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kPerRow = COLS / kPer;
  constexpr int kRowStep = kThreads / kPerRow;
  const int c = threadIdx.x % kPerRow * kPer, r0 = threadIdx.x / kPerRow;
  const bool in_cols = c < live_cols;
  const T* p = src + (size_t)r0 * ld + c;
  T* d = dst + r0 * PITCH + c;
#pragma unroll
  for (int i = 0; i < ROWS / kRowStep; ++i)
    copy_or_zero(d + i * kRowStep * PITCH, p + (size_t)(i * kRowStep) * ld,
                 in_cols && r0 + i * kRowStep < live_rows);
}

// Walks `slices` slices through the ring: fill(slice, stage) starts the
// slice's copies, compute(stage) multiplies it. One barrier a slice: it
// shows slice i to every thread and frees the stage of slice i - 1, which
// the copies of slice i + kStages - 1 then overwrite.
template <typename Fill, typename Compute>
__device__ __forceinline__ void pipeline(int slices, const Fill& fill,
                                         const Compute& compute) {
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < slices) fill(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < slices; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = i + kStages - 1;
    if (next < slices) fill(next, next % kStages);
    cp_async_commit();
    compute(i % kStages);
  }
}

// (0) one warp a (task, class) row of the weights
__global__ void prep_weights_kernel(const float* __restrict__ w,
                                    float* __restrict__ w2,
                                    bf16* __restrict__ wb,
                                    float* __restrict__ wf, int rows, int d,
                                    int dp) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;  // warp-uniform
  const float* row = w + (size_t)warp * d;
  float s = 0.0f;
  for (int j = lane; j < dp; j += 32) {
    const float v = j < d ? row[j] : 0.0f;
    s = fmaf(v, v, s);
    if (wb != nullptr) wb[(size_t)warp * dp + j] = __float2bfloat16_rn(v);
    if (wf != nullptr) wf[(size_t)warp * dp + j] = v;
  }
  s = warp_sum(s);
  if (lane == 0) w2[warp] = 0.5f * s;
}

// (2) one warp a support row: L's row to G's row
template <typename G> __device__ __forceinline__ G to_g(float v);
template <> __device__ __forceinline__ float to_g<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 to_g<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// four values of G's row, stored at once
__device__ __forceinline__ void store4(float* g, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(g) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* g, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<uint2*>(g) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}

// from the row's max m, sum of exp(l - m) and label logit: lse and the
// scaled coefficient
__device__ __forceinline__ void row_coef(float m, float sum, float l_lab,
                                         float scale, float alpha,
                                         int ce_alpha, float& lse,
                                         float& coef) {
  lse = m + logf(sum);
  const float z = l_lab - lse;
  const float log_p = logaddexp(z, kLogTimEps);
  const float sigma = expf(z - log_p);
  coef = scale * (ce_alpha ? -expf((1.0f - alpha) * log_p) * sigma : sigma);
}

// A row of up to 32 x 4 x kRowCache values is read once, 16 bytes a lane,
// and kept in registers over the three sweeps; a longer row is swept three
// times through L1
constexpr int kRowCache = 8;

template <typename G>
__global__ void support_rows_kernel(float* logits, const int* __restrict__ y,
                                    G* g_out, int rows, int k, int kp,
                                    float scale, float alpha, int ce_alpha) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  const float* l = logits + (size_t)row * kp;
  G* g = g_out + (size_t)row * kp;
  const int label = y[row];
  const float l_lab = (label >= 0 && label < k) ? l[label] : 0.0f;
  float lse, coef;
  if (kp <= 128 * kRowCache) {
    float v[kRowCache][4];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kRowCache; ++i) {
      const int j = (lane + 32 * i) * 4;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < kp) q = *reinterpret_cast<const float4*>(l + j);
      v[i][0] = q.x; v[i][1] = q.y; v[i][2] = q.z; v[i][3] = q.w;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (j + c >= k) v[i][c] = -INFINITY;   // past K: exp gives 0
        m = fmaxf(m, v[i][c]);
      }
    }
    m = warp_max(m);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kRowCache; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sum += expf(v[i][c] - m);
    sum = warp_sum(sum);
    row_coef(m, sum, l_lab, scale, alpha, ce_alpha, lse, coef);
    // the shuffles above came after every lane's reads: G may overwrite L
#pragma unroll
    for (int i = 0; i < kRowCache; ++i) {
      const int j = (lane + 32 * i) * 4;
      if (j >= kp) continue;
      float o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[c] = j + c < k
            ? coef * (expf(v[i][c] - lse) - (j + c == label ? 1.0f : 0.0f))
            : 0.0f;
      store4(g + j, o[0], o[1], o[2], o[3]);
    }
    return;
  }
  float m = -INFINITY;
  for (int j = lane; j < k; j += 32) m = fmaxf(m, l[j]);
  m = warp_max(m);
  float sum = 0.0f;
  for (int j = lane; j < k; j += 32) sum += expf(l[j] - m);
  sum = warp_sum(sum);
  row_coef(m, sum, l_lab, scale, alpha, ce_alpha, lse, coef);
  __syncwarp();  // every lane has read the row before G overwrites it
  for (int j = lane; j < kp; j += 32) {
    float o = 0.0f;
    if (j < k) o = coef * (expf(l[j] - lse) - (j == label ? 1.0f : 0.0f));
    g[j] = to_g<G>(o);
  }
}

// ------------------------------------------------------------ 'default'

// (1) grid (ceil(K / 128), ceil(s / 128), N); shared memory kStages x
// (x slice | W slice), each [128][kPitchKB] bf16
__global__ void __launch_bounds__(kThreads, 2)
logits_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wb,
                   const float* __restrict__ w2, float* __restrict__ logits,
                   int s, int k, int dp, int kp, float temp) {
  extern __shared__ uint4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4);
  constexpr int kSlice = kTile * kPitchKB;
  const int task = blockIdx.z;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const bf16* xa = x + (size_t)task * s * dp;
  const bf16* wa = wb + (size_t)task * k * dp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.0f;

  auto fill = [&](int slice, int stage) {
    bf16* a = ring + stage * 2 * kSlice;
    const int d0 = slice * kDepthB;
    fill_slice<bf16, kTile, kDepthB, kPitchKB>(
        a, xa + (size_t)row0 * dp + d0, dp, s - row0, dp - d0);
    fill_slice<bf16, kTile, kDepthB, kPitchKB>(
        a + kSlice, wa + (size_t)col0 * dp + d0, dp, k - col0, dp - d0);
  };
  auto compute = [&](int stage) {
    const bf16* a = ring + stage * 2 * kSlice;
    const bf16* b = a + kSlice;
    const bf16* ap =
        a + (wm * 64 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kPitchKB
        + 8 * (lane >> 4);
    const bf16* bp = b + (wn * 32 + (lane & 7) + 8 * (lane >> 4)) * kPitchKB
        + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < kDepthB; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], ap + mi * 16 * kPitchKB + kk);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4(bfr[p], bp + p * 16 * kPitchKB + kk);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][2 * (ni & 1)],
                   bfr[ni >> 1][2 * (ni & 1) + 1]);
    }
  };
  pipeline((dp + kDepthB - 1) / kDepthB, fill, compute);

  const int g = lane >> 2, t = lane & 3;
  const float* w2t = w2 + (size_t)task * k;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = col0 + wn * 32 + ni * 8 + 2 * t;   // even, as Kp
    if (col >= kp) continue;
    const float w2a = col < k ? w2t[col] : 0.0f;
    const float w2b = col + 1 < k ? w2t[col + 1] : 0.0f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + wm * 64 + mi * 16 + g + 8 * half;
        if (row >= s) continue;
        *reinterpret_cast<float2*>(
            logits + ((size_t)task * s + row) * kp + col) =
            make_float2(temp * (acc[mi][ni][2 * half] - w2a),
                        temp * (acc[mi][ni][2 * half + 1] - w2b));
      }
  }
}

// (3) grid (ceil(d / 128), ceil(K / 128), N); shared memory kStages x
// (G slice | x slice), each [kDepthB][kPitchMB] bf16
__global__ void __launch_bounds__(kThreads, 2)
grad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gb,
                 float* __restrict__ gs_x, float* __restrict__ col, int s,
                 int k, int d, int dp, int kp) {
  extern __shared__ uint4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4);
  constexpr int kSlice = kDepthB * kPitchMB;
  const int task = blockIdx.z;
  const int k0 = blockIdx.y * kTile, d0 = blockIdx.x * kTile;
  const bf16* ga = gb + (size_t)task * s * kp;
  const bf16* xa = x + (size_t)task * s * dp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const bool with_col = blockIdx.x == 0 && wn == 0;   // warp-uniform

  float acc[4][4][4], csum[4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      csum[mi][c] = 0.0f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) acc[mi][ni][c] = 0.0f;
    }

  auto fill = [&](int slice, int stage) {
    bf16* a = ring + stage * 2 * kSlice;
    const int n0 = slice * kDepthB;
    fill_slice<bf16, kDepthB, kTile, kPitchMB>(
        a, ga + (size_t)n0 * kp + k0, kp, s - n0, kp - k0);
    fill_slice<bf16, kDepthB, kTile, kPitchMB>(
        a + kSlice, xa + (size_t)n0 * dp + d0, dp, s - n0, dp - d0);
  };
  auto compute = [&](int stage) {
    const bf16* a = ring + stage * 2 * kSlice;
    const bf16* b = a + kSlice;
    // both operands lie [support row][column]: transposed fragment loads
    const bf16* ap = a + ((lane & 7) + 8 * (lane >> 4)) * kPitchMB + wm * 64
        + 8 * ((lane >> 3) & 1);
    const bf16* bp = b + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kPitchMB
        + wn * 32 + 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < kDepthB; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4_trans(af[mi], ap + kk * kPitchMB + mi * 16);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4_trans(bfr[p], bp + kk * kPitchMB + p * 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][2 * (ni & 1)],
                   bfr[ni >> 1][2 * (ni & 1) + 1]);
        if (with_col) mma_bf16(csum[mi], af[mi], kOnesBf16, kOnesBf16);
      }
    }
  };
  pipeline((s + kDepthB - 1) / kDepthB, fill, compute);

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kr = k0 + wm * 64 + mi * 16 + g + 8 * half;
      if (kr >= k) continue;
      float* out_row = gs_x + ((size_t)task * k + kr) * d;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int dc = d0 + wn * 32 + ni * 8 + 2 * t;
        if (dc < d) out_row[dc] = acc[mi][ni][2 * half];
        if (dc + 1 < d) out_row[dc + 1] = acc[mi][ni][2 * half + 1];
      }
      // against ones every column of the tile holds the row's sum
      if (with_col && t == 0) col[(size_t)task * k + kr] = csum[mi][2 * half];
    }
}

// ------------------------------------------------------------ 'highest'

// (1) grid (ceil(K / 128), ceil(s / 128), N); shared memory kStages x
// (x slice | W slice), each [128][kPitchKF] fp32. A warp covers 32 rows x
// 64 classes: lane = 4 row slots x 8 class slots, rows slot + 4i, classes
// slot + 8j
__global__ void __launch_bounds__(kThreads, 2)
logits_f32_kernel(const float* __restrict__ x, const float* __restrict__ wf,
                  const float* __restrict__ w2, float* __restrict__ logits,
                  int s, int k, int dp, int kp, float temp) {
  extern __shared__ uint4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  constexpr int kSlice = kTile * kPitchKF;
  const int task = blockIdx.z;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const float* xa = x + (size_t)task * s * dp;
  const float* wa = wf + (size_t)task * k * dp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int ty = lane >> 3, tx = lane & 7;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  auto fill = [&](int slice, int stage) {
    float* a = ring + stage * 2 * kSlice;
    const int d0 = slice * kDepthF;
    fill_slice<float, kTile, kDepthF, kPitchKF>(
        a, xa + (size_t)row0 * dp + d0, dp, s - row0, dp - d0);
    fill_slice<float, kTile, kDepthF, kPitchKF>(
        a + kSlice, wa + (size_t)col0 * dp + d0, dp, k - col0, dp - d0);
  };
  auto compute = [&](int stage) {
    const float* ap = ring + stage * 2 * kSlice + (wm * 32 + ty) * kPitchKF;
    const float* bp = ring + stage * 2 * kSlice + kSlice
        + (wn * 64 + tx) * kPitchKF;
#pragma unroll
    for (int kk = 0; kk < kDepthF; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(ap + 4 * i * kPitchKF + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(bp + 8 * j * kPitchKF + kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  };
  pipeline((dp + kDepthF - 1) / kDepthF, fill, compute);

  const float* w2t = w2 + (size_t)task * k;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + wn * 64 + tx + 8 * j;
    if (col >= k) continue;
    const float w2v = w2t[col];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + wm * 32 + ty + 4 * i;
      if (row < s)
        logits[((size_t)task * s + row) * kp + col] = temp * (acc[i][j] - w2v);
    }
  }
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

// (3) grid (ceil(d / 128), ceil(K / 128), N); shared memory kStages x
// (G slice | x slice), each [kDepthF][kPitchMF] fp32
__global__ void __launch_bounds__(kThreads, 2)
grad_f32_kernel(const float* __restrict__ x, const float* __restrict__ gf,
                float* __restrict__ gs_x, float* __restrict__ col, int s,
                int k, int d, int dp, int kp) {
  extern __shared__ uint4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  constexpr int kSlice = kDepthF * kPitchMF;
  const int task = blockIdx.z;
  const int k0 = blockIdx.y * kTile, d0 = blockIdx.x * kTile;
  const float* ga = gf + (size_t)task * s * kp;
  const float* xa = x + (size_t)task * s * dp;
  const bool with_col = blockIdx.x == 0;  // block-uniform
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[8][8], csum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    csum[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }

  auto fill = [&](int slice, int stage) {
    float* a = ring + stage * 2 * kSlice;
    const int n0 = slice * kDepthF;
    fill_slice<float, kDepthF, kTile, kPitchMF>(
        a, ga + (size_t)n0 * kp + k0, kp, s - n0, kp - k0);
    fill_slice<float, kDepthF, kTile, kPitchMF>(
        a + kSlice, xa + (size_t)n0 * dp + d0, dp, s - n0, dp - d0);
  };
  auto compute = [&](int stage) {
    const float* gsm = ring + stage * 2 * kSlice;
    const float* xsm = gsm + kSlice;
#pragma unroll
    for (int j = 0; j < kDepthF; ++j) {
      float a[8], b[8];
      load8(a, gsm + j * kPitchMF, ty);
      load8(b, xsm + j * kPitchMF, tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
        if (with_col) csum[i] += a[i];
      }
    }
  };
  pipeline((s + kDepthF - 1) / kDepthF, fill, compute);

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

// ------------------------------------------------------------- launches

constexpr size_t kSmemLogitsB = sizeof(bf16) * kStages * 2 * kTile * kPitchKB;
constexpr size_t kSmemGradB = sizeof(bf16) * kStages * 2 * kDepthB * kPitchMB;
constexpr size_t kSmemLogitsF = sizeof(float) * kStages * 2 * kTile * kPitchKF;
constexpr size_t kSmemGradF = sizeof(float) * kStages * 2 * kDepthF * kPitchMF;


template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int launch(const void* x, const int* y, const float* w, float* gs_x,
           float* col, float* logits, bf16* g_bf16, void* w_prep, float* w2,
           int n_task, int s, int k, int d, int dp, int kp, float temp,
           float scale, float alpha, int ce_alpha, int is_bf16,
           cudaStream_t stream) {
  const int w_rows = n_task * k, x_rows = n_task * s;
  const dim3 grid_logits((k + kTile - 1) / kTile, (s + kTile - 1) / kTile,
                         n_task);
  const dim3 grid_grad((d + kTile - 1) / kTile, (k + kTile - 1) / kTile,
                       n_task);
  cudaError_t err;
  if (is_bf16) {
    if ((err = allow_smem(logits_bf16_kernel, kSmemLogitsB)) != cudaSuccess ||
        (err = allow_smem(grad_bf16_kernel, kSmemGradB)) != cudaSuccess)
      return (int)err;
    bf16* wb = static_cast<bf16*>(w_prep);
    const bf16* xb = static_cast<const bf16*>(x);
    prep_weights_kernel<<<(w_rows + 7) / 8, 256, 0, stream>>>(
        w, w2, wb, nullptr, w_rows, d, dp);
    logits_bf16_kernel<<<grid_logits, kThreads, kSmemLogitsB, stream>>>(
        xb, wb, w2, logits, s, k, dp, kp, temp);
    support_rows_kernel<bf16><<<(x_rows + 7) / 8, 256, 0, stream>>>(
        logits, y, g_bf16, x_rows, k, kp, scale, alpha, ce_alpha);
    grad_bf16_kernel<<<grid_grad, kThreads, kSmemGradB, stream>>>(
        xb, g_bf16, gs_x, col, s, k, d, dp, kp);
  } else {
    if ((err = allow_smem(logits_f32_kernel, kSmemLogitsF)) != cudaSuccess ||
        (err = allow_smem(grad_f32_kernel, kSmemGradF)) != cudaSuccess)
      return (int)err;
    // the weights as they lie when their rows already start on 16 bytes
    float* wf = static_cast<float*>(w_prep);
    const float* xf = static_cast<const float*>(x);
    prep_weights_kernel<<<(w_rows + 7) / 8, 256, 0, stream>>>(
        w, w2, nullptr, wf, w_rows, d, dp);
    logits_f32_kernel<<<grid_logits, kThreads, kSmemLogitsF, stream>>>(
        xf, wf != nullptr ? wf : w, w2, logits, s, k, dp, kp, temp);
    support_rows_kernel<float><<<(x_rows + 7) / 8, 256, 0, stream>>>(
        logits, y, logits, x_rows, k, kp, scale, alpha, ce_alpha);
    grad_f32_kernel<<<grid_grad, kThreads, kSmemGradF, stream>>>(
        xf, logits, gs_x, col, s, k, d, dp, kp);
  }
  return (int)cudaGetLastError();
}

}  // namespace tclip

extern "C" const char* tclip_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Enqueues the four passes on `stream`, never synchronises, and returns
// cudaGetLastError() (0 on success). x [N, s, dp] is __nv_bfloat16 when
// bf16 != 0, else float, zero past d; dp is d rounded up to a 16-byte row
// pitch (8 bf16, 4 fp32) and kp is K rounded up to 8. Scratch the caller
// allocates: logits [N, s, kp] fp32 (in 'highest' G overwrites it), w2
// [N, K] fp32, g_bf16 [N, s, kp] bf16 (bf16 only, else null) and w_prep
// [N, K, dp]: bf16 when bf16 != 0; else fp32, or null when dp == d.
extern "C" int tclip_tim_support_grad(const void* x, const int* y,
                                      const float* w, float* gs_x, float* col,
                                      float* logits, void* g_bf16,
                                      void* w_prep, float* w2, int n_task,
                                      int n_support, int k, int d, int dp,
                                      int kp, float temp, float scale,
                                      float alpha, int ce_alpha, int bf16,
                                      void* stream) {
  const int unit = bf16 ? 8 : 4;
  if (n_task <= 0 || n_task > 65535 || n_support <= 0 || k <= 0 || d <= 0 ||
      dp < d || dp % unit != 0 || kp < k || kp % 8 != 0 ||
      (long long)n_task * k > 0x7fffffffLL ||
      (long long)n_task * n_support > 0x7fffffffLL ||
      (n_support + tclip::kTile - 1) / tclip::kTile > 65535 ||
      (bf16 ? (g_bf16 == nullptr || w_prep == nullptr)
            : (w_prep == nullptr && dp != d)))
    return (int)cudaErrorInvalidValue;
  return tclip::launch(x, y, w, gs_x, col, logits,
                       static_cast<tclip::bf16*>(g_bf16), w_prep, w2, n_task,
                       n_support, k, d, dp, kp, temp, scale, alpha, ce_alpha,
                       bf16, (cudaStream_t)stream);
}
