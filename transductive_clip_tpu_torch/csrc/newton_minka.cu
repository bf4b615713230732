// The Newton-Minka step of the Dirichlet concentration solve for Hopper
// (sm_90a), bound with ctypes by ops/cuda_newton.py.
//
// The JAX package runs ops/dirichlet.py's minka_newton_update_alpha as one
// lax.while_loop whose body XLA fuses: Newton on each cluster row's sum s
// of F(s) = sum_d psi^{-1}(psi(s) + y_d) - s. It has no Pallas kernel. This
// source gives the step one launch:
//
// tclip_newton_minka_step — from s [N, R] to the next s and each task's
//    criterion sums [N, 2] (num, den). Per row: z_d = psi(s) + y_d;
//    a_d = psi^{-1}(z_d) by newton_iters Newton steps from Minka's
//    initialisation, clamped at 1e-10, with 1/psi'(a_d) of the last
//    iterate; A(s) = sum_d a_d; F' = psi'(s) sum_d 1/psi'(a_d) - 1; the
//    Newton step s - (A(s) - s) / F', or A(s) where that step is
//    non-finite, not positive, or |F'| <= 1e-12. A frozen row (live mask
//    false) keeps s and adds nothing to the sums; the output is s itself
//    wherever the device flag `done` is set. Per task: num = sum_r
//    (s_new - s)^2 and den = sum_r s^2 over the live rows.
// tclip_newton_minka_final — alpha = psi^{-1}(psi(s) + y) [N, R, K] at the
//    converged s, frozen rows copied from alpha0 bit for bit.
//
// What bounds them. A step reads y once (N R K floats) and writes two
// floats a row; the work is the per-element psi^{-1}, three Newton steps of
// special.cuh's digamma/trigamma series, 19 MUFU operations an element,
// the same update K1 (dirichlet_solve.cu) runs. The torch composition it
// replaces launched ~400 elementwise kernels a step and passed over
// [N, R, K] temporaries a few hundred times; here nothing of size N R K
// but y is touched.
//
// Geometry. A warp takes a row: its lanes stride over the row's K entries
// and the row's two sums close with a butterfly of shuffles, which leaves
// every lane the same bits. A task's rows are dealt round robin over the
// warps of one thread-block cluster of `ctas` CTAs of `warps` warps
// (launch_geometry in ops/cuda_newton.py: 4-warp CTAs at the compact
// widths, ~4 rows a warp at 1,000 rows; at most kMaxCtas x kMaxWarps),
// so its num/den close in the same launch: each warp adds its rows' terms
// in row order, each CTA its warps' pairs in warp order, and CTA 0 the
// CTAs' pairs in rank order through distributed shared memory. Every sum
// has a fixed order and no atomics: two launches give the same bits. A
// frozen row's warp skips the row's elements (the row's terms are exact
// zeros in the plain version).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math (special.cuh's parity argument
// rests on IEEE fp32).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "special.cuh"

namespace cg = cooperative_groups;

namespace tclip {

// launch geometry, mirrored by launch_geometry() in ops/cuda_newton.py
constexpr int kMaxCtas = 8;      // CTAs of a task's cluster (portable size)
constexpr int kMaxWarps = 32;    // warps of a CTA
constexpr int kFinalWarps = 8;   // warps of a CTA of the final pass
constexpr float kFprimeFloor = 1e-12f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// One row's Newton-Minka step, the warp's lanes over its k entries; every
// lane returns the same bits.
__device__ __forceinline__ float row_step(float s, const float* __restrict__ y,
                                          int k, int newton_iters, int lane) {
  const float psi = digamma_pos(s);
  float a_sum = 0.0f, d_sum = 0.0f;
  for (int j = lane; j < k; j += 32) {
    float dinv;
    const float a = inv_digamma_and_deriv(psi + __ldg(y + j), newton_iters,
                                          dinv);
    a_sum += a;
    d_sum += dinv;
  }
  a_sum = warp_sum(a_sum);
  d_sum = warp_sum(d_sum);
  // rounded one operation at a time, as the plain version
  const float fprime = __fsub_rn(__fmul_rn(trigamma_pos(s), d_sum), 1.0f);
  const float s_newton = __fsub_rn(s, __fdiv_rn(__fsub_rn(a_sum, s), fprime));
  const bool ok =
      isfinite(s_newton) && s_newton > 0.0f && fabsf(fprime) > kFprimeFloor;
  return ok ? s_newton : a_sum;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
newton_minka_step_kernel(const float* __restrict__ s,
                         const float* __restrict__ y,
                         const unsigned char* __restrict__ live,
                         const unsigned char* __restrict__ done,
                         float* __restrict__ s_out, float* __restrict__ part,
                         int n_rows, int k, int newton_iters) {
  __shared__ float2 warp_part[kMaxWarps];
  __shared__ float2 cta_part;
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int warps = (int)(blockDim.x >> 5);
  const int warp = (int)(threadIdx.x >> 5);
  const int lane = (int)(threadIdx.x & 31);
  const size_t row0 = (size_t)blockIdx.y * n_rows;
  const bool keep = *done != 0;
  float num = 0.0f, den = 0.0f;
  for (int r = rank * warps + warp; r < n_rows; r += ctas * warps) {
    const size_t row = row0 + r;
    const float s_r = s[row];
    float s_new = s_r;
    if (live == nullptr || live[row] != 0) {
      s_new = row_step(s_r, y + row * k, k, newton_iters, lane);
      const float d = __fsub_rn(s_new, s_r);
      num = __fadd_rn(num, __fmul_rn(d, d));
      den = __fadd_rn(den, __fmul_rn(s_r, s_r));
    }
    if (lane == 0) s_out[row] = keep ? s_r : s_new;
  }
  if (lane == 0) warp_part[warp] = make_float2(num, den);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = make_float2(0.0f, 0.0f);
    for (int w = 0; w < warps; ++w) {
      t.x += warp_part[w].x;
      t.y += warp_part[w].y;
    }
    cta_part = t;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float2 t = make_float2(0.0f, 0.0f);
    for (int c = 0; c < ctas; ++c) {
      const float2 v = *cluster.map_shared_rank(&cta_part, c);
      t.x += v.x;
      t.y += v.y;
    }
    part[2 * blockIdx.y] = t.x;
    part[2 * blockIdx.y + 1] = t.y;
  }
  cluster.sync();   // no CTA leaves while CTA 0 may read its pair
}

__global__ void __launch_bounds__(kFinalWarps * 32)
newton_minka_final_kernel(const float* __restrict__ s,
                          const float* __restrict__ y,
                          const float* __restrict__ alpha0,
                          const unsigned char* __restrict__ live,
                          float* __restrict__ out, long long n_total_rows,
                          int k, int newton_iters) {
  const long long row =
      (long long)blockIdx.x * kFinalWarps + (long long)(threadIdx.x >> 5);
  if (row >= n_total_rows) return;
  const int lane = (int)(threadIdx.x & 31);
  const size_t base = (size_t)row * k;
  if (live != nullptr && live[row] == 0) {
    for (int j = lane; j < k; j += 32) out[base + j] = alpha0[base + j];
    return;
  }
  const float psi = digamma_pos(s[row]);
  for (int j = lane; j < k; j += 32)
    out[base + j] = inv_digamma(psi + __ldg(y + base + j), newton_iters);
}

}  // namespace tclip

// Both launchers enqueue on `stream`, never synchronise, and return 0 or a
// cudaError_t. `live` may be null (every row live); `done` is the solve's
// device flag (one byte).
extern "C" int tclip_newton_minka_step(const float* s, const float* y,
                                       const unsigned char* live,
                                       const unsigned char* done, float* s_out,
                                       float* part, int n_task, int n_rows,
                                       int k, int ctas, int warps,
                                       int newton_iters, void* stream) {
  if (n_task <= 0 || n_task > 65535 || n_rows <= 0 || k <= 0 || ctas <= 0 ||
      ctas > tclip::kMaxCtas || warps <= 0 || warps > tclip::kMaxWarps ||
      newton_iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, n_task);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, tclip::newton_minka_step_kernel, s, y, live,
                         done, s_out, part, n_rows, k, newton_iters);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int tclip_newton_minka_final(const float* s, const float* y,
                                        const float* alpha0,
                                        const unsigned char* live, float* out,
                                        int n_task, int n_rows, int k,
                                        int newton_iters, void* stream) {
  if (n_task <= 0 || n_rows <= 0 || k <= 0 || newton_iters < 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n_task * n_rows;
  const long long blocks = (rows + tclip::kFinalWarps - 1) / tclip::kFinalWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tclip::newton_minka_final_kernel<<<(unsigned)blocks, tclip::kFinalWarps * 32,
                                     0, (cudaStream_t)stream>>>(
      s, y, alpha0, live, out, rows, k, newton_iters);
  return (int)cudaGetLastError();
}
