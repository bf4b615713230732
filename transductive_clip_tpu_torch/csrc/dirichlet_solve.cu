// Dirichlet concentration row solves for Hopper (sm_90a), bound with ctypes
// by ops/cuda_dirichlet.py.
//
// K1 tclip_dirichlet_row_solve replaces the TPU kernel _solver_kernel of
//    transductive_clip_tpu/ops/pallas_dirichlet.py (pallas_dirichlet_solve):
//    Minka's fixed point a <- psi^{-1}(psi(sum a) + y) per cluster row, three
//    Newton steps for psi^{-1}, stopping a block of rows at
//    ||delta||^2 / ||alpha_live||^2 < tol or after max_iters iterations.
// K2 tclip_mm_row_solve replaces _mm_kernel (pallas_mm_solve): the
//    reference's MM quadratic-surrogate update with its schedule — min(50,
//    iter_mm) updates, then checked blocks of one update + the single-step
//    criterion + min(49, iter_mm - it - 1) more updates while not converged.
//
// Stop granularity. As on the TPU, one block of block_rows cluster rows of
// one task decides together when to stop: each thread block owns one
// (task, row-block) pair and runs the whole iteration loop itself. The
// block's num/den are reduced through shared memory with __syncthreads, so
// every thread takes the same exit. The plain torch versions in
// cuda_dirichlet.py use the same block_rows and so stop on the same
// iteration, up to the order of the fp32 sums.
//
// Layout. On the TPU a [block_rows, K] block stays in VMEM for the whole
// solve. Here it cannot: at the main path's compact width a 96-row x
// 1000-lane fp32 block is 384 KB, over the 227 KB of shared memory a block
// may have, and one warp per row with alpha in registers needs ~32 floats a
// lane per row, three rows a warp at 96 rows — over the 64 registers a
// thread may have in a 1024-thread block. So the state lives in the output
// buffer in device memory: it is first a copy of alpha0, and every update
// rewrites it in place. One warp owns whole rows (rows warp, warp + 32,
// ...); its lanes walk the row at stride 32, so loads are coalesced, the
// row sum is a warp shuffle reduction, and a lane only ever reads back what
// it wrote itself. Between its row-sum pass and its update pass a row
// (4 KB) is still in L1; across iterations the state streams through L2.
// Updates that check nothing (K2 between checkpoints) need no block-wide
// synchronisation at all.
//
// Masking. Nothing is padded: the ragged row block is cut at n_rows and the
// lanes at k. A row whose first y lane is >= ROW_FREEZE / 2 is frozen: it
// keeps its incoming alpha bit for bit and is left out of den (and adds 0
// to num), the sentinel contract of pallas_dirichlet.py:37-53.
//
// Bound. Both kernels are bound by fp32 special-function arithmetic, not by
// bytes. K1 at [100, 91, 1000] moves ~110 MB if each input is read once and
// the output written once (~33 us at 3.35 TB/s), but each update costs ~148
// operations a lane-element (3 Newton steps x (5 reciprocals + 1 log) of
// digamma/trigamma series), ~40 iterations deep. K2 costs ~71 a
// lane-element and update, up to 1000 updates. The design answers this with
// full IEEE math in registers and no traffic beyond L2 between iterations;
// the state re-read per iteration is the next thing to remove (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math (the parity argument rests on
// IEEE fp32 division, logf and expf).

#include <cuda_runtime.h>
#include <math.h>

#include "special.cuh"

namespace tclip {

constexpr float kRowFreeze = 1.0f;
constexpr float kTrigamma1 = (float)(3.141592653589793 * 3.141592653589793 / 6.0);
constexpr float kAlphaFloor = 1e-11f;
constexpr float kDenFloor = 1e-30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// Block-wide sums of (a, b); every thread gets them. Every thread of the
// block must call it.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 v = lane < n_warps ? scratch[lane] : make_float2(0.0f, 0.0f);
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
    if (lane == 0) scratch[32] = v;
  }
  __syncthreads();
  const float2 total = scratch[32];
  __syncthreads();  // scratch is reused by the next call
  return total;
}

__device__ __forceinline__ bool row_live(const float* y_row) {
  return y_row[0] < kRowFreeze / 2;
}

// the (task, row-block) this thread block owns
struct Block {
  const float* y;
  float* state;
  int rows;
};

__device__ __forceinline__ Block block_setup(const float* __restrict__ alpha0,
                                             const float* __restrict__ y,
                                             float* __restrict__ out,
                                             int n_rows, int k, int block_rows) {
  const int row0 = blockIdx.x * block_rows;
  const size_t base = ((size_t)blockIdx.y * n_rows + row0) * (size_t)k;
  Block b;
  b.y = y + base;
  b.state = out + base;
  b.rows = min(block_rows, n_rows - row0);
  const int n = b.rows * k;
  for (int i = threadIdx.x; i < n; i += blockDim.x) b.state[i] = alpha0[base + i];
  __syncthreads();
  return b;
}

// one Minka fixed-point update of every live row this warp owns; adds the
// block criterion's terms to num/den
__device__ __forceinline__ void minka_pass(const Block& b, int k, int newton_iters,
                                           float& num, float& den) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < b.rows; r += n_warps) {
    const float* y_row = b.y + (size_t)r * k;
    if (!row_live(y_row)) continue;  // warp-uniform
    float* a_row = b.state + (size_t)r * k;
    float s = 0.0f;
    for (int j = lane; j < k; j += 32) s += a_row[j];
    const float psi_s = digamma_pos(warp_sum(s));
    for (int j = lane; j < k; j += 32) {
      const float a = a_row[j];
      const float a_new = inv_digamma(psi_s + __ldg(y_row + j), newton_iters);
      const float d = a_new - a;
      num += d * d;
      den += a * a;
      a_row[j] = a_new;
    }
  }
}

__global__ void dirichlet_row_solve_kernel(const float* __restrict__ alpha0,
                                           const float* __restrict__ y,
                                           float* __restrict__ out, int n_rows,
                                           int k, int block_rows, int max_iters,
                                           float tol, int newton_iters) {
  __shared__ float2 scratch[33];
  const Block b = block_setup(alpha0, y, out, n_rows, k, block_rows);
  float crit = INFINITY;
  for (int it = 0; it < max_iters && crit >= tol; ++it) {
    float num = 0.0f, den = 0.0f;
    minka_pass(b, k, newton_iters, num, den);
    const float2 t = block_sum2(num, den, scratch);
    crit = t.x / fmaxf(t.y, kDenFloor);
  }
}

__device__ __forceinline__ float mm_update(float a, float psi_s, float y) {
  const float digam = digamma_pos(a + 1.0f);
  const float curv =
      a > kAlphaFloor
          ? fabsf(2.0f * (digam * a - lgamma_pos(a + 1.0f)) / (a * a))
          : kTrigamma1;
  const float b = digam - psi_s - curv * a - y;
  return (-b + sqrtf(b * b + 4.0f * curv)) / (2.0f * curv);
}

// one MM update of every live row this warp owns; with kMeasure, adds the
// block criterion's terms to num/den
template <bool kMeasure>
__device__ __forceinline__ void mm_pass(const Block& b, int k, float& num,
                                        float& den) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < b.rows; r += n_warps) {
    const float* y_row = b.y + (size_t)r * k;
    if (!row_live(y_row)) continue;  // warp-uniform
    float* a_row = b.state + (size_t)r * k;
    float s = 0.0f;
    for (int j = lane; j < k; j += 32) s += a_row[j];
    const float psi_s = digamma_pos(warp_sum(s));
    for (int j = lane; j < k; j += 32) {
      const float a = a_row[j];
      const float a_new = mm_update(a, psi_s, __ldg(y_row + j));
      if (kMeasure) {
        const float d = a_new - a;
        num += d * d;
        den += a * a;
      }
      a_row[j] = a_new;
    }
  }
}

__global__ void mm_row_solve_kernel(const float* __restrict__ alpha0,
                                    const float* __restrict__ y,
                                    float* __restrict__ out, int n_rows, int k,
                                    int block_rows, int iter_mm, float tol,
                                    int check_every) {
  __shared__ float2 scratch[33];
  const Block b = block_setup(alpha0, y, out, n_rows, k, block_rows);
  float unused = 0.0f;
  const int first = min(check_every, iter_mm);
  for (int i = 0; i < first; ++i) mm_pass<false>(b, k, unused, unused);
  float crit = INFINITY;
  for (int it = first; it < iter_mm && crit >= tol;) {
    // checked step: one update, the criterion on its single-step delta
    float num = 0.0f, den = 0.0f;
    mm_pass<true>(b, k, num, den);
    const float2 t = block_sum2(num, den, scratch);
    crit = t.x / fmaxf(t.y, kDenFloor);
    // the rest of the block only when not converged, clamped so that
    // exactly iter_mm updates run when the test never fires
    const int rem = min(check_every - 1, iter_mm - it - 1);
    if (!(crit < tol))
      for (int i = 0; i < rem; ++i) mm_pass<false>(b, k, unused, unused);
    it += 1 + rem;
  }
}

inline int launch_shape(int n_task, int n_rows, int k, int block_rows,
                        dim3& grid, dim3& threads) {
  if (n_task <= 0 || n_task > 65535 || n_rows <= 0 || k <= 0 || block_rows <= 0)
    return (int)cudaErrorInvalidValue;
  grid = dim3((n_rows + block_rows - 1) / block_rows, n_task);
  threads = dim3(32 * (block_rows < 32 ? block_rows : 32));
  return 0;
}

}  // namespace tclip

extern "C" const char* tclip_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Both launchers enqueue on `stream`, never synchronise, and return
// cudaGetLastError() (0 on success).
extern "C" int tclip_dirichlet_row_solve(const float* alpha0, const float* y,
                                         float* out, int n_task, int n_rows,
                                         int k, int block_rows, int max_iters,
                                         float tol, int newton_iters,
                                         void* stream) {
  dim3 grid, threads;
  const int rc = tclip::launch_shape(n_task, n_rows, k, block_rows, grid, threads);
  if (rc != 0) return rc;
  tclip::dirichlet_row_solve_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      alpha0, y, out, n_rows, k, block_rows, max_iters, tol, newton_iters);
  return (int)cudaGetLastError();
}

extern "C" int tclip_mm_row_solve(const float* alpha0, const float* y, float* out,
                                  int n_task, int n_rows, int k, int block_rows,
                                  int iter_mm, float tol, int check_every,
                                  void* stream) {
  dim3 grid, threads;
  const int rc = tclip::launch_shape(n_task, n_rows, k, block_rows, grid, threads);
  if (rc != 0) return rc;
  tclip::mm_row_solve_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      alpha0, y, out, n_rows, k, block_rows, iter_mm, tol, check_every);
  return (int)cudaGetLastError();
}
