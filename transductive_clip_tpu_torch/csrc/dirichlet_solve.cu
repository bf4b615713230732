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
// What bounds them on this card. Neither moves many bytes: at [100, 91,
// 1000] each input is read once and the output written once in ~33 us. Both
// are bound by issued instructions. The library is built without
// --use_fast_math, so every 1.0f / x is a MUFU.RCP with two correcting
// FMAs, every a / b a MUFU.RCP and a longer correction (by a constant b,
// the reciprocal is refined from a constant by FMAs instead), logf a
// libdevice polynomial, sqrtf a MUFU.RSQ and its correction: a K1 update of
// one element runs three Newton steps of five reciprocals, three divisions
// (two by constants) and a logf, 19 MUFU operations with the initial guess;
// a K2 update five reciprocals, four divisions (two by constants), five
// logf and a sqrtf, 8 MUFU. The special-function unit issues 16 MUFU a
// clock an SM against 128 FFMA, a floor of ~0.51 ms for K1 at [100, 91,
// 1000]; the instructions around it are the higher one. In the first design's build a Newton step was ~170
// SASS instructions, half of them the slow-path tests, branches and
// reconvergence each reciprocal, division and log carries; special.cuh
// tests the argument of a series once instead (its head comment), which
// leaves ~87, the same bits. That arithmetic is what the plain versions in
// cuda_dirichlet.py compute; the rest of the design is about how much of
// the card does it.
//
// Stop granularity. As on the TPU, a block of block_rows rows of one task
// (block_rows_for in cuda_dirichlet.py) stops together. The first design
// ran such a block on one thread block, so a launch lasted as long as one
// SM took for the heaviest block (a dense task's 91 rows) while the other
// SMs idled.
// Here a stopping block is one thread-block CLUSTER of `ctas` CTAs (8, the
// portable size), scheduled together on one GPC:
//  * the block's live rows (y[r, 0] < ROW_FREEZE / 2, fixed for the whole
//    solve) are dealt round robin over the cluster's CTAs, the l-th live
//    row to CTA l % ctas, so the shares differ by at most one row; frozen
//    rows are dealt the same way and copied from alpha0 to out bit for bit;
//  * a row's sum stays inside its CTA (a warp a row, four partial sums a
//    lane), so K2's unchecked updates need only the CTA's own barriers;
//  * a checked update reduces num/den over the CTA (warp shuffles, then a
//    fixed-order sum of the warps' partials), publishes the CTA's pair in
//    its shared memory, and after one cluster barrier every thread reads
//    the ctas pairs through distributed shared memory (map_shared_rank) and
//    sums them in rank order: every CTA computes the same bits and takes
//    the same exit. The pair's slot alternates between two, so one
//    cluster barrier a check suffices; a last one keeps every CTA's shared
//    memory alive until the others have read it.
//
// Rows on chip. A CTA reads its rows of alpha0 and y once into shared
// memory (rows_per_cta x K of each, 64 KB at K = 1000 and 8 rows), keeps
// the state there for the whole solve, and writes the output once. Between
// the row-sum pass and the update pass every thread of the CTA takes every
// `threads`-th element of the CTA's rows, so a CTA with one live row keeps
// all its warps busy as well as one with twelve. The launch geometry
// (launch_geometry in cuda_dirichlet.py: ctas, threads, rows_per_cta and
// shared memory as a function of R and K) picks the threads so that the
// CTAs that fit an SM by shared memory hold ~32 warps; the constants below
// mirror it, and a CPU test holds the two against each other. What then
// sets the fill is the clusters' placement: the card holds 30 clusters of
// 8 CTAs of 96 KB at once (15 of CTAs that take a whole SM; the
// occupancy query below), so the 50 dense clusters of a [100, 91, 1000]
// batch run in about two rounds.
//
// Masking. Nothing is padded: the ragged row block is cut at n_rows and the
// lanes at k. A frozen row keeps its incoming alpha bit for bit and is left
// out of num and den, the sentinel contract of pallas_dirichlet.py:37-53.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math (the parity argument rests on
// IEEE fp32 division, logf and expf).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "special.cuh"

namespace cg = cooperative_groups;

namespace tclip {

constexpr float kRowFreeze = 1.0f;
constexpr float kTrigamma1 = (float)(3.141592653589793 * 3.141592653589793 / 6.0);
constexpr float kAlphaFloor = 1e-11f;
constexpr float kDenFloor = 1e-30f;

// launch geometry, mirrored by launch_geometry() in ops/cuda_dirichlet.py
constexpr int kClusterCtas = 8;        // CTAs of a stopping block (portable)
constexpr int kMaxBlockRows = 128;     // block_rows_for's cap
constexpr int kMaxRowsPerCta = (kMaxBlockRows + kClusterCtas - 1) / kClusterCtas;
constexpr int kMinThreads = 128;       // the live-row scan takes 128 threads
constexpr int kMaxThreads = 1024;
constexpr int kSmemMax = 232448;       // shared memory a CTA may take
constexpr int kSmemStatic = 512;       // what Meta (static) may take of it
constexpr int kMaxDevices = 64;

// shared memory besides the rows (static)
struct Meta {
  float psi[kMaxRowsPerCta];        // digamma of each row's sum
  int live_row[kMaxRowsPerCta];     // block-local index of each owned live row
  int frozen_row[kMaxRowsPerCta];   // ... of each frozen row this CTA copies
  float2 part[kMaxThreads / 32];    // the warps' num/den partials
  float2 slot[2];                   // the CTA's num/den, read by the cluster
  unsigned live_bits[kMaxBlockRows / 32];
  int n_live, n_frozen;             // rows owned by this CTA
};
static_assert(sizeof(Meta) + 16 <= kSmemStatic, "Meta outgrew kSmemStatic");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// The (task, row block) this CTA's cluster owns, and the CTA's share of it.
struct Share {
  size_t base;      // element offset of the block's first row
  float* a;         // rows x k state (shared)
  float* y;         // rows x k y (shared)
  int n_elems;      // n_live x k
};

// Deals the block's rows, loads the owned live rows into shared memory and
// copies the owned frozen rows to out. Every thread must call it.
__device__ Share setup(const float* __restrict__ alpha0,
                       const float* __restrict__ y, float* __restrict__ out,
                       int n_rows, int k, int block_rows, Meta& m,
                       float* smem) {
  const int ctas = (int)cg::this_cluster().num_blocks();
  const int rank = (int)cg::this_cluster().block_rank();
  const int row0 = (blockIdx.x / ctas) * block_rows;
  const int rows_blk = min(block_rows, n_rows - row0);
  Share sh;
  sh.base = ((size_t)blockIdx.y * n_rows + row0) * (size_t)k;
  const int t = threadIdx.x;
  if (t < kMaxBlockRows) {
    const bool live = t < rows_blk && y[sh.base + (size_t)t * k] < kRowFreeze / 2;
    const unsigned bits = __ballot_sync(0xffffffffu, live);
    if ((t & 31) == 0) m.live_bits[t >> 5] = bits;
  }
  __syncthreads();
  int n_live = 0;
#pragma unroll
  for (int w = 0; w < kMaxBlockRows / 32; ++w) n_live += __popc(m.live_bits[w]);
  if (t < rows_blk) {
    int below = __popc(m.live_bits[t >> 5] & ((1u << (t & 31)) - 1u));
    for (int w = 0; w < (t >> 5); ++w) below += __popc(m.live_bits[w]);
    if ((m.live_bits[t >> 5] >> (t & 31)) & 1u) {
      if (below % ctas == rank) m.live_row[below / ctas] = t;
    } else {
      const int f = t - below;
      if (f % ctas == rank) m.frozen_row[f / ctas] = t;
    }
  }
  if (t == 0) {
    m.n_live = n_live > rank ? (n_live - rank + ctas - 1) / ctas : 0;
    const int n_frozen = rows_blk - n_live;
    m.n_frozen = n_frozen > rank ? (n_frozen - rank + ctas - 1) / ctas : 0;
  }
  __syncthreads();
  sh.a = smem;
  sh.y = smem + (size_t)m.n_live * k;   // packed after the live rows
  sh.n_elems = m.n_live * k;
  for (int e = t; e < m.n_frozen * k; e += blockDim.x) {
    const int r = e / k;
    const size_t g = sh.base + (size_t)m.frozen_row[r] * k + (e - r * k);
    out[g] = alpha0[g];
  }
  for (int e = t; e < sh.n_elems; e += blockDim.x) {
    const int r = e / k;
    const size_t g = sh.base + (size_t)m.live_row[r] * k + (e - r * k);
    sh.a[e] = alpha0[g];
    sh.y[e] = y[g];
  }
  __syncthreads();
  return sh;
}

__device__ void store(const Share& sh, const Meta& m, float* __restrict__ out,
                      int k) {
  for (int e = threadIdx.x; e < sh.n_elems; e += blockDim.x) {
    const int r = e / k;
    out[sh.base + (size_t)m.live_row[r] * k + (e - r * k)] = sh.a[e];
  }
}

// psi(sum a) of every owned row into m.psi, a warp a row; ends with a
// barrier
__device__ __forceinline__ void row_psi(const Share& sh, Meta& m, int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < m.n_live; r += blockDim.x >> 5) {
    const float* row = sh.a + (size_t)r * k;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    int j = lane;
    for (; j + 96 < k; j += 128) {
      s0 += row[j];
      s1 += row[j + 32];
      s2 += row[j + 64];
      s3 += row[j + 96];
    }
    for (; j < k; j += 32) s0 += row[j];
    const float s = warp_sum((s0 + s1) + (s2 + s3));
    if (lane == 0) m.psi[r] = digamma_pos(s);
  }
  __syncthreads();
}

// Walks this thread's elements e = threadIdx.x, + blockDim.x, ... of the
// CTA's rows, tracking each one's row for psi: f(e, row).
template <typename F>
__device__ __forceinline__ void for_elements(const Share& sh, int k, F f) {
  const int step = blockDim.x;
  const int row_step = step / k;
  const int col_step = step - row_step * k;
  int row = threadIdx.x / k;
  int col = threadIdx.x - row * k;
  for (int e = threadIdx.x; e < sh.n_elems; e += step) {
    f(e, row);
    col += col_step;
    row += row_step;
    if (col >= k) {
      col -= k;
      ++row;
    }
  }
}

// The block criterion of a checked update: num/den summed over the CTA,
// then over the cluster in rank order; the same bits in every CTA. Every
// thread must call it; `parity` alternates between checks.
__device__ float cluster_crit(float num, float den, Meta& m, int& parity) {
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5;
  num = warp_sum(num);
  den = warp_sum(den);
  if ((threadIdx.x & 31) == 0) m.part[warp] = make_float2(num, den);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = make_float2(0.0f, 0.0f);
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      t.x += m.part[w].x;
      t.y += m.part[w].y;
    }
    m.slot[parity] = t;
  }
  cluster.sync();
  float2 total = make_float2(0.0f, 0.0f);
  const int ctas = (int)cluster.num_blocks();
  for (int c = 0; c < ctas; ++c) {
    const float2 v = *cluster.map_shared_rank(&m.slot[parity], c);
    total.x += v.x;
    total.y += v.y;
  }
  parity ^= 1;
  return total.x / fmaxf(total.y, kDenFloor);
}

__global__ void __launch_bounds__(kMaxThreads)
dirichlet_row_solve_kernel(const float* __restrict__ alpha0,
                           const float* __restrict__ y,
                           float* __restrict__ out, int n_rows, int k,
                           int block_rows, int max_iters, float tol,
                           int newton_iters) {
  __shared__ Meta m;
  extern __shared__ float smem[];
  const Share sh = setup(alpha0, y, out, n_rows, k, block_rows, m, smem);
  int parity = 0;
  float crit = INFINITY;
  for (int it = 0; it < max_iters && crit >= tol; ++it) {
    row_psi(sh, m, k);
    float num = 0.0f, den = 0.0f;
    for_elements(sh, k, [&](int e, int row) {
      const float a = sh.a[e];
      const float a_new = inv_digamma(m.psi[row] + sh.y[e], newton_iters);
      const float d = a_new - a;
      num += d * d;
      den += a * a;
      sh.a[e] = a_new;
    });
    crit = cluster_crit(num, den, m, parity);
  }
  store(sh, m, out, k);
  cg::this_cluster().sync();   // no CTA leaves while its slot may be read
}

__device__ __forceinline__ float mm_update(float a, float psi_s, float y) {
  float digam, lgam;
  digamma_lgamma_pos(a + 1.0f, digam, lgam);
  const float curv =
      a > kAlphaFloor ? fabsf(2.0f * (digam * a - lgam) / (a * a)) : kTrigamma1;
  const float b = digam - psi_s - curv * a - y;
  return (-b + sqrtf(b * b + 4.0f * curv)) / (2.0f * curv);
}

// one MM update of every owned live row; with kMeasure, returns the block
// criterion (cluster-wide), else ends with a CTA barrier
template <bool kMeasure>
__device__ __forceinline__ float mm_pass(const Share& sh, Meta& m, int k,
                                         int& parity) {
  row_psi(sh, m, k);
  float num = 0.0f, den = 0.0f;
  for_elements(sh, k, [&](int e, int row) {
    const float a = sh.a[e];
    const float a_new = mm_update(a, m.psi[row], sh.y[e]);
    if (kMeasure) {
      const float d = a_new - a;
      num += d * d;
      den += a * a;
    }
    sh.a[e] = a_new;
  });
  if (kMeasure) return cluster_crit(num, den, m, parity);
  __syncthreads();
  return 0.0f;
}

__global__ void __launch_bounds__(kMaxThreads)
mm_row_solve_kernel(const float* __restrict__ alpha0,
                    const float* __restrict__ y, float* __restrict__ out,
                    int n_rows, int k, int block_rows, int iter_mm, float tol,
                    int check_every) {
  __shared__ Meta m;
  extern __shared__ float smem[];
  const Share sh = setup(alpha0, y, out, n_rows, k, block_rows, m, smem);
  int parity = 0;
  const int first = min(check_every, iter_mm);
  for (int i = 0; i < first; ++i) mm_pass<false>(sh, m, k, parity);
  float crit = INFINITY;
  for (int it = first; it < iter_mm && crit >= tol;) {
    // checked step: one update, the criterion on its single-step delta
    crit = mm_pass<true>(sh, m, k, parity);
    // the rest of the block only when not converged, clamped so that
    // exactly iter_mm updates run when the test never fires
    const int rem = min(check_every - 1, iter_mm - it - 1);
    if (!(crit < tol))
      for (int i = 0; i < rem; ++i) mm_pass<false>(sh, m, k, parity);
    it += 1 + rem;
  }
  store(sh, m, out, k);
  cg::this_cluster().sync();   // no CTA leaves while its slot may be read
}

// The geometry launch_geometry() computed, checked against what the
// kernels take; 0 or a cudaError_t.
inline int check_geometry(int n_task, int n_rows, int k, int block_rows,
                          int ctas, int threads, int rows_per_cta,
                          int smem_bytes) {
  const bool ok =
      n_task > 0 && n_task <= 65535 && n_rows > 0 && k > 0 &&
      block_rows > 0 && block_rows <= kMaxBlockRows && ctas > 0 &&
      ctas <= kClusterCtas && threads >= kMinThreads &&
      threads <= kMaxThreads && threads % 32 == 0 && rows_per_cta > 0 &&
      rows_per_cta <= kMaxRowsPerCta && rows_per_cta * ctas >= block_rows &&
      smem_bytes + kSmemStatic <= kSmemMax &&
      (size_t)smem_bytes >= 2 * sizeof(float) * (size_t)rows_per_cta * k;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// what each kernel's dynamic shared memory limit is raised to, by device
int raised_smem[2][kMaxDevices] = {};

// Raises kernel `which`'s (0: K1, 1: K2) dynamic shared memory limit to
// `bytes` on the current device; it only ever grows.
inline int allow_smem(int which, int bytes) {
  const void* kernel = which == 0 ? (const void*)dirichlet_row_solve_kernel
                                  : (const void*)mm_row_solve_kernel;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int* raised = device < kMaxDevices ? &raised_smem[which][device] : nullptr;
  if (raised != nullptr && bytes <= *raised) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (raised != nullptr) *raised = bytes;
  return 0;
}

// A launch of clusters of `ctas` CTAs along x.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int which, int n_task, int n_rows,
           int block_rows, int ctas, int threads, int smem_bytes,
           cudaStream_t stream, Args... args) {
  int rc = allow_smem(which, smem_bytes);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_rows + block_rows - 1) / block_rows * ctas, n_task);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace tclip

// Both launchers take the geometry of launch_geometry() in
// cuda_dirichlet.py, enqueue on `stream`, never synchronise, and return
// 0 or the cudaError_t of the launch.
extern "C" int tclip_dirichlet_row_solve(const float* alpha0, const float* y,
                                         float* out, int n_task, int n_rows,
                                         int k, int block_rows, int ctas,
                                         int threads, int rows_per_cta,
                                         int smem_bytes, int max_iters,
                                         float tol, int newton_iters,
                                         void* stream) {
  const int rc = tclip::check_geometry(n_task, n_rows, k, block_rows, ctas,
                                       threads, rows_per_cta, smem_bytes);
  if (rc != 0) return rc;
  return tclip::launch(tclip::dirichlet_row_solve_kernel, 0, n_task, n_rows,
                       block_rows, ctas, threads, smem_bytes,
                       (cudaStream_t)stream, alpha0, y, out, n_rows, k,
                       block_rows, max_iters, tol, newton_iters);
}

extern "C" int tclip_mm_row_solve(const float* alpha0, const float* y,
                                  float* out, int n_task, int n_rows, int k,
                                  int block_rows, int ctas, int threads,
                                  int rows_per_cta, int smem_bytes,
                                  int iter_mm, float tol, int check_every,
                                  void* stream) {
  const int rc = tclip::check_geometry(n_task, n_rows, k, block_rows, ctas,
                                       threads, rows_per_cta, smem_bytes);
  if (rc != 0) return rc;
  return tclip::launch(tclip::mm_row_solve_kernel, 1, n_task, n_rows,
                       block_rows, ctas, threads, smem_bytes,
                       (cudaStream_t)stream, alpha0, y, out, n_rows, k,
                       block_rows, iter_mm, tol, check_every);
}
