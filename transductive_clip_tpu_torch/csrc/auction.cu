// Batched auction for the cluster->class assignment, for Hopper (sm_90a),
// bound with ctypes by ops/cuda_auction.py.
//
// tclip_auction has no Pallas counterpart: it replaces the plain XLA
// auction_assign of transductive_clip_tpu/ops/auction.py (_auction_single
// under jax.vmap), one lax.while_loop of up to max_iters rounds that never
// leaves the device. A loop of torch ops would pay a dozen launches a round
// and a host read every few rounds, over tens of rounds on continuous values
// and ~2.5e4 in the price wars of tie-heavy square instances; here one CTA
// runs a task's loop to its end, and the launch covers the whole batch.
//
// Layout. values [N, R, C] fp32 (R persons = cluster rows, C objects =
// classes), col4row [N, R] int32 (-1 for a person left unassigned when the
// budget ran out), rounds [N] int32. A task's prices, owners and bid keys
// live in shared memory (16 C + 8 R bytes: 16.6 KB at [75, 1000]); its value
// rows stay in device memory (300 KB a task, more than a CTA's 227 KB) and
// are read through L2, which holds the whole [100, 75, 1000] batch (30 MB of
// 50 MB).
//
// One round, in the JAX function's order and arithmetic:
//  1. the unassigned persons are listed (col_of[r] < 0);
//  2. a warp per listed person scans net = v - price: b1 its maximum,
//     best_j the lowest index of it, b2 the maximum over the other columns
//     (so a duplicate maximum gives b2 = b1; C = 1 leaves b2 = -inf, which
//     becomes b1 as jnp.where(isfinite(b2), b2, b1) makes it);
//  3. the bid is (price[best_j] + (b1 - b2)) + eps, fp32 adds in that order;
//  4. each object keeps its highest bid, ties to the lowest person as
//     jnp.argmax over persons: a 64-bit shared atomicMax on (the bid's
//     order-preserving bits << 32 | R - 1 - r);
//  5. objects that got a bid take its price and its bidder; the bidder's
//     col_of is set and the previous owner's cleared (a previous owner was
//     assigned, so it did not bid: the writes never collide);
//  6. the loop goes on while a person is unassigned and it < max_iters.
// So col4row is the JAX function's bit for bit.
//
// What bounds it: the value rows each bidding person reads once a round,
// 4 C bytes (4 KB at C = 1000), from L2 after the first round. At [100, 75,
// 1000] most tasks settle in tens of rounds with few persons bidding after
// the first, so a launch is short and latency-bound (a round is four
// barriers and a warp's scan of 1000 columns). The design keeps every
// round on chip and needs no host step; it is the simple, exact first
// kernel, not a tuned one.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace tclip {

constexpr unsigned kFull = 0xffffffffu;

// float -> unsigned with the same order (finite values)
__device__ __forceinline__ unsigned order_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void __launch_bounds__(1024)
auction_kernel(const float* __restrict__ values, int* __restrict__ col4row,
               int* __restrict__ rounds_out, int n_rows, int n_cols,
               float eps, int max_iters) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* key = smem;                               // [C]
  float* price = reinterpret_cast<float*>(key + n_cols);        // [C]
  int* owner = reinterpret_cast<int*>(price + n_cols);          // [C]
  int* col_of = owner + n_cols;                                 // [R]
  int* todo = col_of + n_rows;                                  // [R]
  __shared__ int n_todo;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const float* v = values + (size_t)blockIdx.x * n_rows * n_cols;

  for (int j = tid; j < n_cols; j += blockDim.x) {
    key[j] = 0ull;
    price[j] = 0.0f;
    owner[j] = -1;
  }
  for (int r = tid; r < n_rows; r += blockDim.x) col_of[r] = -1;

  int it = 0;
  while (true) {
    if (tid == 0) n_todo = 0;
    __syncthreads();
    for (int r = tid; r < n_rows; r += blockDim.x)
      if (col_of[r] < 0) todo[atomicAdd(&n_todo, 1)] = r;
    __syncthreads();
    const int n_bid = n_todo;
    if (n_bid == 0 || it >= max_iters) break;

    for (int q = warp; q < n_bid; q += n_warps) {
      const int r = todo[q];
      const float* row = v + (size_t)r * n_cols;
      float m1 = -INFINITY, m2 = -INFINITY;
      int i1 = n_cols;
      for (int j = lane; j < n_cols; j += 32) {
        const float x = __fsub_rn(__ldg(row + j), price[j]);
        if (x > m1) {
          m2 = m1;
          m1 = x;
          i1 = j;
        } else if (x > m2) {
          m2 = x;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float o1 = __shfl_xor_sync(kFull, m1, off);
        const float o2 = __shfl_xor_sync(kFull, m2, off);
        const int oi = __shfl_xor_sync(kFull, i1, off);
        if (o1 > m1 || (o1 == m1 && oi < i1)) {
          m2 = fmaxf(o2, m1);
          m1 = o1;
          i1 = oi;
        } else {
          m2 = fmaxf(m2, o1);
        }
      }
      if (lane == 0) {
        const float b2 = isfinite(m2) ? m2 : m1;
        const float bid = __fadd_rn(__fadd_rn(price[i1], __fsub_rn(m1, b2)),
                                    eps);
        const unsigned long long k =
            ((unsigned long long)order_bits(bid) << 32) |
            (unsigned)(n_rows - 1 - r);
        atomicMax(&key[i1], k);
      }
    }
    __syncthreads();

    for (int j = tid; j < n_cols; j += blockDim.x) {
      const unsigned long long k = key[j];
      if (k != 0ull) {
        key[j] = 0ull;
        price[j] = from_order_bits((unsigned)(k >> 32));
        const int winner = n_rows - 1 - (int)(k & 0xffffffffull);
        const int old = owner[j];
        if (old >= 0) col_of[old] = -1;
        owner[j] = winner;
        col_of[winner] = j;
      }
    }
    ++it;
    __syncthreads();
  }

  for (int r = tid; r < n_rows; r += blockDim.x)
    col4row[(size_t)blockIdx.x * n_rows + r] = col_of[r];
  if (tid == 0) rounds_out[blockIdx.x] = it;
}

}  // namespace tclip

extern "C" const char* tclip_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Enqueues the batched auction on `stream` (one CTA of `threads` threads per
// task, `smem_bytes` of dynamic shared memory from cuda_auction.smem_bytes),
// never synchronises, and returns 0 or the cudaError_t of the launch.
extern "C" int tclip_auction(const float* values, int* col4row, int* rounds,
                             int n_task, int n_rows, int n_cols, float eps,
                             int max_iters, int threads, int smem_bytes,
                             void* stream) {
  if (n_task <= 0 || n_rows <= 0 || n_cols <= 0 || threads % 32 != 0 ||
      threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tclip::auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  tclip::auction_kernel<<<n_task, threads, smem_bytes, (cudaStream_t)stream>>>(
      values, col4row, rounds, n_rows, n_cols, eps, max_iters);
  return (int)cudaGetLastError();
}
