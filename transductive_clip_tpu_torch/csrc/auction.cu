// Batched auction for the cluster->class assignment, for Hopper (sm_90a),
// bound with ctypes by ops/cuda_auction.py.
//
// tclip_auction has no Pallas counterpart: it replaces the plain XLA
// auction_assign of transductive_clip_tpu/ops/auction.py (_auction_single
// under jax.vmap), one lax.while_loop of up to max_iters rounds that never
// leaves the device. Here one CTA runs a task's loop to its end, and one
// launch covers the whole batch with no host step.
//
// Layout. values [N, R, C] fp32 (R persons = cluster rows, C objects =
// classes), col4row [N, R] int32 (-1 for a person left unassigned when the
// budget ran out), rounds [N] int32, scans [N] int32 (optional: the bids
// made over the rounds, one a group with an unassigned row a round, each
// from a scan of the group's row; the first round's scans are step 1's).
//
// One round of the JAX function: every unassigned person r scans
// net = v[r] - price for b1 (its maximum), best_j (the lowest index of it)
// and b2 (the maximum over the other columns; a duplicate maximum gives
// b2 = b1, and C = 1 leaves b2 = -inf, which becomes b1 as
// jnp.where(isfinite(b2), b2, b1) makes it), bids
// (price[best_j] + (b1 - b2)) + eps, fp32 adds in that order, and each
// object takes its highest bid, ties to the lowest person (jnp.argmax over
// persons): here a 64-bit atomicMax on (the bid's order-preserving bits
// << 32 | R - 1 - r). So col4row and the rounds are the JAX function's.
//
// What the design does about the work. In a zero-shot batch ~69 of a task's
// 75 rows belong to absent clusters and are all zero. Rows that are equal bit
// for bit make the same bid in every round, and the lowest of them wins the
// tie, so only the lowest unassigned row of each group of equal rows bids:
// the others could win nothing, and leaving them out changes no winner,
// price or round (ops/auction.py's return_scans counts the rows scanned
// so). The first design let every unassigned person bid, ~2,400 row scans a
// zero-shot task where this one makes ~75.
//  1. Once, a warp a row reads the task's values (its one read from device
//     memory, eight 16-byte loads in flight a lane) into an order-free hash
//     of (bits, column) and the row's first-round (b1, best_j, b2) (prices
//     are zero then, and v - 0 is v). A row's leader is the lowest row with
//     its hash whose bits are equal (compared only where the hashes match);
//     the groups are numbered in the order of their leaders, each row links
//     to the next row of its group, and rep[g], the group's lowest
//     unassigned row, starts at its leader.
//  2. A bidder scans its leader's row, so a task reads only its distinct
//     rows again, and the few of a zero-shot task (~7 rows, 28 KB) stay in
//     L1 beside the state's ~17 KB of shared memory. (Staging them in
//     shared memory instead read the same: the no_staging ablation in
//     PERF.md.)
//  3. The rounds run on warp 0 alone, with no barrier (the other warps
//     are done once the rows are read and grouped). The first bids with
//     step 1's results; in a later one the warp scans each bidder's row in
//     turn (four 16-byte loads in flight a lane) and reduces it with three
//     redux.sync. A round of one bid, most rounds after the first of a
//     zero-shot task and of a price war, is settled by lane 0 alone; with
//     more, each object keeps its highest bid key by a 64-bit shared
//     atomicMax.
//  4. Settling touches only the objects bid for: price, owner, the winner's
//     column, the previous owner's cleared (a previous owner was assigned,
//     so it did not bid, and the writes never collide). A winner's group
//     hands its turn to its next unassigned row (rows below the winner were
//     assigned), an evicted row takes it back where it is lower, and the
//     next bidders are the groups' reps.
//
// What bounds it. The batch is read once (30 MB at [100, 75, 1000], 9 us
// at 3.35 TB/s). After that a zero-shot task runs ~69 rounds of one bid
// each, and a round is one warp's chain of dependent loads, reductions and
// instruction fetches: a latency, not a rate.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace tclip {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;
// 16-byte loads a lane has in flight in a scan of a row
constexpr int kScanLoads = 4;

// float -> unsigned with the same order (finite values)
__device__ __forceinline__ unsigned order_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the order of the float compares: -0.0 as +0.0 (x + 0 rounds -0 to +0)
__device__ __forceinline__ unsigned compare_bits(float f) {
  return order_bits(__fadd_rn(f, 0.0f));
}

// a column's bits mixed with its index; a row's hash is the sum over its
// columns, so any split of the columns over lanes gives the same hash
__device__ __forceinline__ unsigned mix(float x, int j) {
  unsigned z = __float_as_uint(x) ^ ((unsigned)j * 0x9e3779b9u);
  z ^= z >> 16;
  z *= 0x85ebca6bu;
  return z ^ (z >> 13);
}

// the running maximum, the lowest index of it, and the maximum of the rest
struct Top2 {
  float m1;
  int i1;
  float m2;
};

// x at column j, after every lower column of t: with selects, no branch (a
// zero's sign may differ from the compares' choice, which moves no bid)
__device__ __forceinline__ void push(Top2& t, float x, int j) {
  const bool above = x > t.m1;
  t.m2 = above ? t.m1 : fmaxf(t.m2, x);
  t.i1 = above ? j : t.i1;
  t.m1 = fmaxf(t.m1, x);
}

// four columns from j
__device__ __forceinline__ void push4(Top2& t, float4 x, float4 p, int j) {
  push(t, __fsub_rn(x.x, p.x), j);
  push(t, __fsub_rn(x.y, p.y), j + 1);
  push(t, __fsub_rn(x.z, p.z), j + 2);
  push(t, __fsub_rn(x.w, p.w), j + 3);
}

__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  if (b.m1 > a.m1 || (b.m1 == a.m1 && b.i1 < a.i1))
    return {b.m1, b.i1, fmaxf(b.m2, a.m1)};
  return {a.m1, a.i1, fmaxf(a.m2, b.m1)};
}

// the whole warp's (b1, lowest best_j, b2) in three reductions: the maximum,
// the lowest index holding it, and the maximum of every lane's m1 but the
// lane holding best_j, whose m2 stands in. A zero comes out as +0.0, which
// moves no bid: price + (b1 - b2) is the same for either zero
__device__ __forceinline__ Top2 warp_top2(Top2 t) {
  const unsigned k1 = __reduce_max_sync(kFull, compare_bits(t.m1));
  const int i1 =
      (int)__reduce_min_sync(kFull, compare_bits(t.m1) == k1 ? (unsigned)t.i1
                                                             : 0xffffffffu);
  const unsigned k2 =
      __reduce_max_sync(kFull, compare_bits(t.i1 == i1 ? t.m2 : t.m1));
  return {from_order_bits(k1), i1, from_order_bits(k2)};
}

// one lane's (b1, best_j, b2) over a row net of the prices: 4 columns a
// unit (vec: the row 16-byte aligned) or 1; a lane takes units lane,
// lane + 32, ... in increasing order, so strict compares keep the lowest
// index
__device__ Top2 scan_row(const float* row, bool vec,
                            const float* __restrict__ price, int n_cols,
                            int lane) {
  Top2 t{-INFINITY, n_cols, -INFINITY};
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* p4 = reinterpret_cast<const float4*>(price);
    const int units = n_cols >> 2;
    for (int g = lane; g < units; g += 32 * kScanLoads) {
      float4 a[kScanLoads], p[kScanLoads];
#pragma unroll
      for (int k = 0; k < kScanLoads; ++k) {
        if (g + 32 * k < units) {
          a[k] = __ldg(r4 + g + 32 * k);
          p[k] = p4[g + 32 * k];
        }
      }
#pragma unroll
      for (int k = 0; k < kScanLoads; ++k)
        if (g + 32 * k < units) push4(t, a[k], p[k], 4 * (g + 32 * k));
    }
  } else {
    // rolled: one warp alone runs this round after round, and more code is
    // more for it to fetch (the scalar_unrolled ablation in PERF.md)
#pragma unroll 1
    for (int j = lane; j < n_cols; j += 32)
      push(t, __fsub_rn(__ldg(row + j), price[j]), j);
  }
  return t;
}

// the bid of person r for best_j, and its key: the bid's order bits over
// R - 1 - r, so an object's highest key is its highest bid, ties to the
// lowest person
__device__ __forceinline__ unsigned long long bid_key(Top2 t,
                                                      const float* price,
                                                      float eps, int r,
                                                      int n_rows) {
  const float b2 = isfinite(t.m2) ? t.m2 : t.m1;
  const float bid = __fadd_rn(__fadd_rn(price[t.i1], __fsub_rn(t.m1, b2)), eps);
  return ((unsigned long long)order_bits(bid) << 32) |
         (unsigned)(n_rows - 1 - r);
}

// whether rows a and b are equal bit for bit; warp-uniform
__device__ bool rows_equal(const float* a, const float* b, bool vec,
                           int n_cols, int lane) {
  bool differ = false;
  if (vec) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const int units = n_cols >> 2;
#pragma unroll 8
    for (int g = lane; g < units; g += 32) {
      const float4 x = __ldg(a4 + g), y = __ldg(b4 + g);
      differ |= __float_as_int(x.x) != __float_as_int(y.x) ||
                __float_as_int(x.y) != __float_as_int(y.y) ||
                __float_as_int(x.z) != __float_as_int(y.z) ||
                __float_as_int(x.w) != __float_as_int(y.w);
    }
  } else {
#pragma unroll 8
    for (int j = lane; j < n_cols; j += 32)
      differ |= __float_as_int(__ldg(a + j)) != __float_as_int(__ldg(b + j));
  }
  return !__any_sync(kFull, differ);
}

// a task's state in shared memory (the rows' arrays hold R ints each)
struct State {
  unsigned long long* key;  // [C] the round's highest bid key, 0 for none
  float* price;             // [C]
  int* owner;               // [C] person or -1
  int* col_of;              // object or -1
  int* gid;                 // the row's group
  int* next;                // the next row of the group, or -1
  int* lead;                // the lowest row bit-equal to the row
  int* rep;                 // by group: its lowest unassigned row or kNone
  int* todo;                // this round's bidders
  int* touched;             // objects bid for this round
  int* evicted;             // their previous owners
  int n_rows;
};

// object j takes bid key k: its price and owner, the winner's column, the
// previous owner's cleared (a previous owner was assigned, so it did not
// bid, and the writes of one round never collide); returns the previous
// owner
__device__ __forceinline__ int commit(const State& s, int j,
                                      unsigned long long k, int& winner) {
  s.price[j] = from_order_bits((unsigned)(k >> 32));
  winner = s.n_rows - 1 - (int)(k & 0xffffffffull);
  const int old = s.owner[j];
  if (old >= 0) s.col_of[old] = -1;
  s.owner[j] = winner;
  s.col_of[winner] = j;
  return old;
}

// a winner was its group's lowest unassigned row: the group's next one is
// the first unassigned row after it (rows below it were assigned, and come
// back only by eviction, see take_back), after every commit of the round
__device__ __forceinline__ void hand_on(const State& s, int winner) {
  int r = s.next[winner];
  while (r >= 0 && s.col_of[r] >= 0) r = s.next[r];
  s.rep[s.gid[winner]] = r >= 0 ? r : kNone;
}

// an evicted row bids for its group where it is lower, after every hand_on
__device__ __forceinline__ void take_back(const State& s, int old) {
  atomicMin(&s.rep[s.gid[old]], old);
}

// warp 0: the next round's bidders, one a group with an unassigned row, in
// the order of the groups, into todo; returns how many
__device__ __forceinline__ int list_bidders(const State& s, int n_groups,
                                            int lane) {
  int n = 0;
  for (int base = 0; base < n_groups; base += 32) {
    const int g = base + lane;
    const int r = g < n_groups ? s.rep[g] : kNone;
    const bool bids = r != kNone;
    const unsigned ballot = __ballot_sync(kFull, bids);
    if (bids) s.todo[n + __popc(ballot & ((1u << lane) - 1u))] = r;
    n += __popc(ballot);
  }
  __syncwarp();
  return n;
}

// warp 0, a round whose winning bids are in `key` for the objects in
// touched[0, n_touched): commits, hands on, takes back, lists the bidders
__device__ __forceinline__ int settle(const State& s, int n_touched,
                                      int n_groups, int lane) {
  for (int q = lane; q < n_touched; q += 32) {
    const int j = s.touched[q];
    const unsigned long long k = s.key[j];
    s.key[j] = 0ull;
    int winner;
    s.evicted[q] = commit(s, j, k, winner);
  }
  __syncwarp();
  for (int q = lane; q < n_touched; q += 32) hand_on(s, s.owner[s.touched[q]]);
  __syncwarp();
  for (int q = lane; q < n_touched; q += 32)
    if (s.evicted[q] >= 0) take_back(s, s.evicted[q]);
  __syncwarp();
  return list_bidders(s, n_groups, lane);
}

// warp 0: a lane's bid (key for object j, if `bids`) into `key`, and the
// objects it reaches first onto touched
__device__ __forceinline__ void offer(const State& s, bool bids, int j,
                                      unsigned long long k, int& n_touched,
                                      int lane) {
  const bool first = bids && atomicMax(&s.key[j], k) == 0ull;
  const unsigned ballot = __ballot_sync(kFull, first);
  if (first) s.touched[n_touched + __popc(ballot & ((1u << lane) - 1u))] = j;
  n_touched += __popc(ballot);
}

__global__ void __launch_bounds__(512)
auction_kernel(const float* __restrict__ values, int* __restrict__ col4row,
               int* __restrict__ rounds_out, int* __restrict__ scans_out,
               int n_rows, int n_cols, float eps, int max_iters) {
  // the layout of cuda_auction.smem_bytes
  extern __shared__ unsigned long long smem8[];
  State s;
  s.n_rows = n_rows;
  s.key = smem8;                                            // [C]
  s.price = reinterpret_cast<float*>(s.key + n_cols);       // [C]
  s.owner = reinterpret_cast<int*>(s.price + n_cols);       // [C]
  s.col_of = s.owner + n_cols;                              // [R] each
  s.gid = s.col_of + n_rows;
  s.next = s.gid + n_rows;
  s.lead = s.next + n_rows;
  s.rep = s.lead + n_rows;
  s.todo = s.rep + n_rows;
  s.touched = s.todo + n_rows;
  s.evicted = s.touched + n_rows;
  float* first_m1 = reinterpret_cast<float*>(s.evicted + n_rows);  // [R]
  int* first_i1 = reinterpret_cast<int*>(first_m1 + n_rows);       // [R]
  float* first_m2 = reinterpret_cast<float*>(first_i1 + n_rows);   // [R]
  int& n_groups = *reinterpret_cast<int*>(first_m2 + n_rows);
  int* hash = s.todo;  // until the groups are found

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const float* v = values + (size_t)blockIdx.x * n_rows * n_cols;
  // every row 16-byte aligned in device memory
  const bool vec = (n_cols & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(values) & 15) == 0;

  for (int j = tid; j < n_cols; j += blockDim.x) {
    s.key[j] = 0ull;
    s.price[j] = 0.0f;
    s.owner[j] = -1;
  }
  for (int r = tid; r < n_rows; r += blockDim.x) s.col_of[r] = -1;

  // 1. a warp a row, the task's one read from device memory: the row's
  // hash and its first-round (b1, best_j, b2) (the prices are zero, and
  // v - 0 is v)
  for (int r = warp; r < n_rows; r += n_warps) {
    const float* row = v + (size_t)r * n_cols;
    unsigned h = 0;
    Top2 t{-INFINITY, n_cols, -INFINITY}, odd = t;
    if (vec) {
      const float4* r4 = reinterpret_cast<const float4*>(row);
      const float4 zero{0.0f, 0.0f, 0.0f, 0.0f};
      const int units = n_cols >> 2;
      for (int g = lane; g < units; g += 256) {
        float4 x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (g + 32 * k < units) x[k] = __ldg(r4 + g + 32 * k);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = 4 * (g + 32 * k);
          if (g + 32 * k < units) {
            h += mix(x[k].x, j) + mix(x[k].y, j + 1) + mix(x[k].z, j + 2) +
                 mix(x[k].w, j + 3);
            push4(k & 1 ? odd : t, x[k], zero, j);
          }
        }
      }
    } else {
#pragma unroll 8
      for (int j = lane; j < n_cols; j += 32) {
        const float x = __ldg(row + j);
        h += mix(x, j);
        push(t, x, j);
      }
    }
    h = __reduce_add_sync(kFull, h);
    t = warp_top2(merge(t, odd));
    if (lane == 0) {
      hash[r] = (int)h;
      first_m1[r] = t.m1;
      first_i1[r] = t.i1;
      first_m2[r] = t.m2;
    }
  }
  __syncthreads();

  // 2. each row's leader: the lowest row with its hash and its bits
  for (int r = warp; r < n_rows; r += n_warps) {
    const int h = hash[r];
    int found = r;
    for (int base = 0; base < r && found == r; base += 32) {
      const int q = base + lane;
      unsigned cand = __ballot_sync(kFull, q < r && hash[q] == h);
      while (cand) {
        const int q0 = base + __ffs(cand) - 1;
        cand &= cand - 1u;
        if (rows_equal(v + (size_t)q0 * n_cols, v + (size_t)r * n_cols, vec,
                       n_cols, lane)) {
          found = q0;
          break;
        }
      }
    }
    if (lane == 0) s.lead[r] = found;
  }
  __syncthreads();

  // 3. each row's next row in its group; warp 0 numbers the groups in the
  // order of their leaders (each leader its group's first bidder), then
  // gives the other rows their leader's group
  for (int r = warp; r < n_rows; r += n_warps) {
    const int l = s.lead[r];
    int nx = -1;
    for (int base = r + 1; base < n_rows && nx < 0; base += 32) {
      const int q = base + lane;
      const unsigned hit = __ballot_sync(kFull, q < n_rows && s.lead[q] == l);
      if (hit) nx = base + __ffs(hit) - 1;
    }
    if (lane == 0) s.next[r] = nx;
  }
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_rows; base += 32) {
      const int r = base + lane;
      const bool leads = r < n_rows && s.lead[r] == r;
      const unsigned ballot = __ballot_sync(kFull, leads);
      if (leads) {
        const int g = n + __popc(ballot & ((1u << lane) - 1u));
        s.todo[g] = r;
        s.rep[g] = r;
        s.gid[r] = g;
      }
      n += __popc(ballot);
    }
    if (lane == 0) n_groups = n;
    __syncwarp();
    for (int r = lane; r < n_rows; r += 32)
      if (s.lead[r] != r) s.gid[r] = s.gid[s.lead[r]];
  }
  __syncthreads();

  // 4. the rounds, on warp 0 alone with no barrier. The first takes every
  // group's leader's bid from step 1; in a later one the warp scans each
  // bidder's leader's row in turn (a round of one bid, every round after
  // the first of a zero-shot task, is settled by lane 0 alone, with no
  // atomic)
  if (warp != 0) return;
  const int groups = n_groups;
  int n = groups, it = 0, scanned = 0;
  if (n > 0 && max_iters > 0) {
    int n_touched = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const int r = i < n ? s.todo[i] : 0;
      const Top2 t{first_m1[r], first_i1[r], first_m2[r]};
      offer(s, i < n, t.i1, bid_key(t, s.price, eps, r, n_rows), n_touched,
            lane);
    }
    __syncwarp();
    scanned = n;
    n = settle(s, n_touched, groups, lane);
    it = 1;
  }
  while (n > 0 && it < max_iters) {
    scanned += n;
    int n_touched = 0;
    for (int q = 0; q < n; ++q) {
      const int r = s.todo[q];
      const Top2 t = warp_top2(scan_row(v + (size_t)s.lead[r] * n_cols,
                                           vec, s.price, n_cols, lane));
      if (n == 1) {
        if (lane == 0) {
          int winner;
          const int old =
              commit(s, t.i1, bid_key(t, s.price, eps, r, n_rows), winner);
          hand_on(s, winner);
          if (old >= 0 && old < s.rep[s.gid[old]]) s.rep[s.gid[old]] = old;
        }
        __syncwarp();
      } else {
        offer(s, lane == 0, t.i1, bid_key(t, s.price, eps, r, n_rows),
              n_touched, lane);
      }
    }
    __syncwarp();
    n = n == 1 ? list_bidders(s, groups, lane)
               : settle(s, n_touched, groups, lane);
    ++it;
  }

  for (int r = lane; r < n_rows; r += 32)
    col4row[(size_t)blockIdx.x * n_rows + r] = s.col_of[r];
  if (lane == 0) {
    rounds_out[blockIdx.x] = it;
    if (scans_out != nullptr) scans_out[blockIdx.x] = scanned;
  }
}

}  // namespace tclip

// Enqueues the batched auction on `stream` (one CTA of `threads` threads per
// task, `smem_bytes` of dynamic shared memory from cuda_auction.smem_bytes;
// `scans` may be null), never synchronises, and returns 0 or the
// cudaError_t of the launch.
extern "C" int tclip_auction(const float* values, int* col4row, int* rounds,
                             int* scans, int n_task, int n_rows, int n_cols,
                             float eps, int max_iters, int threads,
                             int smem_bytes, void* stream) {
  if (n_task <= 0 || n_rows <= 0 || n_cols <= 0 || threads % 32 != 0 ||
      threads < 32 || threads > 512)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tclip::auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  tclip::auction_kernel<<<n_task, threads, smem_bytes, (cudaStream_t)stream>>>(
      values, col4row, rounds, scans, n_rows, n_cols, eps, max_iters);
  return (int)cudaGetLastError();
}
