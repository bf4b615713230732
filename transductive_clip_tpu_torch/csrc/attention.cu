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
//   3. s = s + mask (the optional additive [n, n] mask, as fp32; any mask,
//      not only the causal one);
//   4. m = max_j s, e = exp(s - m), p = e / sum_j e, all fp32;
//   5. p rounded to the qkv dtype;
//   6. o = p . v_h accumulated in fp32;
//   7. o rounded to the qkv dtype, written to out[b, n, h*64 : h*64 + 64].
// except K4b in bf16, which walks the keys once with an online softmax and
// rounds e, not p: steps 2 and 3 are one FFMA with a mask (x = s scale +
// mask) and none without (x = s); per key tile, the max in use m moves to
// the running max when some row of the warp has passed it by more than
// kSlack (8) in log2 units, and the sum and o are then rescaled; e =
// 2^(x c - m c) by one FFMA and ex2.approx (c = scale log2(e) on raw
// scores, log2(e) on masked ones; e < 2^8), the fp32 sum takes the
// unrounded e, o += e . v_h (fp32) takes e rounded to bf16; at the end
// one division a row (the IEEE reciprocal of its sum) and o rounded to
// bf16. Against the TPU's order only the place of the bf16 rounding (of e
// before the division, not of p after it), the max subtracted and the
// exp's last bits differ: within one bf16 ulp of the output.
// Rows whose scores are all -inf are not special-cased (they come out NaN,
// as in the plain version); every other row is guarded against
// exp(-inf - -inf) while its running max is still -inf.
//
// Bound. 4 b heads n^2 64 operations (two products) against the bytes of
// qkv and out. The text tower's [1000, 77, 3 x 512] bf16 is bound by bytes
// (0.32 GB: 0.094 ms at 3.35 TB/s, against 0.012 ms of bf16 tensor cores),
// as are the ViT towers' bf16 shapes ([64, 577, 3 x 1024]: 0.30 GB, 0.090
// ms, against 0.088 ms of tensor cores); ViT-L/14@336px fp32 by operations
// (8.7e10 at the 67 TFLOP/s of fp32 FFMA: 1.3 ms; TF32 stays off). K4b in
// bf16 also does an ex2 a score on the special-function unit (16 a clock
// an SM: 0.10 ms at [64, 577]), as long as its products. So the bf16
// kernels must keep many loads in flight and the tensor cores and the
// special-function unit busy together, and the fp32 kernels must keep the
// FFMA pipe fed: few shared-memory loads per FMA.
//
// Design, K4a and the fp32 K4b. A warp owns 16 q rows of one (sequence,
// head); nothing of a score row ever lies in shared or device memory. Keys
// and values come in tiles of 64 rows, staged in the qkv dtype with
// 16-byte cp.async copies (a head's row is 128 or 256 contiguous bytes) at
// a padded pitch (72 bf16, 68 fp32) that keeps ldmatrix and float4 reads
// free of bank conflicts.
//
//   K4a, bf16: both products on tensor cores, mma.sync m16n8k16 (bf16 x
//     bf16 -> fp32), fragments by ldmatrix (ldmatrix.trans for v); one
//     block of ceil(n / 16) warps per (sequence, head) holds q, k, v of the
//     head (35 KB at n = 77) and a warp's whole [16, n] score row block in
//     registers (mma.sync and not wgmma: wgmma's 64-row tile turns n = 77
//     into 128 rows where 16-row tiles make 80). Scale, mask, max, exp, sum
//     and the division happen in the accumulator registers (a row lives in
//     one quad: two shuffles), and p, normalised and then rounded to bf16
//     as on the TPU, is packed straight into the A fragments of p . v (the
//     accumulators of two m16n8 tiles have the A layout of one m16k16). A
//     row's many divisions by its one sum are the product with the IEEE
//     reciprocal corrected by one Newton step on the remainder (div_by).
//   fp32: FFMA with a register tile of 4 rows x 8 columns a thread (lane =
//     4 row slots x 8 column slots; rows slot + 4i, key columns slot + 8j,
//     output columns 4 slot .. 4 slot + 3 and 32 + the same), both operands
//     read as float4 along the reduction: 12 LDS.128 for 128 FMAs. p is not
//     rounded in fp32, so the softmax is online: a running max and sum a
//     row, the output accumulators rescaled when the max moves, o / sum at
//     the end; only the order of fp32 operations differs from the plain
//     version. A tile's p passes through a warp-private [16, 64] strip of
//     shared memory to become the p . v operand.
//       K4a (n <= 128): one block of ceil(n / 16) warps per (sequence,
//         head) with the head's q, k, v resident; only the live columns of
//         the last tile are computed.
//       K4b: one block of 8 warps per (sequence, head, 128 q rows); the
//         k tile loads while p . v runs and the v tile while q . k^T runs,
//         two barriers a tile.
//     With a mask, a warp first looks at the mask entries of its rows and
//     computes a tile only up to the last 8-key group that the mask leaves
//     finite for any of them (under the text towers' causal mask that is
//     40% of the groups less); the mask may be any [n, n] values.
//   Warps whose 16 rows lie past n only help to load.
//
// Design, K4b in bf16 (Hopper's warpgroup products and TMA). A persistent
// grid of two blocks an SM walks work items of (sequence, head, 128 q
// rows); a block has two consumer warpgroups of 64 q rows and one producer
// warp. The producer's one thread copies q and the k / v tiles of 64 keys
// by TMA into shared memory under the 128-byte swizzle, through a ring of
// kStages stages with a full and an empty barrier a stage, and runs ahead
// of the consumers into the next item. A warpgroup reads each k and v tile
// once from shared memory for its 64 rows: s = q k^T by wgmma m64n64k16
// (q and k K-major in shared memory) into registers, the softmax there,
// and o += e v by wgmma with e from registers (the accumulators of s have
// the A-fragment layout) and v MN-major (the transpose bit). The last tile
// of a sequence computes only its live 16-key groups with a narrow wgmma
// (n16 / n32 / n48; a ViT sequence is a square plus one: 1 live key of 64
// at n = 577, 5 at n = 197), and the rows past n only fill the 64-row
// product. The warpgroups of a block run apart, each waiting only for its
// tiles; ptxas serialises wgmma when a branch it takes for divergent lies
// between a product's issue and its wait, so none does, and the
// warpgroup's index is read from lane 0.
// The TPU kernel keeps a whole [n, 3w] image in VMEM and loops over the
// heads; here a head is the unit of work, and no shared-memory size
// depends on n in K4b.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math (IEEE expf and division). The
// tensor maps come from cuTensorMapEncodeTiled, looked up through the
// runtime at first use, so the library is not linked against libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace tclip {

typedef __nv_bfloat16 bf16;

constexpr int kHeadDim = 64;
constexpr int kWarpRows = 16;    // q rows of a warp
constexpr int kKeys = 64;        // rows of a k / v tile
constexpr int kBlockRows = 128;  // q rows of a K4b block (8 warps)
constexpr int kRowsMaxN = 128;   // K4a's longest sequence
constexpr int kPitchB = 72;      // bf16 row pitch of q, k, v (144 bytes)
constexpr int kPitchF = 68;      // fp32 row pitch of q, k, v (272 bytes)
constexpr int kPitchP = 72;      // fp32 row pitch of the p strip

template <typename T> struct Pitch;
template <> struct Pitch<bf16> { static constexpr int value = kPitchB; };
template <> struct Pitch<float> { static constexpr int value = kPitchF; };

// rows [row0, row0 + rows) of the q (which = 0), k (1) or v (2) third of
// head h into dst [rows][pitch], 16 bytes a copy; rows past n are zero
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ qkv,
                                          size_t seq_off, int n, int width,
                                          int h, int which, int row0,
                                          int rows) {
  constexpr int kPer = 16 / sizeof(T);          // values a copy
  constexpr int kChunks = kHeadDim / kPer;      // copies a row
  const T* src = qkv + seq_off + (size_t)which * width + h * kHeadDim;
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = e % kChunks, row = row0 + r;
    T* d = dst + r * Pitch<T>::value + c * kPer;
    if (row < n)
      cp_async16(d, src + (size_t)row * 3 * width + c * kPer);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// steps 2 and 3 on one score; mrow: the mask's row or null. With CHECK the
// key column may lie past n, where the score is -inf
template <bool CHECK, bool MASK>
__device__ __forceinline__ float scale_mask(float s, float scale,
                                            const float* __restrict__ mrow,
                                            int n, int col) {
  if (CHECK && col >= n) return -INFINITY;
  const float v = __fmul_rn(s, scale);   // rounded before the mask is added
  return MASK ? v + mrow[col] : v;
}

// the mask's row for a q row (the last row for the padding rows past n,
// whose results are never stored), or null
__device__ __forceinline__ const float* mask_row(const float* __restrict__ mask,
                                                 int n, int row) {
  return mask == nullptr ? nullptr : mask + (size_t)min(row, n - 1) * n;
}

// e / l given r = 1 / l (IEEE): the product e r corrected by one Newton
// step on its remainder, which is the rounded quotient (a row's many
// divisions by one sum cost three operations each, not a division each)
__device__ __forceinline__ float div_by(float e, float l, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, l, e), r, q);
}

// the max to subtract: 0 while every score so far is -inf, so that
// exp(-inf - m) is 0 and not exp(-inf + inf)
__device__ __forceinline__ float guard(float m) {
  return m == -INFINITY ? 0.f : m;
}

// ---------------------------------------------------------------- bf16

// the A fragments of a warp's 16 q rows (qw: its first row), one per 16 of d
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[4][4],
                                             const bf16* qw, int lane) {
  const bf16* p = qw + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kPitchB
      + 8 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(qf[ks], p + 16 * ks);
}

// s[j] = the m16n8 tile of q_w . k^T against keys 8j .. 8j + 7 of kt. Four
// tiles go together, so that an mma never waits for the one before it
template <int NT8>
__device__ __forceinline__ void qk_tile(float (&s)[NT8][4],
                                        const uint32_t (&qf)[4][4],
                                        const bf16* kt, int lane) {
  const bf16* kp = kt + (lane & 7) * kPitchB + 8 * (lane >> 3);
#pragma unroll
  for (int j = 0; j < NT8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int j0 = 0; j0 < NT8; j0 += 4) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t b[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (j0 + jj < NT8)
          ldmatrix_x4(b[jj], kp + 8 * (j0 + jj) * kPitchB + 32 * half);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (j0 + jj < NT8)
            mma_bf16(s[j0 + jj], qf[2 * half + ks], b[jj][2 * ks],
                     b[jj][2 * ks + 1]);
    }
  }
}

// steps 2 and 3 on a warp's score tiles; mr0, mr1: the mask rows of the
// lane's two accumulator rows (or null), col_t: the key column of its first
// column; tiles from CHECK_FROM on may reach past n
template <int NT8, int CHECK_FROM, bool MASK>
__device__ __forceinline__ void scale_mask_tile_m(float (&s)[NT8][4],
                                                  float scale,
                                                  const float* mr0,
                                                  const float* mr1, int n,
                                                  int col_t) {
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = col_t + 8 * j + (c & 1);
      const float* mr = c < 2 ? mr0 : mr1;
      s[j][c] = j >= CHECK_FROM
          ? scale_mask<true, MASK>(s[j][c], scale, mr, n, col)
          : scale_mask<false, MASK>(s[j][c], scale, mr, n, col);
    }
}
template <int NT8, int CHECK_FROM>
__device__ __forceinline__ void scale_mask_tile(float (&s)[NT8][4],
                                                float scale,
                                                const float* mr0,
                                                const float* mr1, int n,
                                                int col_t) {
  if (mr0 != nullptr)
    scale_mask_tile_m<NT8, CHECK_FROM, true>(s, scale, mr0, mr1, n, col_t);
  else
    scale_mask_tile_m<NT8, CHECK_FROM, false>(s, scale, mr0, mr1, n, col_t);
}

// p = e / sum rounded to bf16, as the A fragments of p . v
template <int NK16>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[NK16][4],
                                       const float (&e)[2 * NK16][4],
                                       float l0, float l1) {
  const float r0 = 1.f / l0, r1 = 1.f / l1;
#pragma unroll
  for (int kk = 0; kk < NK16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float (&t)[4] = e[2 * kk + half];
      pa[kk][2 * half] = pack_bf16(div_by(t[0], l0, r0), div_by(t[1], l0, r0));
      pa[kk][2 * half + 1] =
          pack_bf16(div_by(t[2], l1, r1), div_by(t[3], l1, r1));
    }
  }
}

// o += p . v over the 16 NK16 values of vt. (Forming p, rounding it and
// multiplying 16 keys at a time would keep one A fragment alive instead of
// NK16, but it ran slower on the card: it leaves the scheduler less to
// overlap.)
template <int NK16>
__device__ __forceinline__ void pv_tile(float (&o)[8][4],
                                        const uint32_t (&pa)[NK16][4],
                                        const bf16* vt, int lane) {
#pragma unroll
  for (int kk = 0; kk < NK16; ++kk) {
    const bf16* vp = vt
        + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kPitchB
        + 8 * (lane >> 4);
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vp + 16 * nn);
      mma_bf16(o[2 * nn], pa[kk], b[0], b[1]);
      mma_bf16(o[2 * nn + 1], pa[kk], b[2], b[3]);
    }
  }
}

// step 7: the warp's [16, 64] output through its own q rows in shared
// memory (stage; no other warp reads them), then 16 bytes a lane
__device__ __forceinline__ void store_warp(bf16* stage, const float (&o)[8][4],
                                           bf16* __restrict__ out_head,
                                           int width, int row0, int n,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * kPitchB + 8 * j + 2 * t) =
        pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kPitchB + 8 * j + 2 * t) =
        pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
  for (int e = lane; e < kWarpRows * 8; e += 32) {
    const int r = e >> 3, c = e & 7;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(out_head + (size_t)(row0 + r) * width + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * kPitchB + 8 * c);
  }
}

// K4a, bf16: grid (b * heads), 32 NT threads (NT = ceil(n / 16)); shared
// memory q, k, v [16 NT][72] bf16
template <int NT>
__global__ void __launch_bounds__(32 * NT)
attention_rows_bf16(const bf16* __restrict__ qkv,
                    const float* __restrict__ mask, bf16* __restrict__ out,
                    int n, int heads, float scale) {
  extern __shared__ uint4 smem4[];
  constexpr int np = 16 * NT;
  bf16* q = reinterpret_cast<bf16*>(smem4);
  bf16* k = q + np * kPitchB;
  bf16* v = k + np * kPitchB;
  const int width = heads * kHeadDim;
  const int seq = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t seq_off = (size_t)seq * n * 3 * width;
  load_rows(q, qkv, seq_off, n, width, h, 0, 0, np);
  load_rows(k, qkv, seq_off, n, width, h, 1, 0, np);
  cp_async_commit();
  load_rows(v, qkv, seq_off, n, width, h, 2, 0, np);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();                     // q and k are here, v on its way
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* qw = q + warp * kWarpRows * kPitchB;
  const float* mr0 = mask_row(mask, n, warp * kWarpRows + g);
  const float* mr1 = mask_row(mask, n, warp * kWarpRows + g + 8);
  float s[2 * NT][4];
  {
    uint32_t qf[4][4];
    load_q_frags(qf, qw, lane);
    qk_tile<2 * NT>(s, qf, k, lane);
  }
  // only the last 16 key columns can lie past n
  scale_mask_tile<2 * NT, 2 * NT - 2>(s, scale, mr0, mr1, n, 2 * t);
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    s[j][0] = expf(s[j][0] - m0);
    s[j][1] = expf(s[j][1] - m0);
    s[j][2] = expf(s[j][2] - m1);
    s[j][3] = expf(s[j][3] - m1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  uint32_t pa[NT][4];
  pack_p<NT>(pa, s, l0, l1);
  cp_async_wait<0>();
  __syncthreads();                     // v is here
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  pv_tile<NT>(o, pa, v, lane);
  store_warp(qw, o, out + (size_t)seq * n * width + h * kHeadDim, width,
             warp * kWarpRows, n, lane);
}

// ------------------------------------------------------ K4b bf16 (wgmma)

constexpr int kWgRows = 64;                     // q rows of a warpgroup
constexpr int kWarpgroups = 2;                  // consumer warpgroups a block
constexpr int kStages = 4;                      // k / v tiles of the ring
constexpr int kRowsB = kWarpgroups * kWgRows;   // q rows of a block
constexpr int kConsumers = 128 * kWarpgroups;   // consumer threads
constexpr int kThreadsB = kConsumers + 32;      // and one producer warp
constexpr int kBlocksPerSm = 2;                 // resident blocks an SM
constexpr int kTileBytes = kKeys * kHeadDim * 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSlack = 8.f;   // log2 units a row may outrun its max in use

// 2^x on the special-function unit (ex2.approx: 2 ulp, ex2(-inf) = 0)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a thread's share of its warpgroup's 64 q rows: the [64, 64] output
// accumulator in wgmma's layout (rows r and r + 8, r = 16 warp + lane / 4),
// the two rows' max in use (of the raw scores, or of s scale + mask) and
// its share of their running sums of exp (the quad's four shares are added
// at the end)
struct WgState {
  float o[32];
  float m0, m1, l0, l1;
};

// one key tile for a warpgroup, over the tile's first 16 NK16 keys (kt,
// vt: its k and v in shared memory; dq: q's descriptor): s = q k^T by
// wgmma m64n(16 NK16)k16 (four steps of 16 along d: 32 bytes, 2 descriptor
// units), the online softmax in the accumulator registers, o += e v by
// wgmma with e from registers (steps of 16 keys: 2048 bytes, 128 units).
// The max in use moves only when a row's scores pass it by more than
// kSlack in log2 units (so e stays below 2^kSlack), and o and the sums are
// rescaled only then, decided by a vote over the warp. e = 2^(x c - max c)
// by one FFMA and one ex2 a score (x = s, or s scale + mask; c takes x to
// log2 units); the sums take e unrounded, p . v takes e rounded to bf16
// (the A fragments of 16 keys are the accumulators of two 8-key column
// groups). EDGE: keys from n on are -inf; MASK: the [n, n] mask, r0: the
// thread's first q row
template <int NK16, bool EDGE, bool MASK>
__device__ __forceinline__ void blocked_tile(WgState& st, uint64_t dq,
                                             const bf16* kt, const bf16* vt,
                                             float scale, float c,
                                             const float* __restrict__ mask,
                                             int r0, int n, int j0) {
  constexpr int NT8 = 2 * NK16;
  float s[4 * NT8];
  const uint64_t dk = wgmma_desc_sw128(kt, 1);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_ss<16 * NK16>(s, dq + 2 * ks, dk + 2 * ks, ks);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_regs(s);
  if (EDGE || MASK) {
    const int t = threadIdx.x & 3;
    const float* mr0 = MASK ? mask_row(mask, n, r0) : nullptr;
    const float* mr1 = MASK ? mask_row(mask, n, r0 + 8) : nullptr;
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = j0 + 8 * j + 2 * t + (i & 1);
        float& x = s[4 * j + i];
        if (EDGE && col >= n)
          x = -INFINITY;
        else if (MASK)
          x = fmaf(x, scale, (i < 2 ? mr0 : mr1)[col]);
      }
  }
  // the rows' tile max (a row lives in one quad: two shuffles)
  float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    t0 = fmaxf(t0, fmaxf(s[4 * j], s[4 * j + 1]));
    t1 = fmaxf(t1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
    t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
  }
  // a max of -inf (every score so far masked) takes any finite one: +inf
  if (__any_sync(0xffffffffu, fmaf(t0, c, -(st.m0 * c)) > kSlack
                              || fmaf(t1, c, -(st.m1 * c)) > kSlack)) {
    const float n0 = fmaxf(st.m0, t0), n1 = fmaxf(st.m1, t1);
    // 0 while the old max is -inf
    const float a0 = exp2_sfu(fmaf(st.m0, c, -(guard(n0) * c)));
    const float a1 = exp2_sfu(fmaf(st.m1, c, -(guard(n1) * c)));
    st.m0 = n0;
    st.m1 = n1;
    st.l0 *= a0;
    st.l1 *= a1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      st.o[4 * j] *= a0;
      st.o[4 * j + 1] *= a0;
      st.o[4 * j + 2] *= a1;
      st.o[4 * j + 3] *= a1;
    }
  }
  const float b0 = guard(st.m0) * c, b1 = guard(st.m1) * c;
  uint32_t pa[NK16][4];
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    const float e0 = exp2_sfu(fmaf(s[4 * j], c, -b0));
    const float e1 = exp2_sfu(fmaf(s[4 * j + 1], c, -b0));
    const float e2 = exp2_sfu(fmaf(s[4 * j + 2], c, -b1));
    const float e3 = exp2_sfu(fmaf(s[4 * j + 3], c, -b1));
    sum0 += e0 + e1;
    sum1 += e2 + e3;
    pa[j >> 1][2 * (j & 1)] = pack_bf16(e0, e1);
    pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(e2, e3);
  }
  st.l0 += sum0;
  st.l1 += sum1;
  const uint64_t dv = wgmma_desc_sw128(vt, 64);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK16; ++kk)
    wgmma_rs_n64_mn(st.o, pa[kk], dv + 128 * kk);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_fence_regs(st.o);
}

// step 7 for a warp: its 16 rows of o times the IEEE reciprocal of their
// sums (a division each would cost a division a value), rounded to bf16,
// through its own 16 q rows of shared memory (stage, swizzled as the
// tiles; the last product that read them has completed), then 16 bytes a
// lane to the rows of out before n
__device__ __forceinline__ void store_rows_wg(bf16* stage, WgState& st,
                                              bf16* __restrict__ out_head,
                                              int width, int row0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, off);
    st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, off);
  }
  const float i0 = __frcp_rn(st.l0), i1 = __frcp_rn(st.l1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // rows g and g + 8 share their swizzle (g + 8 = g mod 8)
    const int col = ((j ^ g) << 3) + 2 * t;
    *reinterpret_cast<uint32_t*>(stage + g * kHeadDim + col) =
        pack_bf16(st.o[4 * j] * i0, st.o[4 * j + 1] * i0);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kHeadDim + col) =
        pack_bf16(st.o[4 * j + 2] * i1, st.o[4 * j + 3] * i1);
  }
  __syncwarp();
  for (int e = lane; e < 16 * 8; e += 32) {
    const int r = e >> 3, c = e & 7;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(out_head + (size_t)(row0 + r) * width + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * kHeadDim
                                          + ((c ^ (r & 7)) << 3));
  }
}

// K4b, bf16, for a last key tile of 16 NK16 live keys or fewer. A
// persistent grid of kBlocksPerSm blocks an SM walks the work items
// (sequence, head, block of kRowsB q rows), item w + k gridDim.x for block
// w; neighbouring items are q blocks of one (sequence, head), which run
// together, so its k and v come from L2 after the first. kThreadsB threads:
// kWarpgroups consumer warpgroups of 64 q rows and one producer warp, whose
// one thread issues every TMA copy (tmap: qkv as [b][n][3 width], rows
// past n read as zero) and runs ahead of the consumers across items: the
// next item's q and first tiles load while this one computes and stores.
// Shared memory (1024-byte aligned): two q buffers [kRowsB][64], a ring of
// kStages stages of a k and a v tile [64][64], bf16 under the 128-byte
// swizzle, then the barriers: a full and an empty one a q buffer and a
// stage. The g-th tile a block walks (over all its items) lives in stage
// g % kStages; a stage or q buffer is refilled once every consumer warp
// has released it
template <int NK16, bool MASK>
__global__ void __launch_bounds__(kThreadsB, kBlocksPerSm)
attention_blocked_bf16(const __grid_constant__ CUtensorMap tmap,
                       const float* __restrict__ mask, bf16* __restrict__ out,
                       int n, int heads, int items, float scale) {
  extern __shared__ uint4 smem4[];
  constexpr int kTile = kKeys * kHeadDim;
  constexpr int kQ = kRowsB * kHeadDim;
  bf16* qbuf = reinterpret_cast<bf16*>(
      reinterpret_cast<char*>(smem4)
      + ((1024u - (smem_addr(smem4) & 1023u)) & 1023u));
  bf16* ring = qbuf + 2 * kQ;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kTile);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kStages;
  const int width = heads * kHeadDim;
  const int qblocks = (n + kRowsB - 1) / kRowsB;
  const int tiles = (n + kKeys - 1) / kKeys;
  // the warpgroup (kWarpgroups: the producer), read from lane 0 so that
  // the compiler sees it uniform over each warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, kConsumers / 32);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (wg == kWarpgroups) {
    // the producer: one thread issues every copy
    if (threadIdx.x != kConsumers) return;
    int g = 0;
    for (int w = blockIdx.x, k = 0; w < items; w += gridDim.x, ++k) {
      const int sh = w / qblocks, seq = sh / heads, h = sh % heads;
      const int row0 = (w % qblocks) * kRowsB;
      bf16* q = qbuf + (k & 1) * kQ;
      if (k >= 2) mbar_wait(q_empty + (k & 1), (k / 2 - 1) & 1);
      mbar_arrive_expect_tx(q_full + (k & 1), kQ * 2);
      for (int i = 0; i < kWarpgroups; ++i)
        tma_load_3d(q + i * kWgRows * kHeadDim, &tmap, q_full + (k & 1),
                    h * kHeadDim, row0 + i * kWgRows, seq);
      for (int t = 0; t < tiles; ++t, ++g) {
        const int s = g % kStages;
        if (g >= kStages) mbar_wait(empty + s, (g / kStages - 1) & 1);
        bf16* kt = ring + s * 2 * kTile;
        mbar_arrive_expect_tx(full + s, 2 * kTileBytes);
        tma_load_3d(kt, &tmap, full + s, width + h * kHeadDim, t * kKeys,
                    seq);
        tma_load_3d(kt + kTile, &tmap, full + s, 2 * width + h * kHeadDim,
                    t * kKeys, seq);
      }
    }
    return;
  }
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const float c = MASK ? kLog2e : scale * kLog2e;
  int g = 0;
  for (int w = blockIdx.x, k = 0; w < items; w += gridDim.x, ++k) {
    const int sh = w / qblocks, seq = sh / heads, h = sh % heads;
    const int wrow = (w % qblocks) * kRowsB + wg * kWgRows;   // first row
    const bool live = wrow < n;
    const int r0 = wrow + 16 * warp + (lane >> 2);
    bf16* qg = qbuf + (k & 1) * kQ + wg * kWgRows * kHeadDim;
    const uint64_t dq = wgmma_desc_sw128(qg, 1);
    WgState st;
    st.m0 = st.m1 = -INFINITY;
    st.l0 = st.l1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) st.o[i] = 0.f;
    if (live) mbar_wait(q_full + (k & 1), (k / 2) & 1);
    for (int t = 0; t < tiles; ++t, ++g) {
      const int s = g % kStages;
      mbar_wait(full + s, (g / kStages) & 1);
      if (live) {
        const bf16* kt = ring + s * 2 * kTile;
        const int j0 = t * kKeys;
        // the last tile computes only its live 16-key groups (a ViT
        // sequence is a square plus one: 1 live key of 64 at n = 577, 5 at
        // n = 197)
        if (t + 1 < tiles)
          blocked_tile<4, false, MASK>(st, dq, kt, kt + kTile, scale, c,
                                       mask, r0, n, j0);
        else
          blocked_tile<NK16, true, MASK>(st, dq, kt, kt + kTile, scale, c,
                                         mask, r0, n, j0);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    if (live)
      store_rows_wg(qg + 16 * warp * kHeadDim, st,
                    out + (size_t)seq * n * width + h * kHeadDim, width,
                    wrow + 16 * warp, n);
    // the staging's generic writes before the next TMA writes there
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty + (k & 1));
  }
}

typedef void (*BlockedBf16)(const CUtensorMap, const float*, bf16*, int, int,
                            int, float);

template <bool MASK>
BlockedBf16 blocked_bf16_kernel_m(int nk16) {
  switch (nk16) {
    case 1: return attention_blocked_bf16<1, MASK>;
    case 2: return attention_blocked_bf16<2, MASK>;
    case 3: return attention_blocked_bf16<3, MASK>;
    default: return attention_blocked_bf16<4, MASK>;
  }
}

// K4b bf16's kernel for n keys: by the live 16-key groups of the last tile
inline BlockedBf16 blocked_bf16_kernel(int n, bool masked) {
  const int nk16 = (n - (n - 1) / kKeys * kKeys + 15) / 16;
  return masked ? blocked_bf16_kernel_m<true>(nk16)
                : blocked_bf16_kernel_m<false>(nk16);
}


// ---------------------------------------------------------------- fp32

// s[i][j] = q row (slot + 4i) . key (slot + 8j) of a tile, for j < jn;
// qw: the lane's first q row, kt: the lane's first key row
template <bool FULL>
__device__ __forceinline__ void qk_tile_f32(float (&s)[4][8], const float* qw,
                                            const float* kt, int jn) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
  // not unrolled: two steps' operands in flight spill K4b's 128 registers
#pragma unroll 1
  for (int d = 0; d < kHeadDim; d += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(qw + 4 * i * kPitchF + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (FULL || j < jn) {
        const float4 b =
            *reinterpret_cast<const float4*>(kt + 8 * j * kPitchF + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
        }
      }
    }
  }
}

// o[i][.] += p row (slot + 4i) . v over nk4 keys (a multiple of 4); pw: the
// lane's first p row, vt: the tile's first row at the lane's first column
__device__ __forceinline__ void pv_tile_f32(float (&o)[4][8], const float* pw,
                                            const float* vt, int nk4) {
#pragma unroll 2
  for (int kk = 0; kk < nk4; kk += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(pw + 4 * i * kPitchP + kk);
      p[i][0] = v.x; p[i][1] = v.y; p[i][2] = v.z; p[i][3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 v0 =
          *reinterpret_cast<const float4*>(vt + (kk + c) * kPitchF);
      const float4 v1 =
          *reinterpret_cast<const float4*>(vt + (kk + c) * kPitchF + 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i][0] = fmaf(p[i][c], v0.x, o[i][0]);
        o[i][1] = fmaf(p[i][c], v0.y, o[i][1]);
        o[i][2] = fmaf(p[i][c], v0.z, o[i][2]);
        o[i][3] = fmaf(p[i][c], v0.w, o[i][3]);
        o[i][4] = fmaf(p[i][c], v1.x, o[i][4]);
        o[i][5] = fmaf(p[i][c], v1.y, o[i][5]);
        o[i][6] = fmaf(p[i][c], v1.z, o[i][6]);
        o[i][7] = fmaf(p[i][c], v1.w, o[i][7]);
      }
    }
  }
}

// a warp's running state over the key tiles, fp32
struct RowState {
  float m[4], l[4], o[4][8];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
    }
  }
};

// steps 1-4 of one key tile in the online form: scores, the running max
// and sum, the accumulators rescaled, exp(s - max) into the warp's p strip.
// row_l: the sequence row of the lane's first row; key0: the tile's first
// key; jn: the 8-key groups to compute (FULL: all 8, every key before n)
template <bool FULL>
__device__ __forceinline__ void scores_online_m(RowState& st, const float* qw,
                                                const float* kt, float* pw,
                                                float scale,
                                                const float* __restrict__ mask,
                                                int n, int row_l, int key0,
                                                int jn, int tx) {
  float s[4][8];
  qk_tile_f32<FULL>(s, qw, kt, jn);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* mr = mask_row(mask, n, row_l + 4 * i);
    if (mr != nullptr) mr += key0 + tx;
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = (FULL || j < jn)
          ? (mr != nullptr
                 ? scale_mask<!FULL, true>(s[i][j], scale, mr, n - key0 - tx,
                                           8 * j)
                 : scale_mask<!FULL, false>(s[i][j], scale, mr,
                                            n - key0 - tx, 8 * j))
          : -INFINITY;
      tmax = fmaxf(tmax, s[i][j]);
    }
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float mn = fmaxf(st.m[i], tmax), mu = guard(mn);
    const float alpha = expf(st.m[i] - mu);
    st.m[i] = mn;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (FULL || j < jn) {
        const float e = expf(s[i][j] - mu);
        sum += e;
        pw[4 * i * kPitchP + tx + 8 * j] = e;
      }
    }
    st.l[i] = st.l[i] * alpha + sum;
#pragma unroll
    for (int c = 0; c < 8; ++c) st.o[i][c] *= alpha;
  }
}

// of a tile's jn 8-key groups, how many to compute: up to the last one in
// which the mask leaves any of the warp's scores finite (the groups after
// it have p = 0 whatever q and k hold). Decided by looking at the mask
__device__ __forceinline__ int live_groups(const float* __restrict__ mask,
                                           int n, int row_l, int key0, int tx,
                                           int jn) {
  uint32_t live = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= jn) break;
    const int col = key0 + tx + 8 * j;
    bool dead = true;
    if (col < n) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dead = dead && mask_row(mask, n, row_l + 4 * i)[col] == -INFINITY;
    }
    if (!__all_sync(0xffffffffu, dead)) live |= 1u << j;
  }
  return 32 - __clz(live);
}

// one key tile of nk keys; returns the keys p . v has to cover (0: the tile
// changes nothing)
__device__ __forceinline__ int scores_online(RowState& st, const float* qw,
                                             const float* kt, float* pw,
                                             float scale,
                                             const float* __restrict__ mask,
                                             int n, int row_l, int key0,
                                             int nk, int tx) {
  int jn = (nk + 7) >> 3;
  if (mask != nullptr) jn = live_groups(mask, n, row_l, key0, tx, jn);
  if (jn == 0) return 0;
  if (jn == 8 && nk == kKeys)
    scores_online_m<true>(st, qw, kt, pw, scale, mask, n, row_l, key0, jn, tx);
  else
    scores_online_m<false>(st, qw, kt, pw, scale, mask, n, row_l, key0, jn,
                           tx);
  return min((nk + 3) & ~3, 8 * jn);
}

// o / sum, step 7
__device__ __forceinline__ void store_rows_f32(RowState& st,
                                               float* __restrict__ out_head,
                                               int width, int row_l, int n,
                                               int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = st.l[i];
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int row = row_l + 4 * i;
    if (row < n) {
      float* o = out_head + (size_t)row * width + 4 * tx;
      *reinterpret_cast<float4*>(o) = make_float4(
          st.o[i][0] / l, st.o[i][1] / l, st.o[i][2] / l, st.o[i][3] / l);
      *reinterpret_cast<float4*>(o + 32) = make_float4(
          st.o[i][4] / l, st.o[i][5] / l, st.o[i][6] / l, st.o[i][7] / l);
    }
  }
}

// K4a, fp32: grid (b * heads), 32 ceil(n / 16) threads; shared memory q, k,
// v [np][68] and p [np][72] fp32, np = 16 ceil(n / 16)
__global__ void __launch_bounds__(256)
attention_rows_f32(const float* __restrict__ qkv,
                   const float* __restrict__ mask, float* __restrict__ out,
                   int n, int heads, float scale) {
  extern __shared__ uint4 smem4[];
  const int np = blockDim.x >> 1;          // 16 rows a warp
  float* q = reinterpret_cast<float*>(smem4);
  float* k = q + np * kPitchF;
  float* v = k + np * kPitchF;
  float* p = v + np * kPitchF;
  const int width = heads * kHeadDim;
  const int seq = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t seq_off = (size_t)seq * n * 3 * width;
  load_rows(q, qkv, seq_off, n, width, h, 0, 0, np);
  load_rows(k, qkv, seq_off, n, width, h, 1, 0, np);
  cp_async_commit();
  load_rows(v, qkv, seq_off, n, width, h, 2, 0, np);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 3, tx = lane & 7;
  const int row_l = warp * kWarpRows + ty;
  RowState st;
  st.init();
  for (int key0 = 0; key0 < n; key0 += kKeys) {
    const int nk = min(kKeys, n - key0);
    const int keys = scores_online(
        st, q + row_l * kPitchF, k + (key0 + tx) * kPitchF,
        p + row_l * kPitchP, scale, mask, n, row_l, key0, nk, tx);
    if (key0 == 0) {
      cp_async_wait<0>();
      __syncthreads();                     // v is here
    }
    __syncwarp();
    pv_tile_f32(st.o, p + row_l * kPitchP, v + key0 * kPitchF + 4 * tx, keys);
    __syncwarp();
  }
  store_rows_f32(st, out + (size_t)seq * n * width + h * kHeadDim, width,
                 row_l, n, tx);
}

// K4b, fp32: grid (b * heads, ceil(n / 128)), 256 threads; shared memory
// q [128][68], a k tile and a v tile [64][68], p [128][72] fp32
__global__ void __launch_bounds__(256, 2)
attention_blocked_f32(const float* __restrict__ qkv,
                      const float* __restrict__ mask, float* __restrict__ out,
                      int n, int heads, float scale) {
  extern __shared__ uint4 smem4[];
  float* q = reinterpret_cast<float*>(smem4);
  float* kt = q + kBlockRows * kPitchF;
  float* vt = kt + kKeys * kPitchF;
  float* p = vt + kKeys * kPitchF;
  const int width = heads * kHeadDim;
  const int seq = blockIdx.x / heads, h = blockIdx.x % heads;
  const int row0 = blockIdx.y * kBlockRows;
  const size_t seq_off = (size_t)seq * n * 3 * width;
  load_rows(q, qkv, seq_off, n, width, h, 0, row0, kBlockRows);
  load_rows(kt, qkv, seq_off, n, width, h, 1, 0, kKeys);
  cp_async_commit();
  load_rows(vt, qkv, seq_off, n, width, h, 2, 0, kKeys);
  cp_async_commit();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 3, tx = lane & 7;
  const int loc = warp * kWarpRows + ty;   // the lane's first row in the block
  const bool live = row0 + warp * kWarpRows < n;
  RowState st;
  st.init();
  // two barriers a tile: the k tile of the next step loads while p . v
  // runs, the v tile of the next step while q . k^T runs
  cp_async_wait<1>();
  __syncthreads();                         // q and the first k tile are here
  for (int key0 = 0; key0 < n; key0 += kKeys) {
    const int nk = min(kKeys, n - key0);
    const bool more = key0 + kKeys < n;
    int keys = 0;
    if (live)
      keys = scores_online(st, q + loc * kPitchF, kt + tx * kPitchF,
                           p + loc * kPitchP, scale, mask, n, row0 + loc,
                           key0, nk, tx);
    cp_async_wait<0>();
    __syncthreads();     // this v tile is here; everyone is done with k
    if (more) load_rows(kt, qkv, seq_off, n, width, h, 1, key0 + kKeys, kKeys);
    cp_async_commit();
    pv_tile_f32(st.o, p + loc * kPitchP, vt + 4 * tx, keys);
    cp_async_wait<0>();
    __syncthreads();     // the next k tile is here; everyone is done with v
    if (more) load_rows(vt, qkv, seq_off, n, width, h, 2, key0 + kKeys, kKeys);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (live)
    store_rows_f32(st, out + (size_t)seq * n * width + h * kHeadDim, width,
                   row0 + loc, n, tx);
}

// ------------------------------------------------------------- launches

__host__ __device__ inline int padded_rows(int n) {
  return (n + kWarpRows - 1) / kWarpRows * kWarpRows;
}

// K4a: q, k, v of a head at the padded pitch, and in fp32 the p strips
size_t rows_smem_bytes(int n, int is_bf16) {
  const size_t np = padded_rows(n);
  return is_bf16 ? sizeof(bf16) * 3 * np * kPitchB
                 : sizeof(float) * np * (3 * kPitchF + kPitchP);
}

// K4b: in bf16 1024 bytes to align the tiles for the swizzle, two q
// buffers of kRowsB rows and kStages stages of a k and a v tile in 128-byte
// rows, and the barriers (a full and an empty one a q buffer and a stage);
// in fp32 q of 128 rows, one k tile, one v tile and the p strips. No term
// depends on n
size_t blocked_smem_bytes(int is_bf16) {
  return is_bf16
      ? 1024 + sizeof(bf16) * (2 * kRowsB + 2 * kStages * kKeys) * kHeadDim
            + sizeof(uint64_t) * (4 + 2 * kStages)
      : sizeof(float) * ((kBlockRows + 2 * kKeys) * kPitchF
                         + kBlockRows * kPitchP);
}

// cuTensorMapEncodeTiled, looked up through the runtime (the library is
// not linked against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// K4b bf16's tensor map: qkv [b][n][3 width] bf16, boxes of 64 rows x 64
// values (a head's q, k or v rows) under the 128-byte swizzle; rows past
// n read as zero
cudaError_t qkv_tensor_map(CUtensorMap* map, const void* qkv, int b, int n,
                           int width) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)3 * width, (cuuint64_t)n,
                              (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)3 * width * sizeof(bf16),
                                 (cuuint64_t)n * 3 * width * sizeof(bf16)};
  const cuuint32_t box[3] = {kHeadDim, kKeys, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(qkv), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K, typename T>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t st, const T* qkv, const float* mask, T* out,
                   int n, int heads, float scale) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(qkv, mask, out, n, heads, scale);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_rows_bf16(int nt, dim3 grid, size_t smem, cudaStream_t st,
                             const bf16* qkv, const float* mask, bf16* out,
                             int n, int heads, float scale) {
  if (nt == NT)
    return launch(attention_rows_bf16<NT>, grid, 32 * NT, smem, st, qkv, mask,
                  out, n, heads, scale);
  if constexpr (NT > 1)
    return launch_rows_bf16<NT - 1>(nt, grid, smem, st, qkv, mask, out, n,
                                    heads, scale);
  return cudaErrorInvalidValue;
}

}  // namespace tclip

extern "C" {

// K4a. qkv [b, n, 3 heads 64] and out [b, n, heads 64] contiguous and
// aligned to 16 bytes, fp32 (bf16 = 0) or bf16 (bf16 = 1), n <= 128; mask
// [n, n] fp32 or null. Returns the CUDA error of the launch (0 on success).
int tclip_attention_rows(const void* qkv, const float* mask, void* out, int b,
                         int n, int heads, float scale, int bf16,
                         void* stream) {
  if (n < 1 || n > tclip::kRowsMaxN) return (int)cudaErrorInvalidValue;
  const size_t smem = tclip::rows_smem_bytes(n, bf16);
  const int nt = tclip::padded_rows(n) / tclip::kWarpRows;
  const dim3 grid(b * heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)tclip::launch_rows_bf16<tclip::kRowsMaxN / tclip::kWarpRows>(
        nt, grid, smem, st, static_cast<const tclip::bf16*>(qkv), mask,
        static_cast<tclip::bf16*>(out), n, heads, scale);
  return (int)tclip::launch(tclip::attention_rows_f32, grid, 32 * nt, smem, st,
                            static_cast<const float*>(qkv), mask,
                            static_cast<float*>(out), n, heads, scale);
}

// K4b, same arguments, any n
int tclip_attention_blocked(const void* qkv, const float* mask, void* out,
                            int b, int n, int heads, float scale, int bf16,
                            void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = tclip::blocked_smem_bytes(bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const long long items =
        (long long)b * heads * ((n + tclip::kRowsB - 1) / tclip::kRowsB);
    if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return (int)err;
    const long long blocks =
        items < (long long)tclip::kBlocksPerSm * sms
            ? items : (long long)tclip::kBlocksPerSm * sms;
    CUtensorMap map;
    err = tclip::qkv_tensor_map(&map, qkv, b, n, heads * tclip::kHeadDim);
    if (err != cudaSuccess) return (int)err;
    const tclip::BlockedBf16 kernel =
        tclip::blocked_bf16_kernel(n, mask != nullptr);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3((unsigned)blocks), tclip::kThreadsB, smem, st>>>(
        map, mask, static_cast<tclip::bf16*>(out), n, heads, (int)items,
        scale);
    return (int)cudaGetLastError();
  }
  const dim3 grid(b * heads,
                  (n + tclip::kBlockRows - 1) / tclip::kBlockRows);
  return (int)tclip::launch(tclip::attention_blocked_f32, grid, 256, smem, st,
                            static_cast<const float*>(qkv), mask,
                            static_cast<float*>(out), n, heads, scale);
}

}  // extern "C"
