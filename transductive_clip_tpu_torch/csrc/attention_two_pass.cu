// K4b in bf16 as it was before its wgmma redesign (attention.cu), kept
// only so that chip_smoke.py and ops/attention_variants.py can time it
// beside the kernel in one run; the port never calls it. A warp owns 16 q
// rows of a block of 8 warps (128 rows) and walks the key tiles twice
// through a double-buffered ring of padded rows (mma.sync m16n8k16 with
// ldmatrix fragments): pass 1 keeps a running max and sum of IEEE expf,
// pass 2 computes q . k^T again and p = exp(s - m) / sum, rounds p to bf16
// and multiplies it by v (the TPU kernel's order of roundings). It spills
// at its 128 registers a thread; each of the 8 warps reads the whole k and
// v tile through ldmatrix.
//
// Build: as attention.cu.

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

// a warp's state over K4b's two passes, bf16
struct PassState {
  float m0, m1, l0, l1;     // running (then final) max and sum of two rows
  float o[8][4];
};

// one stage of K4b, bf16, over the first 16 NK16 keys of a tile (the last
// tile of a sequence is mostly padding: ViT sequences are a square plus
// one). kb: the k tile, then the v tile; second: pass 2
template <int NK16, bool EDGE>
__device__ __forceinline__ void blocked_stage(PassState& st, const bf16* qw,
                                              const bf16* kb, bool second,
                                              float scale, const float* mr0,
                                              const float* mr1, int n, int j0,
                                              int lane) {
  constexpr int NT8 = 2 * NK16;
  float sc[NT8][4];
  {
    // q's fragments anew each stage: 16 registers less to carry
    uint32_t qf[4][4];
    load_q_frags(qf, qw, lane);
    qk_tile<NT8>(sc, qf, kb, lane);
  }
  // only the last 16 of an edge tile's keys can lie past n
  scale_mask_tile<NT8, EDGE ? NT8 - 2 : NT8>(sc, scale, mr0, mr1, n,
                                             j0 + 2 * (lane & 3));
  if (!second) {
    // pass 1: this lane's share of the rows' running max and sum
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      t0 = fmaxf(t0, fmaxf(sc[j][0], sc[j][1]));
      t1 = fmaxf(t1, fmaxf(sc[j][2], sc[j][3]));
    }
    const float n0 = fmaxf(st.m0, t0), n1 = fmaxf(st.m1, t1);
    const float u0 = guard(n0), u1 = guard(n1);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT8; ++j) {
      a0 += expf(sc[j][0] - u0) + expf(sc[j][1] - u0);
      a1 += expf(sc[j][2] - u1) + expf(sc[j][3] - u1);
    }
    st.l0 = st.l0 * expf(st.m0 - u0) + a0;
    st.l1 = st.l1 * expf(st.m1 - u1) + a1;
    st.m0 = n0;
    st.m1 = n1;
    return;
  }
  // pass 2: p normalised, then rounded, then multiplied
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
    sc[j][0] = expf(sc[j][0] - st.m0);
    sc[j][1] = expf(sc[j][1] - st.m0);
    sc[j][2] = expf(sc[j][2] - st.m1);
    sc[j][3] = expf(sc[j][3] - st.m1);
  }
  uint32_t pa[NK16][4];
  pack_p<NK16>(pa, sc, st.l0, st.l1);
  pv_tile<NK16>(st.o, pa, kb + kKeys * kPitchB, lane);
}

// K4b, bf16: grid (b * heads, ceil(n / 128)), 256 threads; shared memory
// q [128][72] and two stages of a k and a v tile [64][72] bf16
__global__ void __launch_bounds__(256, 2)
attention_blocked_bf16(const bf16* __restrict__ qkv,
                       const float* __restrict__ mask, bf16* __restrict__ out,
                       int n, int heads, float scale) {
  extern __shared__ uint4 smem4[];
  constexpr int kTile = kKeys * kPitchB;
  bf16* q = reinterpret_cast<bf16*>(smem4);
  bf16* ring = q + kBlockRows * kPitchB;
  const int width = heads * kHeadDim;
  const int seq = blockIdx.x / heads, h = blockIdx.x % heads;
  const int row0 = blockIdx.y * kBlockRows;
  const size_t seq_off = (size_t)seq * n * 3 * width;
  const int tiles = (n + kKeys - 1) / kKeys, stages = 2 * tiles;
  // stage s: the k tile s % tiles, and from the second pass on its v tile
  auto prefetch = [&](int s) {
    bf16* kb = ring + (s & 1) * 2 * kTile;
    const int j0 = (s < tiles ? s : s - tiles) * kKeys;
    load_rows(kb, qkv, seq_off, n, width, h, 1, j0, kKeys);
    if (s >= tiles)
      load_rows(kb + kTile, qkv, seq_off, n, width, h, 2, j0, kKeys);
    cp_async_commit();
  };
  load_rows(q, qkv, seq_off, n, width, h, 0, row0, kBlockRows);
  prefetch(0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int wrow = row0 + warp * kWarpRows;
  const bool live = wrow < n;
  bf16* qw = q + warp * kWarpRows * kPitchB;
  PassState st;
  st.m0 = st.m1 = -INFINITY;
  st.l0 = st.l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    st.o[j][0] = st.o[j][1] = st.o[j][2] = st.o[j][3] = 0.f;
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<0>();
    __syncthreads();      // stage s is here; everyone is done with s - 1
    if (s + 1 < stages) prefetch(s + 1);
    if (!live) continue;
    if (s == tiles) {
      // the rows' final max and sum from the quad's four shares
      float n0 = st.m0, n1 = st.m1;
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        n0 = fmaxf(n0, __shfl_xor_sync(0xffffffffu, n0, off));
        n1 = fmaxf(n1, __shfl_xor_sync(0xffffffffu, n1, off));
      }
      n0 = guard(n0);
      n1 = guard(n1);
      st.l0 *= expf(st.m0 - n0);
      st.l1 *= expf(st.m1 - n1);
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, off);
        st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, off);
      }
      st.m0 = n0;
      st.m1 = n1;
    }
    const bf16* kb = ring + (s & 1) * 2 * kTile;
    const bool second = s >= tiles;
    const int j0 = (second ? s - tiles : s) * kKeys;
    // the mask rows anew each stage too: four registers less to carry
    const float* mr0 = mask_row(mask, n, wrow + g);
    const float* mr1 = mask_row(mask, n, wrow + g + 8);
    const int nk = n - j0;
    if (nk >= kKeys)
      blocked_stage<4, false>(st, qw, kb, second, scale, mr0, mr1, n, j0, lane);
    else if (nk > 48)
      blocked_stage<4, true>(st, qw, kb, second, scale, mr0, mr1, n, j0, lane);
    else if (nk > 32)
      blocked_stage<3, true>(st, qw, kb, second, scale, mr0, mr1, n, j0, lane);
    else if (nk > 16)
      blocked_stage<2, true>(st, qw, kb, second, scale, mr0, mr1, n, j0, lane);
    else
      blocked_stage<1, true>(st, qw, kb, second, scale, mr0, mr1, n, j0, lane);
  }
  if (live)
    store_warp(qw, st.o, out + (size_t)seq * n * width + h * kHeadDim, width,
               wrow, n, lane);
}

}  // namespace tclip

extern "C" {

// the two-pass K4b bf16, same arguments as attention.cu's entry (bf16 only)
int tclip_attention_blocked(const void* qkv, const float* mask, void* out,
                            int b, int n, int heads, float scale, int bf16,
                            void* stream) {
  if (n < 1 || !bf16) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(tclip::bf16)
      * (tclip::kBlockRows + 4 * tclip::kKeys) * tclip::kPitchB;
  cudaError_t err = cudaFuncSetAttribute(
      tclip::attention_blocked_bf16,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tclip::attention_blocked_bf16<<<
      dim3(b * heads, (n + tclip::kBlockRows - 1) / tclip::kBlockRows), 256,
      smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const tclip::bf16*>(qkv), mask,
      static_cast<tclip::bf16*>(out), n, heads, scale);
  return (int)cudaGetLastError();
}

const char* tclip_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
