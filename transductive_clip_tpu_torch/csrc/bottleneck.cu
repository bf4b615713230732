// The fused ResNet identity bottleneck for Hopper (sm_90a), bound with
// ctypes by ops/cuda_bottleneck.py.
//
// K5 tclip_bottleneck replaces _kernel (fused_identity_bottleneck) of
//    transductive_clip_tpu/ops/pallas_bottleneck.py. For x [B, H, W, C] (NHWC),
//    w1 [C, Cm], w2 [3, 3, Cm, Cm] (HWIO), w3 [Cm, C] and the biases of the
//    folded BatchNorms, in the TPU kernel's roundings (T is x's dtype):
//      h1  = T(relu(x . w1 + b1))                 fp32 sums and bias
//      h2  = T(relu(conv3x3(h1, pad 1) . w2 + b2))
//      out = relu(T(T(T(h2 . w3) + T(b3)) + x))   the adds in T
//    Products of two T values are exact in fp32, and every sum is fp32, as
//    the TPU's bf16 x bf16 -> fp32 dots.
//
// Bound. At the RN50 identity blocks and batch 512 a launch is 2.2e11
// operations (the three convolutions; the same at every stage), 0.23 ms at
// 989 TFLOP/s of bf16 tensor cores, against 1.6, 0.8, 0.4 and 0.2 GB of x,
// out and weights in bf16 (layer1 to layer4; 0.49 and 0.25 ms at 3.35 TB/s
// for layer1 and layer2): bound by bytes in the first two stages and by
// operations in the last two.
//
// Design. The TPU instance holds one whole image in VMEM. Here layer1's
// zero-padded hidden block alone is [58, 58, 64] bf16 = 420 KB, over a
// block's 227 KB of shared memory. So one block (512 threads in bf16, 256 in
// fp32; one block an SM) owns an
// (image, strip of R output rows), h1 and h2 never leave shared memory, and
// the three convolutions are three products pixels x input channels times
// input x output channels:
//   1. conv1 over the strip's rows plus a one-row halo above and below (the
//      rows inside the image only), + b1, relu, rounded to T, into h1
//      [R + 2][W + 2][pitch], zeroed first: the columns left and right and
//      the halo rows outside the image are conv2's padding;
//   2. conv2 as a 9-tap sum over h1 (the contraction is 9 Cm deep, tap-major
//      as w2's HWIO layout), + b2, relu, rounded to T, into h2 [R W][pitch];
//   3. conv3 over h2, then the T roundings and adds of the formula, straight
//      to out; the residual x is read again from device memory or L2.
//
//   bf16 (bottleneck_bf16_kernel): the three products on tensor cores,
//   mma.sync m16n8k16 (bf16 x bf16 -> fp32) with ldmatrix fragments;
//   mma.sync and not wgmma, as in attention.cu: a strip is 49 to 448 pixels,
//   16-row tiles fit it where 64-row ones waste up to a quarter, and the
//   route is the one this repository already runs. The A operand of conv2
//   and conv3 is read where it lies: every lane of an ldmatrix gives its own
//   row address, so a 3 x 3 tap is the offset (dh (W + 2) + dw) pitch from
//   the pixel's own h1 row and the im2col costs nothing (one division a
//   lane and 16-row tile, none per element). The channel pitch is Cm
//   rounded up to 32 (a slice of the contraction never straddles two taps;
//   the new channels are zero) plus 8, so that the eight rows of an
//   ldmatrix fall in different banks. The weights keep their [K][N] layout
//   and come in, like x for conv1, by 16-byte cp.async through a ring of
//   three slices 32 deep, read with ldmatrix.trans; one barrier a slice,
//   the copies of the slice two ahead started behind the slice's mma (their
//   places in the slice worked out once a product, not once a copy), and
//   the ring runs on across the output tiles of a product, so a tile's
//   first slices load while the tile before it is multiplied. A product
//   walks its output in chunks of at most 256 rows and tiles of 32 WN
//   columns: 16 warps as WM x WN with WM = 2, 4 or 8 by the chunk's rows, a
//   warp owns 32 rows x 32 columns (4 ldmatrix.x4 for 8 mma; with 8 warps of
//   64 x 32 the two small stages ran 10% slower and the two deep ones 4%
//   faster). The column tiles are walked from a start that differs from
//   block to block, so that the blocks in flight do not all ask L2 for the
//   same weight slice. conv3's output tile, + b3, passes through shared
//   memory (h1's place: h1 is done with) and leaves 16 bytes a lane, with
//   the residual x asked for before the tile's first slice. Shapes whose
//   rows do not start on 16 bytes (C or Cm not a multiple of 8) are staged
//   value by value into the same slices.
//   What a block owns (ops/cuda_bottleneck.strip_rows: the largest R that
//   fits 227 KB less the ring, then evened over the image; one block an SM):
//     layer1 [56, 56, 256] / 64:   R = 8, 7 strips; halo 10 / 8 of conv1
//     layer2 [28, 28, 512] / 128:  R = 7, 4 strips; halo 9 / 7
//     layer3 [14, 14, 1024] / 256: R = 7, 2 strips; halo 8 / 7
//     layer4 [7, 7, 2048] / 512:   the whole image, no halo; 49 pixels in
//                                  four 16-row tiles
//   Every block streams the three weight matrices from L2 once per chunk of
//   rows (layer4: 8.9 MB for each of 512 blocks; they fit L2). What holds
//   the kernel at 5 to 9 times its bound: a block's slice is a chain of
//   copies, barrier, fragment loads, mma and tile stores, each a similar
//   share of a launch (the ablations in PERF.md), and shared memory
//   leaves room for one block an SM, so nothing hides one link behind
//   another; at layer3 and layer4 the 98 and 49 pixels a block owns make it
//   re-read 2.2 and 8.9 MB of weights from L2.
//   ptxas (-Xptxas -v, sm_90a): 117 registers at 512 threads (128 in the
//   build for rows off 16 bytes), no spills;
//   shared memory 223,296 / 202,016 / 203,040 / 210,464 bytes at layer1-4.
//
//   fp32 (bottleneck_f32_kernel): FFMA, TF32 stays off. Bound: 2 B H W
//   (2 C Cm + 9 Cm^2) operations at 67 TFLOP/s, the same 0.4172 ms at every
//   RN50 stage at batch 64; x, out and the weights are 0.41 GB at most
//   (0.12 ms at 3.35 TB/s): bound by operations everywhere. 256 threads, an
//   8 x 8 register tile a thread. A is read as float4 along the
//   contraction where it lies: conv2's from h1 with the tap as the address
//   offset (dh (W + 2) + dw) pitch (no im2col; one division a row and
//   tile), conv3's from h2; conv1's x comes by 16-byte cp.async through a
//   ring of three slices [rows][16 + 4] in h2's place (h2 is free until
//   conv2). The channel pitch of h1 and h2 is Cm rounded up to 16 (a slice
//   of conv2's contraction never straddles two taps; the new channels are
//   zero) plus 4, so that the rows of a float4 read fall in different
//   banks. The weights keep their [K][N] layout and come by 16-byte
//   cp.async through a ring of three slices 16 deep, read as float4 across
//   the tile; one barrier a slice, the copies of the slice two ahead
//   started before the slice's FMAs, the ring running on across a
//   product's tiles. Each product picks its own cut (TilingF): warps of
//   32 x 64 outputs, the 8 of them over one tile of 64 to 256 rows, or in
//   2 or 4 groups that split each slice's depth over a smaller tile (down
//   to 32 rows) and hand their sums over in place (where the output goes:
//   h1, h2 or out) at the tile's end; whichever pads least. Without the
//   groups, layer4's products of 21 to 35 rows padded 64-row tiles by up
//   to 60% and the stage ran 1.3 times slower. Shapes whose rows do not
//   start on 16 bytes (C or Cm not a multiple of 4) are staged value by
//   value into the same slices.
//   What a block owns (strip_rows: the largest R within 227 KB, one block
//   an SM, then evened over the image):
//     layer1 [56, 56, 256] / 64:   R = 4, 14 strips; 205,248 bytes
//     layer2 [28, 28, 512] / 128:  R = 4, 7 strips;  205,632 bytes
//     layer3 [14, 14, 1024] / 256: R = 4, 4 strips (4, 4, 4, 2); 210,432
//     layer4 [7, 7, 2048] / 512:   R = 4, 2 strips (4, 3); 222,048 bytes
//   conv1 runs on 1.46, 1.43, 1.43 and 1.29 times the output rows; every
//   block reads the three weight matrices from L2 once: 0.25, 0.50, 1.14
//   and 2.28 GB a launch at batch 64 (layer1 to layer4).
//   What holds it at ~3.7 times its bound (PERF.md; a reading of the
//   design, not a profile): a 4-deep step of a warp is 16 LDS.128 for 256
//   FMAs, and an LDS.128 delivers 512 bytes at the SM's 128 a cycle, so
//   the shared-memory pipe is as busy as the FMA pipes, and with 8 warps an
//   SM the tiles run at ~40% of the FMA rate. An 8 x 16 tile a thread (24
//   LDS.128 for 512 FMAs) needed more than 255 registers and spilled: 1.2
//   times slower.
//   ptxas (-Xptxas -v, sm_90a): 233 registers at 256 threads, no spills.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
// -Xcompiler -fPIC, without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace tclip {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;

// ------------------------------------------------------------------ bf16

constexpr int kThreadsB = 512;  // 16 warps, each a 32 x 32 share of a tile
constexpr int kDepth = 32;      // depth of a slice of the contraction
constexpr int kStages = 3;      // slices in the ring
constexpr int kChanUnit = 32;   // Cm is padded to a multiple of it in h1, h2
constexpr int kPad = 8;         // bf16 values of padding a shared-memory row
constexpr int kChunkRows = 256; // most rows of a chunk (8 warps x 32)
constexpr int kAPitch = kDepth + kPad;       // a streamed A slice's row
// a stage holds an A slice of 32 WM rows and a weight slice of 512 / WM
// columns; WM = 8 is the largest
constexpr int kStageBytes =
    2 * (kChunkRows * kAPitch + kDepth * (64 + kPad));
// conv3's output tile on its way out: the largest of [256][64 + 8],
// [128][128 + 8] and [64][256 + 8] bf16; it takes h1's place
constexpr int kStagingBytes = 2 * kChunkRows * (64 + kPad);
// 16-byte pieces of such a tile a thread: 256 x 64, 128 x 128 or 64 x 256
// values over 512 threads
constexpr int kTileVecs = kChunkRows * 64 / 8 / kThreadsB;
// 16-byte copies of a slice a thread: 32 x 256 weights or 256 x 32 of A
constexpr int kCopies = kDepth * 256 / 8 / kThreadsB;
constexpr int kSmemMax = 227 * 1024;

__host__ __device__ inline int padded_channels(int c_mid) {
  return (c_mid + kChanUnit - 1) / kChanUnit * kChanUnit;
}
// bytes of h1 [R + 2][W + 2][pitch], at least conv3's staging tile
__host__ __device__ inline size_t h1_bytes(int W, int Cm, int R) {
  const size_t bytes =
      2 * (size_t)(padded_channels(Cm) + kPad) * (R + 2) * (W + 2);
  return bytes > (size_t)kStagingBytes ? bytes : (size_t)kStagingBytes;
}
// bytes of shared memory for strips of R rows
__host__ __device__ inline size_t smem_bytes_bf16(int W, int Cm, int R) {
  return (size_t)kStages * kStageBytes + h1_bytes(W, Cm, R)
         + 2 * (size_t)(padded_channels(Cm) + kPad) * R * W;
}

// 8 values from src into dst: one 16-byte cp.async when the rows are
// aligned, else value by value; the first `live` of them, zeros after
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int live,
                                       bool aligned) {
  if (aligned) {
    if (live > 0)
      cp_async16(dst, src);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dst[i] = i < live ? src[i] : __float2bfloat16_rn(0.f);
}

// what a product reads and where: see block_gemm
struct GemmShape {
  int M;          // output rows
  int n_out;      // output columns to compute
  int groups;     // groups of slices of the contraction (conv2: the 9 taps)
  int per_group;  // slices a group
  const bf16* B;  // weights [rows][ldb] in device memory
  int ldb;        // their row length = their live columns
  const bf16* A;  // streamed A [M][lda] in device memory, or null: in place
  int lda;        // its row length = its live columns
  bool aligned;   // every row of A and B starts on 16 bytes
};

// where a product's walk stands: chunk of rows, tile of columns, group and
// slice of the contraction, innermost last (no division in the loop)
struct Walk {
  int ch = 0, nt = 0, g = 0, j = 0, left;
  // a block starts a chunk at column tile `first` and wraps around, so that
  // the blocks in flight do not all ask L2 for the same weight slice at once
  __device__ __forceinline__ Walk(int first, int tiles)
      : nt(first), left(tiles) {}
  __device__ __forceinline__ void step(int tiles, const GemmShape& s) {
    if (++j < s.per_group) return;
    j = 0;
    if (++g < s.groups) return;
    g = 0;
    if (++nt == tiles) nt = 0;
    if (--left > 0) return;
    left = tiles;
    ++ch;
  }
};

// how block_gemm cuts a product of M rows: chunks of `rows` rows (a multiple
// of 16, at most 256), 16 warps as wm x (16 / wm), each 32 rows x 32
// columns, output tiles of bn columns
struct Tiling {
  // wm = 1 << wshift, bn = 8 << bshift
  int chunks, rows, wm, wshift, bn, bshift;
  __device__ __forceinline__ explicit Tiling(int M) {
    chunks = (M + kChunkRows - 1) / kChunkRows;
    rows = ((M + chunks - 1) / chunks + 15) / 16 * 16;
    wshift = rows <= 64 ? 1 : rows <= 128 ? 2 : 3;
    wm = 1 << wshift;
    bn = 32 * (16 / wm);
    bshift = 6 - wshift;
  }
};

// C[M, n_out] = A . B on the tensor cores. Slice (g, j) of B is rows
// b_row0(g, j) .. + b_live(j) of s.B (the rest of the 32 zero). A is either
// streamed from s.A through the ring (columns 32 (g per_group + j) ..), or
// read in place from shared memory: a_base(g, j) + row_off(m) is row m's
// first value of the slice. The sums of row m, columns n and n + 1 (n even)
// go, as value(n, sum) rounded to bf16, to row_ptr(m, row in the chunk, bn)
// + n (LOCAL: + the column in the tile) in shared memory; with LOCAL,
// before_tile(first row, rows, first column, bn, bshift) runs before a
// tile's first slice and after_tile(the same) after a barrier once the tile
// is stored. Every thread of the block must call it; it
// ends with the ring drained but without a barrier.
template <bool LOCAL, typename BRow0, typename BLive, typename ABase,
          typename RowOff, typename RowPtr, typename Value,
          typename BeforeTile, typename AfterTile>
__device__ __forceinline__ void block_gemm(
    const GemmShape& s, char* ring, const BRow0& b_row0, const BLive& b_live,
    const ABase& a_base, const RowOff& row_off, const RowPtr& row_ptr,
    const Value& value, const BeforeTile& before_tile,
    const AfterTile& after_tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tiling tl(s.M);
  const int b_pitch = tl.bn + kPad;
  const int wm = warp & (tl.wm - 1), wn = warp >> tl.wshift;
  const int tiles = (s.n_out + tl.bn - 1) / tl.bn;
  const int total = tl.chunks * tiles * s.groups * s.per_group;
  const int a_bytes = 2 * 32 * tl.wm * kAPitch;
  // the warp's live 16-row tiles of a chunk
  const int n_mi = max(0, min(2, (tl.rows - wm * 32) / 16));

  // this thread's copies of a slice: up to kCopies 16-byte pieces of the
  // weight slice and of the streamed A slice, their places worked out once
  int b_row[kCopies], b_col[kCopies], a_row[kCopies], a_col[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int e = threadIdx.x + i * kThreadsB;
    b_row[i] = e < kDepth << tl.bshift ? e >> tl.bshift : -1;
    b_col[i] = (e & ((1 << tl.bshift) - 1)) << 3;
    a_row[i] = s.A != nullptr && e < tl.rows * (kDepth / 8)
        ? e / (kDepth / 8) : -1;
    a_col[i] = e % (kDepth / 8) * 8;
  }
  auto fill = [&](const Walk& w, int stage) {
    bf16* as = reinterpret_cast<bf16*>(ring + stage * kStageBytes);
    bf16* bs = reinterpret_cast<bf16*>(ring + stage * kStageBytes + a_bytes);
    const int live_rows = b_live(w.j), col0 = w.nt * tl.bn;
    const bf16* bsrc = s.B + (size_t)b_row0(w.g, w.j) * s.ldb + col0;
    const int k0 = (w.g * s.per_group + w.j) * kDepth, m0 = w.ch * tl.rows;
    const bf16* asrc = s.A + (size_t)m0 * s.lda + k0;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      if (b_row[i] >= 0)
        stage8(bs + b_row[i] * b_pitch + b_col[i],
               bsrc + b_row[i] * s.ldb + b_col[i],
               b_row[i] < live_rows ? min(8, s.ldb - col0 - b_col[i]) : 0,
               s.aligned);
      if (a_row[i] >= 0)
        stage8(as + a_row[i] * kAPitch + a_col[i],
               asrc + a_row[i] * s.lda + a_col[i],
               m0 + a_row[i] < s.M ? min(8, s.lda - k0 - a_col[i]) : 0,
               s.aligned);
    }
  };

  float acc[2][4][4];
  int arow[2];
  Walk ahead(blockIdx.x % tiles, tiles), here(blockIdx.x % tiles, tiles);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) {
      fill(ahead, i);
      ahead.step(tiles, s);
    }
    cp_async_commit();
  }
  for (int item = 0; item < total; ++item) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int stage = item % kStages;
    if (here.g == 0 && here.j == 0) {
      if (LOCAL)
        before_tile(here.ch * tl.rows, tl.rows, here.nt * tl.bn, tl.bn,
                    tl.bshift);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;
        // the lane's row of the tile's ldmatrix: rows 0-7, 8-15, 0-7, 8-15
        const int r = (wm * 2 + mi) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        arow[mi] = s.A != nullptr
            ? r * kAPitch
            : row_off(min(here.ch * tl.rows + r, s.M - 1));
      }
    }
    const bf16* ap = (s.A != nullptr
        ? reinterpret_cast<const bf16*>(ring + stage * kStageBytes)
        : a_base(here.g, here.j)) + 8 * (lane >> 4);
    const bf16* bp =
        reinterpret_cast<const bf16*>(ring + stage * kStageBytes + a_bytes)
        + ((lane & 7) + 8 * ((lane >> 3) & 1)) * b_pitch + wn * 32
        + 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      uint32_t af[2][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (mi < n_mi) ldmatrix_x4(af[mi], ap + arow[mi] + kk);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4_trans(bfr[p], bp + kk * b_pitch + p * 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (mi < n_mi) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][2 * (ni & 1)],
                     bfr[ni >> 1][2 * (ni & 1) + 1]);
        }
    }
    // the copies of the slice two ahead are started behind this slice's mma:
    // the tensor cores work while the copies queue up
    if (item + kStages - 1 < total) {
      fill(ahead, (item + kStages - 1) % kStages);
      ahead.step(tiles, s);
    }
    cp_async_commit();
    if (here.g == s.groups - 1 && here.j == s.per_group - 1) {
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (mi >= n_mi) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = (wm * 2 + mi) * 16 + g + 8 * half;
          const int m = here.ch * tl.rows + r;
          if (m >= s.M) continue;
          bf16* dst = row_ptr(m, r, tl.bn);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int c = wn * 32 + ni * 8 + 2 * t;
            const int n = here.nt * tl.bn + c;
            if (n < s.n_out)
              *reinterpret_cast<uint32_t*>(dst + (LOCAL ? c : n)) =
                  pack_bf16(value(n, acc[mi][ni][2 * half]),
                            value(n + 1, acc[mi][ni][2 * half + 1]));
          }
        }
      }
      if (LOCAL) {
        __syncthreads();
        after_tile(here.ch * tl.rows, tl.rows, here.nt * tl.bn, tl.bn,
                   tl.bshift);
      }
    }
    here.step(tiles, s);
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// grid (B * ceil(H / R)), one block an SM; shared memory: the ring, h1
// [R + 2][W + 2][pitch] (at least kStagingBytes: conv3's output tiles pass
// through it) and h2 [R W][pitch], pitch = padded Cm + 8
// ALIGNED: C and Cm are multiples of 8, so every row of x and of the weights
// starts on 16 bytes
template <bool ALIGNED>
__global__ void __launch_bounds__(kThreadsB, 1)
bottleneck_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                       const float* __restrict__ b1,
                       const bf16* __restrict__ w2,
                       const float* __restrict__ b2,
                       const bf16* __restrict__ w3,
                       const bf16* __restrict__ b3, bf16* __restrict__ out,
                       int H, int W, int C, int Cm, int R) {
  extern __shared__ uint4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  const int cmp = padded_channels(Cm), pitch = cmp + kPad, Wp = W + 2;
  bf16* h1 = reinterpret_cast<bf16*>(ring + kStages * kStageBytes);
  bf16* h2 = reinterpret_cast<bf16*>(
      ring + kStages * kStageBytes + h1_bytes(W, Cm, R));
  const int strips = (H + R - 1) / R;
  const int img = blockIdx.x / strips;
  const int y0 = (blockIdx.x % strips) * R;
  const int rows = min(R, H - y0);
  const bf16* xi = x + (size_t)img * H * W * C;
  bf16* oi = out + (size_t)img * H * W * C;
  constexpr bool aligned = ALIGNED;
  const int per_tap = cmp / kDepth;      // slices of a tap, of conv3
  auto no_tile = [](int, int, int, int, int) {};

  // conv2's padding: all of h1 is zero before conv1 fills the image's part
  {
    uint4* z = reinterpret_cast<uint4*>(h1);
    const int n16 = (rows + 2) * Wp * pitch / 8;
    for (int e = threadIdx.x; e < n16; e += kThreadsB)
      z[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // 1. conv1 + b1, relu, over the image's rows among y0 - 1 .. y0 + rows
  const int y_lo = max(y0 - 1, 0), y_hi = min(y0 + rows, H - 1);
  {
    GemmShape s{(y_hi - y_lo + 1) * W, cmp, 1, (C + kDepth - 1) / kDepth, w1,
                Cm, xi + (size_t)y_lo * W * C, C, aligned};
    const int hr0 = y_lo - (y0 - 1);
    block_gemm<false>(
        s, ring, [&](int, int j) { return j * kDepth; },
        [&](int j) { return C - j * kDepth; },
        [&](int, int) -> const bf16* { return nullptr; },
        [&](int) { return 0; },
        [&](int m, int, int) {
          return h1 + ((hr0 + m / W) * Wp + m % W + 1) * pitch;
        },
        [&](int n, float v) { return n < Cm ? fmaxf(v + b1[n], 0.f) : 0.f; },
        no_tile, no_tile);
  }
  __syncthreads();

  // 2. conv2 (3 x 3, the 9 taps tap-major) + b2, relu; A is h1 in place
  {
    GemmShape s{rows * W, cmp, 9, per_tap, w2, Cm, nullptr, 0, aligned};
    block_gemm<false>(
        s, ring, [&](int g, int j) { return g * Cm + j * kDepth; },
        [&](int j) { return Cm - j * kDepth; },
        [&](int g, int j) -> const bf16* {
          return h1 + ((g / 3) * Wp + g % 3) * pitch + j * kDepth;
        },
        [&](int m) { return ((m / W) * Wp + m % W) * pitch; },
        [&](int m, int, int) { return h2 + m * pitch; },
        [&](int n, float v) { return n < Cm ? fmaxf(v + b2[n], 0.f) : 0.f; },
        no_tile, no_tile);
  }
  __syncthreads();

  // 3. conv3 and + b3 in bf16 into a tile in shared memory (h1's place: h1
  // is done with), then + x in bf16 and relu, 16 bytes a lane, to out. A
  // lane's share of the tile's x (at most 8 x 16 bytes) is asked for before
  // the tile's first slice and has arrived when the tile is stored
  {
    GemmShape s{rows * W, C, 1, per_tap, w3, C, nullptr, 0, aligned};
    bf16* tile = h1;
    uint4 xr[kTileVecs];
    // the lane's i-th 16 bytes of a tile: row and column in the tile, and
    // the offset in the image, or -1 past the strip or the channels
    auto vec = [&](int i, int m0, int tile_rows, int n0, int bshift, int& r,
                   int& c) -> long long {
      const int e = threadIdx.x + i * kThreadsB;
      r = e >> bshift;
      c = (e & ((1 << bshift) - 1)) << 3;
      if (r >= tile_rows || m0 + r >= rows * W || n0 + c >= C) return -1;
      return ((long long)y0 * W + m0 + r) * C + n0 + c;
    };
    block_gemm<true>(
        s, ring, [&](int, int j) { return j * kDepth; },
        [&](int j) { return Cm - j * kDepth; },
        [&](int, int j) -> const bf16* { return h2 + j * kDepth; },
        [&](int m) { return m * pitch; },
        [&](int, int r, int bn) { return tile + r * (bn + kPad); },
        [&](int n, float v) {
          return n < C
              ? round_bf16(round_bf16(v) + __bfloat162float(b3[n])) : 0.f;
        },
        [&](int m0, int tile_rows, int n0, int, int bshift) {
          if (!aligned) return;
#pragma unroll
          for (int i = 0; i < kTileVecs; ++i) {
            int r, c;
            const long long off = vec(i, m0, tile_rows, n0, bshift, r, c);
            if (off >= 0) xr[i] = *reinterpret_cast<const uint4*>(xi + off);
          }
        },
        [&](int m0, int tile_rows, int n0, int bn, int bshift) {
#pragma unroll
          for (int i = 0; i < kTileVecs; ++i) {
            int r, c;
            const long long off = vec(i, m0, tile_rows, n0, bshift, r, c);
            if (off < 0) continue;
            const bf16* sp = tile + r * (bn + kPad) + c;
            if (aligned) {
              const uint4 sv = *reinterpret_cast<const uint4*>(sp);
              const __nv_bfloat162* s2 =
                  reinterpret_cast<const __nv_bfloat162*>(&sv);
              const __nv_bfloat162* x2 =
                  reinterpret_cast<const __nv_bfloat162*>(&xr[i]);
              uint32_t o[4];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                o[q] = pack_bf16(
                    fmaxf(round_bf16(__low2float(s2[q]) + __low2float(x2[q])),
                          0.f),
                    fmaxf(round_bf16(__high2float(s2[q])
                                     + __high2float(x2[q])), 0.f));
              *reinterpret_cast<uint4*>(oi + off) =
                  make_uint4(o[0], o[1], o[2], o[3]);
            } else {
              for (int q = 0; q < 8 && n0 + c + q < C; ++q)
                oi[off + q] = __float2bfloat16_rn(fmaxf(
                    round_bf16(__bfloat162float(sp[q])
                               + __bfloat162float(xi[off + q])), 0.f));
            }
          }
        });
  }
}

// ------------------------------------------------------------------ fp32

constexpr int kDepthF = 16;      // depth of a slice of the contraction
constexpr int kChanUnitF = 16;   // Cm is padded to a multiple of it in h1, h2
constexpr int kPadF = 4;         // floats of padding a shared-memory row
constexpr int kRingColsF = 256;  // the widest weight slice (64 x 256 tiles)
constexpr int kRowsF = 256;      // the most rows of a tile (256 x 64 tiles)
constexpr int kAPitchF = kDepthF + 4;          // a streamed x slice's row
constexpr int kWStageF = kDepthF * kRingColsF;  // floats of a weight slice
constexpr int kXStageF = kRowsF * kAPitchF;     // floats of an x slice

__host__ __device__ inline int padded_channels_f32(int c_mid) {
  return (c_mid + kChanUnitF - 1) / kChanUnitF * kChanUnitF;
}
// bytes of shared memory for strips of R rows: the weight ring, h1
// [R + 2][W + 2][pitch], and h2 [R W][pitch], whose place holds conv1's x
// ring before h2 is written (pitch = padded Cm + kPadF)
__host__ __device__ inline size_t smem_bytes_f32(int W, int Cm, int R) {
  const size_t pitch = padded_channels_f32(Cm) + kPadF;
  const size_t h2 = pitch * R * W, x_ring = (size_t)kStages * kXStageF;
  return sizeof(float) * ((size_t)kStages * kWStageF
                          + pitch * (R + 2) * (W + 2)
                          + (h2 > x_ring ? h2 : x_ring));
}

// 4 values from src into dst: one 16-byte cp.async when the rows are
// aligned, else value by value; the first `live` of them, zeros after
__device__ __forceinline__ void stage4(float* dst, const float* src, int live,
                                       bool aligned) {
  if (aligned) {
    if (live > 0)
      cp_async16(dst, src);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[i] = i < live ? src[i] : 0.f;
}

// what an fp32 product reads and where: see block_gemm_f32
struct GemmF {
  int M;           // output rows
  int n_out;       // output columns to compute
  int groups;      // groups of slices of the contraction (conv2: the 9 taps)
  int per_group;   // slices a group
  const float* B;  // weights [rows][ldb] in device memory
  int ldb;         // their row length = their live columns
  const float* A;  // streamed A [M][lda] in device memory, or null: in place
  int lda;         // its row length = its live columns
  bool aligned;    // every row of A and B starts on 16 bytes
};

// how an fp32 product is cut: output tiles of rows x bn; the 8 warps form
// `split` groups (1, 2 or 4), each a wm x wn grid of warps of 32 x 64
// outputs (8 x 8 a thread) over the whole tile, that takes its own
// 16 / split of every slice's depth. Of the cuts whose tile fits the rings
// (at most kRowsF rows and kRingColsF columns), the one with the least
// padded work, (K + 16 (split - 1)) for every output of every tile: a
// split adds one pass over the tile per group at its end (ties: the
// smaller split, more rows). A split serves the products of few rows:
// layer4's 21- to 35-row strips take 32-row tiles split 2 ways, not 64-row
// tiles half empty
struct TilingF {
  int split, wm, wn, rows, bn, chunks, tiles;
  __device__ __forceinline__ TilingF(int M, int N, int K) {
    long long best = 0x7fffffffffffffffLL;
    split = 1, wm = 8, wn = 1;
    for (int s = 1; s <= 4; s *= 2)
      for (int m = 8; m >= 1; m /= 2) {
        const int groupw = 8 / s;
        if (groupw % m) continue;
        const int r = 32 * m, b = 64 * (groupw / m);
        if (r > kRowsF || b > kRingColsF) continue;
        const long long cost = (long long)((M + r - 1) / r)
            * ((N + b - 1) / b) * r * b * (K + 16 * (s - 1));
        if (cost < best) {
          best = cost;
          split = s, wm = m, wn = groupw / m;
        }
      }
    rows = 32 * wm;
    bn = 64 * wn;
    chunks = (M + rows - 1) / rows;
    tiles = (N + bn - 1) / bn;
  }
};

// where an fp32 product's walk stands: chunk of rows, tile of columns,
// group and slice of the contraction, innermost last; a block starts at
// column tile `first`, so that the blocks in flight do not all ask L2 for
// the same weight slice at once
struct WalkF {
  int ch = 0, nt, g = 0, j = 0, left;
  __device__ __forceinline__ WalkF(int first, int tiles)
      : nt(first), left(tiles) {}
  __device__ __forceinline__ void step(int tiles, const GemmF& s) {
    if (++j < s.per_group) return;
    j = 0;
    if (++g < s.groups) return;
    g = 0;
    if (++nt == tiles) nt = 0;
    if (--left > 0) return;
    left = tiles;
    ++ch;
  }
};

// C[M, n_out] = A . B in FFMA, cut as TilingF picks. Slice (g, j) of B is
// rows b_row0(g, j) .. + b_live(j) of s.B (the rest of the 16 zero), and
// comes through the weight ring by 16-byte cp.async. A is either streamed
// from s.A through x_ring (columns 16 (g per_group + j) ..), or read in
// place from shared memory: a_base(g, j) + row_off(m) is row m's first
// value of the slice. A thread owns rows wm 32 + ty + 4 i (i < 8) and
// columns wn 64 + tx 4 + {0..3} and + 32 of a tile; per 4-deep step it
// reads A as 8 float4 along the contraction (4 rows a warp-wide read, each
// shared by 8 lanes) and the weights as 8 float4 across the tile, for 256
// FMAs. At a tile's end the groups hand their sums over in order: epi(m,
// n, 4 sums of columns n .. n + 3, first, last) for n < n_out (n a
// multiple of 4) is called by group 0 with first, then by each later group
// after a barrier, the last with last: the first stores its sums where the
// output goes, the others add theirs to what is there, and the last
// finishes the output. Every thread of the block must call it; it ends
// with the ring drained but without a barrier.
template <typename BRow0, typename BLive, typename ABase, typename RowOff,
          typename Epi>
__device__ __forceinline__ void block_gemm_f32(
    const GemmF& s, float* w_ring, float* x_ring, const BRow0& b_row0,
    const BLive& b_live, const ABase& a_base, const RowOff& row_off,
    const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 3, tx = lane & 7;
  const TilingF tl(s.M, s.n_out, s.groups * s.per_group * kDepthF);
  const int groupw = 8 / tl.split, grp = warp / groupw, wg = warp % groupw;
  const int wm = wg % tl.wm, wn = wg / tl.wm;
  const int kq = kDepthF / tl.split, k_lo = grp * kq;
  const int total = tl.chunks * tl.tiles * s.groups * s.per_group;
  const bool streamed = s.A != nullptr;
  // 16-byte pieces of a slice: kDepthF x bn weights are 4 bn pieces, rows x
  // kDepthF of x are 4 rows; at most 1024 of each, 4 a thread
  const int bsh = __ffs(tl.bn) - 3;           // log2 of the pieces a row
  auto fill = [&](const WalkF& w, int stage) {
    float* bs = w_ring + stage * kWStageF;
    const int live_rows = b_live(w.j), col0 = w.nt * tl.bn;
    const float* bsrc = s.B + (size_t)b_row0(w.g, w.j) * s.ldb + col0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e >= kDepthF << bsh) break;
      const int r = e >> bsh, c = (e & ((1 << bsh) - 1)) << 2;
      stage4(bs + r * tl.bn + c, bsrc + (size_t)r * s.ldb + c,
             r < live_rows ? min(4, s.ldb - col0 - c) : 0, s.aligned);
    }
    if (!streamed) return;
    float* as = x_ring + stage * kXStageF;
    const int k0 = (w.g * s.per_group + w.j) * kDepthF, m0 = w.ch * tl.rows;
    const float* asrc = s.A + (size_t)m0 * s.lda + k0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e >= tl.rows * (kDepthF / 4)) break;
      const int r = e >> 2, c = (e & 3) << 2;
      stage4(as + r * kAPitchF + c, asrc + (size_t)r * s.lda + c,
             m0 + r < s.M ? min(4, s.lda - k0 - c) : 0, s.aligned);
    }
  };

  float acc[8][8];
  int arow[8];
  WalkF ahead(blockIdx.x % tl.tiles, tl.tiles),
      here(blockIdx.x % tl.tiles, tl.tiles);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) {
      fill(ahead, i);
      ahead.step(tl.tiles, s);
    }
    cp_async_commit();
  }
  for (int item = 0; item < total; ++item) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the slice two ahead goes into the stage every thread is done with
    if (item + kStages - 1 < total) {
      fill(ahead, (item + kStages - 1) % kStages);
      ahead.step(tl.tiles, s);
    }
    cp_async_commit();
    const int stage = item % kStages;
    if (here.g == 0 && here.j == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
        const int r = wm * 32 + ty + 4 * i;
        arow[i] = streamed ? r * kAPitchF
                           : row_off(min(here.ch * tl.rows + r, s.M - 1));
      }
    }
    const float* ap = (streamed ? x_ring + stage * kXStageF
                                : a_base(here.g, here.j)) + k_lo;
    const float* bp =
        w_ring + stage * kWStageF + k_lo * tl.bn + wn * 64 + tx * 4;
    for (int kk = 0; kk < kq; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(ap + arow[i] + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(bp + (kk + q) * tl.bn);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bp + (kk + q) * tl.bn + 32);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = q == 0 ? a[i].x : q == 1 ? a[i].y
                        : q == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(v, b0.x, acc[i][0]);
          acc[i][1] = fmaf(v, b0.y, acc[i][1]);
          acc[i][2] = fmaf(v, b0.z, acc[i][2]);
          acc[i][3] = fmaf(v, b0.w, acc[i][3]);
          acc[i][4] = fmaf(v, b1.x, acc[i][4]);
          acc[i][5] = fmaf(v, b1.y, acc[i][5]);
          acc[i][6] = fmaf(v, b1.z, acc[i][6]);
          acc[i][7] = fmaf(v, b1.w, acc[i][7]);
        }
      }
    }
    if (here.g == s.groups - 1 && here.j == s.per_group - 1) {
      for (int p = 0; p < tl.split; ++p) {
        if (p > 0) __syncthreads();
        if (grp != p) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = here.ch * tl.rows + wm * 32 + ty + 4 * i;
          if (m >= s.M) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = here.nt * tl.bn + wn * 64 + tx * 4 + 32 * h;
            if (n < s.n_out)
              epi(m, n, make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                    acc[i][4 * h + 2], acc[i][4 * h + 3]),
                  p == 0, p == tl.split - 1);
          }
        }
      }
    }
    here.step(tl.tiles, s);
  }
}

// the hand-over of a split product's sums where they go (see block_gemm_f32)
__device__ __forceinline__ float4 gather4(float* d, float4 v, bool first) {
  if (first) return v;
  const float4 o = *reinterpret_cast<const float4*>(d);
  return make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
}

// relu(v + bias) for the columns below Cm, 0 for the padded ones
__device__ __forceinline__ float4 bias_relu(float4 v, const float* bias,
                                            int n, int Cm) {
  return make_float4(n < Cm ? fmaxf(v.x + bias[n], 0.f) : 0.f,
                     n + 1 < Cm ? fmaxf(v.y + bias[n + 1], 0.f) : 0.f,
                     n + 2 < Cm ? fmaxf(v.z + bias[n + 2], 0.f) : 0.f,
                     n + 3 < Cm ? fmaxf(v.w + bias[n + 3], 0.f) : 0.f);
}

// grid (B * ceil(H / R)), one block an SM; shared memory: the weight ring,
// h1 [R + 2][W + 2][pitch] and h2 [R W][pitch] (conv1's x ring before it),
// pitch = Cm padded to kChanUnitF, + kPadF
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ w3,
                      const float* __restrict__ b3, float* __restrict__ out,
                      int H, int W, int C, int Cm, int R) {
  extern __shared__ uint4 smem4[];
  float* w_ring = reinterpret_cast<float*>(smem4);
  const int cmp = padded_channels_f32(Cm), pitch = cmp + kPadF, Wp = W + 2;
  float* h1 = w_ring + kStages * kWStageF;
  float* h2 = h1 + (size_t)(R + 2) * Wp * pitch;
  const int strips = (H + R - 1) / R;
  const int img = blockIdx.x / strips;
  const int y0 = (blockIdx.x % strips) * R;
  const int rows = min(R, H - y0);
  const float* xi = x + (size_t)img * H * W * C;
  float* oi = out + (size_t)img * H * W * C;
  const bool aligned = C % 4 == 0 && Cm % 4 == 0;
  const int per_tap = cmp / kDepthF;   // slices of a tap, of conv3
  auto no_base = [](int, int) -> const float* { return nullptr; };
  auto no_row = [](int) { return 0; };

  // conv2's padding: all of h1 is zero before conv1 fills the image's part
  {
    float4* z = reinterpret_cast<float4*>(h1);
    const int n16 = (rows + 2) * Wp * pitch / 4;
    for (int e = threadIdx.x; e < n16; e += kThreads)
      z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // 1. conv1 + b1, relu, over the image's rows among y0 - 1 .. y0 + rows;
  // x comes through the ring in h2's place
  const int y_lo = max(y0 - 1, 0), y_hi = min(y0 + rows, H - 1);
  {
    GemmF s{(y_hi - y_lo + 1) * W, cmp, 1, (C + kDepthF - 1) / kDepthF, w1,
            Cm, xi + (size_t)y_lo * W * C, C, aligned};
    const int hr0 = y_lo - (y0 - 1);
    block_gemm_f32(
        s, w_ring, h2, [&](int, int j) { return j * kDepthF; },
        [&](int j) { return C - j * kDepthF; }, no_base, no_row,
        [&](int m, int n, float4 v, bool first, bool last) {
          float* d = h1 + ((hr0 + m / W) * Wp + m % W + 1) * pitch + n;
          v = gather4(d, v, first);
          *reinterpret_cast<float4*>(d) = last ? bias_relu(v, b1, n, Cm) : v;
        });
  }
  __syncthreads();

  // 2. conv2 (3 x 3, the 9 taps tap-major) + b2, relu; A is h1 in place, a
  // tap the offset (dh (W + 2) + dw) pitch from the pixel's own row
  {
    GemmF s{rows * W, cmp, 9, per_tap, w2, Cm, nullptr, 0, aligned};
    block_gemm_f32(
        s, w_ring, nullptr, [&](int g, int j) { return g * Cm + j * kDepthF; },
        [&](int j) { return Cm - j * kDepthF; },
        [&](int g, int j) -> const float* {
          return h1 + ((g / 3) * Wp + g % 3) * pitch + j * kDepthF;
        },
        [&](int m) { return ((m / W) * Wp + m % W) * pitch; },
        [&](int m, int n, float4 v, bool first, bool last) {
          float* d = h2 + m * pitch + n;
          v = gather4(d, v, first);
          *reinterpret_cast<float4*>(d) = last ? bias_relu(v, b2, n, Cm) : v;
        });
  }
  __syncthreads();

  // 3. conv3, + b3, + x, relu, straight to out (16 bytes a lane when the
  // rows start on 16 bytes); a split product hands its sums over in out
  {
    GemmF s{rows * W, C, 1, per_tap, w3, C, nullptr, 0, aligned};
    block_gemm_f32(
        s, w_ring, nullptr, [&](int, int j) { return j * kDepthF; },
        [&](int j) { return Cm - j * kDepthF; },
        [&](int, int j) -> const float* { return h2 + j * kDepthF; },
        [&](int m) { return m * pitch; },
        [&](int m, int n, float4 v, bool first, bool last) {
          const size_t off = ((size_t)y0 * W + m) * C + n;
          if (aligned) {
            float4* d = reinterpret_cast<float4*>(oi + off);
            if (!first) {
              const float4 o = *d;
              v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
            }
            if (last) {
              const float4 r = *reinterpret_cast<const float4*>(xi + off);
              v = make_float4(fmaxf(v.x + b3[n] + r.x, 0.f),
                              fmaxf(v.y + b3[n + 1] + r.y, 0.f),
                              fmaxf(v.z + b3[n + 2] + r.z, 0.f),
                              fmaxf(v.w + b3[n + 3] + r.w, 0.f));
            }
            *d = v;
            return;
          }
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (n + q < C) {
              const float t = first ? vs[q] : oi[off + q] + vs[q];
              oi[off + q] = last ? fmaxf(t + b3[n + q] + xi[off + q], 0.f)
                                 : t;
            }
        });
  }
}

// ------------------------------------------------------------- launches

template <typename T, typename K>
int launch(K kernel, int threads, size_t smem, const void* x, const void* w1,
           const float* b1, const void* w2, const float* b2, const void* w3,
           const void* b3, void* out, int B, int H, int W, int C, int Cm,
           int R, cudaStream_t stream) {
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int strips = (H + R - 1) / R;
  kernel<<<B * strips, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<const T*>(w3),
      static_cast<const T*>(b3), static_cast<T*>(out), H, W, C, Cm, R);
  return (int)cudaGetLastError();
}

}  // namespace tclip

extern "C" {

// K5. x and out [B, H, W, C], w1 [C, Cm], w2 [3, 3, Cm, Cm], w3 [Cm, C] and
// b3 [C] in T (fp32: bf16 = 0, bf16: bf16 = 1); b1 and b2 [Cm] fp32; all
// contiguous and aligned to 16 bytes. R: output rows a block
// (ops/cuda_bottleneck.strip_rows). Returns the CUDA error of the launch (0
// on success).
int tclip_bottleneck(const void* x, const void* w1, const float* b1,
                     const void* w2, const float* b2, const void* w3,
                     const void* b3, void* out, int B, int H, int W, int C,
                     int Cm, int R, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cm <= 0 || R <= 0 || R > H)
    return (int)cudaErrorInvalidValue;
  if (bf16 && C % 8 == 0 && Cm % 8 == 0)
    return tclip::launch<tclip::bf16>(
        tclip::bottleneck_bf16_kernel<true>, tclip::kThreadsB,
        tclip::smem_bytes_bf16(W, Cm, R), x, w1, b1, w2, b2, w3, b3, out, B,
        H, W, C, Cm, R, st);
  if (bf16)
    return tclip::launch<tclip::bf16>(
        tclip::bottleneck_bf16_kernel<false>, tclip::kThreadsB,
        tclip::smem_bytes_bf16(W, Cm, R), x, w1, b1, w2, b2, w3, b3, out, B,
        H, W, C, Cm, R, st);
  return tclip::launch<float>(
      tclip::bottleneck_f32_kernel, tclip::kThreads,
      tclip::smem_bytes_f32(W, Cm, R), x, w1, b1, w2, b2, w3, b3, out, B, H, W,
      C, Cm, R, st);
}

}  // extern "C"
