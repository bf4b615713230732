"""CLIP multi-head self-attention over a fused qkv projection on the card
(counterpart of transductive_clip_tpu/ops/pallas_attention.py).

Two CUDA C++ kernels for sm_90a (``csrc/attention.cu``) replace the TPU's:

* K4a ``attention_rows`` — ``_attn_kernel`` (``fused_attention``): one block
  of ceil(n / 16) warps per (sequence, head) holds the head's q, k and v in
  shared memory; n <= 128 (the text towers' 77, ViT-B/32's 50);
* K4b ``attention_blocked`` — ``_attn_kernel_blocked``
  (``_fused_attention_blocked``): one block per (sequence, head, 128 q rows)
  streams k and v through tiles of 64 rows; any n.

Both compute the q.k dot in fp32 from the qkv dtype, ``* scale``, ``+ mask``
as fp32, the max, exp and sum in fp32, p.v accumulated in fp32 and the
output rounded to the qkv dtype; no score row ever lies in shared or device
memory. The text tower's bf16 shape is bound by bytes and ViT-L/14@336px's
fp32 shape by FFMA operations, so:

* K4a in bf16 keeps the TPU kernel's order (p normalised, then rounded to
  bf16, then multiplied): both products on tensor cores (``mma.sync``
  m16n8k16, fragments by ``ldmatrix``), a warp's whole [16, n] score block
  in registers;
* K4b in bf16 walks the keys once with an online softmax on ``wgmma``: a
  persistent grid of blocks of two consumer warpgroups of 64 q rows and a
  producer warp that copies q and the k / v tiles by TMA into a ring in
  shared memory under the 128-byte swizzle; s = q.k^T into registers,
  e = exp(s - m) by ``ex2`` on pre-scaled scores, the sum of the
  unrounded e, e rounded to bf16 straight into the A operand of
  ``o += e.v``; the max in use m moves (and the sum and o are rescaled)
  only when a row of the warp passes it by ``SLACK`` in log2 units; one
  reciprocal a row at the end. It rounds the unnormalised e where the TPU
  rounds p: within one bf16 ulp of the output;
* fp32 runs FFMA on a 4 x 8 register tile a thread with float4 operand
  reads and an online softmax (running max and sum, rescaled accumulators,
  one division at the end): p is not rounded in fp32, so only the order of
  fp32 operations differs from the plain version.

:func:`attention_route` is the dispatch between the two on this card; every
OpenAI tower of ``models/clip/config.CLIP_CONFIGS`` resolves to one of them
at bf16 and at fp32, and a shape neither takes raises. The kernels need
head_dim 64 (every OpenAI tower); the plain version takes any.

:func:`fused_attention` takes the plain torch version
(:func:`fused_attention_reference`) for tensors on the CPU, and only then;
for CUDA tensors it launches a kernel or raises. ``attention_rows.launches``
and ``attention_blocked.launches`` count the launches.
:func:`fused_attention_tiled_reference` repeats K4b's tiled order of
operations in torch ops for the CPU tests.
"""

from __future__ import annotations

import math

import torch

from . import kernel_build

SOURCE = "attention.cu"
#: the entry points' C arguments (``kernel_build.ARG_TYPES``)
SIGNATURES = {"tclip_attention_rows": "ppp iii f i p",
              "tclip_attention_blocked": "ppp iii f i p"}
HEAD_DIM = 64
WARP_ROWS = 16     # q rows of a warp (csrc kWarpRows)
KEYS = 64          # rows of a k / v tile (csrc kKeys)
BLOCK_ROWS = 128   # q rows of a K4b block (csrc kBlockRows; in bf16
#                    kRowsB = WARPGROUPS x WG_ROWS, the same 128)
WG_ROWS = 64       # q rows of a K4b bf16 warpgroup (csrc kWgRows)
WARPGROUPS = 2     # consumer warpgroups of a K4b bf16 block (csrc kWarpgroups)
STAGES = 4         # k / v tiles of K4b bf16's ring (csrc kStages)
SLACK = 8.0        # log2 units a row may pass K4b bf16's max in use (kSlack)
ROWS_MAX_N = 128   # K4a's longest sequence (csrc kRowsMaxN): in bf16 a
#                    warp's [16, n] fp32 scores stay in registers
PITCH_BF16 = 72    # bf16 row pitch of q, k, v in shared memory (csrc kPitchB)
PITCH_FP32 = 68    # fp32 row pitch of q, k, v (csrc kPitchF)
PITCH_P = 72       # fp32 row pitch of the p strips (csrc kPitchP)
# shared memory a block can use on an H100 (232,448 bytes of the SM's 256 KB)
SMEM_LIMIT = 232448
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def rows_smem_bytes(n: int, dtype) -> int:
    """K4a's shared memory: q, k, v of a head over n rounded up to 16 rows,
    in the qkv dtype at the padded pitch; in fp32 also the p strips."""
    rows = -(-n // WARP_ROWS) * WARP_ROWS
    if dtype == torch.bfloat16:
        return 2 * 3 * rows * PITCH_BF16
    return 4 * rows * (3 * PITCH_FP32 + PITCH_P)


def blocked_smem_bytes(dtype) -> int:
    """K4b's shared memory, the same for every n. bf16: 1024 bytes to align
    the tiles, two q buffers of WARPGROUPS x WG_ROWS rows and a ring of
    STAGES stages of a k and a v tile, in rows of 128 bytes (the 128-byte
    swizzle of wgmma and TMA, no padding), and the 8-byte barriers (a full
    and an empty one a q buffer and a stage); fp32: q of 128 rows, one k
    tile, one v tile and the p strips."""
    if dtype == torch.bfloat16:
        rows = 2 * WARPGROUPS * WG_ROWS + 2 * STAGES * KEYS
        return 1024 + 2 * HEAD_DIM * rows + 8 * (4 + 2 * STAGES)
    return 4 * ((BLOCK_ROWS + 2 * KEYS) * PITCH_FP32 + BLOCK_ROWS * PITCH_P)


def attention_route(n: int, width: int, heads: int, dtype) -> str:
    """'rows' (K4a) or 'blocked' (K4b) for a [b, n, 3 width] qkv with
    ``heads`` heads; raises ValueError for a shape neither kernel takes.

    K4a while n <= ``ROWS_MAX_N`` (its shared memory, which grows with n and
    with the staging dtype, then fits the card), else K4b, whose shared
    memory does not depend on n."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused attention: dtype {dtype} is neither float32 "
                         "nor bfloat16")
    if width % heads or width // heads != HEAD_DIM:
        raise ValueError(f"fused attention: width {width} / heads {heads} is "
                         f"not head_dim {HEAD_DIM}, the only one the kernels "
                         "take (use attention_impl='xla')")
    if n < 1:
        raise ValueError(f"fused attention: n = {n}")
    if n <= ROWS_MAX_N and rows_smem_bytes(n, dtype) <= SMEM_LIMIT:
        return "rows"
    return "blocked"


def fused_attention_supported(n: int, width: int, heads: int, dtype) -> bool:
    """True when :func:`attention_route` takes the shape."""
    try:
        attention_route(n, width, heads, dtype)
    except ValueError:
        return False
    return True


def _split(qkv, heads):
    b, n, three_w = qkv.shape
    width = three_w // 3
    if width * 3 != three_w or width % heads:
        raise ValueError(f"bad qkv shape {tuple(qkv.shape)} for heads={heads}")
    return b, n, width


def _mask_2d(mask, n, device):
    if mask is None:
        return None
    return mask.reshape(mask.shape[-2:]).to(device=device,
                                            dtype=torch.float32).contiguous()


def fused_attention_reference(qkv, heads: int, mask=None):
    """Plain torch version of K4a / K4b, in their order of operations (fp32
    products of the qkv-dtype values; TF32 is off on the card). qkv
    [b, n, 3 width] -> [b, n, width] in qkv's dtype; mask broadcastable to
    [n, n]."""
    b, n, width = _split(qkv, heads)
    hd = width // heads
    q, k, v = (t.permute(0, 2, 1, 3).float()
               for t in qkv.reshape(b, n, 3, heads, hd).unbind(2))
    s = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
    if mask is not None:
        s = s + _mask_2d(mask, n, s.device)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(qkv.dtype)
    o = torch.matmul(p.float(), v).to(qkv.dtype)
    return o.permute(0, 2, 1, 3).reshape(b, n, width)


def _tile_scores(q, k, hd, mask, j0, j1):
    s = torch.matmul(q, k[:, :, j0:j1].transpose(-1, -2)) * hd ** -0.5
    return s if mask is None else s + mask[:, j0:j1]


def _guard(m):
    """The max to subtract: 0 while every score so far is -inf."""
    return torch.where(torch.isneginf(m), torch.zeros_like(m), m)


def _warp_any(x):
    """x [b, heads, n, 1] bool -> True for every row of a 16-row group (the
    rows of one warp in K4b bf16) in which any row is True."""
    b, h, n, _ = x.shape
    pad = -n % WARP_ROWS
    g = torch.nn.functional.pad(x[..., 0], (0, pad)).reshape(b, h, -1,
                                                             WARP_ROWS)
    return g.any(-1, keepdim=True).expand(-1, -1, -1, WARP_ROWS).reshape(
        b, h, n + pad, 1)[:, :, :n]


def fused_attention_tiled_reference(qkv, heads: int, mask=None):
    """K4b's order of operations in torch ops, the keys walked once in tiles
    of ``KEYS``; for the tests only. One pass with a running max and sum,
    the accumulators rescaled when the max moves, one division at the end.
    fp32: ``o += e . v`` with e = exp(s - m) in fp32. bf16: the sum takes e
    unrounded and ``o += e . v`` takes e rounded to bf16 (the TPU rounds the
    normalised p instead), and the max in use moves only when a row of the
    warp's 16 passes it by more than ``SLACK`` in log2 units. A max that is
    still -inf subtracts as 0."""
    b, n, width = _split(qkv, heads)
    hd = width // heads
    q, k, v = (t.permute(0, 2, 1, 3).float()
               for t in qkv.reshape(b, n, 3, heads, hd).unbind(2))
    mask = _mask_2d(mask, n, qkv.device)
    m = torch.full((b, heads, n, 1), float("-inf"))
    l = torch.zeros((b, heads, n, 1))
    o = torch.zeros((b, heads, n, hd))
    lazy = qkv.dtype == torch.bfloat16
    for j0 in range(0, n, KEYS):
        j1 = min(j0 + KEYS, n)
        s = _tile_scores(q, k, hd, mask, j0, j1)
        t = s.amax(-1, keepdim=True)
        m_new = torch.maximum(m, t)
        if lazy:
            # (t - m) log2(e) > SLACK, -inf - -inf (nan) not
            up = _warp_any((t - m) * math.log2(math.e) > SLACK)
            m_new = torch.where(up, m_new, m)
        alpha = torch.exp(m - _guard(m_new))
        if lazy:
            alpha = torch.where(up, alpha, torch.ones_like(alpha))
        e = torch.exp(s - _guard(m_new))
        l = l * alpha + e.sum(-1, keepdim=True)
        o = o * alpha + torch.matmul(e.to(qkv.dtype).float(), v[:, :, j0:j1])
        m = m_new
    return (o / l).to(qkv.dtype).permute(0, 2, 1, 3).reshape(b, n, width)


def _launch(entry, qkv, heads, mask):
    """Checks, allocates and launches."""
    b, n, width = _split(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"{entry}: qkv is on {qkv.device}; the kernel takes "
                         "CUDA tensors (or CPU tensors for the plain version)")
    if not qkv.is_contiguous():
        raise ValueError(f"{entry}: qkv must be contiguous")
    attention_route(n, width, heads, qkv.dtype)     # dtype, head_dim, n
    if not 0 < b * heads < 2 ** 31:
        raise ValueError(f"{entry}: {b} x {heads} blocks")
    m = _mask_2d(mask, n, qkv.device)
    if m is not None and m.shape != (n, n):
        raise ValueError(f"{entry}: mask {tuple(mask.shape)} is not [n, n]")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{entry}: qkv must be aligned to 16 bytes (the "
                         "kernels copy 16 bytes at a time)")
    out = torch.empty((b, n, width), dtype=qkv.dtype, device=qkv.device)
    kernel_build.launch(
        getattr(kernel_build.load(SOURCE, SIGNATURES), entry), qkv.device,
        qkv.data_ptr(), m.data_ptr() if m is not None else None,
        out.data_ptr(), b, n, heads, float((width // heads) ** -0.5),
        int(qkv.dtype == torch.bfloat16))
    return out


def attention_rows(qkv, heads: int, mask=None):
    """K4a on a [b, n, 3 width] qkv with n <= ``ROWS_MAX_N`` (the plain
    version for CPU tensors)."""
    if qkv.device.type == "cpu":
        return fused_attention_reference(qkv, heads, mask)
    if qkv.shape[1] > ROWS_MAX_N:
        raise ValueError(f"tclip_attention_rows: n = {qkv.shape[1]} is over "
                         f"{ROWS_MAX_N}, the longest sequence whose scores "
                         "the kernel keeps in registers (use "
                         "attention_blocked)")
    out = _launch("tclip_attention_rows", qkv, heads, mask)
    attention_rows.launches += 1
    return out


def attention_blocked(qkv, heads: int, mask=None):
    """K4b on a [b, n, 3 width] qkv of any n (the plain version for CPU
    tensors)."""
    if qkv.device.type == "cpu":
        return fused_attention_reference(qkv, heads, mask)
    out = _launch("tclip_attention_blocked", qkv, heads, mask)
    attention_blocked.launches += 1
    return out


attention_rows.launches = 0
attention_blocked.launches = 0


def fused_attention(qkv, heads: int, mask=None):
    """Multi-head self-attention over a fused qkv projection.

    qkv:  [b, n, 3 width], q | k | v with the heads contiguous inside each
          third (OpenAI CLIP's in_proj layout).
    mask: optional additive mask broadcastable to [n, n].
    Returns [b, n, width] in qkv's dtype (before ``out_proj``). On the card
    it runs K4a or K4b as :func:`attention_route` says, and raises for a
    shape neither takes."""
    if qkv.device.type == "cpu":
        return fused_attention_reference(qkv, heads, mask)
    _, n, width = _split(qkv, heads)
    if attention_route(n, width, heads, qkv.dtype) == "rows":
        return attention_rows(qkv, heads, mask)
    return attention_blocked(qkv, heads, mask)
