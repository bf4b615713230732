"""CLIP multi-head self-attention over a fused qkv projection on the card
(counterpart of transductive_clip_tpu/ops/pallas_attention.py).

Two CUDA C++ kernels for sm_90a (``csrc/attention.cu``) replace the TPU's:

* K4a ``attention_rows`` — ``_attn_kernel`` (``fused_attention``): one block
  per (sequence, head) keeps the head's k and v in shared memory for the
  whole sequence;
* K4b ``attention_blocked`` — ``_attn_kernel_blocked``
  (``_fused_attention_blocked``): one block per (sequence, head, 64 q rows)
  streams k and v through one tile.

Both keep the TPU kernel's order of operations: the q.k dot in fp32 from the
qkv dtype, ``* scale``, ``+ mask`` as fp32, the max, exp, sum and division in
fp32, p rounded to the qkv dtype, p.v accumulated in fp32, the output
rounded to the qkv dtype. :func:`attention_route` is the dispatch between
them on this card, with its shared-memory budget; every OpenAI tower of
``models/clip/config.CLIP_CONFIGS`` resolves to one of them at bf16 and at
fp32, and a shape neither takes raises. The kernels need head_dim 64 (every
OpenAI tower); the plain version takes any.

:func:`fused_attention` takes the plain torch version
(:func:`fused_attention_reference`) for tensors on the CPU, and only then;
for CUDA tensors it launches a kernel or raises. ``attention_rows.launches``
and ``attention_blocked.launches`` count the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import kernel_build

SOURCE = "attention.cu"
HEAD_DIM = 64
ROWS = 64          # q rows of a row group (csrc kRows)
KEYS = 64          # rows of a streamed k / v tile (csrc kKeys)
KV_PITCH = HEAD_DIM + 1
# shared memory a block can use on an H100 (232,448 bytes of the SM's 256 KB)
SMEM_LIMIT = 232448
# K4a keeps k and v of a head for the whole sequence: taken while two blocks
# fit an SM (2 x (113 KB + 1 KB reserved) of its 228 KB), i.e. n <= 128 (the
# text towers' 77, ViT-B/32's 50); longer sequences take K4b, whose 64-row
# tiles fit up to n = 776
K4A_SMEM_BUDGET = 113 * 1024
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _library():
    lib = kernel_build.load(SOURCE)
    for fn in (lib.tclip_attention_rows, lib.tclip_attention_blocked):
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _F, _I, _P]
        fn.restype = _I
    lib.tclip_error_string.argtypes = [_I]
    lib.tclip_error_string.restype = ctypes.c_char_p
    return lib


def _score_pitch(n: int) -> int:
    return -(-n // 4) * 4


def rows_smem_bytes(n: int) -> int:
    """K4a's shared memory: q [64, 64], scores [64, sp], k and v [sp, 65]."""
    sp = _score_pitch(n)
    return 4 * (ROWS * HEAD_DIM + ROWS * sp + 2 * sp * KV_PITCH)


def blocked_smem_bytes(n: int) -> int:
    """K4b's shared memory: q [64, 64], scores [64, sp], a tile [64, 65]."""
    sp = _score_pitch(n)
    return 4 * (ROWS * HEAD_DIM + ROWS * sp + KEYS * KV_PITCH)


def attention_route(n: int, width: int, heads: int, dtype) -> str:
    """'rows' (K4a) or 'blocked' (K4b) for a [b, n, 3 width] qkv with
    ``heads`` heads; raises ValueError for a shape neither kernel takes.

    Both stage q, k, v and the scores in fp32 whatever the qkv dtype, so the
    rule depends on n only: K4a while its shared memory fits
    ``K4A_SMEM_BUDGET`` (two blocks an SM), else K4b while its own fits
    ``SMEM_LIMIT``."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused attention: dtype {dtype} is neither float32 "
                         "nor bfloat16")
    if width % heads or width // heads != HEAD_DIM:
        raise ValueError(f"fused attention: width {width} / heads {heads} is "
                         f"not head_dim {HEAD_DIM}, the only one the kernels "
                         "take (use attention_impl='xla')")
    if rows_smem_bytes(n) <= K4A_SMEM_BUDGET:
        return "rows"
    if blocked_smem_bytes(n) <= SMEM_LIMIT:
        return "blocked"
    raise ValueError(f"fused attention: n = {n} needs "
                     f"{blocked_smem_bytes(n)} bytes of shared memory in the "
                     f"blocked kernel, over {SMEM_LIMIT} (use "
                     "attention_impl='xla')")


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


def _launch(entry, qkv, heads, mask, smem_bytes):
    """Checks, allocates and launches; ``smem_bytes(n)``: the kernel's
    shared memory (either kernel runs any n whose memory fits the card;
    :func:`attention_route` picks the one for a tower)."""
    b, n, width = _split(qkv, heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"{entry}: qkv is on {qkv.device}; the kernel takes "
                         "CUDA tensors (or CPU tensors for the plain version)")
    if not qkv.is_contiguous():
        raise ValueError(f"{entry}: qkv must be contiguous")
    attention_route(n, width, heads, qkv.dtype)     # dtype, head_dim, n
    if smem_bytes(n) > SMEM_LIMIT:
        raise ValueError(f"{entry}: n = {n} needs {smem_bytes(n)} bytes of "
                         f"shared memory, over {SMEM_LIMIT}")
    if not 0 < b * heads < 2 ** 31:
        raise ValueError(f"{entry}: {b} x {heads} blocks")
    m = _mask_2d(mask, n, qkv.device)
    if m is not None and m.shape != (n, n):
        raise ValueError(f"{entry}: mask {tuple(mask.shape)} is not [n, n]")
    out = torch.empty((b, n, width), dtype=qkv.dtype, device=qkv.device)
    lib = _library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            qkv.data_ptr(), m.data_ptr() if m is not None else None,
            out.data_ptr(), b, n, heads, float((width // heads) ** -0.5),
            int(qkv.dtype == torch.bfloat16), stream)
    if rc != 0:
        msg = lib.tclip_error_string(rc).decode()
        raise RuntimeError(f"{entry}: kernel launch failed: {msg} "
                           f"(cuda error {rc})")
    return out


def attention_rows(qkv, heads: int, mask=None):
    """K4a on a [b, n, 3 width] qkv (the plain version for CPU tensors)."""
    if qkv.device.type == "cpu":
        return fused_attention_reference(qkv, heads, mask)
    out = _launch("tclip_attention_rows", qkv, heads, mask, rows_smem_bytes)
    attention_rows.launches += 1
    return out


def attention_blocked(qkv, heads: int, mask=None):
    """K4b on a [b, n, 3 width] qkv (the plain version for CPU tensors)."""
    if qkv.device.type == "cpu":
        return fused_attention_reference(qkv, heads, mask)
    out = _launch("tclip_attention_blocked", qkv, heads, mask,
                  blocked_smem_bytes)
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
