"""The fused ResNet identity bottleneck on the card (counterpart of
transductive_clip_tpu/ops/pallas_bottleneck.py).

K5 ``fused_identity_bottleneck`` is CUDA C++ for sm_90a
(``csrc/bottleneck.cu``), the TPU kernel ``_kernel`` behind
``clip_fused_resnet: True``:

    relu(x + (conv1x1(relu(conv3x3(relu(conv1x1(x) + b1)) + b2)) + b3))

NHWC x [B, H, W, C], w1 [C, Cm], w2 [3, 3, Cm, Cm] (HWIO), w3 [Cm, C], the
BatchNorms folded into the biases. Operands in x's dtype, fp32 sums; h1, h2
and the conv3 output are rounded to x's dtype, and ``+ b3`` and ``+ x`` are
done in x's dtype (``pallas_bottleneck.py:104-119``).

The support gate :func:`fused_bottleneck_supported` is this card's own: a
block owns a strip of output rows of one image, and the gate accepts a block
when a strip of at least one row fits ``SMEM_BUDGET``. It accepts all 12
RN50 identity blocks at bf16 and at fp32; blocks it rejects take the plain
graph (``models/clip/resnet.py``).

The wrapper takes its plain torch version for tensors on the CPU, and only
then; for CUDA tensors it launches the kernel or raises.
``fused_identity_bottleneck.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import kernel_build

SOURCE = "bottleneck.cu"
# csrc tiles: the staged A slice [64][17] and weight slice [16][64], fp32
_STAGE_BYTES = 4 * (64 * 17 + 16 * 64)
# two blocks an SM: 2 x (113 KB + 1 KB reserved) of its 228 KB
SMEM_BUDGET = 113 * 1024
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library():
    lib = kernel_build.load(SOURCE)
    lib.tclip_bottleneck.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.tclip_bottleneck.restype = _I
    lib.tclip_error_string.argtypes = [_I]
    lib.tclip_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(w: int, c_mid: int, rows: int, item: int) -> int:
    """A block's shared memory for strips of ``rows`` output rows: the
    staged slices, h1 [rows + 2, w + 2, Cm] and h2 [rows w, Cm] in x's
    dtype."""
    return _STAGE_BYTES + item * ((rows + 2) * (w + 2) * c_mid
                                  + rows * w * c_mid)


def strip_rows(h: int, w: int, c: int, c_mid: int, dtype) -> int:
    """Output rows a block owns: the largest strip that fits SMEM_BUDGET, or
    0 when not even one row does (or the dtype is not a kernel's)."""
    if dtype not in KERNEL_DTYPES:
        return 0
    item = torch.empty((), dtype=dtype).element_size()
    best = 0
    for rows in range(1, h + 1):
        if smem_bytes(w, c_mid, rows, item) <= SMEM_BUDGET:
            best = rows
    return best


def fused_bottleneck_supported(h: int, w: int, c: int, c_mid: int,
                               dtype) -> bool:
    """True when K5 takes an identity block of this shape and dtype."""
    return strip_rows(h, w, c, c_mid, dtype) > 0


def fused_identity_bottleneck_reference(x, w1, b1, w2, b2, w3, b3):
    """Plain torch version of K5 with the same roundings: each convolution in
    fp32 on operands rounded to x's dtype (what the kernel's fp32 sums of
    exact products give; TF32 is off on the card), the adds of b3 and x in
    x's dtype. Shapes and layout as :func:`fused_identity_bottleneck`."""
    dt = x.dtype
    xn = x.permute(0, 3, 1, 2)                                  # NCHW view
    w1n = w1.to(dt).float().t()[:, :, None, None]
    w2n = w2.to(dt).float().permute(3, 2, 0, 1)
    w3n = w3.to(dt).float().t()[:, :, None, None]
    h1 = F.relu(F.conv2d(xn.float(), w1n) + b1.float()[:, None, None]).to(dt)
    h2 = F.relu(F.conv2d(h1.float(), w2n, padding=1)
                + b2.float()[:, None, None]).to(dt)
    out = F.conv2d(h2.float(), w3n).to(dt) + b3.to(dt)[:, None, None]
    return F.relu(out + xn).permute(0, 2, 3, 1).contiguous()


def _check(x, w1, b1, w2, b2, w3, b3):
    name = "fused_identity_bottleneck"
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B, H, W, C], got "
                         f"{tuple(x.shape)}")
    bsz, h, w, c = x.shape
    c_mid = w1.shape[-1]
    want = {"x": (x, x.dtype, (bsz, h, w, c)),
            "w1": (w1, x.dtype, (c, c_mid)),
            "b1": (b1, torch.float32, (c_mid,)),
            "w2": (w2, x.dtype, (3, 3, c_mid, c_mid)),
            "b2": (b2, torch.float32, (c_mid,)),
            "w3": (w3, x.dtype, (c_mid, c)),
            "b3": (b3, x.dtype, (c,))}
    for what, (t, dtype, shape) in want.items():
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {what} is on {t.device}; every input "
                             "must be on one CUDA device (or all on the CPU "
                             "for the plain version)")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"{name}: {what} must be {dtype} {list(shape)}, "
                            f"got {t.dtype} {list(t.shape)} (the kernel "
                            "layout is made once at load)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous (x NHWC)")
    rows = strip_rows(h, w, c, c_mid, x.dtype)
    if rows == 0:
        raise ValueError(f"{name}: [{h}, {w}, {c}] / {c_mid} {x.dtype} does "
                         "not fit the kernel (fused_bottleneck_supported)")
    if not 0 < bsz * -(-h // rows) < 2 ** 31:
        raise ValueError(f"{name}: batch {bsz} out of range")
    return rows


def fused_identity_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """K5 (see the module docstring). x [B, H, W, C] NHWC; w1 [C, Cm],
    w2 [3, 3, Cm, Cm], w3 [Cm, C] and b3 [C] in x's dtype; b1, b2 [Cm]
    fp32; all contiguous. Returns [B, H, W, C] in x's dtype."""
    if x.device.type == "cpu" and all(
            t.device.type == "cpu" for t in (w1, b1, w2, b2, w3, b3)):
        return fused_identity_bottleneck_reference(x, w1, b1, w2, b2, w3, b3)
    rows = _check(x, w1, b1, w2, b2, w3, b3)
    bsz, h, w, c = x.shape
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tclip_bottleneck(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            bsz, h, w, c, w1.shape[1], rows, int(x.dtype == torch.bfloat16),
            stream)
    if rc != 0:
        msg = lib.tclip_error_string(rc).decode()
        raise RuntimeError(f"fused_identity_bottleneck: kernel launch "
                           f"failed: {msg} (cuda error {rc})")
    fused_identity_bottleneck.launches += 1
    return out


fused_identity_bottleneck.launches = 0
