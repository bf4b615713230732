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

In bf16 the three convolutions run on the tensor cores, with conv2's and
conv3's input read where it lies in shared memory; fp32 keeps FFMA (TF32
stays off).

The support gate :func:`fused_bottleneck_supported` is this card's own: a
block owns a strip of output rows of one image (:func:`strip_rows`), and
the gate accepts a block when a strip of at least one row fits the dtype's
:func:`smem_budget`. It accepts all 12 RN50 identity blocks at bf16 and at
fp32; blocks it rejects take the plain graph (``models/clip/resnet.py``).

The wrapper takes its plain torch version for tensors on the CPU, and only
then; for CUDA tensors it launches the kernel or raises.
``fused_identity_bottleneck.launches`` counts the launches.
:func:`fused_identity_bottleneck_tiled_reference` repeats the bf16 kernel's
own order of operations in torch ops (what a block owns, the halo rows, the
padded pitch, the tap-major contraction slice by slice), for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import kernel_build

SOURCE = "bottleneck.cu"
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# csrc, fp32: the staged A slice [64][17] and weight slice [16][64]
_STAGE_BYTES_F32 = 4 * (64 * 17 + 16 * 64)
# csrc, bf16: a ring of STAGES slices DEPTH deep, each an A slice of up to
# 256 rows (pitch DEPTH + PAD) and a weight slice of 64 columns (the wider
# weight slices of shorter chunks take less); h1 and h2 rows of Cm rounded
# up to CHAN_UNIT, plus PAD
DEPTH, STAGES, CHAN_UNIT, PAD = 32, 3, 32, 8
_RING_BYTES_BF16 = STAGES * 2 * (256 * (DEPTH + PAD) + DEPTH * (64 + PAD))
# conv3's output tile passes through h1's place on its way out
_STAGING_BYTES_BF16 = 2 * 256 * (64 + PAD)
# a block's shared memory: fp32 two blocks an SM (2 x (113 KB + 1 KB
# reserved) of its 228 KB), bf16 one block an SM
_SMEM_BUDGET = {torch.float32: 113 * 1024, torch.bfloat16: 227 * 1024}

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


def smem_budget(dtype) -> int:
    """The shared memory a block of the dtype's kernel may take."""
    return _SMEM_BUDGET[dtype]


def padded_channels(c_mid: int) -> int:
    """Cm as the bf16 kernel lays it in h1 and h2: rounded up to CHAN_UNIT,
    so that a slice of conv2's contraction lies inside one tap."""
    return -(-c_mid // CHAN_UNIT) * CHAN_UNIT


def smem_bytes(w: int, c_mid: int, rows: int, item: int) -> int:
    """A block's shared memory for strips of ``rows`` output rows, by the
    item size of x's dtype: the staged slices, h1 [rows + 2, w + 2, pitch]
    and h2 [rows w, pitch]; pitch is Cm in fp32, padded Cm + PAD in bf16,
    where h1 is also at least the tile conv3's output passes through."""
    h1, h2 = (rows + 2) * (w + 2), rows * w
    if item == 2:
        pitch = 2 * (padded_channels(c_mid) + PAD)
        return (_RING_BYTES_BF16 + max(pitch * h1, _STAGING_BYTES_BF16)
                + pitch * h2)
    return _STAGE_BYTES_F32 + 4 * c_mid * (h1 + h2)


def strip_rows(h: int, w: int, c: int, c_mid: int, dtype) -> int:
    """Output rows a block owns, or 0 when not even one row fits the
    dtype's budget (or the dtype is not a kernel's). fp32: the largest
    strip that fits. bf16: the largest strip that fits sets the number of
    strips of an image, and the rows are then spread evenly over them (28
    rows: 4 strips of 7, not 8 + 8 + 8 + 4), so that the blocks take about
    the same time and fewer strips need a second chunk of rows."""
    if dtype not in KERNEL_DTYPES:
        return 0
    item = torch.empty((), dtype=dtype).element_size()
    best = 0
    for rows in range(1, h + 1):
        if smem_bytes(w, c_mid, rows, item) <= smem_budget(dtype):
            best = rows
    if best == 0 or dtype == torch.float32:
        return best
    strips = -(-h // best)
    return -(-h // strips)


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
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be contiguous (x NHWC) "
                             "and start on 16 bytes")
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


def fused_identity_bottleneck_tiled_reference(x, w1, b1, w2, b2, w3, b3):
    """K5 in the bf16 kernel's own order of operations, in torch ops: an
    (image, strip of :func:`strip_rows` rows) at a time; conv1 over the
    strip's rows and the halo rows inside the image into a zeroed h1
    [rows + 2, W + 2, padded Cm + PAD]; conv2 as nine taps, each a shifted
    view of h1, the contraction tap-major in slices of DEPTH channels;
    conv3 over h2 in the same slices; the roundings and the adds of the
    formula in x's dtype. Shapes and layout as
    :func:`fused_identity_bottleneck`."""
    dt = x.dtype
    bsz, h, w, c = x.shape
    c_mid = w1.shape[1]
    rows = strip_rows(h, w, c, c_mid, dt)
    if rows == 0:
        raise ValueError(f"[{h}, {w}, {c}] / {c_mid} {dt} does not fit the "
                         "kernel (fused_bottleneck_supported)")
    cp = padded_channels(c_mid)
    w1p = torch.zeros(c, cp)
    w1p[:, :c_mid] = w1.float()
    w2p = torch.zeros(9, cp, cp)
    w2p[:, :c_mid, :c_mid] = w2.float().reshape(9, c_mid, c_mid)
    w3p = torch.zeros(cp, c)
    w3p[:c_mid] = w3.float()
    b1p, b2p = torch.zeros(cp), torch.zeros(cp)
    b1p[:c_mid], b2p[:c_mid] = b1.float(), b2.float()

    def product(a, wp):
        acc = torch.zeros(*a.shape[:-1], wp.shape[1])
        for k0 in range(0, a.shape[-1], DEPTH):
            acc += a[..., k0:k0 + DEPTH].float() @ wp[k0:k0 + DEPTH]
        return acc

    out = torch.empty_like(x)
    for y0 in range(0, h, rows):
        r = min(rows, h - y0)
        y_lo, y_hi = max(y0 - 1, 0), min(y0 + r, h - 1)
        h1 = torch.zeros(bsz, rows + 2, w + 2, cp + PAD, dtype=dt)
        v = F.relu(product(x[:, y_lo:y_hi + 1], w1p) + b1p)
        hr0 = y_lo - (y0 - 1)
        h1[:, hr0:hr0 + y_hi - y_lo + 1, 1:w + 1, :cp] = v.to(dt)
        acc = torch.zeros(bsz, r, w, cp)
        for tap in range(9):
            dh, dw = divmod(tap, 3)
            acc += product(h1[:, dh:dh + r, dw:dw + w, :cp], w2p[tap])
        h2 = torch.zeros(bsz, r, w, cp + PAD, dtype=dt)
        h2[..., :cp] = F.relu(acc + b2p).to(dt)
        o = product(h2[..., :cp], w3p).to(dt) + b3.to(dt)
        out[:, y0:y0 + r] = F.relu(o + x[:, y0:y0 + r])
    return out
