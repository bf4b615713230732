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

In bf16 the three convolutions run on the tensor cores, in fp32 on FFMA
(TF32 stays off) with an 8 x 8 register tile a thread; in both, conv2's and
conv3's input is read where it lies in shared memory, and the weights come
through a ring of ``cp.async`` slices.

The support gate :func:`fused_bottleneck_supported` is this card's own: a
block owns a strip of output rows of one image (:func:`strip_rows`), and
the gate accepts a block when a strip of at least one row fits
``SMEM_BUDGET``. It accepts all 12 RN50 identity blocks at bf16 and at
fp32; blocks it rejects take the plain graph (``models/clip/resnet.py``).

The wrapper takes its plain torch version for tensors on the CPU, and only
then; for CUDA tensors it launches the kernel or raises.
``fused_identity_bottleneck.launches`` counts the launches.
:func:`fused_identity_bottleneck_tiled_reference` repeats the kernels'
tiling in torch ops (what a block owns, the halo rows, the padded pitch, the
tap-major contraction slice by slice), for the CPU tests; the order of the
sums inside a slice, and the fp32 kernel's split groups, it does not model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel_build

SOURCE = "bottleneck.cu"
#: the entry point's C arguments (``kernel_build.ARG_TYPES``)
SIGNATURES = {"tclip_bottleneck": "pppppppp iiiiiii p"}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# csrc, bf16: a ring of STAGES slices DEPTH deep, each an A slice of up to
# 256 rows (pitch DEPTH + PAD) and a weight slice of 64 columns (the wider
# weight slices of shorter chunks take less); h1 and h2 rows of Cm rounded
# up to CHAN_UNIT, plus PAD
DEPTH, STAGES, CHAN_UNIT, PAD = 32, 3, 32, 8
_RING_BYTES_BF16 = STAGES * 2 * (256 * (DEPTH + PAD) + DEPTH * (64 + PAD))
# conv3's output tile passes through h1's place on its way out
_STAGING_BYTES_BF16 = 2 * 256 * (64 + PAD)
# csrc, fp32: a ring of STAGES weight slices DEPTH_F32 deep and up to
# RING_COLS_F32 wide; conv1's x comes through a ring of STAGES slices of up to
# ROWS_F32 rows (pitch DEPTH_F32 + 4) in h2's place; h1 and h2 rows of Cm
# rounded up to CHAN_UNIT_F32, plus PAD_F32
DEPTH_F32, CHAN_UNIT_F32, PAD_F32, RING_COLS_F32, ROWS_F32 = 16, 16, 4, 256, 256
_STAGE_BYTES_F32 = 4 * DEPTH_F32 * RING_COLS_F32
_X_RING_BYTES_F32 = STAGES * 4 * ROWS_F32 * (DEPTH_F32 + 4)
# a block's shared memory (kSmemMax): one block an SM in both dtypes
SMEM_BUDGET = 227 * 1024


def padded_channels(c_mid: int, unit: int = CHAN_UNIT) -> int:
    """Cm as a kernel lays it in h1 and h2: rounded up to ``unit``
    (CHAN_UNIT in bf16, CHAN_UNIT_F32 in fp32), so that a slice of conv2's
    contraction lies inside one tap."""
    return -(-c_mid // unit) * unit


def smem_bytes(w: int, c_mid: int, rows: int, item: int) -> int:
    """A block's shared memory for strips of ``rows`` output rows, by the
    item size of x's dtype: the ring, h1 [rows + 2, w + 2, pitch] and h2
    [rows w, pitch], pitch the padded Cm plus the padding of a row. bf16:
    h1 is also at least the tile conv3's output passes through. fp32: h2's
    place is also at least conv1's x ring."""
    h1, h2 = (rows + 2) * (w + 2), rows * w
    if item == 2:
        pitch = 2 * (padded_channels(c_mid) + PAD)
        return (_RING_BYTES_BF16 + max(pitch * h1, _STAGING_BYTES_BF16)
                + pitch * h2)
    pitch = 4 * (padded_channels(c_mid, CHAN_UNIT_F32) + PAD_F32)
    return (STAGES * _STAGE_BYTES_F32 + pitch * h1
            + max(pitch * h2, _X_RING_BYTES_F32))


def strip_rows(h: int, w: int, c: int, c_mid: int, dtype) -> int:
    """Output rows a block owns, or 0 when not even one row fits the budget
    (or the dtype is not a kernel's). The largest strip that fits sets the
    number of strips of an image, and the rows are then spread evenly over
    them (28 rows: 4 strips of 7, not 8 + 8 + 8 + 4), so that
    the blocks take about the same time and fewer strips need a second
    chunk of rows."""
    if dtype not in KERNEL_DTYPES:
        return 0
    item = torch.empty((), dtype=dtype).element_size()
    best = 0
    for rows in range(1, h + 1):
        if smem_bytes(w, c_mid, rows, item) <= SMEM_BUDGET:
            best = rows
    if best == 0:
        return 0
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
    kernel_build.launch(
        kernel_build.load(SOURCE, SIGNATURES).tclip_bottleneck, x.device,
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        bsz, h, w, c, w1.shape[1], rows, int(x.dtype == torch.bfloat16))
    fused_identity_bottleneck.launches += 1
    return out


fused_identity_bottleneck.launches = 0


def fused_identity_bottleneck_tiled_reference(x, w1, b1, w2, b2, w3, b3):
    """K5 in the kernels' tiling, in torch ops: an (image, strip of
    :func:`strip_rows` rows) at a time; conv1 over the strip's rows and the
    halo rows inside the image into a zeroed h1 [rows + 2, W + 2, padded
    Cm + pad]; conv2 as nine taps, each a shifted view of h1, the
    contraction tap-major in slices (DEPTH deep in bf16, DEPTH_F32 in
    fp32); conv3 over h2 in the same slices; the roundings and the adds of
    the formula in x's dtype. Shapes and layout as
    :func:`fused_identity_bottleneck`.

    Each slice is one matmul, so the order of the sums inside a slice is
    torch's. Nor is the fp32 kernel's split modelled: where its tiling cuts
    the 8 warps into 2 or 4 groups (most products at RN50's layer3-4), each
    group sums its share of every slice's depth and the groups hand their
    partial sums over in place at the tile's end. Only the ``cuda`` tests,
    kernel against plain version, cover that hand-over."""
    dt = x.dtype
    bsz, h, w, c = x.shape
    c_mid = w1.shape[1]
    rows = strip_rows(h, w, c, c_mid, dt)
    if rows == 0:
        raise ValueError(f"[{h}, {w}, {c}] / {c_mid} {dt} does not fit the "
                         "kernel (fused_bottleneck_supported)")
    if dt == torch.float32:
        depth, pad = DEPTH_F32, PAD_F32
        cp = padded_channels(c_mid, CHAN_UNIT_F32)
    else:
        depth, pad, cp = DEPTH, PAD, padded_channels(c_mid)
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
        for k0 in range(0, a.shape[-1], depth):
            acc += a[..., k0:k0 + depth].float() @ wp[k0:k0 + depth]
        return acc

    out = torch.empty_like(x)
    for y0 in range(0, h, rows):
        r = min(rows, h - y0)
        y_lo, y_hi = max(y0 - 1, 0), min(y0 + r, h - 1)
        h1 = torch.zeros(bsz, rows + 2, w + 2, cp + pad, dtype=dt)
        v = F.relu(product(x[:, y_lo:y_hi + 1], w1p) + b1p)
        hr0 = y_lo - (y0 - 1)
        h1[:, hr0:hr0 + y_hi - y_lo + 1, 1:w + 1, :cp] = v.to(dt)
        acc = torch.zeros(bsz, r, w, cp)
        for tap in range(9):
            dh, dw = divmod(tap, 3)
            acc += product(h1[:, dh:dh + r, dw:dw + w, :cp], w2p[tap])
        h2 = torch.zeros(bsz, r, w, cp + pad, dtype=dt)
        h2[..., :cp] = F.relu(acc + b2p).to(dt)
        o = product(h2[..., :cp], w3p).to(dt) + b3.to(dt)
        out[:, y0:y0 + r] = F.relu(o + x[:, y0:y0 + r])
    return out
