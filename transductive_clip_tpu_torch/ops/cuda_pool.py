"""The ResNet towers' average pool on the card (``csrc/avg_pool.cu``).

``avg_pool_nhwc(x, window)`` is a ``window`` x ``window``, stride-``window``,
unpadded, floor-mode average pool of x [N, C, H, W], as ``F.avg_pool2d(x,
window)`` computes it. Every pool of ``models/clip/resnet.ModifiedResNet``
goes through it. The JAX package pools with flax's ``nn.avg_pool``
(``transductive_clip_tpu/models/clip/resnet.py``) and has no Pallas kernel
for it.

* Window 1 returns x itself, on every device, as the JAX package skips its
  pool at stride 1: nothing is copied or launched.
* For a tensor off the card (on the CPU, or on the meta device, which
  carries only shapes) the plain version, ``F.avg_pool2d``, runs, and only
  there.
* For a CUDA tensor the kernel runs or the call raises. x is made
  ``channels_last`` contiguous first, a no-op on the tower's path, and the
  output is ``channels_last``. The kernel sums each window in fp32 in
  PyTorch's order and divides once, so its output is bit-equal to
  ``F.avg_pool2d`` on the card in fp32, bf16 and fp16.

A thread of the kernel loads 16 bytes of channels at a time where a pixel's
channels fill whole 16-byte groups and both tensors start on 16 bytes, and
one element otherwise (:func:`vector_width`: the shape, the dtype and the
pointers decide). ``avg_pool_nhwc.launches`` counts the launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel_build

SOURCE = "avg_pool.cu"
#: the entry point's C arguments (``kernel_build.ARG_TYPES``)
SIGNATURES = {"tclip_avg_pool": "pp iiiii ii p"}
#: the dtypes the kernel takes -> their code in ``tclip_avg_pool``
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
VECTOR_BYTES = 16
_INT_MAX = 2**31 - 1


def vector_width(channels: int, dtype: torch.dtype, *pointers: int) -> int:
    """The elements a thread of the kernel loads at once: 16 bytes' worth
    where ``channels`` of ``dtype`` fill whole 16-byte groups and every
    pointer is 16-byte aligned, else 1."""
    item = dtype.itemsize
    if (channels * item) % VECTOR_BYTES == 0 and all(
            p % VECTOR_BYTES == 0 for p in pointers):
        return VECTOR_BYTES // item
    return 1


def _check(x, window):
    if x.dim() != 4:
        raise ValueError(f"avg_pool_nhwc: x must be [N, C, H, W], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"avg_pool_nhwc: the kernel takes "
                        f"{sorted(map(str, KERNEL_DTYPES))}, got {x.dtype}")
    n, c, h, w = x.shape
    if h < window or w < window:
        raise ValueError(f"avg_pool_nhwc: a {window} x {window} window over "
                         f"{h} x {w} pixels leaves no output")
    if max(n, c, h, w) > _INT_MAX:
        raise ValueError(f"avg_pool_nhwc: {tuple(x.shape)} has a size past "
                         "a C int")


def avg_pool_nhwc(x: torch.Tensor, window: int) -> torch.Tensor:
    """``F.avg_pool2d(x, window)`` (kernel size and stride ``window``);
    ``x`` itself at window 1. On the card the output is ``channels_last``."""
    if window < 1:
        raise ValueError(f"avg_pool_nhwc: window {window} < 1")
    if window == 1:
        return x
    if x.device.type != "cuda":
        return F.avg_pool2d(x, window)
    _check(x, window)
    x = x.contiguous(memory_format=torch.channels_last)
    n, c, h, w = x.shape
    out = torch.empty((n, c, h // window, w // window), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    kernel_build.launch(
        kernel_build.load(SOURCE, SIGNATURES).tclip_avg_pool, x.device,
        x.data_ptr(), out.data_ptr(), n, h, w, c, window,
        KERNEL_DTYPES[x.dtype],
        vector_width(c, x.dtype, x.data_ptr(), out.data_ptr()))
    avg_pool_nhwc.launches += 1
    return out


avg_pool_nhwc.launches = 0
