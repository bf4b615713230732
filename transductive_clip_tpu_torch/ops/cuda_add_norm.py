"""The CLIP transformers' residual add with the LayerNorm after it, on the
card (``csrc/add_layer_norm.cu``).

``add_layer_norm(x, y, weight, bias, eps)`` returns ``(s, h)``: ``s = x +
y``, the residual stream after a block's attention or MLP branch, and ``h
= F.layer_norm(s, (w,), weight, bias, eps)``, the next branch's input.
``models/clip/layers.Transformer`` runs each of its blocks' residual adds
through it. The JAX package computes the pair in plain XLA
(``transductive_clip_tpu/models/clip/layers.py``,
``ResidualAttentionBlock``) and has no Pallas kernel for it.

* For tensors off the card (on the CPU, or on the meta device, which
  carries only shapes) the plain pair, :func:`add_layer_norm_reference`,
  runs, and only there: ``x + y`` into a new tensor, then ``F.layer_norm``.
* For CUDA tensors the kernel runs or the call raises: x, y, weight and
  bias of one dtype among fp32, bf16 and fp16, x and y of one shape, weight
  and bias of its last dimension, a row of at most ``MAX_ROW_BYTES``. In one
  read of x and y it writes s, bit-equal to ``x + y``, and h, whose
  statistics it takes in fp32 from the rounded s in two passes over
  registers (not PyTorch's Welford pass: h is within an ulp of an fp32
  LayerNorm of s, not bit-equal to PyTorch's).
* **On the card s is written over y** and y is returned as s: the caller
  passes a y that no one else holds. The towers pass the fresh output of
  ``out_proj`` or ``c_proj``. A y that is not contiguous is copied first,
  and s goes into the copy.

The kernel moves 16 bytes a step where the width fills whole 16-byte packs
and every pointer lies on 16 bytes, and one element otherwise (the C side
picks from the width and the pointers). ``add_layer_norm.launches`` counts
the launches; an empty tensor launches none. The outputs have no autograd
history: the towers run without gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernel_build

SOURCE = "add_layer_norm.cu"
#: the entry point's C arguments (``kernel_build.ARG_TYPES``)
SIGNATURES = {"tclip_add_layer_norm": "ppppp l i f i p"}
#: the dtypes the kernel takes -> their code in ``tclip_add_layer_norm``
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the widest row a warp of the kernel holds in registers (``kRowBytes``)
MAX_ROW_BYTES = 4096


def add_layer_norm_reference(x, y, weight, bias, eps):
    """The plain pair: the residual add, then the LayerNorm of the sum."""
    s = x + y
    return s, F.layer_norm(s, (s.shape[-1],), weight, bias, eps)


def _check(x, y, weight, bias):
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"add_layer_norm: the kernel takes "
                        f"{sorted(map(str, KERNEL_DTYPES))}, got {x.dtype}")
    w = x.shape[-1] if x.dim() else 0
    for name, t, shape in (("y", y, x.shape), ("weight", weight, (w,)),
                           ("bias", bias, (w,))):
        if t.dtype != x.dtype or tuple(t.shape) != tuple(shape) or (
                t.device != x.device):
            raise ValueError(
                f"add_layer_norm: {name} must be {x.dtype} of shape "
                f"{tuple(shape)} on {x.device}, got {t.dtype} of shape "
                f"{tuple(t.shape)} on {t.device}")
    if w * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"add_layer_norm: a row of {w} {x.dtype} is wider "
                         f"than the kernel's {MAX_ROW_BYTES} bytes")


def add_layer_norm(x, y, weight, bias, eps):
    """``(x + y, LayerNorm(x + y))``: the kernel on the card, with the sum
    written over y; the plain pair elsewhere."""
    if x.device.type != "cuda":
        return add_layer_norm_reference(x, y, weight, bias, eps)
    _check(x, y, weight, bias)
    x, y = x.contiguous(), y.contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    h = torch.empty_like(x)
    if x.numel() == 0:
        return y, h
    w = x.shape[-1]
    kernel_build.launch(
        kernel_build.load(SOURCE, SIGNATURES).tclip_add_layer_norm, x.device,
        x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        h.data_ptr(), x.numel() // w, w, float(eps), KERNEL_DTYPES[x.dtype])
    add_layer_norm.launches += 1
    return y, h


add_layer_norm.launches = 0
