"""The CLIP transformers' QuickGELU on the card (``csrc/quick_gelu.cu``).

``quick_gelu(x)`` is ``x * torch.sigmoid(1.702 * x)``, the activation
between each block's ``c_fc`` and ``c_proj`` (``models/clip/layers.py``),
out of place. The JAX package computes it in plain XLA
(``transductive_clip_tpu/models/clip/layers.py``, ``QuickGELU``) and has no
Pallas kernel for it.

* For a tensor off the card (on the CPU, or on the meta device, which
  carries only shapes) the plain chain, :func:`quick_gelu_reference`, runs,
  and only there.
* For a CUDA tensor the kernel runs or the call raises: it takes fp32, bf16
  and fp16. x is made contiguous first, a no-op on the towers' path, and the
  output is contiguous. The kernel rounds as the chain does (each of its
  three ops in fp32, rounded to the dtype), so its output is bit-equal to
  the chain on the card, in one read of x and one write of the output
  where the chain makes seven passes.

The kernel moves 16 bytes a thread where both pointers lie on 16 bytes, and
one element otherwise (the C side picks from the pointers).
``quick_gelu.launches`` counts the launches; an empty tensor launches none.
The output has no autograd history: the towers run without gradients.
"""

from __future__ import annotations

import torch

from . import kernel_build

SOURCE = "quick_gelu.cu"
#: the entry point's C arguments (``kernel_build.ARG_TYPES``)
SIGNATURES = {"tclip_quick_gelu": "pp l i p"}
#: the dtypes the kernel takes -> their code in ``tclip_quick_gelu``
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quick_gelu_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain chain: OpenAI CLIP's QuickGELU in three PyTorch ops."""
    return x * torch.sigmoid(1.702 * x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 x)``: the kernel on the card, the plain chain
    elsewhere."""
    if x.device.type != "cuda":
        return quick_gelu_reference(x)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"quick_gelu: the kernel takes "
                        f"{sorted(map(str, KERNEL_DTYPES))}, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    kernel_build.launch(
        kernel_build.load(SOURCE, SIGNATURES).tclip_quick_gelu, x.device,
        x.data_ptr(), out.data_ptr(), x.numel(), KERNEL_DTYPES[x.dtype])
    quick_gelu.launches += 1
    return out


quick_gelu.launches = 0
