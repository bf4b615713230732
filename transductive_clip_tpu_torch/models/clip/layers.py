"""Transformer building blocks shared by the CLIP vision and text towers
(counterpart of transductive_clip_tpu/models/clip/layers.py).

Parameter names are OpenAI CLIP's state-dict keys (``attn.in_proj_weight``,
``mlp.c_fc.weight``, ...), so a checkpoint loads with ``load_state_dict``.
Activations are batch-first [b, n, width], as in the JAX package.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cuda_add_norm import add_layer_norm
from ...ops.cuda_attention import fused_attention
from ...ops.cuda_gelu import quick_gelu

LN_EPS = 1e-5
ATTN_IMPLS = ("xla", "fused")


class QuickGELU(nn.Module):
    """``x * sigmoid(1.702 x)`` through ``ops/cuda_gelu.quick_gelu``: one
    hand-written pass on the card, the plain chain elsewhere."""

    def forward(self, x):
        return quick_gelu(x)


class MultiHeadAttention(nn.Module):
    """Fused-qkv multi-head attention in OpenAI CLIP's in_proj layout.

    ``attn_impl`` selects the score computation:
      * ``'xla'`` — plain torch ops in the order of the JAX package's einsum
        path: ``q * scale`` before the dot in the compute dtype, ``+ mask``,
        the softmax in fp32, then a cast back to the compute dtype;
      * ``'fused'`` — ``ops/cuda_attention.fused_attention``: K4a or K4b on
        the card, their plain version on the CPU.
    Both share the in/out projections, so the parameters are the same."""

    def __init__(self, width: int, heads: int, attn_impl: str = "xla"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one "
                             f"of {ATTN_IMPLS}")
        self.width, self.heads, self.attn_impl = width, heads, attn_impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask=None):
        b, n, _ = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)   # [b, n, 3w]
        if self.attn_impl == "fused":
            return self.out_proj(fused_attention(qkv, self.heads, mask))
        head_dim = self.width // self.heads
        q, k, v = (t.permute(0, 2, 1, 3) for t in
                   qkv.reshape(b, n, 3, self.heads, head_dim).unbind(2))
        attn = torch.matmul(q * head_dim ** -0.5, k.transpose(-1, -2))
        if mask is not None:
            attn = attn + mask
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).permute(0, 2, 1, 3).reshape(b, n, self.width)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    """One block's parameters under OpenAI's keys. It has no forward of its
    own: ``Transformer.forward`` runs the blocks, fusing each residual add
    with the LayerNorm after it across block boundaries."""

    def __init__(self, width: int, heads: int, attn_impl: str = "xla"):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = MultiHeadAttention(width, heads, attn_impl)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(4 * width, width)),
        ]))


class Transformer(nn.Module):
    """OpenAI CLIP's stack of blocks, ``x = x + attn(ln_1(x))`` then ``x = x
    + mlp(ln_2(x))`` in each. The blocks hold the parameters (and their
    state-dict keys); this forward runs them, so that each residual add and
    the LayerNorm after it are one ``ops/cuda_add_norm.add_layer_norm`` (one
    hand-written pass on the card, the plain pair elsewhere): a block's
    first add with its own ``ln_2``, its second with the next block's
    ``ln_1``. That is 2 x layers - 1 pairs; the first ``ln_1`` and the last
    add run alone."""

    def __init__(self, width: int, layers: int, heads: int,
                 attn_impl: str = "xla"):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, attn_impl)
             for _ in range(layers)])

    def forward(self, x, mask=None):
        blocks = self.resblocks
        h = blocks[0].ln_1(x)
        for i, block in enumerate(blocks):
            # attn's and mlp's outputs are fresh: the kernel writes the sum
            # over them
            ln = block.ln_2
            x, h = add_layer_norm(x, block.attn(h, mask), ln.weight,
                                  ln.bias, ln.eps)
            if i + 1 == len(blocks):
                return x + block.mlp(h)
            ln = blocks[i + 1].ln_1
            x, h = add_layer_norm(x, block.mlp(h), ln.weight, ln.bias, ln.eps)
