"""CLIP Vision Transformer tower (ViT-B/16, ViT-B/32, ViT-L/14) —
counterpart of transductive_clip_tpu/models/clip/vit.py, with OpenAI's
state-dict names (``visual.conv1.weight``, ``visual.class_embedding``,
...).

Each forward counts, on the active ``core.profiling`` timer, the
attention modules its transformer ran (``vit.attention``, one a layer)
and those that ran in a hand-written kernel (``vit.kernel_attention``: the
launches of ``ops/cuda_attention``'s K4a and K4b in the forward, whichever
``attention_route`` picked; 0 on the CPU and on the 'xla' route), after
the transformer and outside its loop; and, the same way, the MLP
activations it ran (``vit.mlp_activations``, one a layer) and those that
ran in the QuickGELU kernel (``vit.kernel_activations``: the launches of
``ops/cuda_gelu.quick_gelu`` in the forward; 0 off the card); and the
residual adds its transformer ran with the LayerNorm after them
(``vit.add_norms``, 2 x layers - 1) and those that ran in the add-norm
kernel (``vit.kernel_add_norms``: the launches of
``ops/cuda_add_norm.add_layer_norm`` in the forward; 0 off the card)."""

from __future__ import annotations

import torch
from torch import nn

from ...core.profiling import count
from ...ops.cuda_add_norm import add_layer_norm
from ...ops.cuda_attention import attention_blocked, attention_rows
from ...ops.cuda_gelu import quick_gelu
from .config import CLIPVisionConfig
from .layers import LN_EPS, Transformer


def _kernel_launches() -> int:
    return attention_rows.launches + attention_blocked.launches


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, embed_dim: int,
                 attn_impl: str = "xla"):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size,
                               bias=False)
        n_tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(n_tokens, w))
        self.ln_pre = nn.LayerNorm(w, eps=LN_EPS)
        self.transformer = Transformer(w, cfg.layers, cfg.heads, attn_impl)
        self.ln_post = nn.LayerNorm(w, eps=LN_EPS)
        self.proj = nn.Parameter(torch.empty(w, embed_dim))

    def forward(self, images):
        """images [b, 3, H, W] (CLIP-normalized) -> [b, embed_dim]: the patch
        conv, the class token, the positional embedding, ln_pre, the
        transformer, ln_post on the class token, then proj."""
        x = self.conv1(images)                                  # [b, w, g, g]
        b, w = x.shape[:2]
        x = x.reshape(b, w, -1).permute(0, 2, 1)                # [b, g*g, w]
        cls = self.class_embedding.to(x.dtype).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        launched, activated = _kernel_launches(), quick_gelu.launches
        normed = add_layer_norm.launches
        x = self.transformer(x)
        layers = len(self.transformer.resblocks)
        count("vit.attention", layers)
        count("vit.kernel_attention", _kernel_launches() - launched)
        count("vit.mlp_activations", layers)
        count("vit.kernel_activations", quick_gelu.launches - activated)
        count("vit.add_norms", 2 * layers - 1)
        count("vit.kernel_add_norms", add_layer_norm.launches - normed)
        x = self.ln_post(x[:, 0, :])
        return x @ self.proj.to(x.dtype)
