"""CLIP text tower: token embedding + causal transformer + projection,
pooled at the end-of-text token (the highest token id) — counterpart of
transductive_clip_tpu/models/clip/text.py.

OpenAI CLIP keeps the text tower's weights at the top level of its state
dict (``token_embedding.weight``, ``positional_embedding``,
``transformer.*``, ``ln_final.*``, ``text_projection``), so the model
(models/clip/model.py) subclasses this tower rather than holding it."""

from __future__ import annotations

import torch
from torch import nn

from .config import CLIPTextConfig
from .layers import LN_EPS, Transformer


class TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, embed_dim: int,
                 attn_impl: str = "xla"):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.width))
        self.transformer = Transformer(cfg.width, cfg.layers, cfg.heads,
                                       attn_impl)
        self.ln_final = nn.LayerNorm(cfg.width, eps=LN_EPS)
        self.text_projection = nn.Parameter(torch.empty(cfg.width, embed_dim))

    def encode_text(self, tokens):
        """tokens [b, context_length] int -> [b, embed_dim] in the
        parameters' dtype: the causal ``-inf`` mask in that dtype, pooling
        at the argmax token id, then ``text_projection``."""
        x = self.token_embedding(tokens)
        x = x + self.positional_embedding.to(x.dtype)
        n = tokens.shape[-1]
        causal = torch.full((n, n), float("-inf"), dtype=x.dtype,
                            device=x.device).triu(1)
        x = self.transformer(x, causal)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection.to(x.dtype)
