"""CLIP architecture configurations (the port's own copy of
transductive_clip_tpu/models/clip/config.py).

The full OpenAI model family the reference can load via clip.load
(reference main.py:50); the evaluation protocol itself uses RN50 /
ViT-B/16 / ViT-L/14 (reference: config/main_config.yaml).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    # ViT fields
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    # ResNet fields (used when is_resnet)
    is_resnet: bool = False
    resnet_layers: Tuple[int, ...] = (3, 4, 6, 3)


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8


@dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    vision: CLIPVisionConfig
    text: CLIPTextConfig


CLIP_CONFIGS = {
    "RN50": CLIPConfig(
        name="RN50",
        embed_dim=1024,
        vision=CLIPVisionConfig(
            image_size=224, width=64, is_resnet=True,
            resnet_layers=(3, 4, 6, 3), heads=32,
        ),
        text=CLIPTextConfig(width=512, layers=12, heads=8),
    ),
    "RN101": CLIPConfig(
        name="RN101",
        embed_dim=512,
        vision=CLIPVisionConfig(
            image_size=224, width=64, is_resnet=True,
            resnet_layers=(3, 4, 23, 3), heads=32,
        ),
        text=CLIPTextConfig(width=512, layers=12, heads=8),
    ),
    # the scaled ResNets: attnpool heads = trunk width // 2, text heads =
    # text width // 64 (the OpenAI family's scaling rule)
    "RN50x4": CLIPConfig(
        name="RN50x4",
        embed_dim=640,
        vision=CLIPVisionConfig(
            image_size=288, width=80, is_resnet=True,
            resnet_layers=(4, 6, 10, 6), heads=40,
        ),
        text=CLIPTextConfig(width=640, layers=12, heads=10),
    ),
    "RN50x16": CLIPConfig(
        name="RN50x16",
        embed_dim=768,
        vision=CLIPVisionConfig(
            image_size=384, width=96, is_resnet=True,
            resnet_layers=(6, 8, 18, 8), heads=48,
        ),
        text=CLIPTextConfig(width=768, layers=12, heads=12),
    ),
    "RN50x64": CLIPConfig(
        name="RN50x64",
        embed_dim=1024,
        vision=CLIPVisionConfig(
            image_size=448, width=128, is_resnet=True,
            resnet_layers=(3, 15, 36, 10), heads=64,
        ),
        text=CLIPTextConfig(width=1024, layers=12, heads=16),
    ),
    "ViT-B/16": CLIPConfig(
        name="ViT-B/16",
        embed_dim=512,
        vision=CLIPVisionConfig(patch_size=16, width=768, layers=12, heads=12),
        text=CLIPTextConfig(width=512, layers=12, heads=8),
    ),
    "ViT-B/32": CLIPConfig(
        name="ViT-B/32",
        embed_dim=512,
        vision=CLIPVisionConfig(patch_size=32, width=768, layers=12, heads=12),
        text=CLIPTextConfig(width=512, layers=12, heads=8),
    ),
    "ViT-L/14": CLIPConfig(
        name="ViT-L/14",
        embed_dim=768,
        vision=CLIPVisionConfig(patch_size=14, width=1024, layers=24, heads=16),
        text=CLIPTextConfig(width=768, layers=12, heads=12),
    ),
    "ViT-L/14@336px": CLIPConfig(
        name="ViT-L/14@336px",
        embed_dim=768,
        vision=CLIPVisionConfig(
            image_size=336, patch_size=14, width=1024, layers=24, heads=16,
        ),
        text=CLIPTextConfig(width=768, layers=12, heads=12),
    ),
}
