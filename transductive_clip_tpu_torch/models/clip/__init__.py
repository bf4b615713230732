"""The CLIP towers of the port (counterpart of
transductive_clip_tpu/models/clip/): torch modules with OpenAI's state-dict
keys, K4a / K4b for the transformer attention and K5 for the ResNet
identity bottlenecks on the card."""

from .config import CLIP_CONFIGS, CLIPConfig
from .model import CLIP, TorchCLIP, init_random_state_dict, load

__all__ = [
    "CLIP",
    "CLIP_CONFIGS",
    "CLIPConfig",
    "TorchCLIP",
    "init_random_state_dict",
    "load",
]
