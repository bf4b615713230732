from .sampler_zero_shot import CategoriesSamplerZeroShot, SamplerQueryZeroShot
from .generator import TasksGeneratorZeroShot

__all__ = [
    "CategoriesSamplerZeroShot",
    "SamplerQueryZeroShot",
    "TasksGeneratorZeroShot",
]
