from .sampler_zero_shot import CategoriesSamplerZeroShot, SamplerQueryZeroShot
from .sampler_few_shot import (
    CategoriesSamplerFewShot,
    SamplerQueryFewShot,
    SamplerSupportFewShot,
)
from .generator import TasksGeneratorFewShot, TasksGeneratorZeroShot

__all__ = [
    "CategoriesSamplerZeroShot",
    "SamplerQueryZeroShot",
    "CategoriesSamplerFewShot",
    "SamplerQueryFewShot",
    "SamplerSupportFewShot",
    "TasksGeneratorZeroShot",
    "TasksGeneratorFewShot",
]
