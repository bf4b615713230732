"""Method registries (counterpart of transductive_clip_tpu/methods/registry.py;
reference: src/eval_zero_shot.py:113-138 and src/eval_few_shot.py:189-211).
TIM_GD is wired in too (the reference ships the class and a config but
never registers it)."""

from __future__ import annotations

from .few_shot import ALPHA_TIM, BDCSPN, LAPLACIAN_SHOT, PADDLE, TIM_GD
from .few_shot import EM_DIRICHLET as FS_EM_DIRICHLET
from .few_shot import HARD_EM_DIRICHLET as FS_HARD_EM_DIRICHLET
from .zero_shot import (
    CLIP,
    EM_DIRICHLET,
    EM_GAUSSIAN,
    EM_GAUSSIAN_COV,
    HARD_EM_DIRICHLET,
    HARD_KMEANS,
    KL_KMEANS,
    SOFT_KMEANS,
)

ZERO_SHOT_METHODS = {
    "KL_KMEANS": KL_KMEANS,
    "EM_DIRICHLET": EM_DIRICHLET,
    "HARD_EM_DIRICHLET": HARD_EM_DIRICHLET,
    "EM_GAUSSIAN": EM_GAUSSIAN,
    "EM_GAUSSIAN_COV": EM_GAUSSIAN_COV,
    "SOFT_KMEANS": SOFT_KMEANS,
    "HARD_KMEANS": HARD_KMEANS,
    "CLIP": CLIP,
}

FEW_SHOT_METHODS = {
    "EM_DIRICHLET": FS_EM_DIRICHLET,
    "HARD_EM_DIRICHLET": FS_HARD_EM_DIRICHLET,
    "PADDLE": PADDLE,
    "BDCSPN": BDCSPN,
    "LAPLACIAN_SHOT": LAPLACIAN_SHOT,
    "ALPHA_TIM": ALPHA_TIM,
    "TIM-GD": TIM_GD,
}


def _get(kind, methods, name, **kwargs):
    if name not in methods:
        raise ValueError(
            f"Unknown {kind} method {name!r}; choose from {sorted(methods)}"
        )
    return methods[name](**kwargs)


def get_zero_shot_method(name, model=None, device=None, log_file=None, args=None):
    return _get("zero-shot", ZERO_SHOT_METHODS, name, model=model,
                device=device, log_file=log_file, args=args)


def get_few_shot_method(name, model=None, device=None, log_file=None, args=None):
    return _get("few-shot", FEW_SHOT_METHODS, name, model=model,
                device=device, log_file=log_file, args=args)
