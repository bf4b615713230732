"""Method registries (counterpart of transductive_clip_tpu/methods/registry.py;
reference: src/eval_zero_shot.py:113-138 and src/eval_few_shot.py:189-211).

Ported: the two Dirichlet zero-shot methods, and the few-shot EM-Dirichlet
(soft and hard), alpha-TIM and TIM-GD. Asking for another method of the JAX
package raises ``NotImplementedError`` naming the ROADMAP.md item that ports
it.
"""

from __future__ import annotations

from .base import unported
from .few_shot import ALPHA_TIM, TIM_GD
from .few_shot import EM_DIRICHLET as FS_EM_DIRICHLET
from .few_shot import HARD_EM_DIRICHLET as FS_HARD_EM_DIRICHLET
from .zero_shot import EM_DIRICHLET, HARD_EM_DIRICHLET

ZERO_SHOT_METHODS = {
    "EM_DIRICHLET": EM_DIRICHLET,
    "HARD_EM_DIRICHLET": HARD_EM_DIRICHLET,
}

FEW_SHOT_METHODS = {
    "EM_DIRICHLET": FS_EM_DIRICHLET,
    "HARD_EM_DIRICHLET": FS_HARD_EM_DIRICHLET,
    "ALPHA_TIM": ALPHA_TIM,
    "TIM-GD": TIM_GD,
}

# methods of the JAX package still to port -> the ROADMAP.md item
_UNPORTED_ZERO_SHOT = {
    name: "'remaining zero-shot methods'"
    for name in ("KL_KMEANS", "EM_GAUSSIAN", "EM_GAUSSIAN_COV", "SOFT_KMEANS",
                 "HARD_KMEANS", "CLIP")
}
_UNPORTED_FEW_SHOT = {
    name: "'remaining few-shot methods'"
    for name in ("PADDLE", "BDCSPN", "LAPLACIAN_SHOT")
}


def _get(kind, methods, unported_names, name, **kwargs):
    if name in unported_names:
        raise unported(f"{kind} method {name}", unported_names[name])
    if name not in methods:
        raise ValueError(
            f"Unknown {kind} method {name!r}; choose from {sorted(methods)}"
        )
    return methods[name](**kwargs)


def get_zero_shot_method(name, model=None, device=None, log_file=None, args=None):
    return _get("zero-shot", ZERO_SHOT_METHODS, _UNPORTED_ZERO_SHOT, name,
                model=model, device=device, log_file=log_file, args=args)


def get_few_shot_method(name, model=None, device=None, log_file=None, args=None):
    return _get("few-shot", FEW_SHOT_METHODS, _UNPORTED_FEW_SHOT, name,
                model=model, device=device, log_file=log_file, args=args)
