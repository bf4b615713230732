"""Method registry (counterpart of transductive_clip_tpu/methods/registry.py;
reference: src/eval_zero_shot.py:113-138).

Only the two Dirichlet zero-shot methods are ported. Asking for another
method of the JAX package raises ``NotImplementedError`` naming the
ROADMAP.md item that ports it.
"""

from __future__ import annotations

from .base import unported
from .zero_shot import EM_DIRICHLET, HARD_EM_DIRICHLET

ZERO_SHOT_METHODS = {
    "EM_DIRICHLET": EM_DIRICHLET,
    "HARD_EM_DIRICHLET": HARD_EM_DIRICHLET,
}

# methods of the JAX package still to port -> the ROADMAP.md item
_UNPORTED_ZERO_SHOT = {
    name: "'remaining zero-shot methods'"
    for name in ("KL_KMEANS", "EM_GAUSSIAN", "EM_GAUSSIAN_COV", "SOFT_KMEANS",
                 "HARD_KMEANS", "CLIP")
}


def get_zero_shot_method(name, model=None, device=None, log_file=None, args=None):
    if name in _UNPORTED_ZERO_SHOT:
        raise unported(f"zero-shot method {name}", _UNPORTED_ZERO_SHOT[name])
    if name not in ZERO_SHOT_METHODS:
        raise ValueError(
            f"Unknown zero-shot method {name!r}; choose from "
            f"{sorted(ZERO_SHOT_METHODS)}"
        )
    return ZERO_SHOT_METHODS[name](model=model, device=device, log_file=log_file, args=args)


def get_few_shot_method(name, model=None, device=None, log_file=None, args=None):
    raise unported(f"few-shot method {name}", "'few-shot with K3'")
