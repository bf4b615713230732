"""Few-shot hard EM-Dirichlet: argmax one-hot assignments each iteration
(counterpart of transductive_clip_tpu/methods/few_shot/hard_em_dirichlet.py;
reference: src/methods/few_shot/hard_em_dirichlet.py).
"""

from .em_dirichlet import EM_DIRICHLET


class HARD_EM_DIRICHLET(EM_DIRICHLET):
    hard = True
