"""Hard EM-Dirichlet: EM-Dirichlet with hard (argmax one-hot) assignments
each iteration (counterpart of
transductive_clip_tpu/methods/zero_shot/hard_em_dirichlet.py; reference:
src/methods/zero_shot/hard_em_dirichlet.py:254-258).
"""

from .em_dirichlet import EM_DIRICHLET


class HARD_EM_DIRICHLET(EM_DIRICHLET):
    hard = True
