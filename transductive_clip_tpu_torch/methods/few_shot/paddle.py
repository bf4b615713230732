"""PADDLE's support class means (counterpart of the first function of
transductive_clip_tpu/methods/few_shot/paddle.py; reference:
src/methods/few_shot/paddle.py:126-140). TIM starts its weights from them.

The ``PADDLE`` method itself is not ported yet: the registry raises for it
(ROADMAP.md, 'remaining few-shot methods').
"""

from __future__ import annotations

import torch

from ...ops.common import get_one_hot


def support_class_means(support, y_s, n_class):
    """Per-class mean of support features [N, K, d]."""
    one_hot = get_one_hot(y_s, n_class)                           # [N, s, K]
    counts = one_hot.sum(1)[..., None]                            # [N, K, 1]
    sums = torch.einsum("tsk,tsd->tkd", one_hot, support)
    return sums / counts
