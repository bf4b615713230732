"""Synthetic separable zero-shot tasks (class-peaked Dirichlet softmax
features). A copy of the zero-shot half of
transductive_clip_tpu/utils/synthetic.py, so that the port draws the same
tasks from the same numpy Generator; the few-shot generator comes with the
few-shot slice.
"""

from __future__ import annotations

import numpy as np


def make_zero_shot_tasks(rng, n_task, n_query, n_class, k_eff=None,
                         k_eff_range=(3, 10), concentration=60.0):
    """Zero-shot tasks: features [n_task, n_query, n_class] on the simplex,
    labels [n_task, n_query]. Per task, k_eff classes are drawn (uniform in
    ``k_eff_range`` when ``k_eff`` is None, matching the protocol's
    per-task redraw)."""
    x = np.zeros((n_task, n_query, n_class), np.float32)
    y = np.zeros((n_task, n_query), np.int64)
    for t in range(n_task):
        k = k_eff if k_eff is not None else int(
            rng.integers(k_eff_range[0], k_eff_range[1] + 1)
        )
        classes = rng.choice(n_class, size=k, replace=False)
        labels = rng.choice(classes, size=n_query)
        for i, c in enumerate(labels):
            alpha = np.ones(n_class)
            alpha[c] += concentration
            x[t, i] = rng.dirichlet(alpha)
        y[t] = labels
    return x, y

