"""The protocol's task draws for the controls (control.py): which rows of
the feature tables make each task of an evaluation, for a sampler seed. A
run of the benchmark checks the draws the program recorded, not these.

The draws are the paper's (src/sampler_zero_shot.py, src/sampler_few_shot.py)
in the draw order that the program documents for the same seed: a numpy
``default_rng(seed)``; per batch of ``batch_size`` tasks, the query draws,
then (few-shot) the support draws, class-major, by an argpartition of
uniform numbers. Every pool holds at least ``n_query`` rows in the cells'
configurations, so a draw is never retried. Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def class_pools(labels, n_class):
    labels = np.asarray(labels)
    return [np.flatnonzero(labels == c) for c in range(n_class)]


def _query(rng, pools, n_class, n_query, k_eff):
    """One task's query rows; ``k_eff`` None draws it per task, 3 to 10."""
    k = int(rng.integers(3, 11)) if k_eff is None else k_eff
    classes = rng.permutation(n_class)[:k]
    pool = np.concatenate([pools[c] for c in classes])
    query = pool[rng.permutation(len(pool))[:n_query]]
    if len(query) < n_query:
        raise ValueError("a query pool smaller than n_query needs retries, "
                         "which this copy does not draw")
    return query


def zero_shot_tasks(seed, labels, n_class, n_query, n_tasks, batch_size):
    """[n_tasks, n_query] query rows of a zero-shot evaluation."""
    rng = np.random.default_rng(seed)
    pools = class_pools(labels, n_class)
    n = (n_tasks // batch_size) * batch_size
    return np.stack([_query(rng, pools, n_class, n_query, None)
                     for _ in range(n)])


def few_shot_tasks(seed, support_labels, query_labels, n_class, shots,
                   n_query, k_eff, n_tasks, batch_size):
    """([n_tasks, n_class * shots] support rows, [n_tasks, n_query] query
    rows) of a few-shot evaluation."""
    rng = np.random.default_rng(seed)
    s_pools = class_pools(support_labels, n_class)
    q_pools = class_pools(query_labels, n_class)
    supports, queries = [], []
    for _ in range(n_tasks // batch_size):
        queries += [_query(rng, q_pools, n_class, n_query, k_eff)
                    for _ in range(batch_size)]
        per_class = []
        for c in range(n_class):
            pool = s_pools[c]
            r = rng.random((batch_size, len(pool)))
            picks = np.argpartition(r, shots - 1, axis=1)[:, :shots]
            per_class.append(pool[picks])
        supports.append(np.concatenate(per_class, axis=1))
    return np.concatenate(supports), np.stack(queries)
