"""Zero-shot task sampler.

Protocol semantics are load-bearing for the paper's accuracy numbers and are
kept exactly (reference: src/sampler_zero_shot.py):

* each task draws its own effective class count k_eff ~ uniform{3..10},
  *ignoring* the configured k_eff (reference: sampler_zero_shot.py:54),
* the query set pools all samples of the drawn classes and takes a uniform
  subset of size n_query with NO class balancing ("realistic" imbalanced
  tasks),
* with force_query_size=True the draw is retried until the pool yields a
  full-size query set.

Sampling is a numpy Generator, as in the JAX package
(transductive_clip_tpu/tasks/sampler_zero_shot.py): task generation is
host-side, deterministic per seed, independent of the device's generator,
and draws the same tasks as the JAX package from the same seed.
"""

from __future__ import annotations

import numpy as np

# retry budget for force_query_size draws before declaring the pool unfillable
MAX_FORCE_RETRIES = 1000


class CategoriesSamplerZeroShot:
    def __init__(self, n_batch, k_eff, n_class, n_query,
                 force_query_size=False, rng=None):
        self.n_batch = n_batch
        self.k_eff = k_eff
        self.n_query = n_query
        self.n_class = n_class
        self.force_query_size = force_query_size
        self.rng = rng if rng is not None else np.random.default_rng()
        self.m_ind_query = []

    def create_list_classes(self, label_query):
        label_query = np.asarray(label_query)
        self.m_ind_query = [
            np.flatnonzero(label_query == i) for i in range(self.n_class)
        ]


class SamplerQueryZeroShot:
    def __init__(self, cat_samp: CategoriesSamplerZeroShot):
        self.s = cat_samp

    def __len__(self):
        return self.s.n_batch

    def __iter__(self):
        s = self.s
        for _ in range(s.n_batch):
            k_eff = int(s.rng.integers(3, 11))  # per-task redraw, 3..10 incl.
            query = np.empty((0,), np.int64)
            n_trials = 0
            # the reference retries forever under force_query_size
            # (sampler_zero_shot.py:57-71); bounded here so an unfillable
            # pool fails loudly instead of hanging
            max_trials = MAX_FORCE_RETRIES if s.force_query_size else 1
            while len(query) < s.n_query and n_trials < max_trials:
                classes = s.rng.permutation(s.n_class)[:k_eff]
                pool = np.concatenate([s.m_ind_query[c] for c in classes])
                pos = s.rng.permutation(len(pool))[: s.n_query]
                query = pool[pos]
                n_trials += 1
            if s.force_query_size and len(query) < s.n_query:
                sizes = sorted(len(p) for p in s.m_ind_query)
                raise RuntimeError(
                    f"force_query_size: no draw of k_eff={k_eff} classes can "
                    f"fill n_query={s.n_query} after {max_trials} retries "
                    f"(largest class pools: {sizes[-k_eff:]} -> max pool "
                    f"{sum(sizes[-k_eff:])}). Reduce n_query or use a larger "
                    "split."
                )
            yield query
