"""Few-shot task samplers (a copy of
transductive_clip_tpu/tasks/sampler_few_shot.py; reference:
src/sampler_few_shot.py).

Reference semantics kept exactly:

* support: ``shots`` samples drawn from **every** one of the n_class classes
  (support size = n_class * shots) — not just the k_eff query classes; this
  "realistic task" design is load-bearing for the paper's numbers
  (reference: sampler_few_shot.py:64-76),
* query: k_eff (configured) random classes pooled, n_query uniform samples.

Sampling is a numpy Generator with the JAX package's draw order, so the
port draws the same tasks from the same seed.
"""

from __future__ import annotations

import numpy as np

from .sampler_zero_shot import MAX_FORCE_RETRIES


class CategoriesSamplerFewShot:
    def __init__(self, n_batch, k_eff, n_class, s_shot, n_query,
                 force_query_size=False, rng=None,
                 support_draw="vectorized"):
        self.n_batch = n_batch
        self.k_eff = k_eff
        self.s_shot = s_shot
        self.n_query = n_query
        self.n_class = n_class
        self.force_query_size = force_query_size
        self.rng = rng if rng is not None else np.random.default_rng()
        # 'vectorized' (fast, class-major rng stream) or 'per_task' (the
        # reference's draw order: one permutation per task per class)
        self.support_draw = support_draw
        self.m_ind_support = []
        self.m_ind_query = []

    def create_list_classes(self, label_support, label_query):
        label_support = np.asarray(label_support)
        label_query = np.asarray(label_query)
        # pools sized by n_class, not max(label)+1: a class absent from the
        # train split yields an EMPTY support pool (and a reachable query
        # pool), not an IndexError when the query sampler draws it
        n = max(self.n_class, int(label_support.max()) + 1)
        self.m_ind_support = [np.flatnonzero(label_support == i) for i in range(n)]
        self.m_ind_query = [np.flatnonzero(label_query == i) for i in range(n)]


class SamplerSupportFewShot:
    def __init__(self, cat_samp: CategoriesSamplerFewShot):
        self.s = cat_samp

    def __len__(self):
        return self.s.n_batch

    def __iter__(self):
        s = self.s
        if s.support_draw == "per_task":
            # reference draw order: one permutation per task per class
            # (reference: sampler_few_shot.py:64-76)
            for _ in range(s.n_batch):
                support = []
                for c in range(s.n_class):
                    pool = s.m_ind_support[c]
                    pos = s.rng.permutation(len(pool))[: s.s_shot]
                    support.append(pool[pos])
                yield np.concatenate(support)
            return
        # vectorized uniform without-replacement draws: one random matrix +
        # argpartition per class covers all tasks at once. Same
        # distribution: the s_shot smallest of iid uniforms index a uniform
        # subset; class-major row layout kept.
        per_class = []
        for c in range(s.n_class):
            pool = s.m_ind_support[c]
            take = min(s.s_shot, len(pool))
            r = s.rng.random((s.n_batch, len(pool)))
            if take < len(pool):
                picks = np.argpartition(r, take - 1, axis=1)[:, :take]
            else:
                picks = np.argsort(r, axis=1)
            per_class.append(pool[picks])              # [n_batch, take]
        stacked = np.concatenate(per_class, axis=1)    # [n_batch, K*shots]
        for t in range(s.n_batch):
            yield stacked[t]


class SamplerQueryFewShot:
    def __init__(self, cat_samp: CategoriesSamplerFewShot):
        self.s = cat_samp

    def __len__(self):
        return self.s.n_batch

    def __iter__(self):
        s = self.s
        for _ in range(s.n_batch):
            query = np.empty((0,), np.int64)
            n_trials = 0
            max_trials = MAX_FORCE_RETRIES if s.force_query_size else 1
            while len(query) < s.n_query and n_trials < max_trials:
                classes = s.rng.permutation(s.n_class)[: s.k_eff]
                pool = np.concatenate([s.m_ind_query[c] for c in classes])
                pos = s.rng.permutation(len(pool))[: s.n_query]
                query = pool[pos]
                n_trials += 1
            if s.force_query_size and len(query) < s.n_query:
                sizes = sorted(len(p) for p in s.m_ind_query)
                raise RuntimeError(
                    f"force_query_size: no draw of k_eff={s.k_eff} classes "
                    f"can fill n_query={s.n_query} after {max_trials} "
                    f"retries (largest class pools: {sizes[-s.k_eff:]})."
                    " Reduce n_query or use a larger split."
                )
            yield query
