"""Task generators: gather sampled feature rows and stack ``batch_size``
tasks into [n_task, n, d] arrays (a copy of
transductive_clip_tpu/tasks/generator.py; reference:
src/task_generator_zero_shot.py and src/task_generator_few_shot.py).

Few-shot tasks remap dataset labels to task-local ids using the flipped
unique support labels, and — for softmax features — permute the feature
columns to match, so that class j's feature coordinate is column j
(reference: task_generator_few_shot.py:41-57). Since the support sampler
covers every class, this is a deterministic descending relabeling.
"""

from __future__ import annotations

import numpy as np


class TasksGeneratorZeroShot:
    def __init__(self, k_eff, n_query, n_class, loader_query, model=None, args=None):
        self.k_eff = k_eff
        self.n_query = n_query
        self.n_class = n_class
        self.loader_query = loader_query
        self.model = model
        self.args = args

    def generate_tasks(self):
        xs, ys = [], []
        for data_query, labels_query in self.loader_query:
            xs.append(np.asarray(data_query))
            ys.append(np.asarray(labels_query, np.int64))
        x_q = np.stack(xs, axis=0)                        # [n_task, n, d]
        y_q = np.stack(ys, axis=0)[..., None]             # [n_task, n, 1]
        return {"x_q": x_q, "y_q": y_q}


class TasksGeneratorFewShot:
    def __init__(self, k_eff, shot, n_query, n_class, loader_support,
                 loader_query, model=None, args=None):
        self.k_eff = k_eff
        self.shot = shot
        self.n_query = n_query
        self.n_class = n_class
        self.loader_support = loader_support
        self.loader_query = loader_query
        self.model = model
        self.args = args

    def _get_task(self, data_support, data_query, labels_support, labels_query):
        labels_support = np.asarray(labels_support, np.int64)
        labels_query = np.asarray(labels_query, np.int64)
        data_support = np.asarray(data_support)
        data_query = np.asarray(data_query)

        # flipped sorted-unique support labels define the task-local ids
        unique_labels = np.unique(labels_support)[::-1]
        lut = np.zeros(int(unique_labels.max()) + 1, np.int64)
        lut[unique_labels] = np.arange(len(unique_labels))
        new_labels_support = lut[labels_support]
        new_labels_query = lut[labels_query]

        if self.args is not None and self.args.use_softmax_feature:
            data_support = data_support[:, unique_labels]
            data_query = data_query[:, unique_labels]
        else:
            new_labels_support = labels_support
            new_labels_query = labels_query

        return {
            "x_s": data_support,
            "y_s": new_labels_support,
            "x_q": data_query,
            "y_q": new_labels_query,
        }

    def generate_tasks(self):
        tasks = []
        for (ds, ls), (dq, lq) in zip(self.loader_support, self.loader_query):
            tasks.append(self._get_task(ds, dq, ls, lq))
        out = {}
        for key in ("x_s", "x_q"):
            out[key] = np.stack([t[key] for t in tasks], axis=0)
        for key in ("y_s", "y_q"):
            out[key] = np.stack([t[key] for t in tasks], axis=0)[..., None]
        return out
