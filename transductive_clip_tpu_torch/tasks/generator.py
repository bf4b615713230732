"""Zero-shot task generator: gather sampled feature rows and stack
``batch_size`` tasks into [n_task, n, d] arrays (the zero-shot half of
transductive_clip_tpu/tasks/generator.py; the few-shot generator comes with
the few-shot slice).
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
