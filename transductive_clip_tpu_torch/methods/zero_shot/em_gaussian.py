"""EM-Gaussian (identity covariance) zero-shot clustering (counterpart of
transductive_clip_tpu/methods/zero_shot/em_gaussian.py).

GMM-style EM with temperature-scaled euclidean log-likelihoods and the
class-proportion dual term (reference: src/methods/zero_shot/em_gaussian.py).
"""

from __future__ import annotations

import torch

from ...ops.common import EPS
from ...ops.distances import sq_euclidean
from ..base import TransductiveMethod, init_soft_assignments
from .soft_kmeans import assignment_change, weighted_centroids


def em_gaussian_infer(query, u0, T, lambd, n_iter: int, impl: str = "matmul"):
    """Returns (u [N, n, K], criterions [n_iter])."""
    n_task, n_query, n_class = u0.shape
    u, w = u0, weighted_centroids(u0, query)
    v = torch.zeros((n_task, n_class), dtype=torch.float32,
                    device=query.device)
    crits = []
    for _ in range(n_iter):
        w = weighted_centroids(u, query, w_prev=w)
        logits = -0.5 * sq_euclidean(query, w, impl=impl)
        u_new = torch.softmax(T * logits + lambd * v[:, None, :] / n_query,
                              dim=2)
        v = torch.log(u_new.mean(1) + EPS) + 1.0
        crits.append(assignment_change(u_new, u))
        u = u_new
    return u, torch.stack(crits)


class EM_GAUSSIAN(TransductiveMethod):
    acc_mode = "clustering"

    def __init__(self, model=None, device=None, log_file=None, args=None):
        super().__init__(model, device, log_file, args)
        # lambda = int(K / 5) * n_query (reference: em_gaussian.py:20)
        self.lambd = float(int(args.num_classes_test / 5) * args.n_query)

    def _infer(self, task):
        self._log(f" ==> Executing EM-GAUSSIAN with T = {self.args.T}")
        u0 = init_soft_assignments(task["x_q"], self.args,
                                   task.get("text_features"))
        return em_gaussian_infer(
            task["x_q"], u0, float(self.args.T), self.lambd,
            n_iter=int(self.args.iter),
            impl=str(self.args.get("distance_impl", "matmul")),
        )
