"""Soft K-means zero-shot clustering (counterpart of
transductive_clip_tpu/methods/zero_shot/soft_kmeans.py).

Euclidean clustering with temperature-scaled soft assignments
(reference: src/methods/zero_shot/soft_kmeans.py:97-220). Distances use the
matmul expansion (``distance_impl: matmul``) unless ``direct`` is asked for.
"""

from __future__ import annotations

import torch

from ...ops.common import EPS
from ...ops.distances import sq_euclidean
from ..base import TransductiveMethod, init_soft_assignments


def weighted_centroids(u, x, w_prev=None, eps: float = EPS):
    """w_k = sum_n u_nk x_n / sum_n u_nk, keeping w_prev rows (or zeros) for
    empty clusters (reference: soft_kmeans.py:149-166)."""
    counts = u.sum(1)                                               # [N, K]
    num = torch.einsum("tnk,tnd->tkd", u, x)
    w = num / torch.clamp_min(counts, eps)[..., None]
    nonzero = (counts > eps)[..., None]
    if w_prev is None:
        return torch.where(nonzero, w, 0.0)
    return torch.where(nonzero, w, w_prev)


def assignment_change(u_new, u):
    """The criterion of the k-means family: the mean over tasks of
    ||u_new - u|| (Frobenius, per task)."""
    return torch.linalg.norm((u_new - u).reshape(u.shape[0], -1),
                             dim=-1).mean()


def soft_kmeans_infer(query, u0, T, n_iter: int, impl: str = "matmul"):
    """query, u0: [N, n, d] / [N, n, K] on the device to run on.

    Returns (u [N, n, K], criterions [n_iter])."""
    u, w = u0, weighted_centroids(u0, query)
    crits = []
    for _ in range(n_iter):
        w = weighted_centroids(u, query, w_prev=w)
        logits = -0.5 * sq_euclidean(query, w, impl=impl)
        u_new = torch.softmax(T * logits, dim=2)
        crits.append(assignment_change(u_new, u))
        u = u_new
    return u, torch.stack(crits)


class SOFT_KMEANS(TransductiveMethod):
    acc_mode = "clustering"

    def _infer(self, task):
        self._log(f" ==> Executing SOFT K-MEANS with T = {self.args.T}")
        u0 = init_soft_assignments(task["x_q"], self.args,
                                   task.get("text_features"))
        return soft_kmeans_infer(
            task["x_q"], u0, float(self.args.T), n_iter=int(self.args.iter),
            impl=str(self.args.get("distance_impl", "matmul")),
        )
