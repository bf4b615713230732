"""PADDLE: MDL-regularized prototype EM for few-shot transduction
(counterpart of transductive_clip_tpu/methods/few_shot/paddle.py;
reference: src/methods/few_shot/paddle.py, NeurIPS'22 "Towards practical
few-shot query sets"). The prototypes start from the support class means;
block updates of (u, v, w) with the tuned lambda. TIM starts its weights
from the same class means.
"""

from __future__ import annotations

import torch

from ...ops.common import EPS, get_one_hot
from ...ops.distances import sq_euclidean
from ..base import FewShotMethod, init_soft_assignments
from ..zero_shot.soft_kmeans import assignment_change


def support_class_means(support, y_s, n_class):
    """Per-class mean of support features [N, K, d]
    (reference: paddle.py:126-140)."""
    one_hot = get_one_hot(y_s, n_class)                           # [N, s, K]
    counts = one_hot.sum(1)[..., None]                            # [N, K, 1]
    sums = torch.einsum("tsk,tsd->tkd", one_hot, support)
    return sums / counts


def paddle_infer(support, query, y_s, u0, lambd, n_iter: int, n_class: int,
                 dist_impl: str = "matmul"):
    """support/query: [N, s, d] / [N, n, d]; y_s: [N, s] int64; u0:
    [N, n, K] — tensors on the device to run on.

    Returns (u [N, n, K], criterions [n_iter])."""
    n_task, n_query, _ = query.shape
    y_s_one_hot = get_one_hot(y_s, n_class)
    y_s_counts = y_s_one_hot.sum(1)                               # [N, K]
    supp_sums = torch.einsum("tsk,tsd->tkd", y_s_one_hot, support)
    w = supp_sums / y_s_counts[..., None]
    v = torch.zeros((n_task, n_class), dtype=torch.float32,
                    device=query.device)
    u, crits = u0, []
    for _ in range(n_iter):
        logits = -0.5 * sq_euclidean(query, w, impl=dist_impl)
        u_new = torch.softmax(logits + lambd * v[:, None, :] / n_query,
                              dim=2)
        v = torch.log(u_new.mean(1) + EPS) + 1.0
        num = torch.einsum("tnk,tnd->tkd", u_new, query) + supp_sums
        den = u_new.sum(1) + y_s_counts
        w = num / den[..., None]
        crits.append(assignment_change(u_new, u))
        u = u_new
    return u, torch.stack(crits)


class PADDLE(FewShotMethod):
    def __init__(self, model=None, device=None, log_file=None, args=None):
        super().__init__(model, device, log_file, args)
        self.lambd = float(args.lambd)

    def _infer(self, task):
        self._log(f" ==> Executing PADDLE with LAMBDA = {self.lambd}")
        u0 = init_soft_assignments(task["x_q"], self.args,
                                   task.get("text_features"))
        return paddle_infer(
            task["x_s"], task["x_q"], task["y_s"], u0, self.lambd,
            n_iter=int(self.args.iter),
            n_class=int(self.args.num_classes_test),
            dist_impl=str(self.args.get("distance_impl", "matmul")),
        )
