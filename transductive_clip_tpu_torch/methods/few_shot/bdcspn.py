"""BD-CSPN: one-shot prototype rectification + cosine nearest-prototype
prediction (counterpart of transductive_clip_tpu/methods/few_shot/bdcspn.py;
reference: src/methods/few_shot/bdcspn.py, ECCV 2020). The reference loops
over tasks (bdcspn.py:122-139); here the rectification is batched over the
task axis.
"""

from __future__ import annotations

import torch

from ...ops.common import l2_normalize
from ...ops.distances import sq_euclidean
from ..base import FewShotMethod
from .paddle import support_class_means


def _cosine_logits(w, samples, dist_impl: str = "matmul"):
    """-1/2 || w_hat - x_hat ||^2 (reference: bdcspn.py:42-57)."""
    return -0.5 * sq_euclidean(l2_normalize(samples), l2_normalize(w),
                               impl=dist_impl)


def bdcspn_infer(support, query, y_s, temp, n_class: int,
                 norm_type: str = "L2N", dist_impl: str = "matmul"):
    """Returns u_q [N, n, K]."""
    # normalization with train_mean = the support mean
    # (reference: bdcspn.py:161-163)
    train_mean = support.mean(1, keepdim=True)
    if norm_type == "CL2N":
        support = l2_normalize(support - train_mean)
        query = l2_normalize(query - train_mean)
    elif norm_type == "L2N":
        support = l2_normalize(support)
        query = l2_normalize(query)

    init_prototypes = support_class_means(support, y_s, n_class)

    # shift the query towards the support distribution, per task
    eta = support.mean(1, keepdim=True) - query.mean(1, keepdim=True)
    query_aug = torch.cat([support, query + eta], dim=1)         # [N, s+n, d]

    cos_sim = _cosine_logits(init_prototypes, query_aug, dist_impl)
    u = torch.softmax(temp * cos_sim, dim=-1)                    # [N, s+n, K]

    qa_hat = l2_normalize(query_aug)
    counts = u.sum(1)[..., None]                                 # [N, K, 1]
    prototypes = torch.einsum("tnk,tnd->tkd", u, qa_hat) / counts

    logits_q = _cosine_logits(prototypes, query, dist_impl)
    return torch.softmax(temp * logits_q, dim=-1)


class BDCSPN(FewShotMethod):
    def _infer(self, task):
        self._log(" ==> Executing BD-CSPN")
        u = bdcspn_infer(
            task["x_s"], task["x_q"], task["y_s"], float(self.args.temp),
            n_class=int(self.args.num_classes_test),
            norm_type=str(self.args.norm_type),
            dist_impl=str(self.args.get("distance_impl", "matmul")),
        )
        return u, torch.zeros((1,), dtype=torch.float32, device=u.device)
