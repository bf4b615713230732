"""Hard K-means zero-shot clustering (counterpart of
transductive_clip_tpu/methods/zero_shot/hard_kmeans.py).

Nearest-centroid hard assignments; empty clusters are zeroed in the centroid
update (reference: src/methods/zero_shot/hard_kmeans.py:138-199; the
reference's softmax of the distances before the argmin preserves their
order and is dropped). Every empty cluster's centroid is the zero row, so a
query's distances to them tie: ``torch.argmin`` takes the first index, as
``jnp.argmin`` does.
"""

from __future__ import annotations

import torch

from ...ops.common import EPS, get_one_hot
from ...ops.distances import sq_euclidean
from ..base import TransductiveMethod, init_soft_assignments
from .soft_kmeans import assignment_change


def hard_kmeans_infer(query, u0, n_iter: int, impl: str = "matmul"):
    """Returns (u [N, n, K] one-hot, criterions [n_iter])."""
    n_class = u0.shape[-1]
    u, crits = u0, []
    for _ in range(n_iter):
        counts = u.sum(1)
        num = torch.einsum("tnk,tnd->tkd", u, query)
        w = num / torch.clamp_min(counts, EPS)[..., None]
        w = torch.where((counts > EPS)[..., None], w, 0.0)
        d2 = sq_euclidean(query, w, impl=impl)
        u_new = get_one_hot(torch.argmin(d2, dim=-1), n_class)
        crits.append(assignment_change(u_new, u))
        u = u_new
    return u, torch.stack(crits)


class HARD_KMEANS(TransductiveMethod):
    acc_mode = "clustering"

    def _infer(self, task):
        self._log(f" ==> Executing HARD K-MEANS with T = {self.args.T}")
        u0 = init_soft_assignments(task["x_q"], self.args,
                                   task.get("text_features"))
        return hard_kmeans_infer(
            task["x_q"], u0, n_iter=int(self.args.iter),
            impl=str(self.args.get("distance_impl", "matmul")),
        )
