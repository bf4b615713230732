"""Hard KL K-means: k-means under the KL divergence on the probability
simplex (counterpart of transductive_clip_tpu/methods/zero_shot/kl_kmeans.py;
reference: src/methods/zero_shot/kl_kmeans.py:115-189, from the sBeta
paper). Centroids are means of the assigned probability vectors; the
assignment minimizes KL(x || w), one batched product against the log
centroids.
"""

from __future__ import annotations

import torch

from ...ops.common import get_one_hot
from ...ops.distances import kl_divergence_to_centroids
from ..base import TransductiveMethod, init_soft_assignments
from .soft_kmeans import assignment_change


def kl_kmeans_infer(query, u0, n_iter: int):
    """Returns (u [N, n, K] one-hot, criterions [n_iter])."""
    n_class = u0.shape[-1]
    u, crits = u0, []
    for _ in range(n_iter):
        counts = u.sum(1)                                        # [N, K]
        num = torch.einsum("tnk,tnd->tkd", u, query)
        # the reference clamps the denominator at 1 (kl_kmeans.py:169-171)
        w = num / torch.clamp_min(counts, 1.0)[..., None]
        w = torch.where((counts > 0)[..., None], w, 0.0)
        divs = kl_divergence_to_centroids(query, w)
        u_new = get_one_hot(torch.argmin(divs, dim=-1), n_class)
        crits.append(assignment_change(u_new, u))
        u = u_new
    return u, torch.stack(crits)


class KL_KMEANS(TransductiveMethod):
    acc_mode = "clustering"

    def _infer(self, task):
        self._log(f" ==> Executing KL K-MEANS with T = {self.args.T}")
        u0 = init_soft_assignments(task["x_q"], self.args,
                                   task.get("text_features"))
        return kl_kmeans_infer(task["x_q"], u0, n_iter=int(self.args.iter))
