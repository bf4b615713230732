"""EM-Gaussian with a per-class diagonal precision (counterpart of
transductive_clip_tpu/methods/zero_shot/em_gaussian_cov.py).

Adds a per-cluster diagonal precision ``s`` estimated in closed form each
iteration (reference: src/methods/zero_shot/em_gaussian_cov.py:98-257).

Two implementations of the precision-weighted distances
(``gaussian_cov_dist_impl``):

* ``direct`` (default) — the reference's (x - w)^2 form, evaluated in
  class chunks so that the [N, n, K, d] temporary never fully
  materializes. Numerically faithful: near-empty clusters drive s toward
  1/EPS, where the direct form multiplies the huge precision by an exactly
  zero squared deviation.
* ``matmul`` — the expansion
    sum_d s_kd (x_nd - w_kd)^2 = (x^2) @ s^T - 2 x @ (s*w)^T + sum_d s*w^2
  (and the same for the weighted second moment). Faster, but the three
  terms are each ~s in magnitude and cancel: with degenerate clusters
  (s ~ 1/EPS) the cancellation is catastrophic and assignments can flip.
"""

from __future__ import annotations

import torch

from ...ops.common import EPS
from ..base import TransductiveMethod, init_soft_assignments
from .soft_kmeans import assignment_change, weighted_centroids

_CHUNK = 128
# bound on the [N, n, c, d] fp32 temporary the 'direct' path materializes
# per class chunk; the chunk width shrinks with the batch so that peak
# memory stays flat whatever the task batch (at the ImageNet protocol with
# 100-task batches: c = 35 -> ~1 GB)
_CHUNK_BYTES = 1 << 30


def _chunk_width(n_task, n_query, d):
    c = _CHUNK_BYTES // max(1, 4 * n_task * n_query * d)
    return int(min(_CHUNK, max(8, c)))


def _weighted_sq_dev(u, query, query_sq, w):
    """d_q[t, k, d] = sum_n u[t,n,k] * (w[t,k,d] - x[t,n,d])^2 (products)."""
    counts = u.sum(1)                                             # [N, K]
    ux = torch.einsum("tnk,tnd->tkd", u, query)
    ux2 = torch.einsum("tnk,tnd->tkd", u, query_sq)
    return ux2 - 2.0 * w * ux + counts[..., None] * w * w


def _weighted_sq_dev_direct(u, query, w):
    """The reference-shaped (x - w)^2 form, chunked over classes
    (reference: em_gaussian_cov.py:172-181)."""
    outs = []
    chunk = _chunk_width(*query.shape)
    for c0 in range(0, w.shape[1], chunk):
        wc = w[:, c0:c0 + chunk]                                  # [N, c, d]
        diff = wc[:, None, :, :] - query[:, :, None, :]           # [N, n, c, d]
        outs.append(torch.einsum("tnk,tnkd->tkd", u[:, :, c0:c0 + chunk],
                                 diff * diff))
    return torch.cat(outs, dim=1)


def _precision_logits(query, query_sq, w, s):
    """-1/2 sum_d s_kd (x_nd - w_kd)^2 as products -> [N, n, K]."""
    xs = torch.einsum("tnd,tkd->tnk", query_sq, s)
    xsw = torch.einsum("tnd,tkd->tnk", query, s * w)
    sw2 = (s * w * w).sum(-1)[:, None, :]
    return -0.5 * (xs - 2.0 * xsw + sw2)


def _precision_logits_direct(query, w, s):
    """The reference-shaped -1/2 sum_d s_kd (x_nd - w_kd)^2, chunked over
    classes (reference: em_gaussian_cov.py:106-115)."""
    outs = []
    chunk = _chunk_width(*query.shape)
    for c0 in range(0, w.shape[1], chunk):
        wc = w[:, c0:c0 + chunk]
        sc = s[:, c0:c0 + chunk]
        diff = query[:, :, None, :] - wc[:, None, :, :]           # [N, n, c, d]
        outs.append((diff * diff * sc[:, None, :, :]).sum(-1))
    return -0.5 * torch.cat(outs, dim=2)


def em_gaussian_cov_infer(query, u0, lambd, n_iter: int,
                          dist_impl: str = "direct"):
    """Returns (u [N, n, K], criterions [n_iter])."""
    n_task, n_query, n_class = u0.shape
    query_sq = query * query
    direct = dist_impl == "direct"

    def sq_dev(u, w):
        if direct:
            return _weighted_sq_dev_direct(u, query, w)
        return _weighted_sq_dev(u, query, query_sq, w)

    u, w = u0, weighted_centroids(u0, query)
    s = u0.sum(1)[..., None] / torch.clamp_min(sq_dev(u0, w), EPS)
    v = torch.zeros((n_task, n_class), dtype=torch.float32,
                    device=query.device)
    crits = []
    for _ in range(n_iter):
        w = weighted_centroids(u, query, w_prev=w)
        # the precision update, keeping the previous values for empty
        # clusters
        counts = u.sum(1)
        s_new = counts[..., None] / torch.clamp_min(sq_dev(u, w), EPS)
        s = torch.where((counts > EPS)[..., None], s_new, s)
        # the assignments, with the log-determinant term
        if direct:
            logits = _precision_logits_direct(query, w, s)
        else:
            logits = _precision_logits(query, query_sq, w, s)
        det = 0.5 * torch.log(s + EPS).sum(-1)[:, None, :]
        u_new = torch.softmax(logits + det + lambd * v[:, None, :] / n_query,
                              dim=2)
        v = torch.log(u_new.mean(1) + EPS) + 1.0
        crits.append(assignment_change(u_new, u))
        u = u_new
    return u, torch.stack(crits)


class EM_GAUSSIAN_COV(TransductiveMethod):
    acc_mode = "clustering"

    def __init__(self, model=None, device=None, log_file=None, args=None):
        super().__init__(model, device, log_file, args)
        self.lambd = float(int(args.num_classes_test / 5) * args.n_query)

    def _infer(self, task):
        self._log(f" ==> Executing EM-GAUSSIAN-COV with T = {self.args.T}")
        u0 = init_soft_assignments(task["x_q"], self.args,
                                   task.get("text_features"))
        return em_gaussian_cov_infer(
            task["x_q"], u0, self.lambd, n_iter=int(self.args.iter),
            dist_impl=str(self.args.get("gaussian_cov_dist_impl", "direct")),
        )
