"""LaplacianShot: Laplacian-regularized bound optimization (counterpart of
transductive_clip_tpu/methods/few_shot/laplacian_shot.py; reference:
src/methods/few_shot/laplacian_shot.py, ICML 2020).

The reference runs a per-task CPU loop with sklearn's KNN and scipy's
sparse affinities. Here the KNN graph is a dense top-(knn - 1) over a
batched pairwise distance product, the bound updates run over all tasks at
once, and the per-task early stop is a freeze mask, which reproduces the
reference's converge-then-hold accuracy trace with no host read inside the
loop.

The method reports its [N, iter] accuracy trace from its own ``run_task``
and declines the evaluator's deferred and fused pipelines, so that every
route runs the blocking ``run_task`` (the JAX class defines no ``_infer``,
and its pipelines raise there: ROADMAP.md, fault F5).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...ops.common import device_sync, l2_normalize, top_rows
from ...ops.distances import sq_euclidean
from ..base import FewShotMethod, _fetch, timing_logs
from .paddle import support_class_means


def knn_affinity(query, knn: int, dist_impl: str = "matmul"):
    """Dense binary KNN affinity W[i, j] = 1 iff j is one of the (knn - 1)
    nearest neighbours of i, self excluded (reference:
    laplacian_shot.py:88-98 builds the same graph with sklearn and
    scipy.sparse). Ties go to the lower index, as ``jax.lax.top_k`` breaks
    them (``top_rows`` sorts stably; ``torch.topk`` promises no order)."""
    n = query.shape[-2]
    d2 = sq_euclidean(query, query, impl=dist_impl)
    # exclude self with a masked where, NOT eye * inf (0 * inf = NaN would
    # poison every off-diagonal distance)
    eye = torch.eye(n, dtype=torch.bool, device=query.device)
    d2 = torch.where(eye, torch.inf, d2)
    _, idx = top_rows(-d2, knn - 1)                               # [..., n, knn-1]
    return torch.zeros_like(d2).scatter_(-1, idx, 1.0)            # [..., n, n]


def laplacian_shot_infer(support, query, y_s, y_q, lmd, n_iter: int,
                         knn: int, n_class: int, norm_type: str = "L2N",
                         dist_impl: str = "matmul"):
    """support/query: [N, s, d] / [N, n, d]; y_s / y_q: [N, s] / [N, n]
    int64 — tensors on the device to run on.

    Returns (acc_trace [N, n_iter], Y [N, n, K])."""
    if norm_type == "CL2N":
        # centred L2: subtract the support mean before normalizing (the
        # reference's CL2N branch needs a train mean it never passes; the
        # support mean, as in BD-CSPN)
        mean = support.mean(1, keepdim=True)
        support = l2_normalize(support - mean)
        query = l2_normalize(query - mean)
    elif norm_type == "L2N":
        support = l2_normalize(support)
        query = l2_normalize(query)

    prototypes = support_class_means(support, y_s, n_class)       # [N, K, d]
    unary = sq_euclidean(query, prototypes, impl=dist_impl)       # [N, n, K]
    W = knn_affinity(query, knn, dist_impl=dist_impl)             # [N, n, n]

    def energy(Y, pairwise):
        e = (Y * torch.log(torch.clamp_min(Y, 1e-20)) + unary * Y
             - lmd * pairwise * Y)
        return e.sum((1, 2))                                      # [N]

    n_task = query.shape[0]
    Y = torch.softmax(-unary, dim=-1)
    # the W @ Y product is carried between iterations: the energy test and
    # the next bound update need the same product, so each iteration runs
    # one [n, n] x [n, K] product
    WY = torch.bmm(W, Y)
    oldE = torch.full((n_task,), torch.inf, dtype=torch.float32,
                      device=query.device)
    done = torch.zeros((n_task,), dtype=torch.bool, device=query.device)
    accs = []
    for i in range(n_iter):
        Y_new = torch.softmax(-unary + lmd * WY, dim=-1)
        WY_new = torch.bmm(W, Y_new)
        E = energy(Y_new, WY_new)
        converged = (torch.abs(E - oldE) <= 1e-6 * torch.abs(oldE)) & (i > 1)
        # freeze the tasks that converged on an earlier iteration
        Y = torch.where(done[:, None, None], Y, Y_new)
        WY = torch.where(done[:, None, None], WY, WY_new)
        oldE = torch.where(done, oldE, E)
        done = done | converged
        # the sum times the count's reciprocal, as XLA computes jnp.mean
        accs.append((Y.argmax(-1) == y_q).float().sum(1)
                    * (1.0 / y_q.shape[1]))
    return torch.stack(accs, dim=1), Y                            # [N, iter]


class LAPLACIAN_SHOT(FewShotMethod):
    """Its own ``run_task``: the method reports a per-iteration accuracy
    trace (the reference's converge-then-hold curve) rather than one final
    accuracy, so the base class's direct accuracy does not apply."""

    def _declines_pipelines(self) -> bool:
        """Always: the accuracy trace needs this class's ``run_task``, so
        ``run_task_deferred`` and ``run_task_fused`` return None and the
        evaluator runs the blocking ``run_task`` on every route."""
        return True

    def run_task(self, task_dic, shot=None):
        task, y_q = self._prepare_task(task_dic)
        support, query, y_s = task["x_s"], task["x_q"], task["y_s"]
        y_q = torch.as_tensor(y_q, dtype=torch.int64, device=self.device)
        self._log(f" ==> Executing LAPLACIAN SHOT with lmd = {self.args.lmd}")
        n_task = query.shape[0]
        chunk = int(self.args.get("task_chunk", 0) or 0)
        if chunk <= 0 or n_task <= chunk or n_task % chunk != 0:
            chunk = n_task
        n_iter = int(self.args.iter)

        def infer(sl):
            return laplacian_shot_infer(
                support[sl], query[sl], y_s[sl], y_q[sl],
                float(self.args.lmd), n_iter=n_iter, knn=int(self.args.knn),
                n_class=int(self.args.num_classes_test),
                norm_type=str(self.args.norm_type),
                dist_impl=str(self.args.get("distance_impl", "matmul")),
            )

        t0 = time.perf_counter()
        parts = [infer(slice(c, c + chunk)) for c in range(0, n_task, chunk)]
        acc_trace = device_sync(torch.cat([a for a, _ in parts]))
        elapsed = time.perf_counter() - t0
        acc_trace, preds = _fetch(
            acc_trace, torch.cat([torch.argmax(Y, dim=-1) for _, Y in parts]))
        acc_trace, preds, elapsed = self._whole_batch(acc_trace, preds,
                                                      elapsed)
        n_task = acc_trace.shape[0]
        return {
            "acc": acc_trace,                                     # [N, iter]
            "preds": preds,
            "criterions": np.zeros((n_iter,), np.float32),
            **timing_logs(elapsed, n_task, n_iter),
        }
