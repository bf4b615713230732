"""Plain EM-Dirichlet, zero-shot and few-shot: the reference that the task
cells hold the program's predictions against.

Written from the paper's algorithm (Martin et al., "Transductive Zero-Shot
and Few-Shot CLIP", CVPR 2024, and its published code,
src/methods/{zero_shot,few_shot}/em_dirichlet.py), in plain torch, with no
kernel, no cluster or task compaction and no solver shortcut: every
iteration solves the Dirichlet parameters of every cluster with mass, by
Minka's Newton iteration on the row sum run to a fixed number of steps
(``newton_steps``). Each task stops on its own at a relative change of its
parameters under ``tol``, as the published code's early stop reads it per
task. It imports nothing of the program.

The step count is part of the answer: a cluster that holds one query has
no finite maximum-likelihood Dirichlet (its row sum grows at every step),
and how far its solve goes sets how strongly it draws the queries near
it. The configurations give the count of the solver they name (the
Newton-Minka solve's cap of 30 steps, which a batch with such a cluster
always reaches).

Shapes: ``x`` [N, n, K] softmax query features (a task a row), the cluster
axis is the class axis (K clusters), ``alpha`` [N, K, K].

``solve`` is the entry that the task cells' check calls by the reference's
name (``"reference"`` in the configuration file), with the configuration's
``reference_options``. ``quant`` (None for the reference) rounds both
operands of every product, which makes the lower-precision control.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-15
EMPTY_FILL = -10.0
EULER_GAMMA = 0.5772156649015329


def inv_digamma(y, iters=6):
    """x > 0 with digamma(x) = y, by Newton from Minka's start."""
    x = torch.where(y >= -2.22, torch.exp(y) + 0.5, -1.0 / (y + EULER_GAMMA))
    for _ in range(iters):
        x = x - (torch.digamma(x) - y) / torch.polygamma(1, x)
        x = torch.clamp_min(x, 1e-10)
    return x


def solve_alpha(alpha0, y, steps=12):
    """The Dirichlet parameters a [.., K] of each row with
    digamma(a_d) - digamma(sum a) = y_d: Newton on s = sum a of
    F(s) = sum_d inv_digamma(digamma(s) + y_d) - s, from alpha0's sums; a
    plain fixed-point step where Newton's would leave s > 0."""
    s = alpha0.sum(-1)
    for _ in range(steps):
        a = inv_digamma(torch.digamma(s)[..., None] + y)
        a_sum = a.sum(-1)
        fprime = torch.polygamma(1, s) * (1.0 / torch.polygamma(1, a)).sum(-1) - 1.0
        s_new = s - (a_sum - s) / fprime
        ok = torch.isfinite(s_new) & (s_new > 0) & (fprime.abs() > 1e-12)
        s = torch.where(ok, s_new, a_sum)
    return inv_digamma(torch.digamma(s)[..., None] + y)


def tf32(x):
    """x with its float32 mantissa rounded to TF32's 10 bits (to nearest,
    ties away from zero): what a TF32 product reads of its operands."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


# the control: the nearest precision below the configuration's fp32
CONTROL = tf32


def product(eq, a, b, quant=None):
    if quant is not None:
        a, b = quant(a), quant(b)
    return torch.einsum(eq, a, b)


def log_density(log_x, alpha, quant=None):
    """Dirichlet log-density of every query under every cluster [N, n, K]."""
    l12 = torch.lgamma(alpha.sum(-1)) - torch.lgamma(alpha).sum(-1)
    return l12[:, None, :] + product("tnd,tkd->tnk", log_x, alpha - 1.0,
                                     quant)


def assignments(logits, u_in, lambd, hard):
    """u from the cluster logits and the class-proportion term of the
    incoming u."""
    n = u_in.shape[1]
    v = torch.log(u_in.mean(1) + EPS) + 1.0
    u = torch.softmax(logits + lambd * v[:, None, :] / n, dim=-1)
    if hard:
        u = torch.nn.functional.one_hot(u.argmax(-1), u.shape[-1]).to(u.dtype)
    return u


def em_dirichlet(x, lambd, n_iter=20, hard=False, tol=1e-6, support=None,
                 support_labels=None, quant=None, newton_steps=12):
    """(cluster assignments u [N, n, K] after the EM loop, the iterations
    each task ran [N]).

    Zero-shot (``support`` None): clusters start from u = x and a cluster
    with no mass keeps its parameters. Few-shot: ``support`` [N, s, K] with
    ``support_labels`` [N, s] adds each cluster's support rows to its
    statistics."""
    n_task, n, k = x.shape
    log_x = torch.log(x + EPS)
    u = x.clone()
    alpha = torch.ones((n_task, k, k), dtype=x.dtype, device=x.device)
    if support is not None:
        one_hot = torch.nn.functional.one_hot(support_labels, k).to(x.dtype)
        supp_stat = product("tsk,tsd->tkd", one_hot,
                            torch.log(support + EPS), quant)
        supp_mass = one_hot.sum(1)
    active = torch.ones(n_task, dtype=torch.bool, device=x.device)
    iters = torch.zeros(n_task, dtype=torch.int64, device=x.device)
    for _ in range(n_iter):
        mass = u.sum(1)
        stat = product("tnk,tnd->tkd", u, log_x, quant)
        if support is not None:
            stat, mass = stat + supp_stat, mass + supp_mass
        nonzero = (mass > EPS)[..., None]
        y = torch.where(nonzero, stat / torch.clamp_min(mass, EPS)[..., None],
                        EMPTY_FILL)
        new = torch.where(nonzero, solve_alpha(alpha, y, newton_steps),
                          alpha)
        u_new = assignments(log_density(log_x, new, quant), u, lambd, hard)
        rel = (torch.linalg.vector_norm(new - alpha, dim=(1, 2))
               / torch.linalg.vector_norm(alpha, dim=(1, 2)))
        keep = active[:, None, None]
        alpha = torch.where(keep, new, alpha)
        u = torch.where(keep, u_new, u)
        iters += active
        active = active & (rel >= tol)
        if not bool(active.any()):
            break
    return u, iters


def lambda_(n_class, n_query, k):
    """The class-proportion weight of the published code: int(K / k) *
    n_query, with k = 5 zero-shot and k = k_eff few-shot
    (src/methods/{zero_shot,few_shot}/em_dirichlet.py:14)."""
    return float(int(n_class / k) * n_query)


def solve(x, protocol, options, support=None, support_labels=None,
          quant=None):
    """The predictions [N, n] of tasks ``x`` [N, n, K] in the dataset's
    class ids (zero-shot: clusters matched to classes) and the EM
    iterations each task ran [N]. ``protocol``: n_class, n_query, k_eff;
    ``options``: hard, iterations, tol."""
    few = support is not None
    k = int(protocol["k_eff"]) if few else 5
    u, iters = em_dirichlet(
        x, lambda_(int(protocol["n_class"]), int(protocol["n_query"]), k),
        n_iter=int(options["iterations"]), hard=bool(options["hard"]),
        tol=float(options["tol"]), support=support,
        support_labels=support_labels, quant=quant,
        newton_steps=int(options["newton_steps"]))
    preds = (u.argmax(-1).cpu().numpy() if few
             else matched_predictions(u, x))
    return preds, iters.cpu().numpy()


def matched_predictions(u, x):
    """Cluster -> class matching of the paper's zero-shot accuracy: each
    cluster present in the predictions is renamed to a distinct class by
    the assignment that maximises the summed class probabilities of the
    clusters' mean query features (Hungarian, scipy). Returns [N, n]."""
    from scipy.optimize import linear_sum_assignment

    preds = u.argmax(-1).cpu().numpy()
    feats = x.double().cpu().numpy()
    out = np.zeros_like(preds)
    for t in range(preds.shape[0]):
        clusters, first = np.unique(preds[t], return_index=True)
        clusters = clusters[np.argsort(first)]
        protos = np.stack([feats[t][preds[t] == c].mean(0) for c in clusters])
        _, cols = linear_sum_assignment(-protos)
        lut = dict(zip(clusters.tolist(), cols.tolist()))
        out[t] = [lut[c] for c in preds[t]]
    return out
