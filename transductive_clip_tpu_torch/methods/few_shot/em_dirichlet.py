"""Few-shot EM-Dirichlet, soft and hard (counterpart of
transductive_clip_tpu/methods/few_shot/em_dirichlet.py; reference:
src/methods/few_shot/em_dirichlet.py and hard_em_dirichlet.py).

The zero-shot method's Dirichlet EM, with the support one-hot labels adding
fixed statistics to the alpha update and a direct argmax accuracy. lambda =
int(K / k_eff) * n_query (reference: few_shot/em_dirichlet.py:14). The JAX
package's machinery is kept:

* **cluster compaction** — from iteration 2 on only the top C = n_query + 16
  rows by query mass run the solver; every zero-query-mass row takes
  ``alpha_base``, the pure-support fixed point solved once full width right
  after iteration 1 (warm-started from its alpha, like the reference's
  iteration-2 re-solve of every row). Iteration 2 is the transition step
  that moves every drained row there; a row that later leaves the selected
  set moves there the step it leaves. At shots = 1 the single-sample
  Dirichlet MLE diverges, so the reference's drained rows creep by one
  capped solve per iteration; ``alpha_base`` applies exactly one solve's
  worth of that creep (predictions unaffected; the criterion trace then
  leaves out the repeated creep). ``compact_clusters: False`` is the exact
  path;
* the **two-tier solve** — when every task's populated count fits in
  ``_COMPACT_FAST`` = 32 rows only those are solved (zero-mass rows are
  frozen in the solver and substituted either way, so the result is the
  same);
* **early stop** on the batch-max relative alpha change.

The JAX ``lax.cond``s and ``while_loop`` become host decisions: after every
EM iteration one counted transfer (``ops.common.to_host``) reads the
batch-max relative change (the stop test) with the per-task populated count
of the new u (the fast-tier gate, the 'rank' guard and the sparsity
warning). The solver is resolved once at the compact width
(``resolve_solver_for_width``), so ``pallas`` runs K1 there and, like the JAX
package, the Newton-Minka solve at full width; ``mm_pallas`` runs K2 at
every width.

Under a task group (``group``, parallel/) the stop test's max, the
populated count, the solvers' criteria and the criterion trace are the
whole batch's, gathered over its ranks before they are read, as in the
zero-shot method. Under class-axis tensor parallelism (``tp`` > 1) it takes
the zero-shot method's layout: rank t holds the cluster rows
[t K/tp, (t+1) K/tp) of alpha, alpha_base, the support statistics and u;
the support statistics enter y for the local rows only; the compact
selection is the batch's, made on the gathered masses, and each rank
solves the selected populated rows it owns (a rank's other rows sit at
alpha_base, so the padding of its buffer takes alpha_base, as the
zero-mass rows do).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.profiling import count, span
from ...ops.common import EPS, get_one_hot, select_rows_covering, to_host
from ...parallel.task_parallel import batch_rows, class_shard, task_share
from ...ops.dirichlet import (
    dirichlet_logits_cache,
    resolve_solver_for_width,
    update_alpha,
    update_logits_cache_rows,
)
from ..base import FewShotMethod, PendingCompactionCheck, compact_select_impl
from ..zero_shot.em_dirichlet import (
    compaction_geometry,
    finish_assignments,
    owned_rows,
    rel_per_task,
)

_COMPACT_MARGIN = 16
# fast-tier row count for the two-tier compact solve, gated exactly on the
# populated count
_COMPACT_FAST = 32


def _rows(idx, k):
    """Row indices [N, C] expanded for a gather/scatter over [N, K, k]."""
    return idx[..., None].expand(-1, -1, k)


def em_dirichlet_fs_infer(support, query, y_s, lambd, n_iter: int,
                          iter_mm: int, n_class: int, hard: bool,
                          solver: str = "mm", early_stop: bool = True,
                          early_stop_tol: float = 1e-6, compact: bool = True,
                          return_n_iter: bool = False, select: str = "topk",
                          group=None):
    """support/query: [N, s, K] / [N, n, K] softmax features; y_s: [N, s]
    int64 — tensors on the device to run on.

    Returns (u [N, n, K], criterions [n_iter]); with ``return_n_iter`` also
    the executed iteration count and the max populated-cluster count any
    compact iteration consumed (host ints), the former also counted in
    ``em.iterations`` (core.profiling), each iteration a span ``em.step``.
    ``early_stop_tol`` is compared in fp32, as the JAX package compares
    it. ``group``: the tasks are this rank's equal share of the group's
    batch, whose decisions and criterion trace these are. Under
    ``group.tp`` > 1 this rank holds 1/tp of the cluster rows (module
    docstring), and u comes back whole.
    """
    n_task, n_query, _ = query.shape
    device = query.device
    share = task_share(group, n_task, device)
    n_all = n_task if share is None else share.size
    cs = class_shard(group, n_class)
    n_rows = cs.width
    tol = np.float32(early_stop_tol)
    log_s = torch.log(support + EPS)
    log_q = torch.log(query + EPS)
    # this rank's clusters' one-hot columns (labels elsewhere: none)
    y_s_one_hot = get_one_hot(y_s - cs.lo, n_rows)                   # [N, s, K]
    y_s_sum = y_s_one_hot.sum(1)                                  # [N, K]
    # support statistics are constant across iterations
    supp_stat = torch.einsum("tsk,tsd->tkd", y_s_one_hot, log_s)

    alpha0 = torch.ones((n_task, n_rows, n_class), dtype=torch.float32,
                        device=device)
    n_compact, engaged = compaction_geometry(n_query, n_class)
    use_compact = compact and engaged
    n_fast = min(_COMPACT_FAST, n_compact)
    # one solver family for both tiers, resolved at the whole widths
    solver_c = resolve_solver_for_width(solver, n_compact)
    solver = resolve_solver_for_width(solver, n_class)

    def finish_step(u, l12, l3):
        # v (class-proportion dual) is a pure function of the incoming u
        v = torch.log(u.mean(1) + EPS) + 1.0
        return finish_assignments(
            l12[:, None, :] + l3 + lambd * v[:, None, :] / n_query, hard, cs)

    def step_full(u, alpha_old):
        query_stat = torch.einsum("tnk,tnd->tkd", u, log_q)
        y_cst = (supp_stat + query_stat) / (y_s_sum + u.sum(1))[..., None]
        alpha = update_alpha(alpha_old, y_cst, iter_mm=iter_mm, solver=solver,
                             share=share, cs=cs)
        l12, l3 = dirichlet_logits_cache(log_q, alpha)
        return finish_step(u, l12, l3), alpha, l12, l3

    def compact_rows(u, alpha_old, alpha_base, pop, share_max):
        """Select the top-C rows by query mass, solve the populated ones,
        and substitute the pure-support fixed point for zero-mass rows.
        ``pop`` is the host batch max of u's populated count (the gate of
        the fast tier and of the 'rank' selection); ``share_max`` the
        largest count of it on one class rank (the buffer's width under
        tp > 1, where the fast tier is off).

        Returns (idx, alpha_c, alpha_c_old): the selected rows, their new
        and their previous values."""
        mass, idx = select_rows_covering(
            cs.gather(u.sum(1)), n_compact, 0.0, select, populated_max=pop)
        tier = n_fast < n_compact and pop <= n_fast
        if cs.tp > 1:
            idx, mass = owned_rows(
                idx, mass, cs, max(1, min(n_compact, n_rows, share_max)), 0.0)
            tier = False
        u_c = torch.gather(u, 2, idx[:, None, :].expand(-1, n_query, -1))
        query_stat_c = torch.einsum("tnc,tnd->tcd", u_c, log_q)
        supp_c = torch.gather(supp_stat, 1, _rows(idx, n_class))
        y_s_sum_c = torch.gather(y_s_sum, 1, idx)
        y_c = (supp_c + query_stat_c) / (y_s_sum_c + mass)[..., None]
        alpha_c_old = torch.gather(alpha_old, 1, _rows(idx, n_class))
        row_mask = mass > 0                                       # [N, C]

        def solve(a_old, y, m):
            return update_alpha(a_old, y, iter_mm=iter_mm, solver=solver_c,
                                row_mask=m, share=share, cs=cs)

        if tier:
            a = solve(alpha_c_old[:, :n_fast], y_c[:, :n_fast],
                      row_mask[:, :n_fast])
            alpha_c = torch.cat([a, alpha_c_old[:, n_fast:]], dim=1)
        else:
            alpha_c = solve(alpha_c_old, y_c, row_mask)
        # zero-query-mass rows: y_c reduced to the pure support statistics,
        # whose fixed point is alpha_base (the reference re-solves every row
        # each iteration, few_shot/em_dirichlet.py:195-201)
        base_c = torch.gather(alpha_base, 1, _rows(idx, n_class))
        return idx, torch.where(row_mask[..., None], alpha_c, base_c), alpha_c_old

    def step_compact(u, alpha, l12, l3, prev_idx, alpha_base, pop,
                     share_max):
        """A compact iteration; ``alpha`` is updated IN PLACE."""
        idx, alpha_c, alpha_c_old = compact_rows(u, alpha, alpha_base, pop,
                                                 share_max)
        # rows selected last iteration but not now take alpha_base (see the
        # JAX function for the over-capacity argument)
        base_prev = torch.gather(alpha_base, 1, _rows(prev_idx, n_class))
        a_prev = torch.gather(alpha, 1, _rows(prev_idx, n_class))
        notin = (prev_idx[..., None] != idx[:, None, :]).all(-1)  # [N, C]
        # transitions first, current rows second: rows in both take alpha_c
        alpha.scatter_(1, _rows(prev_idx, n_class), base_prev)
        alpha.scatter_(1, _rows(idx, n_class), alpha_c)
        # criterion ingredients from the changed rows only
        trans = torch.where(notin[..., None], base_prev - a_prev, 0.0)
        diff_ss = (((alpha_c - alpha_c_old) ** 2).sum((1, 2))
                   + (trans * trans).sum((1, 2)))
        # elementwise difference BEFORE the reduction: unchanged rows are
        # exact zeros, so the sum is the same for either solve tier
        delta_ss = ((alpha_c ** 2 - alpha_c_old ** 2).sum((1, 2))
                    + torch.where(notin[..., None],
                                  base_prev ** 2 - a_prev ** 2, 0.0).sum((1, 2)))
        diff_ss, delta_ss = cs.sum(torch.stack((diff_ss, delta_ss)))
        # one incremental cache update: transitioned rows take the base
        # values, selected rows their new alpha
        idx_all = torch.cat([prev_idx, idx], dim=1)
        alpha_all = torch.cat([base_prev, alpha_c], dim=1)
        mask_all = torch.cat([notin, torch.ones_like(notin)], dim=1)
        l12, l3 = update_logits_cache_rows(l12, l3, idx_all, alpha_all, log_q,
                                           row_mask=mask_all)
        return finish_step(u, l12, l3), alpha, l12, l3, idx, diff_ss, delta_ss

    def observe(rel, u):
        """The iteration's criterion (the batch's mean relative change) and
        its one host transfer: the batch-max relative change, the
        batch-max populated count of the new u and the largest share of it
        on one class rank. Under a group they are first gathered, in one
        collective (the counts ride as fp32, exact below 2^24)."""
        pops = cs.per_rank((u.sum(1) > 0).sum(-1).to(rel.dtype))
        both = batch_rows(torch.cat((rel[:, None], pops), 1), share)
        crit_max, pop, share_max = to_host(
            both[:, 0].max(), both[:, 1:].sum(1).max(), both[:, 1:].max())
        return (both[:, 0].sum() / n_all, crit_max, int(pop),
                int(share_max))

    # iteration 1 always solves all K rows (the dense initial u = query
    # gives every row query mass). Each EM iteration, its step and its
    # observe, is one span ``em.step`` (``newton`` and ``host_wait`` nest
    # inside it)
    with span("em.step"):
        u, alpha, l12, l3 = step_full(cs.cols(query), alpha0)
        rel = rel_per_task(alpha0, alpha, cs)
        crit, crit_max, pop, share_max = observe(rel, u)
    crits = crit.repeat(n_iter)
    steps = torch.arange(n_iter, device=device)
    pop_max = 0
    it = 1
    prev_idx = None

    if use_compact and n_iter > 1:
        # the pure-support fixed point: where the reference's re-solve sends
        # every zero-query-mass row; warm-started from iteration 1's alpha
        y_pure = supp_stat / torch.clamp_min(y_s_sum, EPS)[..., None]
        alpha_base = update_alpha(alpha, y_pure, iter_mm=iter_mm,
                                  solver=solver, share=share, cs=cs)
        if not early_stop or crit_max >= tol:
            # iteration 2, the transition step: every zero-mass row moves to
            # alpha_base — full-width bookkeeping, paid once
            with span("em.step"):
                idx, alpha_c, _ = compact_rows(u, alpha, alpha_base, pop,
                                               share_max)
                alpha2 = alpha_base.clone()
                alpha2.scatter_(1, _rows(idx, n_class), alpha_c)
                rel = rel_per_task(alpha, alpha2, cs)
                alpha = alpha2
                l12, l3 = dirichlet_logits_cache(log_q, alpha)
                u = finish_step(u, l12, l3)
                ss = cs.sum((alpha * alpha).sum((1, 2)))
                prev_idx = idx
                pop_max = pop
                it = 2
                crit, crit_max, pop, share_max = observe(rel, u)
                crits = torch.where(steps >= 1, crit, crits)

    while it < n_iter and (not early_stop or crit_max >= tol):
        with span("em.step"):
            if use_compact:
                u, alpha, l12, l3, prev_idx, diff_ss, delta_ss = step_compact(
                    u, alpha, l12, l3, prev_idx, alpha_base, pop, share_max)
                rel = torch.sqrt(diff_ss) / torch.sqrt(ss)
                ss = ss + delta_ss
                pop_max = max(pop_max, pop)
            else:
                alpha_old = alpha
                u, alpha, l12, l3 = step_full(u, alpha_old)
                rel = rel_per_task(alpha_old, alpha, cs)
            crit, crit_max, pop, share_max = observe(rel, u)
            crits = torch.where(steps >= it, crit, crits)
        it += 1
    u = cs.gather(u)
    count("em.iterations", it)
    if return_n_iter:
        return u, crits, it, pop_max
    return u, crits


class EM_DIRICHLET(FewShotMethod):
    hard = False
    reduces_over_group = True
    shards_classes = True

    def __init__(self, model=None, device=None, log_file=None, args=None):
        super().__init__(model, device, log_file, args)
        self.lambd = float(
            int(args.num_classes_test / args.k_eff) * args.n_query
        )
        self.n_iter = int(args.iter)
        self.iter_mm = int(args.iter_mm)
        solver = str(args.get("dirichlet_solver", "auto"))
        if solver == "auto":
            solver = "minka"
        self.solver = solver
        self.early_stop = bool(args.get("early_stop", True))
        self.early_stop_tol = float(args.get("early_stop_tol", 1e-6))
        self.compact = bool(args.get("compact_clusters", True))
        self.select = compact_select_impl(args)

    def _check_compaction(self, pop_max, n_query, n_class):
        n_compact, engaged = compaction_geometry(n_query, n_class)
        if self.compact and engaged:
            # pop_max covers every compact iteration, not just the final u
            self._pending_check = PendingCompactionCheck(
                populated=pop_max, n_compact=n_compact, logger=self.logger)

    def _infer(self, task):
        if not self.args.use_softmax_feature:
            raise ValueError(
                "EM-Dirichlet requires features on the unit simplex "
                "(softmax features)."
            )
        self._log(
            f" ==> Executing few-shot {'HARD ' if self.hard else ''}EM-DIRICHLET "
            f"with LAMBDA = {self.lambd}"
        )
        u, criterions, n_exec, pop_max = em_dirichlet_fs_infer(
            task["x_s"], task["x_q"], task["y_s"], self.lambd,
            n_iter=self.n_iter,
            iter_mm=self.iter_mm,
            n_class=int(self.args.num_classes_test),
            hard=self.hard,
            solver=self.solver,
            early_stop=self.early_stop,
            early_stop_tol=self.early_stop_tol,
            compact=self.compact,
            return_n_iter=True,
            select=self.select,
            group=self.group,
        )
        self._check_compaction(pop_max, task["x_q"].shape[1],
                               task["x_q"].shape[2])
        return u, criterions, n_exec
