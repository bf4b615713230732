"""EM-Dirichlet zero-shot clustering, soft and hard (counterpart of
transductive_clip_tpu/methods/zero_shot/em_dirichlet.py; reference:
src/methods/zero_shot/em_dirichlet.py:124-246 and
hard_em_dirichlet.py:124-271).

Clusters softmax features with per-class Dirichlet densities by block
coordinate updates: alpha by a fixed-point solver (ops/dirichlet.py), the
dual v = log class proportions, and soft or hard assignments u. The same
algorithm as the JAX package, with its compaction machinery:

* **cluster compaction** — from iteration 2 on (iteration 1 too with
  ``compact_first``) the alpha solve runs only on the top-C clusters by
  mass, C = n_query + 16; the other rows keep their alpha. The row scatter
  into the [N, K, K] state is IN PLACE (``scatter_``), so the 400 MB state
  at the ImageNet protocol is never copied;
* the **two-tier solve** — when every task's populated-cluster count fits
  in ``n_fast = 32`` rows, only those are solved; empty rows are frozen
  inside the solver, so the tier changes the cost, not the result;
* **early stop** at a batch-max relative alpha change of
  ``early_stop_tol``, and **task compaction** — once at most
  ``compact_tasks`` tasks are unconverged they continue alone in a narrow
  buffer (phase 2).

The JAX package runs all of this as one compiled ``lax.while_loop``. Here it
is Python control flow over torch ops, and each data-dependent decision is a
host transfer (``ops.common.to_host``). Per EM iteration there is exactly
one: the end-of-iteration read of the per-task relative change (the stop
test) together with the next iteration's per-task populated-cluster counts
(the fast-tier gate, the 'rank' selection guard and the sparsity warning).
The solvers add their own: none for the two kernels, one per Newton step for
'minka', one per 50 updates for 'mm'.

Under a task group (``group``, parallel/) each rank runs its share of the
batch, and every decision above reads the whole batch's values: the
per-task changes and populated counts are gathered over the group in task
order before the iteration's host read, the solvers' criteria are summed
over it, and task compaction picks the batch's stragglers, each rank
continuing those it holds. So each rank's u is its rows of the
single-process result.

Under class-axis tensor parallelism (a group with ``tp`` > 1) the tp ranks
of a dp slice hold the same tasks, and rank t holds the cluster rows
[t K/tp, (t+1) K/tp): alpha [N/dp, K/tp, K] and u's matching columns,
with x whole on every rank. The JAX package shards alpha's feature axis
and re-lays the rows only around the kernels (``_shard_map_rows``); the row
layout gives K1 and K2 the same per-rank input with no all-to-all, at the
same memory. The weighted log-means, every row solve and the log-density
terms of the local clusters are local; the u update's per-query max and
sum, the hard argmax (ties to the lowest global index), and every
per-task sum behind a criterion are reduced over the class group. Cluster
compaction stays cost-only: the batch's top-C selection is made on the
gathered cluster masses, as one process makes it, and each rank solves the
selected populated rows it owns, in a buffer as wide as the class group's
largest populated share (padded with frozen rows); the solver is resolved
at the whole compact width C. u comes back whole, its columns gathered.
"""

from __future__ import annotations

import math
import time
import warnings

import numpy as np
import torch

from ...ops.common import (
    EPS,
    device_sync,
    get_one_hot,
    select_rows_covering,
    to_host,
)
from ...ops.dirichlet import (
    clamped_cluster_means,
    dirichlet_logits_cache,
    resolve_solver_for_width,
    update_alpha,
    update_logits_cache_rows,
    weighted_log_means,
)
from ...parallel.task_parallel import (
    TaskShare,
    batch_rows,
    class_shard,
    group_max,
    task_share,
)
from ..base import (
    PendingCompactionCheck,
    TransductiveMethod,
    compact_select_impl,
    narrow_phase_widths,
)

# margin on top of n_query for the compacted cluster count
_COMPACT_MARGIN = 16
# fast-tier row count: once assignments concentrate, the solve runs on this
# many rows instead of n_query + margin — gated exactly on the populated
# count, so it is an execution-plan choice, not an approximation
_COMPACT_FAST = 32


def compaction_geometry(n_query: int, n_class: int):
    """(n_compact, engaged): the compacted row count and whether compaction
    applies at these shapes."""
    n_compact = min(n_class, n_query + _COMPACT_MARGIN)
    return n_compact, n_class > 2 * n_compact


def _populated(u):
    """Per-task count of clusters carrying query mass [N] (incoming u)."""
    return (u.sum(1) > EPS).sum(-1)


def finish_assignments(logits, hard, cs):
    """u from the cluster logits [N, n, K/tp], this rank's columns (``cs``,
    a parallel.ClassShard): the softmax over the clusters, one-hot at its
    argmax when ``hard``; the softmax's row max and sum and the argmax are
    the class group's."""
    u = cs.softmax(logits)
    return get_one_hot(cs.argmax(u) - cs.lo, cs.width) if hard else u


def owned_rows(idx, mass, cs, width, thresh):
    """A compact step's rows on this rank under ``cs``: of the batch's
    selection ``idx`` [N, C] (global rows, masses ``mass``), the rows it
    owns that are solved (mass > ``thresh``) in selection order, then its
    other rows in index order as padding, ``width`` distinct rows in all.
    Returns (local rows [N, width], their masses, 0 on the padding)."""
    n_sel = idx.shape[1]
    rows = torch.arange(cs.width, device=idx.device)
    local = idx - cs.lo
    solved = (mass > thresh) & (local >= 0) & (local < cs.width)
    hit = (local[..., None] == rows) & solved[..., None]        # [N, C, w]
    at = torch.arange(n_sel, device=idx.device)[:, None]
    pos = torch.where(hit, at, n_sel).amin(1)                   # [N, w]
    key = torch.where(pos < n_sel, pos, n_sel + rows)
    order = torch.argsort(key, dim=1, stable=True)[:, :width]
    key = key.gather(1, order)
    m = mass.gather(1, torch.clamp_max(key, n_sel - 1))
    return order, torch.where(key < n_sel, m, 0.0)


def _finish(u, logits_12, logits_3, lambd, n_query, hard, cs):
    # v (dual of the class proportions) is a pure function of the incoming
    # u, recomputed each iteration (reference: em_dirichlet.py:145-151)
    v = torch.log(u.mean(1) + EPS) + 1.0
    logits = logits_12[:, None, :] + logits_3
    return finish_assignments(logits + lambd * v[:, None, :] / n_query,
                              hard, cs)


def _em_step_full(u, alpha_old, log_query, lambd, n_query, n_class,
                  iter_mm, solver, hard, share=None, cs=None):
    """One full-width EM iteration (all K cluster rows solved); ``share``:
    these tasks' place in a batch spread over a task group; ``cs``: this
    rank's share of the cluster rows (all of them by default)."""
    cs = cs or class_shard(None, n_class)
    y_cst, nonzero = weighted_log_means(u, log_query, eps=EPS)
    alpha = update_alpha(alpha_old, y_cst, iter_mm=iter_mm,
                         solver=resolve_solver_for_width(solver, n_class),
                         share=share, cs=cs)
    # keep previous alpha rows for empty clusters (reference: :224-226)
    alpha = torch.where(nonzero, alpha, alpha_old)
    l12, l3 = dirichlet_logits_cache(log_query, alpha)
    u = _finish(u, l12, l3, lambd, n_query, hard, cs)
    return u, alpha, l12, l3


def _em_step_compact(u, alpha, l12, l3, log_query, lambd, n_query,
                     n_class, iter_mm, solver, hard, n_compact, pop_max,
                     n_fast=None, select="topk", share=None, cs=None,
                     width=None):
    """EM iteration solving alpha only for the top-``n_compact`` clusters.

    ``alpha`` [N, K, K] is updated IN PLACE at the solved rows. ``pop_max``
    is the host-side batch max of the incoming u's populated-cluster count:
    it gates the two-tier solve (only when every task's populated rows fit
    in ``n_fast`` are just the first ``n_fast`` rows solved) and the 'rank'
    selection's guard. The logits caches l12 [N, K] and l3 [N, n, K] are
    updated at the changed rows only. ``share``: these tasks' place in a
    batch spread over a task group (the solver's criterion is the batch's).
    ``cs``: this rank's share of the cluster rows (all of them by default);
    under tp > 1 the selection is made on the gathered masses and the rank
    solves its ``width`` rows of it (``owned_rows``), which cover the
    solved rows it owns, with no fast tier.
    """
    cs = cs or class_shard(None, n_class)
    n = u.shape[1]
    mass, idx = select_rows_covering(
        cs.gather(u.sum(1)), n_compact, EPS, select, populated_max=pop_max)
    if cs.tp > 1:
        idx, mass = owned_rows(idx, mass, cs, width, EPS)
        n_fast = None
    u_c = torch.gather(u, 2, idx[:, None, :].expand(-1, n, -1))   # [N, n, C]
    num_c = torch.einsum("tnc,tnd->tcd", u_c, log_query)
    y_c, nonzero_c = clamped_cluster_means(num_c, mass, eps=EPS)
    rows = idx[..., None].expand(-1, -1, n_class)                 # [N, C, K]
    alpha_c_old = torch.gather(alpha, 1, rows)
    row_mask = nonzero_c[..., 0]                                  # [N, C]
    # one solver family for both tiers (ops.dirichlet.resolve_solver_for_width)
    solver = resolve_solver_for_width(solver, n_compact)

    def solve(a_old, y, m):
        # empty rows are frozen at a_old inside the solver and excluded from
        # its convergence criterion, so the executed inner iteration count
        # depends only on the populated rows
        return update_alpha(a_old, y, iter_mm=iter_mm, solver=solver,
                            row_mask=m, share=share, cs=cs)

    if n_fast is not None and n_fast < n_compact and pop_max <= n_fast:
        a = solve(alpha_c_old[:, :n_fast], y_c[:, :n_fast],
                  row_mask[:, :n_fast])
        # the tail rows carry no mass (gate) -> frozen at old values
        alpha_c = torch.cat([a, alpha_c_old[:, n_fast:]], dim=1)
    else:
        alpha_c = solve(alpha_c_old, y_c, row_mask)
    alpha_c = torch.where(nonzero_c, alpha_c, alpha_c_old)
    alpha.scatter_(1, rows, alpha_c)            # in place on the [N, K, K] state

    # criterion ingredients from the compact rows only: alpha changed
    # nowhere else, so the full-tensor norms reduce to these + the carried
    # sum of squares
    diff_ss = ((alpha_c - alpha_c_old) ** 2).sum((1, 2))          # [N]
    # elementwise difference BEFORE the reduction: restored rows are exact
    # zeros, so the sum is the same for either solve tier
    delta_ss = (alpha_c ** 2 - alpha_c_old ** 2).sum((1, 2))
    diff_ss, delta_ss = cs.sum(torch.stack((diff_ss, delta_ss)))

    l12, l3 = update_logits_cache_rows(l12, l3, idx, alpha_c, log_query,
                                       row_mask=row_mask)
    u = _finish(u, l12, l3, lambd, n_query, hard, cs)
    return u, alpha, l12, l3, diff_ss, delta_ss


def rel_per_task(alpha_old, alpha, cs):
    """Per-task relative alpha change [N]. Its mean is the reference's
    recorded criterion; its max gates early stopping. The sums of squares
    are the class group's (``cs``)."""
    ss = cs.sum(torch.stack((((alpha_old - alpha) ** 2).sum((1, 2)),
                             (alpha_old ** 2).sum((1, 2)))))
    return torch.sqrt(ss[0]) / torch.sqrt(ss[1])


def _rel_from_ss(diff_ss, ss_before):
    """The same per-task relative change from compact-row sums of squares
    (ss_before is the carried ||alpha_old||^2)."""
    return torch.sqrt(diff_ss) / torch.sqrt(ss_before)


def em_dirichlet_infer(query, lambd, n_iter: int, iter_mm: int, hard: bool,
                       solver: str = "mm", compact: bool = True,
                       compact_first: bool = False,
                       early_stop: bool = True,
                       early_stop_tol: float = 1e-6,
                       select: str = "topk", compact_tasks: int = 8,
                       return_iter_split: bool = False, group=None):
    """Run EM-Dirichlet on a batch of tasks.

    query: [N, n, K] softmax features (a tensor on the device to run on).
    Returns (u [N, n, K], criterions [n_iter]) — the criterion trace keeps
    length ``n_iter``, padded with the last value under early stopping.
    ``return_iter_split`` adds the host array [executed iterations,
    full-batch (phase-1) iterations] and the max populated-cluster count
    any compact iteration consumed.

    ``early_stop_tol`` is compared in fp32, as the JAX package compares it.

    ``group`` (a parallel.TaskGroup): ``query`` is this dp slice's
    contiguous share of a batch of ``group.dp`` equal shares. Every
    decision reads the whole batch's values (module docstring), so u is
    this slice's rows of the single-process result; the criterion trace,
    the iteration split and the populated count are the whole batch's,
    equal on every rank. Under ``group.tp`` > 1 this rank holds 1/tp of the
    cluster rows, and u comes back whole.
    """
    n_task, n_query, n_class = query.shape
    device = query.device
    lo = 0 if group is None else group.d * n_task
    n_all = n_task if group is None else n_task * group.dp
    cs = class_shard(group, n_class)
    n_rows = cs.width
    tol = np.float32(early_stop_tol)
    log_query = torch.log(query + EPS)
    u = cs.cols(query)
    alpha = torch.ones((n_task, n_rows, n_class), dtype=torch.float32,
                       device=device)

    n_compact, engaged = compaction_geometry(n_query, n_class)
    use_compact = compact and engaged
    n_fast = min(_COMPACT_FAST, n_compact)

    def compact_step(u, alpha, l12, l3, lq, pop, share_max, step_select,
                     share):
        """``pop``: the batch's max populated count of u; ``share_max``:
        the largest count of it on one class rank (``pop`` at tp 1), the
        width the rank's compact buffer needs at most."""
        width = max(1, min(n_compact, n_rows, int(share_max)))
        return _em_step_compact(
            u, alpha, l12, l3, lq, lambd, n_query, n_class, iter_mm, solver,
            hard, n_compact, int(pop), n_fast=n_fast, select=step_select,
            share=share, cs=cs, width=width,
        )

    def populated(u):
        """u's per-task populated counts [N, tp]: a column for each class
        rank's clusters."""
        return cs.per_rank(_populated(u))

    def observe(rel, u, share):
        """The iteration's criterion (the mean relative change, over the
        whole batch: frozen tasks change by exactly 0) and its one host
        transfer: the per-task relative change (stop test, task
        compaction) and the next iteration's per-task populated counts
        (fast-tier gate), as needed. Under a group both are first gathered,
        in one collective, into the batch of the phase (``share``)."""
        parts = [rel[:, None]] + (
            [populated(u).to(rel.dtype)] if use_compact else [])
        both = batch_rows(torch.cat(parts, 1), share)
        crit = both[:, 0].sum() / n_all
        want = ([both[:, 0]] if early_stop else []) + (
            [both[:, 1:]] if use_compact else [])
        got = to_host(*want) if want else ()
        got = got if len(want) > 1 else (got,)
        return (crit, got[0] if early_stop else None,
                got[-1] if use_compact else None)

    share1 = task_share(group, n_task, device)
    ss = torch.full((n_task,), float(n_class) * n_class, dtype=torch.float32,
                    device=device)
    pop_max = 0
    if use_compact and compact_first:
        # iteration 1 compact too, via the analytic alpha = ones logits
        # cache (l3 = (a-1).log-x = 0, l12 = lgamma(K)). Its populated count
        # (= K, dense raw features) is excluded from the sparsity warning:
        # the first-batch guard validates it instead.
        l12 = torch.full((n_task, n_rows), math.lgamma(n_class),
                         dtype=torch.float32, device=device)
        l3 = torch.zeros((n_task, n_query, n_rows), dtype=torch.float32,
                         device=device)
        pops1 = populated(u)
        pop1, share1_max = to_host(group_max(torch.stack(
            (pops1.sum(1).max(), pops1.max())), group))
        u, alpha, l12, l3, diff_ss, delta_ss = compact_step(
            u, alpha, l12, l3, log_query, pop1, share1_max, "topk", share1)
        # ||ones||^2 = K*K exactly
        rel = _rel_from_ss(diff_ss, ss)
        ss = ss + delta_ss
    else:
        alpha_old = alpha
        u, alpha, l12, l3 = _em_step_full(
            u, alpha, log_query, lambd, n_query, n_class, iter_mm, solver,
            hard, share1, cs,
        )
        rel = rel_per_task(alpha_old, alpha, cs)
        if use_compact:
            # carried ||alpha||^2 for the compact criterion
            ss = cs.sum((alpha ** 2).sum((1, 2)))
    crit, rel_h, pops_h = observe(rel, u, share1)
    crits = crit.repeat(n_iter)
    steps = torch.arange(n_iter, device=device)

    # task compaction engages only with early stopping and when the narrow
    # buffer is narrower than the batch; compact_tasks=0 disables
    n_narrow = int(compact_tasks)
    use_tc = early_stop and 0 < n_narrow < n_all
    it = 1

    def run_phase(state, rel_h, pops_h, lq, busy, share):
        """EM iterations over whatever task batch ``lq`` belongs to (this
        rank's part of it: ``share``), while ``busy(rel_h)``."""
        nonlocal it, crits, pop_max
        u, alpha, l12, l3, ss = state
        while it < n_iter and busy(rel_h):
            if use_compact:
                pop = int(pops_h.sum(1).max())
                u, alpha, l12, l3, diff_ss, delta_ss = compact_step(
                    u, alpha, l12, l3, lq, pop, pops_h.max(), select, share)
                rel = _rel_from_ss(diff_ss, ss)
                ss = ss + delta_ss
                pop_max = max(pop_max, pop)
            else:
                alpha_old = alpha
                u, alpha, l12, l3 = _em_step_full(
                    u, alpha_old, lq, lambd, n_query, n_class, iter_mm,
                    solver, hard, share, cs,
                )
                rel = rel_per_task(alpha_old, alpha, cs)
            crit, rel_h, pops_h = observe(rel, u, share)
            crits = torch.where(steps >= it, crit, crits)
            it += 1
        return (u, alpha, l12, l3, ss), rel_h, pops_h

    def busy_phase1(rel_h):
        if not early_stop:
            return True
        if use_tc:
            # full width only while the stragglers outnumber the narrow
            # buffer; phase 2 picks up the rest
            return int((rel_h >= tol).sum()) > n_narrow
        return bool(rel_h.max() >= tol)

    state, rel_h, pops_h = run_phase((u, alpha, l12, l3, ss), rel_h, pops_h,
                                     log_query, busy_phase1, share1)
    u = state[0]
    # iterations executed at the full batch width (phase 1); the rest ran
    # at the narrow straggler width
    it_full = it

    if use_tc:
        # the n_narrow most-unconverged tasks of the batch (covering every
        # task with rel >= tol by the phase-1 exit condition), lower index
        # first on ties as jax.lax.top_k orders them; this rank continues
        # those it holds (maybe none) at their places in that order
        t_host = np.argsort(-rel_h, kind="stable")[:n_narrow]
        mine = np.flatnonzero((t_host >= lo) & (t_host < lo + n_task))
        t_idx = torch.as_tensor(t_host[mine] - lo, device=device)
        share2 = None if group is None else TaskShare(
            group, torch.as_tensor(mine, device=device), len(t_host))
        narrow = tuple(a.index_select(0, t_idx) for a in state)
        narrow, _, _ = run_phase(
            narrow, rel_h[t_host], None if pops_h is None else pops_h[t_host],
            log_query.index_select(0, t_idx),
            lambda r: bool(r.max() >= tol), share2)
        u = u.index_copy(0, t_idx, narrow[0])
    u = cs.gather(u)
    if return_iter_split:
        return u, crits, np.array([it, it_full]), pop_max
    return u, crits


class EM_DIRICHLET(TransductiveMethod):
    acc_mode = "clustering"
    hard = False
    reduces_over_group = True
    shards_classes = True

    def __init__(self, model=None, device=None, log_file=None, args=None):
        super().__init__(model, device, log_file, args)
        # lambda = int(K / 5) * n_query (reference: em_dirichlet.py:14)
        self.lambd = float(int(args.num_classes_test / 5) * args.n_query)
        self.n_iter = int(args.iter)
        self.iter_mm = int(args.iter_mm)
        # 'minka' (Newton-on-row-sum, default) / 'minka_fp' (plain fixed
        # point) / 'pallas' (the K1 kernel) / 'mm' (reference-exact
        # surrogate loop) / 'mm_pallas' (the K2 kernel); all solve the same
        # stationary equation
        solver = str(args.get("dirichlet_solver", "auto"))
        if solver == "auto":
            solver = "minka"
        self.solver = solver
        self.compact = bool(args.get("compact_clusters", True))
        # 'auto' (default): iteration-1 compaction ON, verified against the
        # exact first iteration on the first task batch (see _infer); True:
        # on unguarded; False: off.
        cf = args.get("compact_first_iter", "auto")
        if isinstance(cf, str):
            cf = cf.strip().lower()
            cf = {"true": True, "false": False}.get(cf, cf)
        if cf not in (True, False, "auto"):
            raise ValueError(
                f"compact_first_iter must be True, False, or 'auto'; "
                f"got {cf!r}"
            )
        self.compact_first = cf in (True, "auto")
        self._cf_guard_pending = cf == "auto"
        self._cf_guard_auto = cf == "auto"
        # periodic re-verification cadence (batches between guard re-runs;
        # <= 0 keeps the first-batch-only guard). The guard runs only inside
        # a blocking run_task: direct-API loops advance the batch counter
        # per call, and the deferred and fused evaluator pipelines route
        # every M-th batch through run_task after request_guard_check
        self._cf_recheck = int(args.get("compact_first_recheck", 64))
        self._cf_batches_since_check = 0
        self._cf_force_guard = False
        self.early_stop = bool(args.get("early_stop", True))
        self.early_stop_tol = float(args.get("early_stop_tol", 1e-6))
        # task compaction: True -> default width 8; False/0 -> batch-max
        ct = args.get("compact_tasks", True)
        if isinstance(ct, str):
            ct = {"true": True, "false": False}.get(ct.strip().lower(), ct)
        if ct is True:
            ct = 8
        self.compact_tasks = int(ct or 0)
        self.select = compact_select_impl(args)

    def guard_recheck_batches(self):
        """The ``compact_first_recheck`` cadence while the auto guard could
        still need re-running, else 0: the evaluator routes every M-th batch
        of the deferred and fused pipelines, which never host the guard,
        through the blocking ``run_task`` (eval/zero_shot.py)."""
        if self._cf_guard_auto and self.compact_first and self._cf_recheck > 0:
            return self._cf_recheck
        return 0

    def request_guard_check(self):
        """Force the next blocking ``_infer`` to run the exactness guard."""
        self._cf_force_guard = True

    def _timing_iter_widths(self, n_used, n_full, n_task):
        """Task compaction's cost model: the first ``n_full`` iterations at
        the full batch width, the rest at the ``compact_tasks`` width."""
        return narrow_phase_widths(
            n_used, n_full, n_task, int(self.args.get("task_chunk", 0) or 0),
            self.compact_tasks)

    def _check_compaction(self, pop_max, n_query, n_class):
        n_compact, engaged = compaction_geometry(n_query, n_class)
        if self.compact and engaged:
            # pop_max is the max populated count over every compact
            # iteration (not just the final u)
            self._pending_check = PendingCompactionCheck(
                pop_max, n_compact, logger=self.logger)

    def _run_infer(self, x_q, compact_first: bool):
        return em_dirichlet_infer(
            x_q,
            self.lambd,
            n_iter=self.n_iter,
            iter_mm=self.iter_mm,
            hard=self.hard,
            solver=self.solver,
            compact=self.compact,
            compact_first=compact_first,
            early_stop=self.early_stop,
            early_stop_tol=self.early_stop_tol,
            return_iter_split=True,
            select=self.select,
            compact_tasks=self.compact_tasks,
            group=self.group,
        )

    def _infer(self, task):
        if not self.args.use_softmax_feature:
            raise ValueError(
                "EM-Dirichlet requires features on the unit simplex "
                "(softmax features)."
            )
        self._log(
            f" ==> Executing {'HARD ' if self.hard else ''}EM-DIRICHLET "
            f"with LAMBDA = {self.lambd} and T = {self.args.T}"
        )
        n_query, n_class = task["x_q"].shape[1], task["x_q"].shape[2]
        cf_engaged = (self.compact_first and self.compact
                      and compaction_geometry(n_query, n_class)[1])
        out = self._run_infer(task["x_q"], self.compact_first)
        # the guard fires only inside a blocking run_task (the flag is set
        # there), so its duplicate solve is excluded from the timing
        guard_allowed = getattr(self, "_guard_allowed", False)
        guard_due = cf_engaged and self._cf_guard_auto and guard_allowed and (
            self._cf_guard_pending
            or self._cf_force_guard
            or (self._cf_recheck > 0
                and self._cf_batches_since_check >= self._cf_recheck)
        )
        if cf_engaged and not guard_due:
            self._cf_batches_since_check += 1
        if guard_due:
            # iteration-1 compaction is the one shortcut whose deviation is
            # undetectable post hoc, so the first batch — and every M-th
            # batch after it — is re-solved with the exact first iteration
            # and the predictions compared. The duplicate solve is
            # verification, not method cost.
            device_sync(out[0])          # fast solve fully accounted first
            t_guard = time.perf_counter()
            exact = self._run_infer(task["x_q"], False)
            # one verdict for the whole batch: every rank keeps or drops
            # the fast path together
            differ = (torch.argmax(out[0], dim=-1)
                      != torch.argmax(exact[0], dim=-1)).any()
            same = not bool(to_host(group_max(differ.to(torch.int32),
                                              self.group)))
            self._untimed_overhead_s = time.perf_counter() - t_guard
            first_check = self._cf_guard_pending
            self._cf_guard_pending = False
            self._cf_force_guard = False
            self._cf_batches_since_check = 0
            which = ("first-batch" if first_check
                     else f"periodic (every {self._cf_recheck} batches)")
            if same:
                self._log(
                    f"compact_first_iter: {which} predictions match the "
                    "exact first iteration; keeping the fast path"
                )
            else:
                msg = (
                    "compact_first_iter deviated from the exact first "
                    f"iteration on a {which} guard check (flat features?); "
                    "falling back to the exact path for this evaluation"
                )
                if self.logger is not None:
                    self.logger.warning(msg)
                else:
                    warnings.warn(msg)
                self.compact_first = False
                out = exact
        self._check_compaction(out[3], n_query, n_class)
        return out[:3]
