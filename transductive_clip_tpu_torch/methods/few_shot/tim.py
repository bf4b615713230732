"""TIM-GD and alpha-TIM: transductive information maximization by gradient
descent on class weights (counterpart of
transductive_clip_tpu/methods/few_shot/tim.py; reference:
src/methods/few_shot/tim.py; NeurIPS 2020 "TIM" and NeurIPS 2021 "Realistic
evaluation of transductive few-shot").

The Adam loop is a Python loop of torch steps. The loss gradient comes from
one of three places (``tim_grad_impl``):

* ``autodiff`` — ``torch.autograd`` through the loss (the default, as the
  JAX package resolves ``auto`` off the TPU);
* ``manual`` — the closed-form gradient over label-sorted support (needs the
  protocol's uniform per-class support);
* ``pallas`` — the support side from the K3 kernel (``ops/cuda_tim.py``,
  the name kept so configs work unchanged), the query side in closed form.

Adam is optax's ``adam`` written out on tensors (``_adam_step``), so the
port's trajectory follows the JAX package's to rounding; ``tim_opt_dtype:
bfloat16`` stores the moments in bf16 between steps. As in the reference,
the reported predictions come from the logits computed *before* the final
optimizer step (reference: tim.py:161-189).

``tim_matmul_precision`` reaches K3 only: 'default' feeds it bf16 operands
as the TPU kernel has them, 'highest' fp32. Every other contraction here is
fp32 with TF32 off, which is what 'default' means to the JAX package off the
TPU. ``auto`` resolves to 'highest' and ``tim_grad_impl: auto`` to
'autodiff', as the JAX package resolves them on any backend but the TPU.

The opt-in ``tim_early_stop`` replaces the JAX ``while_loop``s by Python
loops: every step reads the per-task stable count through
``ops.common.to_host``, one counted host sync a step. Under a task group
(``group``, parallel/) that count is gathered over the ranks first, so the
freeze and the stragglers are the whole batch's; the loss is a sum over
tasks, so the steps themselves need no communication.

Under class-axis tensor parallelism (a group with ``tp`` > 1) rank t holds
the class weights [t K/tp, (t+1) K/tp) and their Adam moments
([N/dp, K/tp, d]), the JAX package's communication-optimal layout
(tim.py:298-310): the logits [N/dp, n, K/tp] are local, and the softmax
row statistics (max, sum, the label logit) are reduced over the class
group. The gradient is autodiff's (``tim_grad_impl`` 'pallas' and 'manual'
become 'autodiff', as JAX turns 'pallas' off under a mesh: K3 needs whole
rows of classes), through ``ClassShard.sum_ad``, whose backward sums over
the class group too: each rank differentiates its part of the loss (its
classes' entropy terms, and on t = 0 the cross entropy, which every rank
computes whole), and their sum is the whole loss. Predictions are the
class group's argmax, and u comes back whole.

No learned parameters cross from the JAX package: the initial weights are
the support class means of the same support in both packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.common import TIM_EPS as _EPS, get_one_hot, to_host, top_rows
from ...parallel.task_parallel import (
    class_shard,
    gather_positions,
    gather_tasks,
)
from ..base import FewShotMethod, narrow_phase_widths
from .paddle import support_class_means

_LOG_EPS = math.log(_EPS)
# optax.adam's defaults (the JAX package's optimizer, tim.py:336)
_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def _tim_logits(weights, samples, temp, precision: str = "highest", x2=None):
    """temp * (x.w - ||w||^2/2 - ||x||^2/2) (reference: tim.py:99-113), in
    fp32 for either precision (module docstring). ``x2``: the precomputed
    loop-invariant 0.5*||x||^2 [N, n]."""
    xw = torch.einsum("tnd,tkd->tnk", samples, weights)
    w2 = 0.5 * (weights * weights).sum(-1)[:, None, :]
    if x2 is None:
        x2 = 0.5 * (samples * samples).sum(-1)
    return temp * (xw - w2 - x2[:, :, None])


def _cross_entropy(y_one_hot, probs_s, kind: str, alpha_value, cs):
    """The reference's cross entropy over one-hot labels; ``cs`` (a
    parallel.ClassShard): the columns are this rank's classes, and the sum
    over the classes is the class group's."""
    if kind == "Shannon":
        return -cs.sum_ad((y_one_hot * torch.log(probs_s + _EPS)).sum(2)
                          ).mean(1).sum(0)
    # Alpha (Tsallis-style) cross entropy
    ce = y_one_hot.pow(alpha_value) * (probs_s + _EPS).pow(1.0 - alpha_value)
    return ((1.0 - cs.sum_ad(ce.sum(2))) / (alpha_value - 1.0)).mean(1).sum(0)


def _log_p_label(y_s, logits_s, cs):
    """(log(p_label + eps), lse): the epsilon-capped label log-probability
    from a label gather, and the row logsumexp, over the class group of
    ``cs`` (the rank that holds a label's column gathers its logit)."""
    lse = cs.logsumexp(logits_s)                                 # [N, s]
    local = y_s - cs.lo
    mine = (local >= 0) & (local < cs.width)
    l_lab = torch.gather(logits_s, 2,
                         local.clamp(0, cs.width - 1)[..., None])[..., 0]
    z = cs.sum_ad(torch.where(mine, l_lab, 0.0)) - lse
    return z, torch.logaddexp(z, torch.full_like(z, _LOG_EPS)), lse


def _cross_entropy_gather(y_s, logits_s, kind: str, alpha_value, cs):
    """Cross entropy straight from support logits via a label gather: for
    one-hot labels the reference's sum over classes reduces to the label
    column, so the [N, s, K] one-hot, softmax and power tensors never
    materialise (``tim_ce_impl: onehot`` keeps the reference's shape)."""
    _, log_p, _ = _log_p_label(y_s, logits_s, cs)
    if kind == "Shannon":
        return (-log_p).mean(1).sum(0)
    return ((1.0 - torch.exp((1.0 - alpha_value) * log_p))
            / (alpha_value - 1.0)).mean(1).sum(0)


def _marginal_entropy(q_probs, kind: str, alpha_value):
    marg = q_probs.mean(1)
    if kind == "Shannon":
        return -(marg * torch.log(marg + _EPS)).sum(1).sum(0)
    return ((1.0 - marg.pow(alpha_value).sum(1)) / (alpha_value - 1.0)).sum(0)


def _conditional_entropy(q_probs, kind: str, alpha_value):
    if kind == "Shannon":
        return -(q_probs * torch.log(q_probs + _EPS)).sum(2).mean(1).sum(0)
    return ((1.0 - (q_probs + _EPS).pow(alpha_value).sum(2))
            / (alpha_value - 1.0)).mean(1).sum(0)


def _ce_grad_coef(y_s, logits_s, kind: str, alpha_value, cs):
    """Per-sample coefficient of the CE gradient: dCE/dlogits =
    coef[:, :, None] * (p - onehot(y)) / n_support. Differentiates the
    epsilon-capped log of ``_cross_entropy_gather`` exactly."""
    z, log_p, lse = _log_p_label(y_s, logits_s, cs)
    sigma = torch.exp(z - log_p)                 # p_label / (p_label + eps)
    if kind == "Shannon":
        return sigma, lse
    return -torch.exp((1.0 - alpha_value) * log_p) * sigma, lse


def _query_grad(p_q, entropies, alpha_value, loss_weights):
    """d(-w1*H_marg + w2*H_cond)/dlogits_q through the softmax jacobian."""
    n_query = p_q.shape[1]
    marg = p_q.mean(1)
    if entropies[1] == "Shannon":
        a = -(torch.log(marg + _EPS) + marg / (marg + _EPS))
    else:
        a = (-alpha_value / (alpha_value - 1.0)) * marg.pow(alpha_value - 1.0)
    pa = torch.einsum("tnk,tk->tn", p_q, a)
    g_marg = p_q * (a[:, None, :] - pa[..., None]) / n_query

    if entropies[2] == "Shannon":
        b = -(torch.log(p_q + _EPS) + p_q / (p_q + _EPS)) / n_query
    else:
        b = (-alpha_value / ((alpha_value - 1.0) * n_query)) * (
            p_q + _EPS).pow(alpha_value - 1.0)
    g_cond = p_q * (b - (b * p_q).sum(2, keepdim=True))
    return -loss_weights[1] * g_marg + loss_weights[2] * g_cond


def _query_side(weights, query, x2_q, temp, precision, entropies,
                alpha_value, loss_weights):
    """The query logits and their closed-form gradient terms
    (gq_x [N, K, d], column sums [N, K])."""
    logits_q = _tim_logits(weights, query, temp, precision, x2=x2_q)
    g_q = _query_grad(torch.softmax(logits_q, dim=2), entropies, alpha_value,
                      loss_weights)
    return logits_q, torch.einsum("tnk,tnd->tkd", g_q, query), g_q.sum(1)


def _make_grad_fn(grad_impl, support, query, y_s, x2_s, x2_q, temp,
                  alpha_value, loss_weights, entropies, n_class: int,
                  precision: str, ce_impl: str, cs=None):
    """The per-step gradient function over the given task buffers, returning
    (logits_q, grads). The impl-specific one-time preparation (support sort,
    the kernel's layout, one-hot) happens here, once per phase, outside the
    Adam loop. ``cs`` (a parallel.ClassShard, all classes by default): the
    weights are this rank's classes; under tp > 1 only autodiff runs, over
    the class group (module docstring)."""
    cs = cs or class_shard(None, n_class)
    if grad_impl == "pallas":
        from ...ops.cuda_tim import prepare_support, tim_support_grad

        n_support, d_feat = support.shape[1], support.shape[2]
        # fp32 division, as the JAX package forms its traced scale
        ce_scale = float(np.float32(loss_weights[0]) / np.float32(n_support))
        x_prep, y_prep = prepare_support(support, y_s, precision)

        def grad_fn(weights):
            gs_x, col = tim_support_grad(
                x_prep, y_prep, weights, temp, ce_scale, alpha_value,
                n_support, d_feat, ce_kind=entropies[0], precision=precision,
            )
            logits_q, gq_x, col_q = _query_side(
                weights, query, x2_q, temp, precision, entropies,
                alpha_value, loss_weights)
            col = col + col_q
            return logits_q, temp * (gs_x + gq_x - col[..., None] * weights)

        return grad_fn

    if grad_impl == "manual":
        n_support = support.shape[1]
        if n_support % n_class != 0:
            raise ValueError(
                "grad_impl='manual' needs uniform per-class support "
                f"(n_support={n_support} not divisible by K={n_class})"
            )
        shots = n_support // n_class
        # sort support by label once so the one-hot CE term reduces to a
        # [K, shots] segment contraction instead of a scatter
        order = torch.argsort(y_s, dim=1, stable=True)
        y_sorted = torch.gather(y_s, 1, order)
        x_sorted = torch.gather(
            support, 1, order[..., None].expand(-1, -1, support.shape[2]))
        x2_sorted = torch.gather(x2_s, 1, order)

        def grad_fn(weights):
            # support CE: G_s = w0 * coef * (p_s - onehot) / n_support
            logits_s = _tim_logits(weights, x_sorted, temp, precision,
                                   x2=x2_sorted)
            coef, lse = _ce_grad_coef(y_sorted, logits_s, entropies[0],
                                      alpha_value, cs)
            scale = loss_weights[0] / n_support
            g_plain = (scale * coef)[..., None] * torch.exp(
                logits_s - lse[..., None])
            coef_r = (scale * coef).reshape(-1, n_class, shots)
            x_r = x_sorted.reshape(-1, n_class, shots, x_sorted.shape[-1])
            gs_x = torch.einsum("tnk,tnd->tkd", g_plain, x_sorted)
            gs_x = gs_x - torch.einsum("tks,tksd->tkd", coef_r, x_r)
            col = g_plain.sum(1) - coef_r.sum(2)
            logits_q, gq_x, col_q = _query_side(
                weights, query, x2_q, temp, precision, entropies,
                alpha_value, loss_weights)
            col = col + col_q
            return logits_q, temp * (gs_x + gq_x - col[..., None] * weights)

        return grad_fn

    # each rank's loss is its classes' entropy terms plus, on the first
    # class rank only, the cross entropy (whole on every rank), so that the
    # ranks' losses add up to the whole loss (the entropies' constants
    # aside) and every rank's graph is the same
    y_one_hot = (get_one_hot(y_s - cs.lo, cs.width) if ce_impl == "onehot"
                 else None)
    ce_weight = loss_weights[0] if cs.lo == 0 else 0.0

    def loss_fn(weights):
        logits_s = _tim_logits(weights, support, temp, precision, x2=x2_s)
        logits_q = _tim_logits(weights, query, temp, precision, x2=x2_q)
        q_probs = cs.softmax(logits_q)
        if ce_impl == "onehot":
            ce = _cross_entropy(y_one_hot, cs.softmax(logits_s),
                                entropies[0], alpha_value, cs)
        else:
            ce = _cross_entropy_gather(y_s, logits_s, entropies[0],
                                       alpha_value, cs)
        q_ent = _marginal_entropy(q_probs, entropies[1], alpha_value)
        q_cond_ent = _conditional_entropy(q_probs, entropies[2], alpha_value)
        loss = (ce_weight * ce
                - (loss_weights[1] * q_ent - loss_weights[2] * q_cond_ent))
        return loss, logits_q

    def grad_fn(weights):
        w = weights.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, logits_q = loss_fn(w)
            (grads,) = torch.autograd.grad(loss, w)
        return logits_q.detach(), grads

    return grad_fn


def _adam_init(w0, opt_dtype: str):
    store = torch.bfloat16 if opt_dtype == "bfloat16" else torch.float32
    zeros = torch.zeros_like(w0, dtype=store)
    return {"count": 0, "mu": zeros, "nu": zeros.clone()}


def _adam_step(weights, grads, state, lr: float, opt_dtype: str):
    """One optax ``adam(lr)`` update (scale_by_adam, then -lr): both moments
    bias-corrected, ``mu_hat / (sqrt(nu_hat) + eps)``. With ``opt_dtype``
    'bfloat16' the moments are stored bf16 between steps and computed fp32
    (the JAX package's compress/expand_state)."""
    mu = (1.0 - _B1) * grads + _B1 * state["mu"].float()
    nu = (1.0 - _B2) * (grads * grads) + _B2 * state["nu"].float()
    count = state["count"] + 1
    # 1 - b**count in fp32, as optax's bias_correction computes it
    bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(count))
    update = (mu / bc1) / (torch.sqrt(nu / bc2) + _ADAM_EPS)
    new_weights = weights + (-lr) * update
    store = torch.bfloat16 if opt_dtype == "bfloat16" else torch.float32
    return new_weights, {"count": count, "mu": mu.to(store),
                         "nu": nu.to(store)}


def tim_infer(support, query, y_s, temp, alpha_value, loss_weights,
              n_iter: int, n_class: int, entropies: tuple, lr: float,
              precision: str = "highest", ce_impl: str = "gather",
              grad_impl: str = "autodiff", opt_dtype: str = "float32",
              early_stop: bool = False, es_patience: int = 100,
              compact_tasks: int = 8, group=None):
    """support [N, s, d], query [N, n, d] fp32, y_s [N, s] int64, on the
    device to run on; temp, alpha_value, lr host numbers, loss_weights three
    host numbers.

    Returns (u_q [N, n, K] from the last step's logits, criterions
    [n_iter, N]); with ``early_stop``, a third element: the host array
    ``[executed steps, full-width steps]`` (see ``resolve_exec_count``).

    ``early_stop`` (opt-in; the reference runs all ``n_iter`` Adam steps):
    a task freezes once its query predictions have been unchanged for
    ``es_patience`` consecutive steps; once at most ``compact_tasks`` tasks
    remain active they are gathered into a narrow straggler buffer and only
    they keep stepping. Frozen tasks report the logits they had at freeze
    time (see the JAX function's docstring for the argument).

    ``group`` (a parallel.TaskGroup): the tasks are this dp slice's
    contiguous equal share of the group's batch. The stop decisions and
    the stragglers are the whole batch's, and the criterions come back for
    the whole batch, [n_iter, N x dp]; u stays this slice's. Under
    ``group.tp`` > 1 this rank holds 1/tp of the classes (module
    docstring); u comes back whole.
    """
    loss_weights = [float(v) for v in loss_weights]
    n_task = query.shape[0]
    lo = 0 if group is None else group.d * n_task
    n_all = n_task if group is None else n_task * group.dp
    cs = class_shard(group, n_class)
    if cs.tp > 1:
        grad_impl = "autodiff"

    def whole_batch(criterions):
        if group is None:
            return criterions
        return gather_tasks(criterions.t().contiguous(), group).t()
    # loop-invariant sample norms, hoisted out of the Adam loop
    x2_s = 0.5 * (support * support).sum(-1)
    x2_q = 0.5 * (query * query).sum(-1)
    w0 = support_class_means(support, y_s, n_class)[
        :, cs.lo:cs.lo + cs.width].contiguous()
    state0 = _adam_init(w0, opt_dtype)

    def whole_u(logits):
        return torch.softmax(cs.gather(logits), dim=2)

    def make_step(support_b, query_b, y_s_b, x2_s_b, x2_q_b):
        """One Adam step over the given task buffers (the full batch, or
        phase 2's gathered stragglers)."""
        if support_b.shape[0] == 0:
            # a rank that holds none of the stragglers steps nothing, and
            # still joins every gather (parallel/task_parallel.py)
            def step_none(weights, state):
                empty = query_b.new_zeros((0, query_b.shape[1],
                                           weights.shape[1]))
                return weights, state, empty, query_b.new_zeros(0)

            return step_none
        grad_fn = _make_grad_fn(
            grad_impl, support_b, query_b, y_s_b, x2_s_b, x2_q_b, temp,
            alpha_value, loss_weights, entropies, n_class, precision, ce_impl,
            cs,
        )

        def step(weights, state):
            logits_q, grads = grad_fn(weights)
            new_weights, state = _adam_step(weights, grads, state, lr,
                                            opt_dtype)
            # per-task weight change [N], the reference's recorded criterion
            # (reference: tim.py weight_diff = norm(dim=-1).mean(-1))
            crit = torch.sqrt(((weights - new_weights) ** 2).sum(-1))
            crit = cs.mean(crit)
            return new_weights, state, logits_q, crit

        return step

    step_full = make_step(support, query, y_s, x2_s, x2_q)
    logits_q = _tim_logits(w0, query, temp, precision, x2=x2_q)

    if not early_stop:
        # the reference's fixed schedule (the default)
        weights, state, crits = w0, state0, []
        for _ in range(n_iter):
            weights, state, logits_q, crit = step_full(weights, state)
            crits.append(crit)
        criterions = (torch.stack(crits) if crits else
                      torch.zeros((0, n_task), device=query.device))
        return whole_u(logits_q), whole_batch(criterions)

    n_narrow = int(compact_tasks)
    use_tc = 0 < n_narrow < n_all
    patience = int(es_patience)
    steps = torch.arange(n_iter, device=query.device)[:, None]
    criterions = torch.zeros((n_iter, n_task), device=query.device)
    it = 0

    def run_phase(step, carry, busy, pos, size, t_idx=None):
        """Adam steps over whichever buffer ``step`` was built for, while
        ``busy(stable_h)``. ``pos``, ``size``: where this rank's tasks sit
        in the phase's batch of ``size`` tasks, whose stable counts the host
        reads. ``t_idx``: phase 2's straggler indices — their criterion
        scatters back into the full-batch trace (frozen tasks change by
        exactly 0)."""
        nonlocal it, criterions
        weights, state, logits_q, preds_prev, stable, stable_h = carry
        while it < n_iter and busy(stable_h):
            weights, state, logits_q, crit = step(weights, state)
            # logits_q is this step's PRE-update logits — what a stop after
            # this step reports (the reference's last-loop-body semantics)
            preds = cs.argmax(logits_q)
            same = (preds == preds_prev).all(-1)
            stable = torch.where(same, stable + 1, 0)
            if t_idx is not None:
                crit = torch.zeros(n_task, device=crit.device).index_copy(
                    0, t_idx, crit)
            criterions = torch.where(steps >= it, crit[None, :], criterions)
            it += 1
            preds_prev = preds
            stable_h = to_host(gather_positions(stable, pos, size, group))
        return weights, state, logits_q, preds_prev, stable, stable_h

    def busy_phase1(stable_h):
        active = int((stable_h < patience).sum())
        return active > (n_narrow if use_tc else 0)

    stable0 = torch.zeros(n_task, dtype=torch.int64, device=query.device)
    carry = run_phase(
        step_full,
        (w0, state0, logits_q, cs.argmax(logits_q), stable0,
         np.zeros(n_all, np.int64)),
        busy_phase1, torch.arange(lo, lo + n_task, device=query.device),
        n_all)
    weights, state, logits_q, preds, stable, stable_h = carry
    it_full = it

    if use_tc:
        # the least-stable tasks of the batch (covering every task with
        # stable < patience by the phase-1 exit condition), lower index
        # first on ties as jax.lax.top_k orders them; already-frozen
        # fillers keep stepping harmlessly. This rank continues those it
        # holds (maybe none) at their places in that order
        _, t_host = top_rows(torch.as_tensor(patience - stable_h), n_narrow)
        t_host = t_host.numpy()
        mine = np.flatnonzero((t_host >= lo) & (t_host < lo + n_task))
        t_idx = torch.as_tensor(t_host[mine] - lo, device=query.device)

        def grab(a):
            return a.index_select(0, t_idx)

        state_n = {"count": state["count"], "mu": grab(state["mu"]),
                   "nu": grab(state["nu"])}
        step_narrow = make_step(grab(support), grab(query), grab(y_s),
                                grab(x2_s), grab(x2_q))
        narrow = run_phase(
            step_narrow,
            (grab(weights), state_n, grab(logits_q), grab(preds),
             grab(stable), stable_h[t_host]),
            lambda s: bool((s < patience).any()),
            torch.as_tensor(mine, device=query.device), len(t_host),
            t_idx=t_idx)
        logits_q = logits_q.index_copy(0, t_idx, narrow[2])

    return (whole_u(logits_q), whole_batch(criterions),
            np.array([it, it_full]))


def resolve_matmul_precision(cfg_value: str) -> str:
    """'auto' (the config default) resolves to 'highest' (fp32) here: the
    JAX package resolves it to bf16 ('default') on the TPU only. Set
    ``tim_matmul_precision: default`` to feed K3 bf16 operands."""
    if cfg_value == "auto":
        return "highest"
    return cfg_value


def resolve_opt_dtype(cfg_value: str) -> str:
    """Adam-moment storage dtype: 'float32' (default, reference-exact
    state) or 'bfloat16' (opt-in)."""
    if cfg_value not in ("float32", "bfloat16"):
        raise ValueError(
            f"Unknown tim_opt_dtype {cfg_value!r}; choose 'float32' or "
            "'bfloat16'"
        )
    return cfg_value


def resolve_grad_impl(cfg_value, y_s, n_class, precision="highest"):
    """'auto' keeps autodiff, as the JAX package resolves it on any backend
    but the TPU; 'pallas' selects K3 (any label layout); 'manual' needs the
    protocol's uniform per-class support and falls back to autodiff
    otherwise."""
    if cfg_value in ("autodiff", "pallas"):
        return cfg_value
    if cfg_value == "auto":
        return "autodiff"
    if cfg_value != "manual":
        raise ValueError(
            f"Unknown tim_grad_impl {cfg_value!r}; choose from "
            "'auto', 'pallas', 'manual', 'autodiff'"
        )
    y = to_host(y_s) if isinstance(y_s, torch.Tensor) else np.asarray(y_s)
    n_support = y.shape[-1]
    if n_support % n_class:
        return "autodiff"
    shots = n_support // n_class
    counts = np.apply_along_axis(
        np.bincount, 1, y.reshape(-1, n_support), minlength=n_class
    )
    return "manual" if (counts == shots).all() else "autodiff"


class _TIMBase(FewShotMethod):
    """Shared tim_infer plumbing for TIM-GD and alpha-TIM."""

    reduces_over_group = True
    shards_classes = True

    def _tim_kwargs(self, task):
        args = self.args
        precision = resolve_matmul_precision(
            str(args.get("tim_matmul_precision", "auto")))
        es_patience = int(args.get("tim_es_patience", 100))
        if es_patience < 1:
            raise ValueError(
                f"tim_es_patience must be >= 1, got {es_patience}")
        return dict(
            n_iter=int(args.iter),
            n_class=int(args.num_classes_test),
            precision=precision,
            ce_impl=str(args.get("tim_ce_impl", "gather")),
            grad_impl=resolve_grad_impl(
                str(args.get("tim_grad_impl", "auto")),
                task["y_s"], int(args.num_classes_test),
                precision=precision,
            ),
            opt_dtype=resolve_opt_dtype(
                str(args.get("tim_opt_dtype", "float32"))),
            early_stop=bool(args.get("tim_early_stop", False)),
            es_patience=es_patience,
            compact_tasks=int(args.get("tim_compact_tasks", 8)),
            group=self.group,
        )

    def _timing_iter_widths(self, n_used, n_full, n_task):
        """Phase-1 steps at the full (or chunk) width, the straggler steps
        at the narrow ``tim_compact_tasks`` width."""
        return narrow_phase_widths(
            n_used, n_full, n_task, int(self.args.get("task_chunk", 0) or 0),
            int(self.args.get("tim_compact_tasks", 8)))


class ALPHA_TIM(_TIMBase):
    entropies_default = ("Shannon", "Alpha", "Alpha")

    def _infer(self, task):
        args = self.args
        self._log(
            f" ==> Executing ALPHA-TIM with ALPHA = {args.alpha_value} "
            f"and temp = {args.temp}"
        )
        return tim_infer(
            task["x_s"], task["x_q"], task["y_s"],
            float(args.temp), float(args.alpha_value), args.loss_weights,
            entropies=tuple(args.entropies),
            lr=float(args.lr_alpha_tim),
            **self._tim_kwargs(task),
        )


class TIM_GD(_TIMBase):
    """Shannon-entropy TIM with gradient descent (reference: tim.py:90-189)."""

    def _infer(self, task):
        args = self.args
        self._log(f" ==> Executing TIM-GD with temp = {args.temp}")
        return tim_infer(
            task["x_s"], task["x_q"], task["y_s"],
            float(args.temp), 1.0, args.loss_weights,
            entropies=("Shannon", "Shannon", "Shannon"),
            lr=float(args.lr_tim),
            **self._tim_kwargs(task),
        )
