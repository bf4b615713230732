"""Dirichlet density and the solvers for its concentration parameters
(counterpart of transductive_clip_tpu/ops/dirichlet.py; reference:
src/methods/zero_shot/em_dirichlet.py:28-40 and :153-177).

The JAX package runs each solver as one device-side ``lax.while_loop``.
Here the loops are Python loops over torch ops, and each stop test is one
host transfer (``common.to_host``): the MM loop tests every 50 updates, the
Minka fixed point every block of 4 iterations, and the Newton-Minka solve
reads a device-side stop flag every NEWTON_CHECK_EVERY steps. Each
criterion is a ratio of sums over the whole batch, added up from per-task
partial sums in task order (``parallel.batch_sum``). Under a task group
(``share``, a parallel.TaskShare) the ranks' partial sums are gathered
before the ratio is formed, at every Newton step, with no host read — the
psum GSPMD inserts in the JAX loop — and the ratio is the single-process
run's to the bit. Under class-axis tensor parallelism (``cs``, a
parallel.ClassShard: this rank holds 1/tp of the cluster rows) each task's
partial sums are first summed over the class group, so the ranks of a
slice stop together; the rows themselves need no communication. The two
kernel families ('pallas' and 'mm_pallas', names kept so configs work
unchanged) run their whole loop on the card inside one launch
(``cuda_dirichlet``) and make no transfer.
"""

from __future__ import annotations

import math

import torch

from ..parallel.task_parallel import batch_sum
from .common import to_host
from .special import (
    digamma_pos,
    inv_digamma,
    inv_digamma_and_deriv,
    trigamma_pos,
)

# polygamma(1, 1) = pi^2 / 6; the reference uses this as the curvature at the
# alpha -> 0 limit (reference: em_dirichlet.py:153-155,195-196).
TRIGAMMA_1 = math.pi ** 2 / 6.0


def _per_task(x):
    """Sum of each leading-axis slice of ``x``: [n, ...] -> [n]."""
    return x.flatten(1).sum(-1) if x.dim() > 1 else x


def _crit(num, den, share=None, cs=None):
    """num / max(den, 1e-30) in fp32, as a 0-d tensor, from per-task
    partial sums num, den [n] added up over the batch (over the ranks of
    ``share``'s group, as one [n, 2] gather; under ``cs`` first over the
    class group, whose ranks hold the rest of each task's rows)."""
    x = torch.stack((num, den), -1)
    if cs is not None:
        x = cs.sum(x)
    num, den = batch_sum(x, share)
    return num / torch.clamp_min(den, 1e-30)


def _below(crit, tol) -> bool:
    """Host read of ``crit < tol``, compared in fp32 on the device as the
    JAX loop compares it."""
    return bool(to_host(crit < tol))


def dirichlet_log_pdf(log_samples, alpha):
    """Batched Dirichlet log-density.

    log_samples: [..., n, d]; alpha: [..., K, d]; returns [..., n, K].
    log p = lgamma(sum a) - sum lgamma(a) + sum (a - 1) log x.
    """
    l1 = torch.lgamma(alpha.sum(-1))[..., None, :]            # [..., 1, K]
    l2 = -torch.lgamma(alpha).sum(-1)[..., None, :]           # [..., 1, K]
    l3 = torch.einsum("...nd,...kd->...nk", log_samples, alpha - 1.0)
    return l1 + l2 + l3


def _mm_iteration(alpha, y_cst, alpha_floor=1e-11):
    """One quadratic-surrogate update of alpha: the positive root of
    a x^2 + b x - 1 = 0 (reference: em_dirichlet.py:157-167)."""
    digam = torch.digamma(alpha + 1.0)
    curv = torch.where(
        alpha > alpha_floor,
        torch.abs(2.0 * (digam * alpha - torch.lgamma(alpha + 1.0))
                  / (alpha * alpha)),
        torch.full_like(alpha, TRIGAMMA_1),
    )
    b = (digam - torch.digamma(alpha.sum(-1, keepdim=True)) - curv * alpha
         - y_cst)
    delta = b * b + 4.0 * curv
    return (-b + torch.sqrt(delta)) / (2.0 * curv)


def mm_update_alpha(alpha0, y_cst, iter_mm: int = 1000, tol: float = 1e-11,
                    check_every: int = 50, row_mask=None, share=None,
                   cs=None):
    """The reference's MM inner loop. At update indices 50, 100, ... the
    single-step relative change ||a_{l+1} - a_l||^2 / ||a_l||^2 is tested
    against ``tol`` and the loop breaks keeping a_{l+1}; exactly ``iter_mm``
    updates run when the test never fires (the trailing block is clamped to
    the remaining budget).

    ``row_mask`` ([..., K] bool, optional): False rows are FROZEN at
    ``alpha0`` and excluded from the convergence criterion.
    """
    if row_mask is None:
        step = _mm_iteration
        mask = None
    else:
        mask = row_mask[..., None]

        def step(a, y):
            return torch.where(mask, _mm_iteration(a, y), a)

    alpha = alpha0
    for _ in range(min(check_every, iter_mm)):
        alpha = step(alpha, y_cst)
    it = min(check_every, iter_mm)
    while it < iter_mm:
        # checked step: one update, criterion on its single-step delta
        alpha_new = step(alpha, y_cst)
        num = _per_task((alpha_new - alpha) ** 2)
        live = alpha if mask is None else torch.where(mask, alpha, 0.0)
        den = _per_task(live * live)
        alpha = alpha_new
        rem = min(check_every - 1, iter_mm - it - 1)
        if _below(_crit(num, den, share, cs), tol):
            break
        for _ in range(rem):
            alpha = step(alpha, y_cst)
        it += 1 + rem
    return alpha


def minka_update_alpha(alpha0, y_cst, max_iters: int = 60, tol: float = 1e-11,
                       check_every: int = 4, newton_iters: int = 3,
                       row_mask=None, share=None, cs=None):
    """Minka's inverse-digamma fixed point a_d <- psi^{-1}(psi(sum a) + y_d)
    for the same stationarity equation as ``mm_update_alpha``, tested every
    ``check_every`` iterations. ``row_mask``: False rows are frozen at
    ``alpha0`` and excluded from the criterion."""
    def one_iter(alpha):
        psi_sum = digamma_pos(alpha.sum(-1, keepdim=True))
        new = inv_digamma(psi_sum + y_cst, newton_iters=newton_iters)
        if row_mask is not None:
            new = torch.where(row_mask[..., None], new, alpha)
        return new

    alpha = alpha0
    it = 0
    while it < max_iters:
        prev = alpha
        for _ in range(check_every):
            alpha = one_iter(alpha)
        it += check_every
        num = _per_task((alpha - prev) ** 2)
        live = prev if row_mask is None else torch.where(
            row_mask[..., None], prev, 0.0)
        if _below(_crit(num, _per_task(live * live), share, cs), tol):
            break
    return alpha


# steps between the Newton-Minka solve's host reads of its stop flag: a
# larger interval makes fewer syncs and runs up to NEWTON_CHECK_EVERY - 1
# steps past the stop. Chosen by the wall clock of a whole zero-shot `auto`
# evaluation, first batch and steady ones
# (``dirichlet_variants --newton-reads``; PERF.md)
NEWTON_CHECK_EVERY = 4


def minka_newton_update_alpha(alpha0, y_cst, max_iters: int = 30,
                              tol: float = 1e-11, newton_iters: int = 3,
                              row_mask=None, share=None, cs=None):
    """Newton on the row sum s of F(s) = sum_d psi^{-1}(psi(s) + y_d) - s,
    with F'(s) = psi'(s) sum_d 1/psi'(a_d) - 1 — the same stationary point
    as the fixed point, reached quadratically. A guard takes the plain
    fixed-point step A(s) wherever the Newton step is non-finite,
    non-positive, or F' degenerate. ``row_mask``: False rows are frozen at
    ``alpha0`` and excluded from the criterion.

    The stop is the JAX ``lax.while_loop``'s, kept on the device: a
    ``done`` flag turns on at the first step whose criterion is under
    ``tol``, and from then on ``s`` stays at that step's value. The host
    reads the flag every NEWTON_CHECK_EVERY steps, so a solve makes one
    transfer for every NEWTON_CHECK_EVERY steps and runs at most
    NEWTON_CHECK_EVERY - 1 steps past its stop, which change nothing."""
    check_every = NEWTON_CHECK_EVERY
    s = alpha0.sum(-1)                                        # [..., R]
    live = row_mask

    def newton_step(s):
        z = digamma_pos(s)[..., None] + y_cst
        alpha, dinv = inv_digamma_and_deriv(z, newton_iters=newton_iters)
        a_sum = alpha.sum(-1)                                 # A(s)
        fprime = trigamma_pos(s) * dinv.sum(-1) - 1.0
        s_newton = s - (a_sum - s) / fprime
        ok = (torch.isfinite(s_newton) & (s_newton > 0.0)
              & (torch.abs(fprime) > 1e-12))
        return torch.where(ok, s_newton, a_sum)

    done = torch.zeros((), dtype=torch.bool, device=s.device)
    for it in range(1, max_iters + 1):
        s_new = newton_step(s)
        if live is not None:
            s_new = torch.where(live, s_new, s)
        num = _per_task((s_new - s) ** 2)
        s_live = s if live is None else torch.where(live, s, 0.0)
        crit = _crit(num, _per_task(s_live * s_live), share, cs)
        s = torch.where(done, s, s_new)
        done = done | (crit < tol)
        if it % check_every == 0 and it < max_iters and to_host(done):
            break
    # one final elementwise pass at the converged row-sum
    alpha = inv_digamma(digamma_pos(s)[..., None] + y_cst,
                        newton_iters=newton_iters)
    if row_mask is not None:
        alpha = torch.where(row_mask[..., None], alpha, alpha0)
    return alpha


# 'pallas' solves wider than this route to the Newton-Minka path (same fixed
# point), as in the JAX package: the kernel's per-block early exit pays off
# at compact widths, full-width [N, K, K] solves go to the Newton path
_PALLAS_SOLVER_MAX_ROWS = 256


def resolve_solver_for_width(solver: str, n_rows: int) -> str:
    """The solver family ``update_alpha`` actually runs at this row count:
    'pallas' solves wider than ``_PALLAS_SOLVER_MAX_ROWS`` reroute to the
    Newton-Minka path. The two-tier compact EM steps resolve once at their
    widest width and pass the resolved name to both tiers, so the tiers can
    never mix solver families."""
    if solver == "pallas" and n_rows > _PALLAS_SOLVER_MAX_ROWS:
        return "minka"
    return solver


def update_alpha(alpha0, y_cst, iter_mm: int = 1000, solver: str = "mm",
                 row_mask=None, share=None, cs=None):
    """Dispatch between the reference-exact MM solver (torch ops, or the
    'mm_pallas' kernel), the Minka fixed point ('minka_fp'), the
    Newton-Minka solve ('minka') and the Minka kernel ('pallas'); all solve
    the same stationary equation.

    ``row_mask`` ([..., K] bool, optional): False rows are frozen at
    ``alpha0`` and excluded from every solver's convergence criterion (the
    kernels receive it folded into y as the ``ROW_FREEZE`` sentinel —
    genuine y entries are weighted means of log-simplex values, always
    <= ~1e-15, so a positive value cannot occur naturally).

    ``share`` (a parallel.TaskShare): where these tasks sit in a batch
    spread over a task group; the torch solvers' stop criteria are the
    whole batch's. The kernels stop per (task, row block) and need no
    group; a rank with no tasks launches nothing.

    ``cs`` (a parallel.ClassShard): ``alpha0`` is this rank's share of each
    task's rows, and the torch solvers' criteria are summed over the class
    group. The caller resolves ``solver`` at the whole row count
    (``resolve_solver_for_width``): a shard's count could pick another
    family than one process picks.
    """
    solver = resolve_solver_for_width(solver, alpha0.shape[-2])
    if solver in ("pallas", "mm_pallas"):
        if alpha0.shape[0] == 0:
            return alpha0.clone()
        from .cuda_dirichlet import ROW_FREEZE, dirichlet_row_solve, mm_row_solve

        if row_mask is not None:
            y_cst = torch.where(row_mask[..., None], y_cst, ROW_FREEZE)
        alpha0, y_cst = alpha0.contiguous(), y_cst.contiguous()
        if solver == "pallas":
            return dirichlet_row_solve(alpha0, y_cst)
        return mm_row_solve(alpha0, y_cst, iter_mm=iter_mm)
    if solver == "minka":
        return minka_newton_update_alpha(alpha0, y_cst, row_mask=row_mask,
                                         share=share, cs=cs)
    if solver == "minka_fp":
        return minka_update_alpha(alpha0, y_cst, row_mask=row_mask,
                                  share=share, cs=cs)
    if solver != "mm":
        # a typo must not silently select the (reference-exact but ~100x
        # slower) MM loop
        raise ValueError(
            f"unknown dirichlet_solver {solver!r}; expected one of "
            "'minka', 'minka_fp', 'pallas', 'mm', 'mm_pallas'"
        )
    return mm_update_alpha(alpha0, y_cst, iter_mm=iter_mm, row_mask=row_mask,
                           share=share, cs=cs)


def dirichlet_logits_cache(log_samples, alpha):
    """The Dirichlet log-density split into cacheable terms:
    log_pdf = l12[..., None, :] + l3 with l12 = lgamma(sum a) - sum lgamma(a)
    per cluster row and l3 the (a-1).log-x contraction."""
    l12 = torch.lgamma(alpha.sum(-1)) - torch.lgamma(alpha).sum(-1)
    l3 = torch.einsum("...nd,...kd->...nk", log_samples, alpha - 1.0)
    return l12, l3


def update_logits_cache_rows(l12, l3, idx, alpha_c, log_samples,
                             row_mask=None):
    """Incremental ``dirichlet_logits_cache`` update at cluster rows ``idx``
    ([..., C]) whose parameters changed to ``alpha_c`` ([..., C, d]).

    The lane replacement is a one-hot contraction + mask, as in the JAX
    package: with distinct indices the 0/1 contraction reproduces the
    replaced values bit-exactly (every non-matching term is an exact 0.0),
    which the two-tier solve gate relies on.

    ``row_mask`` ([..., C] bool, optional): False rows are NOT written —
    their cached entries stay as previously stored."""
    k = l12.shape[-1]
    onehot = (idx[..., None] == torch.arange(k, device=idx.device)).to(
        torch.float32)
    if row_mask is not None:
        onehot = onehot * row_mask[..., None].to(torch.float32)
    keep = 1.0 - onehot.amax(-2)                              # [..., K]

    l12_c = torch.lgamma(alpha_c.sum(-1)) - torch.lgamma(alpha_c).sum(-1)
    l12 = l12 * keep + torch.einsum("...c,...ck->...k", l12_c, onehot)
    l3_c = torch.einsum("...nd,...cd->...nc", log_samples, alpha_c - 1.0)
    l3 = (l3 * keep[..., None, :]
          + torch.einsum("...nc,...ck->...nk", l3_c, onehot))
    return l12, l3


def clamped_cluster_means(num, mass, eps: float = 1e-15,
                          empty_fill: float = -10.0):
    """``num / max(mass, eps)`` with empty-cluster rows set to
    ``empty_fill`` (reference: em_dirichlet.py:217-222). Returns
    (y [..., K, d], nonzero mask [..., K, 1])."""
    y = num / torch.clamp_min(mass, eps)[..., :, None]
    nonzero = (mass > eps)[..., :, None]
    return torch.where(nonzero, y, empty_fill), nonzero


def weighted_log_means(u, log_query, eps: float = 1e-15, empty_fill: float = -10.0):
    """Per-cluster weighted means of log-features, the MM constant ``y_cst``.

    u: [..., n, K] soft assignments; log_query: [..., n, d].
    Returns [..., K, d] with rows of empty clusters set to ``empty_fill``,
    plus the nonzero-cluster mask.
    """
    u_sum = u.sum(-2)                                         # [..., K]
    num = torch.einsum("...nk,...nd->...kd", u, log_query)
    return clamped_cluster_means(num, u_sum, eps=eps, empty_fill=empty_fill)
