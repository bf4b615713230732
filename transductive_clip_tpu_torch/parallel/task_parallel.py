"""Task data parallelism and class-axis tensor parallelism over a
:class:`~.mesh.TaskGroup` (counterpart of
transductive_clip_tpu/parallel/task_parallel.py).

Layout: the JAX ``P("dp", ...)`` one on the task axis. Of a batch of N
tasks, the ranks of dp slice d hold tasks [d N/dp, (d+1) N/dp)
(``shard_task_batch``); results come back in task order over the task
group (``gather_tasks``, ``gather_host``). Under ``tp`` > 1 the tp ranks of
a slice hold the same tasks, and a method that shards its class state
(``class_shard``) gives rank t the classes [t K/tp, (t+1) K/tp): its
per-class values are reduced over the class group (``class_sum``,
``class_max``, ``ClassShard.argmax``) and its cluster columns gathered in
global order (``ClassShard.gather``).

In JAX one program runs on the whole mesh and GSPMD computes every
batch-wide reduction over the whole batch. Here each rank runs its own
Python loop, and the methods' loops decide on batch-wide values: the EM
stop test and task compaction, the Newton solve's criterion, alpha-TIM's
stable counts. Those values are reduced over the group before the host
reads them (``group_max``, ``task_sum``, ``gather_positions``, and the
class reductions), so every rank takes the branch the single-process run
takes. The invariant:

    every rank issues the same collectives in the same order, and every
    branch depends only on reduced values.

Otherwise a rank waits forever. A rank that holds none of a loop's tasks
(task compaction's stragglers may all sit on other ranks) still runs the
loop on an empty batch, and so takes part in every reduction.

Device collectives are ``all_reduce`` only (SUM, MAX), which NCCL and gloo
both run on CUDA tensors. A gather scatters each rank's rows (or columns)
into a zero buffer of the whole batch (or class axis) and sums it over the
group: x + 0 is exact, so the result is the concatenation bit for bit. A
sum over the batch (``batch_sum``) gathers the per-task partial sums and
adds them up in task order, as the single-process run does too, so both
round alike and take the same branches. Host values travel through the
gloo groups as pickled objects. With ``group=None`` every function here is
the identity and issues nothing, so the single-device path is unchanged;
the class reductions are the identity at tp 1 as well. What a run issues
is counted in the active ``core.profiling.PhaseTimer``, the port's one
registry of spans and counters (the evaluators' timer during an
evaluation): ``parallel.all_reduce_calls``, ``parallel.all_reduce_bytes``
and ``parallel.gather_host_calls``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.profiling import count


def all_reduce(t, op, group, pg=None):
    """``dist.all_reduce`` of a copy of ``t`` on ``pg`` (``group.pg``, the
    world, by default), counted in ``parallel.all_reduce_calls`` and
    ``parallel.all_reduce_bytes``."""
    count("parallel.all_reduce_calls")
    count("parallel.all_reduce_bytes", t.numel() * t.element_size())
    t = t.clone()
    dist.all_reduce(t, op=op, group=group.pg if pg is None else pg)
    return t


def group_max(t, group):
    """The elementwise max of ``t`` over every rank (identity without a
    group)."""
    return t if group is None else all_reduce(t, dist.ReduceOp.MAX, group)


def task_sum(t, group):
    """The sum of ``t`` over the task group: the dp ranks at this rank's t
    (identity without a group, or at dp 1)."""
    if group is None or group.dp == 1:
        return t
    return all_reduce(t, dist.ReduceOp.SUM, group, group.task_pg)


def class_sum(t, group):
    """The sum of ``t`` over the class group: the tp ranks of this rank's
    dp slice (identity without a group, or at tp 1)."""
    if group is None or group.tp == 1:
        return t
    return all_reduce(t, dist.ReduceOp.SUM, group, group.class_pg)


def class_max(t, group):
    """The elementwise max of ``t`` over the class group (identity without
    a group, or at tp 1)."""
    if group is None or group.tp == 1:
        return t
    return all_reduce(t, dist.ReduceOp.MAX, group, group.class_pg)


class _ClassSum(torch.autograd.Function):
    """``class_sum`` that autodiff sees: the backward sums the incoming
    gradients over the class group too. With each rank's loss the part of
    the whole loss it holds, that is the gradient of the whole loss (a
    plain ``dist.all_reduce`` would leave out the other ranks' share)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return class_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return class_sum(grad.contiguous(), ctx.group), None


@dataclasses.dataclass(frozen=True)
class ClassShard:
    """This rank's share of a class axis of ``n_class`` spread over the
    class group of ``group``: classes [lo, lo + width). At tp 1 (or without
    a group) it is the whole axis, and every reduction is the identity."""

    group: object
    lo: int
    width: int
    n_class: int

    @property
    def tp(self) -> int:
        return self.n_class // self.width

    def cols(self, x):
        """This rank's columns of ``x`` [..., n_class]."""
        return x[..., self.lo:self.lo + self.width]

    def sum(self, x):
        return class_sum(x, self.group)

    def max(self, x):
        return class_max(x, self.group)

    def mean(self, x):
        """The mean over the class axis of the local columns ``x``."""
        if self.tp == 1:
            return x.mean(-1)
        return self.sum(x.sum(-1)) / self.n_class

    def sum_ad(self, x):
        """``sum`` with the class group in the backward as well."""
        return x if self.tp == 1 else _ClassSum.apply(x, self.group)

    def argmax(self, x):
        """The global class index of each row's max over the last axis of
        the local columns ``x``; ties go to the lowest global index, as
        ``torch.argmax`` picks them in one process."""
        if self.tp == 1:
            return torch.argmax(x, dim=-1)
        val, arg = x.max(-1)
        best = self.max(val)
        cand = torch.where(val == best, arg + self.lo, self.n_class)
        return -self.max(-cand)

    def gather(self, x):
        """[..., n_class]: every rank's columns of ``x`` [..., width] at
        their places on the class axis (a zero buffer summed over the
        class group: exact)."""
        if self.tp == 1:
            return x
        out = x.new_zeros(tuple(x.shape[:-1]) + (self.n_class,))
        out[..., self.lo:self.lo + self.width] = x
        return self.sum(out)

    def per_rank(self, x):
        """[..., tp]: every rank's ``x`` [...] in class-rank order."""
        out = x.new_zeros(tuple(x.shape) + (self.tp,))
        out[..., self.lo // self.width] = x
        return self.sum(out)

    def softmax(self, logits):
        """Differentiable softmax over the class axis of the local columns
        ``logits``: the row max and the row sum reduced over the class
        group."""
        if self.tp == 1:
            return torch.softmax(logits, dim=-1)
        m = self.max(logits.detach().amax(-1, keepdim=True))
        e = torch.exp(logits - m)
        return e / self.sum_ad(e.sum(-1, keepdim=True))

    def logsumexp(self, logits):
        """Differentiable logsumexp over the class axis of the local
        columns ``logits``."""
        if self.tp == 1:
            return torch.logsumexp(logits, dim=-1)
        m = self.max(logits.detach().amax(-1))
        return torch.log(self.sum_ad(torch.exp(logits - m[..., None]).sum(
            -1))) + m


def class_shard(group, n_class: int) -> ClassShard:
    """This rank's :class:`ClassShard` of ``n_class`` classes (the whole
    axis without a group or at tp 1). The classes must divide over the tp
    ranks."""
    tp = 1 if group is None else group.tp
    if n_class % tp:
        raise ValueError(f"n_class={n_class} not divisible by tp={tp}")
    width = n_class // tp
    return ClassShard(group, (0 if group is None else group.t) * width,
                      width, n_class)


def shard_task_batch(tree, group):
    """This dp slice's contiguous share of every [n_task, ...] array (numpy
    or tensor) of ``tree`` (an array, or a dict / tuple / list of them):
    tasks [d n_task / dp, (d + 1) n_task / dp) for slice d."""
    if group is None:
        return tree
    if isinstance(tree, dict):
        return {k: shard_task_batch(v, group) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_task_batch(v, group) for v in tree)
    n_task = tree.shape[0]
    if n_task % group.dp:
        raise ValueError(f"a batch of {n_task} tasks does not divide over "
                         f"{group.dp} ranks")
    per = n_task // group.dp
    return tree[group.d * per:(group.d + 1) * per]


def gather_positions(x, positions, size, group):
    """[size, ...]: the rows ``x`` of every rank of the task group placed
    at their ``positions`` (this rank's: a long tensor on ``x``'s device,
    distinct across the task group and covering [0, size) together),
    summed over the task group."""
    if group is None:
        return x
    out = x.new_zeros((size,) + tuple(x.shape[1:]))
    out.index_copy_(0, positions, x)
    return task_sum(out, group)


def gather_tasks(x, group):
    """The whole batch of a tensor whose leading axis is this dp slice's
    tasks, in task order (every slice holds as many)."""
    if group is None:
        return x
    n = x.shape[0]
    pos = torch.arange(group.d * n, (group.d + 1) * n, device=x.device)
    return gather_positions(x, pos, n * group.dp, group)


@dataclasses.dataclass(frozen=True)
class TaskShare:
    """This rank's tasks of a batch spread over ``group``: they sit at
    ``pos`` (a long tensor on their device) among the batch's ``size``
    tasks. A loop hands its share to what reduces over its batch."""

    group: object
    pos: torch.Tensor
    size: int

    def gather(self, x):
        """[size, ...]: every rank's rows of ``x``, in the batch's order."""
        return gather_positions(x, self.pos, self.size, self.group)


def task_share(group, n_task: int, device):
    """The share of a rank holding ``n_task`` contiguous tasks of an equal
    split (None without a group)."""
    if group is None:
        return None
    lo = group.d * n_task
    return TaskShare(group, torch.arange(lo, lo + n_task, device=device),
                     n_task * group.dp)


def batch_rows(x, share):
    """The batch's rows of per-task values ``x`` [n, ...]: gathered over
    the group's ranks under a ``share``, else ``x``."""
    return x if share is None else share.gather(x)


def batch_sum(per_task, share):
    """The batch's sum of per-task values [n, ...] -> [...], added up in
    task order: over the group's ranks under a ``share``, else over
    ``per_task`` alone. Either way the same [batch, ...] tensor is reduced
    the same way, so the ranks and the single-process run agree to the
    bit."""
    return batch_rows(per_task, share).sum(0)


def gather_host(obj, group, world=False):
    """Every rank's ``obj`` (host values), in rank order, through a gloo
    group: the task group's ranks (the batch's shares), or with ``world``
    every rank; counted in ``parallel.gather_host_calls``."""
    if group is None:
        return [obj]
    count("parallel.gather_host_calls")
    pg = group.host_pg if world else group.task_host_pg
    out = [None] * (group.world if world else group.dp)
    dist.all_gather_object(out, obj, group=pg)
    return out


def barrier(group):
    """Wait for every rank (host group)."""
    if group is not None:
        dist.barrier(group=group.host_pg)


def distributed_em_dirichlet(query, lambd, group, n_iter: int = 20,
                             iter_mm: int = 1000, hard: bool = False,
                             solver: str = "mm", compact: bool = False,
                             early_stop: bool = False):
    """EM-Dirichlet over a task group, the JAX function's signature.

    query: [N, n, K] softmax features, the whole batch on every rank
    (numpy or tensor). Each rank solves its dp slice's N/dp tasks on
    ``group.device`` (under tp > 1, its share of their cluster rows) with
    the batch-wide decisions reduced over the group. Returns
    (u [N, n, K], criterions [n_iter]), both over the whole batch, on every
    rank."""
    from ..methods.zero_shot.em_dirichlet import em_dirichlet_infer

    query = torch.as_tensor(query, dtype=torch.float32)
    shard = shard_task_batch(query, group).to(group.device).contiguous()
    u, crits = em_dirichlet_infer(
        shard, float(lambd), n_iter=n_iter, iter_mm=iter_mm, hard=hard,
        solver=solver, compact=compact, early_stop=early_stop, group=group)
    return gather_tasks(u, group), crits
