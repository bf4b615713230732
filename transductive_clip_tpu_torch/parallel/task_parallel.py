"""Task data parallelism over a :class:`~.mesh.TaskGroup` (counterpart of
transductive_clip_tpu/parallel/task_parallel.py).

Layout: the JAX ``P("dp")`` one. Of a batch of N tasks, rank r of dp holds
tasks [r N/dp, (r+1) N/dp) (``shard_task_batch``); results come back in
task order (``gather_tasks``, ``gather_host``).

In JAX one program runs on the whole mesh and GSPMD computes every
batch-wide reduction over the whole batch. Here each rank runs its own
Python loop, and the methods' loops decide on batch-wide values: the EM
stop test and task compaction, the Newton solve's criterion, alpha-TIM's
stable counts. Those values are reduced over the group before the host
reads them (``group_sum``, ``group_max``, ``gather_positions``), so every
rank takes the branch the single-process run takes. The invariant:

    every rank issues the same collectives in the same order, and every
    branch depends only on reduced values.

Otherwise a rank waits forever. A rank that holds none of a loop's tasks
(task compaction's stragglers may all sit on other ranks) still runs the
loop on an empty batch, and so takes part in every reduction.

Device collectives are ``all_reduce`` only (SUM, MAX), which NCCL and gloo
both run on CUDA tensors. A gather scatters each rank's rows into a zero
buffer of the whole batch and sums it over the group: x + 0 is exact, so
the result is the concatenation bit for bit. A sum over the batch
(``batch_sum``) gathers the per-task partial sums and adds them up in task
order, as the single-process run does too, so both round alike and take
the same branches. Host values travel through
the gloo group ``host_pg`` as pickled objects. With ``group=None`` every
function here is the identity and issues nothing, so the single-device
path is unchanged. ``all_reduce.calls`` and ``gather_host.calls`` count
what a run issued.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


def all_reduce(t, op, group):
    """``dist.all_reduce`` of a copy of ``t`` on ``group.pg``, counted in
    ``all_reduce.calls``."""
    all_reduce.calls += 1
    t = t.clone()
    dist.all_reduce(t, op=op, group=group.pg)
    return t


all_reduce.calls = 0


def group_sum(t, group):
    """The sum of ``t`` over the ranks (identity without a group)."""
    return t if group is None else all_reduce(t, dist.ReduceOp.SUM, group)


def group_max(t, group):
    """The elementwise max of ``t`` over the ranks (identity without a
    group)."""
    return t if group is None else all_reduce(t, dist.ReduceOp.MAX, group)


def shard_task_batch(tree, group):
    """This rank's contiguous slice of every [n_task, ...] array (numpy or
    tensor) of ``tree`` (an array, or a dict / tuple / list of them): tasks
    [r n_task / dp, (r + 1) n_task / dp) for rank r."""
    if group is None:
        return tree
    if isinstance(tree, dict):
        return {k: shard_task_batch(v, group) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_task_batch(v, group) for v in tree)
    n_task = tree.shape[0]
    if n_task % group.world:
        raise ValueError(f"a batch of {n_task} tasks does not divide over "
                         f"{group.world} ranks")
    per = n_task // group.world
    return tree[group.rank * per:(group.rank + 1) * per]


def gather_positions(x, positions, size, group):
    """[size, ...]: the rows ``x`` of every rank placed at their
    ``positions`` (this rank's: a long tensor on ``x``'s device, distinct
    across ranks and covering [0, size) together), summed over the group."""
    if group is None:
        return x
    out = x.new_zeros((size,) + tuple(x.shape[1:]))
    out.index_copy_(0, positions, x)
    return group_sum(out, group)


def gather_tasks(x, group):
    """The whole batch of a tensor whose leading axis is this rank's tasks,
    in task order (every rank holds as many)."""
    if group is None:
        return x
    n = x.shape[0]
    pos = torch.arange(group.rank * n, (group.rank + 1) * n, device=x.device)
    return gather_positions(x, pos, n * group.world, group)


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
    lo = group.rank * n_task
    return TaskShare(group, torch.arange(lo, lo + n_task, device=device),
                     n_task * group.world)


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


def gather_host(obj, group):
    """Every rank's ``obj`` (host values), in rank order, through the gloo
    group; counted in ``gather_host.calls``."""
    if group is None:
        return [obj]
    gather_host.calls += 1
    out = [None] * group.world
    dist.all_gather_object(out, obj, group=group.host_pg)
    return out


gather_host.calls = 0


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
    (numpy or tensor). Each rank solves its N/dp tasks on ``group.device``
    with the batch-wide decisions reduced over the group. Returns
    (u [N, n, K], criterions [n_iter]), both over the whole batch, on every
    rank."""
    from ..methods.zero_shot.em_dirichlet import em_dirichlet_infer

    query = torch.as_tensor(query, dtype=torch.float32)
    shard = shard_task_batch(query, group).to(group.device).contiguous()
    u, crits = em_dirichlet_infer(
        shard, float(lambd), n_iter=n_iter, iter_mm=iter_mm, hard=hard,
        solver=solver, compact=compact, early_stop=early_stop, group=group)
    return gather_tasks(u, group), crits
