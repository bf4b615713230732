"""Task data parallelism over ``torch.distributed``, one process per card
(counterpart of transductive_clip_tpu/parallel/)."""

from .launch import spawn_ranks
from .mesh import TaskGroup, destroy_task_group, make_task_group, resolve_tp
from .task_parallel import (
    TaskShare,
    barrier,
    batch_rows,
    batch_sum,
    distributed_em_dirichlet,
    gather_host,
    gather_positions,
    gather_tasks,
    group_max,
    group_sum,
    shard_task_batch,
    task_share,
)

__all__ = [
    "TaskGroup",
    "make_task_group",
    "destroy_task_group",
    "resolve_tp",
    "spawn_ranks",
    "shard_task_batch",
    "gather_positions",
    "gather_tasks",
    "gather_host",
    "group_sum",
    "group_max",
    "barrier",
    "TaskShare",
    "task_share",
    "batch_rows",
    "batch_sum",
    "distributed_em_dirichlet",
]
