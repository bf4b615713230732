"""Task data parallelism and class-axis tensor parallelism over
``torch.distributed``, one process per card (counterpart of
transductive_clip_tpu/parallel/)."""

from .launch import spawn_ranks
from .mesh import (
    TaskGroup,
    choose_layout,
    class_layout,
    destroy_task_group,
    make_task_group,
    resolve_tp,
)
from .task_parallel import (
    ClassShard,
    TaskShare,
    barrier,
    batch_rows,
    batch_sum,
    class_max,
    class_shard,
    class_sum,
    distributed_em_dirichlet,
    gather_host,
    gather_positions,
    gather_tasks,
    group_max,
    shard_task_batch,
    task_share,
    task_sum,
)

__all__ = [
    "TaskGroup",
    "make_task_group",
    "destroy_task_group",
    "choose_layout",
    "resolve_tp",
    "class_layout",
    "spawn_ranks",
    "shard_task_batch",
    "gather_positions",
    "gather_tasks",
    "gather_host",
    "group_max",
    "task_sum",
    "class_sum",
    "class_max",
    "ClassShard",
    "class_shard",
    "barrier",
    "TaskShare",
    "task_share",
    "batch_rows",
    "batch_sum",
    "distributed_em_dirichlet",
]
