"""Task groups: one process per card, laid out as a (dp, tp) grid
(counterpart of transductive_clip_tpu/parallel/mesh.py).

The JAX package runs one controller process over a (dp, tp) device mesh and
lets GSPMD place the work. PyTorch's idiom is one process per card, joined
in a ``torch.distributed`` process group: a :class:`TaskGroup` is this
process's place in it. The ``world = dp * tp`` ranks form a dp x tp grid,
rank = d * tp + t, as ``make_mesh`` reshapes its devices:

* ``dp`` — task data parallelism: the ranks at one t split a batch's tasks,
  and reduce its batch-wide decisions over their *task group*;
* ``tp`` — class-axis tensor parallelism: the tp ranks of one dp slice hold
  the same tasks, and each holds 1/tp of the per-task class state (alpha's
  cluster rows, alpha-TIM's class weights); they reduce over their *class
  group* (parallel/task_parallel.py). The methods with no class sharding in
  the JAX package repeat their slice's work on every t.

``tp: 0`` (auto) is ``choose_layout``'s pick (a copy of the JAX function)
for the methods that shard their classes, tp 1 for the others
(``resolve_tp``). ``class_layout`` is the one place a group is laid out.
"""

from __future__ import annotations

import dataclasses
import gc
import os

import torch
import torch.distributed as dist

from ..ops.common import resolve_device


def choose_layout(n_devices: int, n_class: int, max_tp: int = 8):
    """Pick (dp, tp) with dp * tp == n_devices and tp dividing n_class.

    Prefers pure task-DP (tp=1) — zero communication — and grows tp only as
    needed to keep per-device alpha state reasonable for large n_class.
    """
    if n_class >= 512:
        # large-K regime: give the class axis as many chips as divide evenly
        for tp in range(min(max_tp, n_devices), 0, -1):
            if n_devices % tp == 0 and n_class % tp == 0:
                return n_devices // tp, tp
    return n_devices, 1


@dataclasses.dataclass(frozen=True)
class TaskGroup:
    """This process's rank in a group of ``world`` ranks, its device, and
    its process groups, each a pair: a device group for the collectives on
    device tensors (NCCL on the cards, gloo on the CPU) and a gloo group
    for host values — accuracies, predictions, timings — which then never
    visit a card. ``pg`` / ``host_pg`` span the world; ``task_pg`` /
    ``task_host_pg`` the dp ranks at this rank's t (the world when tp is
    1); ``class_pg`` / ``class_host_pg`` the tp ranks of its dp slice (None
    when tp is 1)."""

    rank: int
    world: int
    device: torch.device
    pg: object
    host_pg: object
    tp: int = 1
    task_pg: object = None
    task_host_pg: object = None
    class_pg: object = None
    class_host_pg: object = None
    #: tp -> this world laid out so (``class_layout``), shared by the
    #: layouts of one world
    layouts: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    def __post_init__(self):
        if self.task_pg is None:
            object.__setattr__(self, "task_pg", self.pg)
            object.__setattr__(self, "task_host_pg", self.host_pg)

    @property
    def dp(self) -> int:
        return self.world // self.tp

    @property
    def d(self) -> int:
        """This rank's place on the task axis (its dp slice)."""
        return self.rank // self.tp

    @property
    def t(self) -> int:
        """This rank's place on the class axis."""
        return self.rank % self.tp

    @property
    def layout(self) -> str:
        return f"dp={self.dp} tp={self.tp}"


def resolve_tp(tp, world: int, n_class=0, shards_classes=True,
               logger=None) -> int:
    """The class-axis width of a group of ``world`` ranks, as the JAX
    evaluator resolves it: ``tp`` > 0 as given, 0 (auto) ``choose_layout``'s
    pick for ``n_class``. A method that does not shard its classes
    (``shards_classes`` False) would only repeat its dp slice's work on
    every t, and its answer does not depend on the layout, so for it auto
    is tp 1. Raises the ``ValueError`` of
    JAX's ``make_mesh`` when ``tp`` does not divide the world."""
    tp = int(tp or 0)
    world = int(world)
    if tp <= 0:
        n_class = int(n_class or 0)
        dp, tp = choose_layout(world, n_class) if shards_classes else (
            world, 1)
        if logger is not None:
            how = (f"choose_layout({world}, {n_class})" if shards_classes
                   else "the method shards no classes")
            logger.info(f"tp 0 (auto): {how} -> dp={dp} tp={tp}")
    if world % tp != 0:
        raise ValueError(f"n_devices={world} not divisible by tp={tp}")
    return tp


def _subgroups(rank: int, world: int, tp: int, backend: str):
    """(task pg, task host pg, class pg, class host pg) of ``rank`` in a
    dp x tp grid. Every rank creates every subgroup, in the same order, as
    ``dist.new_group`` requires."""
    def pair(ranks):
        pg = dist.new_group(ranks, backend=backend)
        host = pg if backend == "gloo" else dist.new_group(ranks,
                                                           backend="gloo")
        return (pg, host) if rank in ranks else (None, None)

    dp = world // tp
    classes = [pair(list(range(d * tp, (d + 1) * tp))) for d in range(dp)]
    tasks = [pair(list(range(t, world, tp))) for t in range(tp)]
    return (*tasks[rank % tp], *classes[rank // tp])


def class_layout(group: TaskGroup, tp: int) -> TaskGroup:
    """``group``'s world laid out as dp x ``tp`` (``group`` itself when it
    has that layout already); tp 1 puts every rank on the task axis, what
    extraction runs on, as the JAX package forces ``make_mesh(tp=1)``
    there. Every rank must call it, in the same order: the first call for
    a ``tp`` > 1 creates the subgroups, later ones reuse them."""
    if group is None or group.tp == tp:
        return group
    if group.world % tp:
        raise ValueError(f"n_devices={group.world} not divisible by tp={tp}")
    if tp not in group.layouts:
        pgs = ((group.pg, group.host_pg, None, None) if tp == 1 else
               _subgroups(group.rank, group.world, tp,
                          dist.get_backend(group.pg)))
        group.layouts[tp] = dataclasses.replace(group, tp=tp, **dict(zip(
            ("task_pg", "task_host_pg", "class_pg", "class_host_pg"), pgs)))
    return group.layouts[tp]


def make_task_group(rank=None, world=None, store_path=None, device=None,
                    backend=None) -> TaskGroup:
    """Join the process group (counterpart of ``make_mesh``), every rank on
    the task axis (tp 1; ``class_layout`` lays it out otherwise).

    Under ``torchrun`` (``rank`` None) the rank and world come from
    ``RANK`` and ``WORLD_SIZE`` and the device is ``cuda:{LOCAL_RANK}``.
    Otherwise the caller passes ``rank``, ``world`` and ``store_path``, a
    ``FileStore`` file every rank can reach. ``device``: the rank's card, or
    ``"cpu"``. ``backend``: NCCL when each rank has a card of its own, gloo
    on the CPU; pass ``"gloo"`` to run ranks that share a card."""
    if rank is None:
        if "RANK" not in os.environ:
            raise ValueError("make_task_group: pass rank, world and "
                             "store_path, or run under torchrun")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if device is None:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        init = {"init_method": "env://"}
    else:
        if store_path is None or world is None:
            raise ValueError("make_task_group: rank needs world and store_path")
        init = {"store": dist.FileStore(store_path, int(world))}
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, rank=int(rank), world_size=int(world),
                            **init)
    pg = dist.group.WORLD
    host_pg = pg if backend == "gloo" else dist.new_group(backend="gloo")
    return TaskGroup(int(rank), int(world), device, pg, host_pg)


def destroy_task_group(group: TaskGroup):
    """Leave the process group ``make_task_group`` joined, with every
    subgroup of its layouts, and free them now, while the interpreter is
    whole: a gloo group still referenced at exit (a layout held in a
    reference cycle) is destroyed during finalization, which can abort the
    process ("terminate called without an active exception")."""
    if group is not None and dist.is_initialized():
        group.layouts.clear()
        dist.destroy_process_group()
        gc.collect()
