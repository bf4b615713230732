"""Task groups: one process per card (counterpart of
transductive_clip_tpu/parallel/mesh.py).

The JAX package runs one controller process over a (dp, tp) device mesh and
lets GSPMD place the work. PyTorch's idiom is one process per card, joined
in a ``torch.distributed`` process group: a :class:`TaskGroup` is this
process's place in it. ``dp`` is the number of ranks and ``tp`` is 1.

Class-axis tensor parallelism (``tp`` > 1: the JAX ``ops/dirichlet.
_shard_map_rows`` with K1/K2 over row shards) is not ported; asking for it
raises (ROADMAP.md: 'class-TP'). ``tp: 0`` (auto) is 1: the JAX package's
answers do not depend on the layout (tests/test_parallel.py), so the
layout is a matter of speed only. For that reason ``choose_layout``, which
only picks ``tp``, has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..ops.common import resolve_device


@dataclasses.dataclass(frozen=True)
class TaskGroup:
    """This process's rank in a group of ``world`` ranks, its device, and
    two process groups: ``pg`` for the collectives on device tensors (NCCL
    on the cards, gloo on the CPU) and ``host_pg`` (gloo) for host values —
    accuracies, predictions, timings — which then never visit a card."""

    rank: int
    world: int
    device: torch.device
    pg: object
    host_pg: object

    @property
    def dp(self) -> int:
        return self.world

    tp = 1


def resolve_tp(tp, logger=None) -> int:
    """The class-axis width: 1. ``tp`` > 1 raises (class-TP is not ported);
    0 (auto) is 1, and the log says so."""
    tp = int(tp or 0)
    if tp > 1:
        from ..methods.base import unported

        raise unported(f"tp = {tp} > 1 (class-axis tensor parallelism)",
                       "'class-TP'")
    if tp <= 0 and logger is not None:
        logger.info("tp 0 (auto) -> 1: the port parallelises over tasks only")
    return 1


def make_task_group(rank=None, world=None, store_path=None, device=None,
                    backend=None) -> TaskGroup:
    """Join the process group (counterpart of ``make_mesh``).

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
    """Leave the process group ``make_task_group`` joined."""
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()
