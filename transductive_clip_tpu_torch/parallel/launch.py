"""Spawned ranks: the launcher behind the CLI's one-worker-per-card runs
(and the CPU tests' gloo ranks).

Each rank is a fresh process started with the ``spawn`` method (never
``fork``: the parent may hold threads), joins a task group through a
``FileStore`` in a temporary directory, runs ``target(group, *args)`` and
leaves the group. Rank 0's return value comes back to the parent through a
file. A rank that fails, or a launch that outlives ``timeout``, stops every
other rank: a rank left waiting in a collective would wait forever.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
import time


def _rank_main(rank, world, store_path, result_path, target, args, device,
               backend):
    import torch

    from .mesh import destroy_task_group, make_task_group

    if device == "cpu":
        # ranks on the CPU share its cores: one thread each, or their
        # spinning intra-op pools starve one another between collectives
        torch.set_num_threads(1)
    group = make_task_group(rank, world, store_path, device=device,
                            backend=backend)
    try:
        out = target(group, *args)
    finally:
        destroy_task_group(group)
    if rank == 0:
        with open(result_path, "wb") as f:
            pickle.dump(out, f)


def spawn_ranks(target, world: int, args=(), device=None, backend=None,
                timeout=None):
    """Run ``target(group, *args)`` (a picklable function) on ``world``
    spawned ranks, every rank on the task axis (``target`` lays the group
    out with ``class_layout``), and return rank 0's result. ``device``:
    None puts rank r on ``cuda:{r}``; a device string (``"cpu"``, or one card for ranks that
    share it) puts every rank there. ``backend``: as ``make_task_group``.
    Raises ``RuntimeError`` when a rank exits with an error and
    ``TimeoutError`` after ``timeout`` seconds; the other ranks are then
    terminated."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tclip_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        result = os.path.join(tmp, "result.pkl")
        procs = [ctx.Process(
            target=_rank_main,
            args=(r, world, store, result, target, tuple(args),
                  f"cuda:{r}" if device is None else device, backend))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [p.exitcode for p in procs
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"a rank exited with code "
                                       f"{failed[0]}; stopping the others")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout} s")
                for p in procs:
                    p.join(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with codes {codes}")
        with open(result, "rb") as f:
            return pickle.load(f)
