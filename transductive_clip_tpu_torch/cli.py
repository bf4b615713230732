#!/usr/bin/env python
"""CLI entry point of the port (counterpart of transductive_clip_tpu/cli.py;
reference: main.py):

    python -m transductive_clip_tpu_torch.cli --opts shots 0 dataset imagenet \
        method em_dirichlet number_tasks 1000 batch_size 100 ...
    python -m transductive_clip_tpu_torch.cli --opts shots 4 dataset imagenet \
        method alpha_tim tim_grad_impl pallas number_tasks 1000 batch_size 100

shots > 0 runs the few-shot evaluator, shots == 0 the zero-shot one. It runs
on ``cuda:{device}`` and raises without a CUDA device.

``data_parallel True`` spreads every task batch (and extraction's image
batches) over all local cards, one process per card:

    torchrun --nproc_per_node 8 -m transductive_clip_tpu_torch.cli \
        --opts ... data_parallel True

joins the group on ``cuda:{LOCAL_RANK}``; started plainly with several
visible cards the CLI spawns one worker per card itself
(``launch_workers``); with one card it runs the single-device path. The
ranks form a (dp, tp) grid: ``tp 0`` (the default) is ``choose_layout``'s
pick, which gives the class axis as many ranks as divide the world and
``n_class`` (at most 8) once ``n_class`` >= 512, and 1 below; ``tp 2``
etc. splits each task's classes over that many ranks
(``torchrun --nproc_per_node 4 ... data_parallel True tp 2``). The CLIP
model is
loaded only when a feature cache is missing: then the towers extract the
features from the dataset's images (the checkpoint from
``$CLIP_WEIGHTS_DIR``, the BPE merges from ``$CLIP_BPE_PATH``; decoding the
images needs PIL).
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from .core.config import load_full_config
from .core.logger import Logger, get_log_file
from .eval import EvaluatorFewShot, EvaluatorZeroShot
from .eval.zero_shot import _parse_flag
from .parallel import (
    destroy_task_group,
    make_task_group,
    resolve_tp,
    spawn_ranks,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="transductive_clip_tpu_torch")
    parser.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    parser.add_argument("--config-root", default="config")
    args = parser.parse_args(argv)
    return load_full_config(opts=args.opts, config_root=args.config_root)


def maybe_load_clip(args, device=None):
    """(model, preprocess) of ``models.clip.load`` when a cache the
    evaluation reads is missing, else (None, None). Checks ``clip_compute``
    ('bf16' | 'float32'), ``clip_attention`` ('auto' | 'fused' | 'xla'),
    ``clip_fold_bn`` (a boolean) and ``clip_fused_resnet`` ('auto' or a
    boolean) as the JAX CLI does. ``device``: ``cuda:{args.device}`` when
    None, or what the caller passes."""
    from .eval.extraction import text_cache_path

    where = {} if device is None else {"device": device}
    if args.shots > 0:
        paths = EvaluatorFewShot(args=args, **where).cache_paths()
    else:
        paths = (EvaluatorZeroShot(args=args, **where).query_cache_path(),)
    need_model = not all(os.path.exists(p) for p in paths)
    if not args.use_softmax_feature:
        # the visual path needs text features for init and matching
        need_model = need_model or not os.path.exists(text_cache_path(args))
    if not need_model:
        return None, None
    from .models import clip

    dtype_name = str(args.get("clip_compute", "bf16")).strip().lower()
    if dtype_name in ("bf16", "bfloat16"):
        compute_dtype = torch.bfloat16
    elif dtype_name in ("float32", "fp32", "f32"):
        compute_dtype = torch.float32
    else:
        raise ValueError(
            f"clip_compute must be 'bf16' or 'float32'; got {dtype_name!r}"
        )
    attn_impl = str(args.get("clip_attention", "auto")).strip().lower()
    if attn_impl not in ("auto", "fused", "xla"):
        raise ValueError(
            f"clip_attention must be 'auto', 'fused' or 'xla'; got {attn_impl!r}"
        )
    fold_bn = _parse_flag(args.get("clip_fold_bn", True), "clip_fold_bn")
    fused = args.get("clip_fused_resnet", "auto")
    if fused != "auto":
        fused = _parse_flag(fused, "clip_fused_resnet")
    if device is None:
        device = f"cuda:{int(args.get('device', 0))}"
    return clip.load(args.backbone, compute_dtype=compute_dtype,
                     attention_impl=attn_impl, fold_bn=fold_bn,
                     fused_resnet=fused, device=device)


def run(args, group=None):
    """One evaluation of the parsed ``args``, as a rank of ``group`` (a
    parallel.TaskGroup, on its device) or alone; returns (mean accuracy,
    mean seconds per task). Only rank 0 writes a log file."""
    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)

    log_file = None
    if group is None or group.rank == 0:
        log_file = get_log_file(log_path=args.log_path, dataset=args.dataset,
                                method=args.name_method)
        Logger(__name__, log_file)
    where = {} if group is None else {"device": group.device, "group": group}
    model, preprocess = maybe_load_clip(
        args, device=None if group is None else group.device)
    evaluator_cls = EvaluatorFewShot if args.shots > 0 else EvaluatorZeroShot
    evaluator = evaluator_cls(args=args, log_file=log_file, **where)
    return evaluator.run_full_evaluation(model=model, preprocess=preprocess)


def _run_rank(group, argv):
    return run(parse_args(argv), group)


def _check_layout(args, world: int):
    """Raise JAX's ``ValueError`` before any rank starts when the ``tp`` of
    ``args`` does not divide ``world`` ranks (the evaluator lays the group
    out, ``parallel.resolve_tp``)."""
    resolve_tp(args.get("tp", 0), world, args.get("n_class", 0))


def launch_workers(argv, world: int, device=None):
    """Spawn ``world`` workers (start method ``spawn``, ``FileStore``
    rendezvous), worker r on ``cuda:{r}`` — or all on ``device`` (the tests
    pass ``"cpu"``) — each running the evaluation of ``argv`` as a rank of
    one task group (the evaluator lays it out from ``tp``); returns rank
    0's (mean accuracy, mean seconds per task)."""
    _check_layout(parse_args(argv), world)
    return spawn_ranks(_run_rank, world, (argv,), device=device)


def main(argv=None):
    """Run one evaluation; returns (mean accuracy, mean seconds per task).
    With ``data_parallel True``: under ``torchrun`` this process joins the
    task group on ``cuda:{LOCAL_RANK}``; started plainly with more than one
    visible card it spawns a worker per card (``launch_workers``); with one
    card it runs the single-device path."""
    args = parse_args(argv)
    if _parse_flag(args.get("data_parallel", False), "data_parallel"):
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            _check_layout(args, int(os.environ["WORLD_SIZE"]))
            group = make_task_group()
            try:
                return run(args, group)
            finally:
                destroy_task_group(group)
        n_cards = torch.cuda.device_count()
        if n_cards > 1:
            return launch_workers(argv, n_cards)
    return run(args)


if __name__ == "__main__":
    main()
