#!/usr/bin/env python
"""CLI entry point of the port (counterpart of transductive_clip_tpu/cli.py;
reference: main.py):

    python -m transductive_clip_tpu_torch.cli --opts shots 0 dataset imagenet \
        method em_dirichlet number_tasks 1000 batch_size 100 ...
    python -m transductive_clip_tpu_torch.cli --opts shots 4 dataset imagenet \
        method alpha_tim tim_grad_impl pallas number_tasks 1000 batch_size 100

shots > 0 runs the few-shot evaluator, shots == 0 the zero-shot one. It runs
on ``cuda:{device}`` and raises without a CUDA device. The CLIP model is
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
    from .eval.zero_shot import _parse_flag

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


def main(argv=None):
    """Run one evaluation; returns (mean accuracy, mean seconds per task)."""
    args = parse_args(argv)
    if args.seed is not None:
        random.seed(args.seed)
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)

    log_file = get_log_file(
        log_path=args.log_path, dataset=args.dataset, method=args.name_method
    )
    Logger(__name__, log_file)
    model, preprocess = maybe_load_clip(args)
    evaluator_cls = EvaluatorFewShot if args.shots > 0 else EvaluatorZeroShot
    evaluator = evaluator_cls(args=args, log_file=log_file)
    return evaluator.run_full_evaluation(model=model, preprocess=preprocess)


if __name__ == "__main__":
    main()
