#!/usr/bin/env python
"""CLI entry point of the port (counterpart of transductive_clip_tpu/cli.py;
reference: main.py):

    python -m transductive_clip_tpu_torch.cli --opts shots 0 dataset imagenet \
        method em_dirichlet number_tasks 1000 batch_size 100 ...
    python -m transductive_clip_tpu_torch.cli --opts shots 4 dataset imagenet \
        method alpha_tim tim_grad_impl pallas number_tasks 1000 batch_size 100

shots > 0 runs the few-shot evaluator, shots == 0 the zero-shot one. It runs
on ``cuda:{device}`` from the cached features and raises without a CUDA
device; feature extraction raises until its slice is ported.
"""

from __future__ import annotations

import argparse
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
    evaluator_cls = EvaluatorFewShot if args.shots > 0 else EvaluatorZeroShot
    evaluator = evaluator_cls(args=args, log_file=log_file)
    return evaluator.run_full_evaluation()


if __name__ == "__main__":
    main()
