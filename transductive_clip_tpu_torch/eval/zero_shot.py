"""Zero-shot evaluator (counterpart of
transductive_clip_tpu/eval/zero_shot.py; reference: src/eval_zero_shot.py).

Pipeline per batch of tasks: sampler -> gather feature rows -> stack into
[n_task, n, d] on the device -> method -> accuracy + CI, along the blocking
path: each batch's method and accuracy finish before the next batch is
sampled. ``defer_fetch`` and ``fused_dispatch`` resolve to off (as they do in
the JAX package off the TPU); asking for either, or for ``data_parallel``,
raises ``NotImplementedError`` until their ROADMAP.md items are ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.logger import Logger
from ..core.metrics import compute_confidence_interval
from ..core.profiling import PhaseTimer, trace_if_requested
from ..features.cache import (
    load_feature_cache,
    softmax_cache_path,
    visual_cache_path,
)
from ..methods import get_zero_shot_method
from ..methods.base import PIPELINES, unported
from ..ops.common import resolve_device
from ..tasks import (
    CategoriesSamplerZeroShot,
    SamplerQueryZeroShot,
    TasksGeneratorZeroShot,
)

def _parse_flag(val, name):
    """Parse a CLI/config boolean that may arrive as a string; raises on
    anything unrecognised (``bool('false')`` is True)."""
    if not isinstance(val, str):
        return bool(val)
    low = val.strip().lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"{name}: expected a boolean or 'auto', got {val!r}")


def _flag_or_auto_off(args, key):
    """An 'auto'-or-boolean knob whose 'auto' resolves to off here."""
    val = args.get(key, "auto")
    if isinstance(val, str) and val.strip().lower() == "auto":
        return False
    return _parse_flag(val, key)


def check_supported(args, matching=True):
    """Raise for the evaluator options whose paths are still to port
    (``matching``: whether the method's accuracy path matches clusters to
    classes, so that ``matching_backend`` applies)."""
    if _flag_or_auto_off(args, "defer_fetch"):
        raise unported("defer_fetch True (the deferred-fetch pipeline)",
                       PIPELINES)
    if _flag_or_auto_off(args, "fused_dispatch"):
        raise unported("fused_dispatch True (the fused one-dispatch "
                       "pipeline)", PIPELINES)
    if matching and str(args.get("matching_backend", "auto")) == "device":
        raise unported("matching_backend: device (the batched auction)",
                       PIPELINES)
    if _parse_flag(args.get("data_parallel", False), "data_parallel"):
        raise unported("data_parallel True", "'multi-device'")


def _resolve_n_batches(args, logger=None):
    """``number_tasks // batch_size``, the reference's truncating semantics
    (eval_zero_shot.py:151) — zero batches raises, a dropped remainder is
    logged."""
    n_batches = int(args.number_tasks) // int(args.batch_size)
    if n_batches == 0:
        raise ValueError(
            f"number_tasks={args.number_tasks} < batch_size="
            f"{args.batch_size}: no batch would run (the reference "
            "evaluates floor(number_tasks / batch_size) batches)"
        )
    rem = int(args.number_tasks) % int(args.batch_size)
    if rem and logger:
        logger.warning(
            f"number_tasks={args.number_tasks} is not a multiple of "
            f"batch_size={args.batch_size}; the trailing {rem} tasks are "
            "not evaluated (reference truncation semantics)"
        )
    return n_batches


class EvaluatorZeroShot:
    """``device``: ``cuda:{args.device}`` when None (raises without a CUDA
    device), or what the caller passes, e.g. ``"cpu"``."""

    def __init__(self, device=None, args=None, log_file=None):
        self.device = resolve_device(device, args)
        self.args = args
        self.log_file = log_file
        self.logger = Logger(__name__, log_file) if log_file else None

    def _log(self, msg):
        if self.logger:
            self.logger.info(msg)

    # ------------------------------------------------------------------
    def query_cache_path(self):
        args = self.args
        store = str(args.get("feature_store", "plk"))
        if args.use_softmax_feature:
            return softmax_cache_path(
                args.dataset, args.used_test_set, args.backbone, args.T,
                root=getattr(args, "root", "data"), store=store,
            )
        return visual_cache_path(
            args.dataset, args.used_test_set, args.backbone,
            root=getattr(args, "root", "data"), store=store,
        )

    def run_full_evaluation(self, model=None, preprocess=None):
        """Extract the test split's features if their cache is missing
        (``model``, ``preprocess``: ``models.clip.load``'s pair), then
        evaluate over all tasks from the cache."""
        args = self.args
        path = self.query_cache_path()
        if not os.path.exists(path):
            from .extraction import ensure_features

            ensure_features(args, model, preprocess,
                            splits=(args.used_test_set,))
        if not args.use_softmax_feature:
            raise unported("visual-feature evaluation (the methods that "
                           "read CLIP text features)",
                           "'remaining zero-shot methods'")
        features, labels = load_feature_cache(path)
        mean_acc, mean_time = self.evaluate_tasks(features, labels)
        self.report_results(mean_acc, mean_time)
        return mean_acc, mean_time

    # ------------------------------------------------------------------
    def evaluate_tasks(self, features, labels, text_features=None):
        args = self.args
        check_supported(args)
        self._log(
            f"=> Running evaluation with method {args.name_method} "
            f"on {args.dataset} ({args.used_test_set} set)"
        )
        rng = np.random.default_rng(args.seed if args.seed is not None else None)
        method = get_zero_shot_method(
            args.name_method, device=self.device, args=args,
            log_file=self.log_file,
        )
        timer = PhaseTimer()
        # device-resident feature table: rows are gathered on the device
        # per batch (device_gather: False restores the host gather+stack)
        device_gather = bool(args.get("device_gather", True))
        if device_gather:
            features_dev = torch.as_tensor(np.asarray(features, np.float32),
                                           device=self.device)
            labels_np = np.asarray(labels)

        results_task, results_time = [], []
        n_batches = _resolve_n_batches(args, self.logger)
        # pools are RNG-free functions of the constant labels: built once
        # (hoisting is draw-order exact since only __iter__ consumes rng)
        sampler = CategoriesSamplerZeroShot(
            args.batch_size, args.k_eff, args.n_class, args.n_query,
            force_query_size=True, rng=rng,
        )
        sampler.create_list_classes(labels)
        with trace_if_requested(args.get("profile_dir")):
            for _ in range(n_batches):
                with timer.phase("sampling"):
                    if device_gather:
                        idx = np.stack(list(SamplerQueryZeroShot(sampler)))
                        tasks = {
                            "x_q": features_dev[torch.as_tensor(
                                idx, device=self.device)],
                            "y_q": labels_np[idx][..., None],
                        }
                    else:
                        loader = [
                            (features[idx], labels[idx])
                            for idx in SamplerQueryZeroShot(sampler)
                        ]
                        tasks = TasksGeneratorZeroShot(
                            k_eff=args.k_eff, n_query=args.n_query,
                            n_class=args.n_class, loader_query=loader,
                            args=args,
                        ).generate_tasks()
                if text_features is not None:
                    tasks["text_features"] = text_features
                with timer.phase("method"):
                    logs = method.run_task(tasks)
                acc_mean, _ = compute_confidence_interval(logs["acc"][:, -1])
                results_task.append(acc_mean)
                results_time.append(logs["timestamps"])

        self._log("phase timing -- " + timer.summary())
        # the first batch's time includes warm-up (allocator, kernel build
        # and load); exclude it from the reported mean when there are later
        # batches
        if len(results_time) > 1:
            results_time = results_time[1:]
        else:
            self._log(
                "note: single-batch run — reported mean time includes "
                "warm-up"
            )
        return float(np.mean(results_task)), float(np.mean(results_time))

    # ------------------------------------------------------------------
    def report_results(self, mean_accuracies, mean_times):
        args = self.args
        self._log("----- Final results -----")
        word = "_softmax" if args.use_softmax_feature else "_visual"
        self._log(
            f"{args.shots}-shot mean test accuracy over "
            f"{args.number_tasks} tasks: {mean_accuracies}"
        )
        self._log(
            f"{args.shots}-shot mean time over "
            f"{args.number_tasks} tasks: {mean_times}"
        )
        if args.save_results:
            path = os.path.join(
                "results_zero_shot", str(args.used_test_set), str(args.dataset)
            )
            os.makedirs(path, exist_ok=True)
            name_file = os.path.join(
                path, f"{args.name_method}{word}_{args.shots}shot.txt"
            )
            new_file = not os.path.isfile(name_file)
            with open(name_file, "a") as f:
                if new_file:
                    f.write("shots\tn_query\tn_task\tacc\n\t\n")
                f.write(
                    f"{args.shots}\t{args.n_query}\t{args.number_tasks}\t"
                    f"{round(100 * mean_accuracies, 1)}\t\n"
                )
