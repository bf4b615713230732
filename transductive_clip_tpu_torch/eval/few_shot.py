"""Few-shot evaluator (counterpart of transductive_clip_tpu/eval/few_shot.py;
reference: src/eval_few_shot.py).

Adds to the zero-shot pipeline: support features from the train split,
query features from ``used_test_set``, the support/query label remap, and
hyperparameter selection from the stored validation grids (the
argmax-accuracy row of results_few_shot/val/<ds>/<METHOD>_<word>_s<shots>.txt,
read relative to the working directory; ImageNet reuses caltech101's grid —
reference: eval_few_shot.py:130-187).

Along the blocking path: each batch's method and accuracy finish before the
next batch. ``defer_fetch``, ``fused_dispatch`` and ``data_parallel`` raise
``NotImplementedError`` until their ROADMAP.md items are ported.
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
from ..methods import get_few_shot_method
from ..methods.base import unported
from ..ops.common import resolve_device
from ..tasks import (
    CategoriesSamplerFewShot,
    SamplerQueryFewShot,
    SamplerSupportFewShot,
    TasksGeneratorFewShot,
)
from .zero_shot import _resolve_n_batches, check_supported

# method -> the hyperparameter tuned on the validation set
VAL_PARAM = {
    "LAPLACIAN_SHOT": "lmd",
    "ALPHA_TIM": "alpha_value",
    "PADDLE": "lambd",
    "BDCSPN": "temp",
}


class EvaluatorFewShot:
    """``device``: ``cuda:{args.device}`` when None (raises without a CUDA
    device), or what the caller passes, e.g. ``"cpu"``."""

    def __init__(self, device=None, args=None, log_file=None):
        self.device = resolve_device(device, args)
        self.args = args
        self.log_file = log_file
        self.logger = Logger(__name__, log_file) if log_file else None
        self.val_param = None

    def _log(self, msg):
        if self.logger:
            self.logger.info(msg)

    # ------------------------------------------------------------------
    def cache_paths(self):
        args = self.args
        root = getattr(args, "root", "data")
        store = str(args.get("feature_store", "plk"))
        if args.use_softmax_feature:
            support = softmax_cache_path(args.dataset, "train", args.backbone,
                                         args.T, root=root, store=store)
            query = softmax_cache_path(args.dataset, args.used_test_set,
                                       args.backbone, args.T, root=root,
                                       store=store)
        else:
            support = visual_cache_path(args.dataset, "train", args.backbone,
                                        root=root, store=store)
            query = visual_cache_path(args.dataset, args.used_test_set,
                                      args.backbone, root=root, store=store)
        return support, query

    def run_full_evaluation(self, model=None, preprocess=None):
        args = self.args
        support_path, query_path = self.cache_paths()
        for path in (support_path, query_path):
            if not os.path.exists(path):
                raise unported(f"feature extraction (no cache at {path})",
                               "'extraction with K4a, K4b and K5'")
        if not args.use_softmax_feature:
            raise unported("visual-feature evaluation (CLIP text features)",
                           "'extraction with K4a, K4b and K5'")
        support_features, support_labels = load_feature_cache(support_path)
        query_features, query_labels = load_feature_cache(query_path)
        mean_acc, mean_time = self.evaluate_tasks(
            support_features, support_labels, query_features, query_labels)
        self.report_results(mean_acc, mean_time)
        return mean_acc, mean_time

    # -- validation-grid hyperparameter selection ----------------------
    def get_method_val_param(self):
        name = VAL_PARAM.get(self.args.name_method)
        if name is not None:
            self.val_param = self.args[name]

    def set_value_opt_param(self, opt_param):
        name = VAL_PARAM.get(self.args.name_method)
        if name is not None:
            self.args[name] = opt_param

    def set_method_opt_param(self):
        """Pick the argmax-accuracy row of the stored val grid (a path
        relative to the working directory, as in the JAX package)."""
        args = self.args
        word = "_softmax" if args.use_softmax_feature else "_visual"
        dataset = "caltech101" if args.dataset == "imagenet" else args.dataset
        name_file = os.path.join(
            "results_few_shot", "val", dataset,
            f"{args.name_method}{word}_s{args.shots}.txt",
        )
        try:
            params, accs = [], []
            with open(name_file) as f:
                for i, line in enumerate(f):
                    # the reference skips the header AND the first grid row
                    # (eval_few_shot.py:171-173); kept for selection parity
                    if i < 2 or not line.strip():
                        continue
                    cols = line.split("\t")
                    params.append(float(cols[0]))
                    accs.append(float(cols[1]))
            accs = np.array(accs)
            idx = np.argwhere(accs == accs.max())[-1][0]
            opt_param = params[idx]
            self._log(f"Selected tuned parameter {opt_param} from {name_file}")
            self.set_value_opt_param(opt_param)
        except (OSError, ValueError, IndexError) as e:
            raise ValueError(
                "The optimal parameter was not found "
                f"(looked in {name_file}). Run the validation sweep first "
                "(scripts/opt_parameters.sh)."
            ) from e

    # ------------------------------------------------------------------
    def evaluate_tasks(self, support_features, support_labels,
                       query_features, query_labels, text_features=None):
        args = self.args
        check_supported(args, matching=False)
        self._log(
            f"=> Running evaluation with method {args.name_method} "
            f"on {args.dataset} ({args.used_test_set} set, {args.shots}-shot)"
        )
        rng = np.random.default_rng(args.seed if args.seed is not None else None)
        if args.used_test_set == "test" and args.tunable:
            self.set_method_opt_param()
        method = get_few_shot_method(
            args.name_method, device=self.device, args=args,
            log_file=self.log_file,
        )
        timer = PhaseTimer()
        n_class = int(args.n_class)
        flip = bool(args.use_softmax_feature)

        # device-resident feature tables + a per-batch index gather. The
        # flipped-unique label remap is the constant flip label ->
        # n_class-1-label when the support labels are exactly
        # {0..n_class-1} (checked here, the max and min too), and the
        # softmax column permutation is a column reversal, applied to the
        # tables once (it commutes with the row gather)
        supp_unique = np.unique(np.asarray(support_labels))
        device_gather = bool(args.get("device_gather", True)) and (
            len(supp_unique) == n_class
            and int(supp_unique.max()) == n_class - 1
            and int(supp_unique.min()) == 0
        )
        if device_gather:
            feats_s_dev, feats_q_dev = (
                torch.as_tensor(np.asarray(f, np.float32), device=self.device)
                for f in (support_features, query_features))
            if flip:
                feats_s_dev = torch.flip(feats_s_dev, dims=[-1])
                feats_q_dev = torch.flip(feats_q_dev, dims=[-1])
            labels_s_np = np.asarray(support_labels)
            labels_q_np = np.asarray(query_labels)

        results_task, results_time = [], []
        n_batches = _resolve_n_batches(args, self.logger)
        # sampler pools are RNG-free functions of the constant label arrays:
        # built once (draw-order exact: only __iter__ consumes rng)
        sampler = CategoriesSamplerFewShot(
            args.batch_size, args.k_eff, args.n_class, args.shots,
            args.n_query, force_query_size=True, rng=rng,
            support_draw=str(args.get("support_draw", "vectorized")),
        )
        sampler.create_list_classes(support_labels, query_labels)

        def gather(table, idx):
            return table[torch.as_tensor(idx, device=self.device)]

        def make_batch():
            # the reference's draw order: query first, then support
            if device_gather:
                idx_q = np.stack(list(SamplerQueryFewShot(sampler)))
                idx_s = np.stack(list(SamplerSupportFewShot(sampler)))
                y_s, y_q = labels_s_np[idx_s], labels_q_np[idx_q]
                if flip:
                    y_s, y_q = n_class - 1 - y_s, n_class - 1 - y_q
                tasks = {
                    "x_s": gather(feats_s_dev, idx_s), "y_s": y_s[..., None],
                    "x_q": gather(feats_q_dev, idx_q), "y_q": y_q[..., None],
                }
            else:
                loader_query = [
                    (query_features[idx], query_labels[idx])
                    for idx in SamplerQueryFewShot(sampler)
                ]
                loader_support = [
                    (support_features[idx], support_labels[idx])
                    for idx in SamplerSupportFewShot(sampler)
                ]
                tasks = TasksGeneratorFewShot(
                    k_eff=args.k_eff, shot=args.shots, n_query=args.n_query,
                    n_class=args.n_class, loader_support=loader_support,
                    loader_query=loader_query, args=args,
                ).generate_tasks()
            if text_features is not None:
                tasks["text_features"] = text_features
            return tasks

        # prefetch (opt-in): one worker thread samples batch i+1 while the
        # card runs batch i; the single worker keeps the rng draw order
        prefetch = bool(args.get("prefetch_sampling", False)) and n_batches > 1
        pool = None
        if prefetch:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(1)
        try:
            with trace_if_requested(args.get("profile_dir")):
                pending = pool.submit(make_batch) if prefetch else None
                for b in range(n_batches):
                    with timer.phase("sampling"):
                        tasks = pending.result() if prefetch else make_batch()
                    if prefetch and b + 1 < n_batches:
                        pending = pool.submit(make_batch)
                    with timer.phase("method"):
                        logs = method.run_task(tasks, shot=args.shots)
                    acc_mean, _ = compute_confidence_interval(logs["acc"][:, -1])
                    results_task.append(acc_mean)
                    results_time.append(logs["timestamps"])
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

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
        path = os.path.join(
            "results_few_shot", str(args.used_test_set), str(args.dataset)
        )
        self._log(
            f"{args.shots}-shot mean test accuracy over "
            f"{args.number_tasks} tasks: {mean_accuracies}"
        )
        self._log(
            f"{args.shots}-shot mean time over "
            f"{args.number_tasks} tasks: {mean_times}"
        )
        if args.used_test_set == "val":
            # validation sweep: append "<param>\t<acc>" to the val grid
            self.get_method_val_param()
            os.makedirs(path, exist_ok=True)
            name_file = os.path.join(
                path, f"{args.name_method}{word}_s{args.shots}.txt"
            )
            new_file = not os.path.isfile(name_file)
            with open(name_file, "a") as f:
                if new_file:
                    f.write("val_param\tacc\n")
                f.write(
                    f"{self.val_param}\t{round(100 * mean_accuracies, 2)}\t\n"
                )
        elif args.used_test_set == "test" and args.save_results:
            os.makedirs(path, exist_ok=True)
            name_file = os.path.join(
                path, f"{args.name_method}{word}_s{args.shots}.txt"
            )
            new_file = not os.path.isfile(name_file)
            with open(name_file, "a") as f:
                if new_file:
                    f.write("shots\tn_query\tk_eff\tacc\n\t\n")
                f.write(
                    f"{args.shots}\t{args.n_query}\t{args.k_eff}\t"
                    f"{round(100 * mean_accuracies, 1)}\t\n"
                )
