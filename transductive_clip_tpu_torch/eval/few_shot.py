"""Few-shot evaluator (counterpart of transductive_clip_tpu/eval/few_shot.py;
reference: src/eval_few_shot.py).

Adds to the zero-shot pipeline: support features from the train split,
query features from ``used_test_set``, the support/query label remap, and
hyperparameter selection from the stored validation grids (the
argmax-accuracy row of results_few_shot/val/<ds>/<METHOD>_<word>_s<shots>.txt,
read relative to the working directory; ImageNet reuses caltech101's grid —
reference: eval_few_shot.py:130-187).

Batch 0 runs blocking; ``defer_fetch`` and ``fused_dispatch`` run the
later batches through the deferred and fused pipelines as the zero-shot
evaluator does (eval/zero_shot.py: the same accuracies and predictions, the
amortised end-to-end time per task). ``data_parallel`` spreads each batch
over a task group as the zero-shot evaluator does (every rank draws the
whole batch and runs its share of the tasks; rank 0 reports); the val-grid
selection runs on every rank.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..core.logger import Logger
from ..core.profiling import PhaseTimer, trace_if_requested
from ..features.cache import (
    load_feature_cache,
    softmax_cache_path,
    visual_cache_path,
)
from ..methods import get_few_shot_method
from ..ops.common import resolve_device
from ..parallel import shard_task_batch
from ..tasks import (
    CategoriesSamplerFewShot,
    SamplerQueryFewShot,
    SamplerSupportFewShot,
    TasksGeneratorFewShot,
)
from .zero_shot import (
    _device_gather,
    _maybe_task_group,
    _resolve_n_batches,
    finalize_deferred,
    mean_results,
    resolve_defer_fetch,
    resolve_fused_dispatch,
)

# method -> the hyperparameter tuned on the validation set
VAL_PARAM = {
    "LAPLACIAN_SHOT": "lmd",
    "ALPHA_TIM": "alpha_value",
    "PADDLE": "lambd",
    "BDCSPN": "temp",
}


class EvaluatorFewShot:
    """``device``: ``cuda:{args.device}`` when None (raises without a CUDA
    device), or what the caller passes, e.g. ``"cpu"``. ``group``: the
    parallel.TaskGroup this process belongs to (its device is the default);
    only its rank 0 logs and writes results."""

    def __init__(self, device=None, args=None, log_file=None, group=None):
        if device is None and group is not None:
            device = group.device
        self.device = resolve_device(device, args)
        self.args = args
        self.group = group
        self.rank = 0 if group is None else group.rank
        self.log_file = log_file if self.rank == 0 else None
        self.logger = Logger(__name__, log_file) if self.log_file else None
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
        """Extract the train and ``used_test_set`` features if a cache is
        missing (``model``, ``preprocess``: ``models.clip.load``'s pair),
        then evaluate over all tasks from the caches; with visual features
        the methods also read the CLIP text prototypes
        (``extraction.get_text_features``)."""
        args = self.args
        support_path, query_path = self.cache_paths()
        if not (os.path.exists(support_path) and os.path.exists(query_path)):
            from .extraction import ensure_features

            ensure_features(args, model, preprocess,
                            splits=("train", args.used_test_set),
                            group=self.group)
        text_features = None
        if not args.use_softmax_feature:
            from .extraction import get_text_features

            text_features = get_text_features(args, model, group=self.group)
        support_features, support_labels = load_feature_cache(support_path)
        query_features, query_labels = load_feature_cache(query_path)
        mean_acc, mean_time = self.evaluate_tasks(
            support_features, support_labels, query_features, query_labels,
            text_features=text_features)
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
        """(mean accuracy, mean seconds per task); ``self.task_accuracies``
        keeps each batch's per-task accuracies [batch_size], in order."""
        args = self.args
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
        group = _maybe_task_group(args, self.group, method, self.logger)
        method.set_task_group(group)
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
            labels_s_np = np.asarray(support_labels)
            labels_q_np = np.asarray(query_labels)
            if flip:
                feats_s_dev = torch.flip(feats_s_dev, dims=[-1])
                feats_q_dev = torch.flip(feats_q_dev, dims=[-1])
                labels_s_np = n_class - 1 - labels_s_np
                labels_q_np = n_class - 1 - labels_q_np
            labels_s_dev = torch.as_tensor(labels_s_np, device=self.device)
            labels_q_dev = torch.as_tensor(labels_q_np, device=self.device)
        # fused path (methods/base.py run_task_fused): per batch only the
        # two index matrices cross; the gathers run on the device
        use_fused = resolve_fused_dispatch(args, device_gather)

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

        def tasks_from_idx(idx_s, idx_q):
            tasks = {
                "x_s": _device_gather(feats_s_dev, idx_s),
                "y_s": labels_s_np[idx_s][..., None],
                "x_q": _device_gather(feats_q_dev, idx_q),
                "y_q": labels_q_np[idx_q][..., None],
            }
            if text_features is not None:
                tasks["text_features"] = text_features
            return tasks

        def make_batch():
            # the reference's draw order: query first, then support. With
            # device_gather only the indices are drawn here. Every rank
            # draws the whole batch, then keeps its share of the tasks
            if device_gather:
                idx_q = np.stack(list(SamplerQueryFewShot(sampler)))
                idx_s = np.stack(list(SamplerSupportFewShot(sampler)))
                return (*shard_task_batch((idx_s, idx_q), group), None)
            loader_query = [
                (query_features[idx], query_labels[idx])
                for idx in SamplerQueryFewShot(sampler)
            ]
            loader_support = [
                (support_features[idx], support_labels[idx])
                for idx in SamplerSupportFewShot(sampler)
            ]
            tasks = shard_task_batch(TasksGeneratorFewShot(
                k_eff=args.k_eff, shot=args.shots, n_query=args.n_query,
                n_class=args.n_class, loader_support=loader_support,
                loader_query=loader_query, args=args,
            ).generate_tasks(), group)
            if text_features is not None:
                tasks["text_features"] = text_features
            return None, None, tasks

        # prefetch (opt-in): one worker thread samples batch i+1 while the
        # card runs batch i; the single worker keeps the rng draw order
        prefetch = bool(args.get("prefetch_sampling", False)) and n_batches > 1
        pool = None
        if prefetch:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(1)
        defer = resolve_defer_fetch(args, self.device, use_fused)
        deferred, t_tail0 = [], None
        # bound what the deferred handles hold (see eval/zero_shot.py):
        # flush every ``defer_flush_batches`` batches (0 = never)
        flush_n = int(args.get("defer_flush_batches", 32) or 0)

        def queue(res):
            nonlocal deferred, t_tail0
            deferred.append(res)
            if flush_n and len(deferred) >= flush_n:
                finalize_deferred(deferred, t_tail0, int(args.batch_size),
                                  results_task, results_time, timer, group)
                deferred, t_tail0 = [], time.perf_counter()

        try:
            with trace_if_requested(args.get("profile_dir")):
                pending = pool.submit(make_batch) if prefetch else None
                for b in range(n_batches):
                    with timer.phase("sampling"):
                        idx_s, idx_q, tasks = (pending.result() if prefetch
                                               else make_batch())
                    if prefetch and b + 1 < n_batches:
                        pending = pool.submit(make_batch)
                    if defer and use_fused and b > 0 and idx_s is not None:
                        with timer.phase("dispatch"):
                            res = method.run_task_fused(
                                feats_s_dev, feats_q_dev, labels_s_dev,
                                labels_q_dev, idx_s, idx_q,
                                shot=args.shots, text_features=text_features,
                            )
                        if res is not None:
                            queue(res)
                            continue
                        use_fused = False
                        self._log(
                            "fused_dispatch: configuration needs a host "
                            "step per batch; using per-program deferred "
                            "dispatch"
                        )
                    if tasks is None:
                        with timer.phase("sampling"):
                            tasks = tasks_from_idx(idx_s, idx_q)
                    # batch 0 runs blocking; later batches queue their
                    # accuracy and are fetched together
                    if defer and b > 0:
                        with timer.phase("dispatch"):
                            res = method.run_task_deferred(
                                tasks, shot=args.shots)
                        if res is not None:
                            queue(res)
                            continue
                        defer = False
                        self._log(
                            "defer_fetch: configuration needs a host step "
                            "per batch; falling back to blocking run_task"
                        )
                    with timer.phase("method"):
                        logs = method.run_task(tasks, shot=args.shots)
                    results_task.append(logs["acc"][:, -1])
                    results_time.append(logs["timestamps"])
                    if defer:
                        t_tail0 = time.perf_counter()
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

        if deferred:
            finalize_deferred(deferred, t_tail0, int(args.batch_size),
                              results_task, results_time, timer, group)
        self._log("phase timing -- " + timer.summary())
        self.task_accuracies = results_task
        return mean_results(results_task, results_time, self.logger)

    # ------------------------------------------------------------------
    def report_results(self, mean_accuracies, mean_times):
        args = self.args
        if self.rank != 0:
            return
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
