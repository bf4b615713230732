"""Zero-shot evaluator (counterpart of
transductive_clip_tpu/eval/zero_shot.py; reference: src/eval_zero_shot.py).

Pipeline per batch of tasks: sampler -> gather feature rows -> stack into
[n_task, n, d] on the device -> method -> accuracy + CI. Batch 0 is always
blocking. After it, ``defer_fetch`` queues each batch's accuracy behind its
method (``run_task_deferred``) and fetches the results of a window of
batches in one transfer, and ``fused_dispatch`` feeds those batches from
the feature and label tables held on the device, so that only the
[n_task, n_query] index matrix crosses per batch (``run_task_fused``).
Accuracies and predictions are the blocking path's, bit for bit; under
deferral the reported time per task is the amortised end-to-end wall clock
of the deferred batches (sampling, method, accuracy and fetch), not the
method's own.

``data_parallel`` spreads every batch over a task group (parallel/; the
CLI makes it: one process per card): every rank draws the same batch from
the same seeded sampler and runs its contiguous share of the tasks (the
rows of the batch, or on the fused route of its index matrix); the method
reduces its batch-wide decisions over the group, each rank gathers the
per-task accuracies after its route's own fetch, and rank 0 logs and
writes the TSV row. The time per task is the slowest rank's over the
whole batch. The group is laid out as (dp, tp) from ``tp``
(``parallel.resolve_tp``; 0 is ``choose_layout``'s pick for ``n_class``):
the tp ranks of a dp slice hold the same tasks and split their classes,
and the results come from the task group at t = 0.
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext

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
from ..methods.base import fetch_tree
from ..ops.common import resolve_device
from ..parallel import (
    class_layout,
    gather_host,
    resolve_tp,
    shard_task_batch,
)
from ..tasks import (
    CategoriesSamplerZeroShot,
    SamplerQueryZeroShot,
    TasksGeneratorZeroShot,
)

# what ``defer_fetch: auto`` resolves to on a CUDA device when the fused
# route applies (``fused_dispatch`` on, with ``device_gather``); off
# elsewhere, as the JAX package resolves it off the TPU. Chosen by the
# zero_shot_pipelines phase of chip_smoke.py, which times the steady
# zero-shot soft 'pallas' batch on every route in turns: over three runs,
# five paired readings of 0.2363, 0.2390, 0.2456, 0.2254 and 0.2460 ms per
# task fused against 0.2523, 0.3192, 0.2643, 0.2300 and 0.2584 blocking,
# all with the device auction (7.8 host syncs a batch against 9.6). The
# deferred route without fused dispatch read 0.2411, 0.2672, 0.2724, 0.2315
# and 0.2538, faster than blocking in only three pairs of five, so ``auto``
# leaves deferral off where the fused route does not apply (H100 80GB HBM3,
# 700 W; PERF.md)
AUTO_DEFER_CUDA = True


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


def resolve_defer_fetch(args, device=None, fused=False):
    """``defer_fetch``: ``auto`` (default) resolves to AUTO_DEFER_CUDA on a
    CUDA ``device`` when the fused route applies (``fused``, what
    ``resolve_fused_dispatch`` gave) and to off elsewhere; ``True`` /
    ``False`` force it.
    With deferral on, every batch after the first queues its accuracy
    behind its method and the host fetches the results of up to
    ``defer_flush_batches`` batches in one transfer. Accuracies are
    bit-identical, and the reported per-task time becomes the steady-state
    end-to-end wall clock (sampling + method + accuracy + fetch, amortised)
    rather than the method-only time, a conservative superset."""
    val = args.get("defer_fetch", "auto")
    if isinstance(val, str) and val.strip().lower() == "auto":
        on_cuda = device is not None and torch.device(device).type == "cuda"
        return AUTO_DEFER_CUDA and on_cuda and bool(fused)
    return _parse_flag(val, "defer_fetch")


def resolve_fused_dispatch(args, device_gather):
    """``fused_dispatch: auto`` (default) feeds each deferred batch from the
    tables on the device (methods/base.py ``run_task_fused``) whenever the
    device-gather path is active; ``True`` / ``False`` force it (it still
    needs device_gather, and engages only with defer_fetch). Accepts the
    string spellings of ``--opts`` (``bool('false')`` is True)."""
    val = args.get("fused_dispatch", "auto")
    if isinstance(val, str) and val.strip().lower() == "auto":
        return device_gather
    return _parse_flag(val, "fused_dispatch") and device_gather


def finalize_deferred(deferred, t_tail0, batch_size, results_task,
                      results_time, timer=None, group=None):
    """Fetch every deferred batch's handles in ONE transfer and append their
    per-task accuracies and times in batch order. ``t_tail0`` marks the
    start of the deferred window (the end of the blocking batch before
    it), so the amortised per-task time covers exactly the window's
    batches. Under a task ``group`` the ranks' accuracies are then gathered
    in one exchange of host values, and the time is the slowest rank's
    window over the whole batches (``batch_size`` is the whole batch)."""
    with timer.phase("deferred_fetch") if timer is not None else nullcontext():
        host = fetch_tree([r.handles for r in deferred])
    wall = time.perf_counter() - t_tail0
    per_task = wall / (len(deferred) * batch_size)
    logs = [res.finalize(h, per_task) for res, h in zip(deferred, host)]
    accs = [l["acc"][:, -1] for l in logs]
    times = [l["timestamps"] for l in logs]
    if group is not None:
        parts = gather_host((wall, accs), group)
        accs = [np.concatenate(a) for a in zip(*(p[1] for p in parts))]
        per_task = max(p[0] for p in parts) / (len(deferred) * batch_size)
        times = [per_task] * len(logs)
    results_task.extend(accs)
    results_time.extend(times)


def _maybe_task_group(args, group, method, logger=None):
    """The task group a batch is spread over (counterpart of the JAX
    ``_maybe_task_mesh``): ``group`` (the caller's parallel.TaskGroup) laid
    out as (dp, tp) from ``tp`` (``resolve_tp``: 0 picks
    ``choose_layout``'s layout for ``n_class`` where ``method`` shards its
    classes, else tp 1; a ``tp`` that does not divide the ranks raises
    JAX's ``ValueError``) when ``data_parallel`` is on. None — the single-device path — when it is off, when there is no
    group (one device), or when ``batch_size`` does not divide over dp:
    then every rank runs the whole batch and rank 0 reports. Every rank
    calls it, in the same order (a new layout creates process groups)."""
    if not _parse_flag(args.get("data_parallel", False), "data_parallel"):
        return None
    if group is None:
        if logger:
            logger.info("data_parallel: one device and no task group; "
                        "running single-device")
        return None
    group = class_layout(group, resolve_tp(
        args.get("tp", 0), group.world, args.get("n_class", 0),
        method.shards_classes, logger))
    if int(args.batch_size) % group.dp != 0:
        if logger:
            logger.info(
                f"data_parallel requested but batch_size={args.batch_size} "
                f"is not divisible by dp={group.dp}; running "
                "single-device on every rank")
        return None
    if logger:
        logger.info(f"data_parallel: task group {group.layout} over "
                    f"{group.world} ranks on {group.device}")
    return group


def mean_results(results_task, results_time, logger=None):
    """(mean accuracy, mean seconds per task) of an evaluation: the mean
    over batches of each batch's mean per-task accuracy, and of the times
    of the batches after the first, whose time includes warm-up (the
    allocator, the kernels' build and load)."""
    if len(results_time) > 1:
        results_time = results_time[1:]
    elif logger:
        logger.info("note: single-batch run — reported mean time includes "
                    "warm-up")
    acc = [compute_confidence_interval(a)[0] for a in results_task]
    return float(np.mean(acc)), float(np.mean(results_time))


def _device_gather(features_dev, idx):
    """Task rows gathered on the device: the feature table crosses once per
    evaluation, and per batch only the [n_task, n] indices."""
    return features_dev[torch.as_tensor(idx, device=features_dev.device)]


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
        evaluate over all tasks from the cache; with visual features
        (``use_softmax_feature: False``) the methods also read the CLIP text
        prototypes (``extraction.get_text_features``: cached, else computed
        with ``model``)."""
        args = self.args
        path = self.query_cache_path()
        if not os.path.exists(path):
            from .extraction import ensure_features

            ensure_features(args, model, preprocess,
                            splits=(args.used_test_set,), group=self.group)
        text_features = None
        if not args.use_softmax_feature:
            from .extraction import get_text_features

            text_features = get_text_features(args, model, group=self.group)
        features, labels = load_feature_cache(path)
        mean_acc, mean_time = self.evaluate_tasks(
            features, labels, text_features=text_features)
        self.report_results(mean_acc, mean_time)
        return mean_acc, mean_time

    # ------------------------------------------------------------------
    def evaluate_tasks(self, features, labels, text_features=None):
        """(mean accuracy, mean seconds per task); ``self.task_accuracies``
        keeps each batch's per-task accuracies [batch_size], in order."""
        args = self.args
        self._log(
            f"=> Running evaluation with method {args.name_method} "
            f"on {args.dataset} ({args.used_test_set} set)"
        )
        rng = np.random.default_rng(args.seed if args.seed is not None else None)
        method = get_zero_shot_method(
            args.name_method, device=self.device, args=args,
            log_file=self.log_file,
        )
        group = _maybe_task_group(args, self.group, method, self.logger)
        method.set_task_group(group)
        timer = PhaseTimer()
        # device-resident feature table: rows are gathered on the device
        # per batch (device_gather: False restores the host gather+stack)
        device_gather = bool(args.get("device_gather", True))
        if device_gather:
            features_dev = torch.as_tensor(np.asarray(features, np.float32),
                                           device=self.device)
            labels_np = np.asarray(labels)
            labels_dev = torch.as_tensor(labels_np, device=self.device)
        use_fused = resolve_fused_dispatch(args, device_gather)

        results_task, results_time = [], []
        n_batches = _resolve_n_batches(args, self.logger)
        # pools are RNG-free functions of the constant labels: built once
        # (hoisting is draw-order exact since only __iter__ consumes rng)
        sampler = CategoriesSamplerZeroShot(
            args.batch_size, args.k_eff, args.n_class, args.n_query,
            force_query_size=True, rng=rng,
        )
        sampler.create_list_classes(labels)
        defer = resolve_defer_fetch(args, self.device, use_fused)
        deferred, t_tail0 = [], None
        # every deferred batch holds its handles (and, with the auction,
        # its [N, R, C] prototype rows, 30 MB at the ImageNet protocol)
        # until fetched: a flush every ``defer_flush_batches`` batches caps
        # that while the fetch is still shared by the window (0 = never)
        flush_n = int(args.get("defer_flush_batches", 32) or 0)

        def settle():
            nonlocal deferred
            finalize_deferred(deferred, t_tail0, int(args.batch_size),
                              results_task, results_time, timer, group)
            deferred = []

        def queue(res):
            nonlocal t_tail0, batches_since_guard
            deferred.append(res)
            batches_since_guard += 1
            if flush_n and len(deferred) >= flush_n:
                settle()
                t_tail0 = time.perf_counter()

        # evaluator-routed periodic exactness guard: the deferred and fused
        # pipelines never host the method's guard, so every guard_every-th
        # batch runs through the blocking run_task with the guard forced —
        # its duplicate solve stays out of the timestamps through the
        # method's _untimed_overhead_s
        batches_since_guard = 0
        with trace_if_requested(args.get("profile_dir")):
            for b in range(n_batches):
                # re-read each batch: a tripped guard turns the fast path
                # (and so the cadence) off for the evaluation
                guard_every = int(method.guard_recheck_batches() or 0)
                guard_batch = (guard_every > 0 and b > 0
                               and batches_since_guard >= guard_every)
                if guard_batch:
                    method.request_guard_check()
                    if deferred:
                        # settle the open window first: the blocking guard
                        # batch would otherwise wait for the queued batches
                        # inside its own timing
                        settle()
                with timer.phase("sampling"):
                    idx = None
                    if device_gather:
                        # every rank draws the whole batch, then keeps its
                        # share of the tasks
                        idx = shard_task_batch(
                            np.stack(list(SamplerQueryZeroShot(sampler))),
                            group)
                if (defer and use_fused and b > 0 and idx is not None
                        and not guard_batch):
                    with timer.phase("dispatch"):
                        res = method.run_task_fused(
                            features_dev, labels_dev, idx,
                            text_features=text_features,
                        )
                    if res is not None:
                        queue(res)
                        continue
                    use_fused = False
                    self._log(
                        "fused_dispatch: configuration needs a host step "
                        "per batch; using per-program deferred dispatch"
                    )
                with timer.phase("sampling"):
                    if device_gather:
                        tasks = {
                            "x_q": _device_gather(features_dev, idx),
                            "y_q": labels_np[idx][..., None],
                        }
                    else:
                        loader = [
                            (features[idx], labels[idx])
                            for idx in SamplerQueryZeroShot(sampler)
                        ]
                        tasks = shard_task_batch(TasksGeneratorZeroShot(
                            k_eff=args.k_eff, n_query=args.n_query,
                            n_class=args.n_class, loader_query=loader,
                            args=args,
                        ).generate_tasks(), group)
                if text_features is not None:
                    tasks["text_features"] = text_features
                # batch 0 always runs blocking: it builds and loads the
                # kernels and hosts the method's first-batch guard
                if defer and b > 0 and not guard_batch:
                    with timer.phase("dispatch"):
                        res = method.run_task_deferred(tasks)
                    if res is not None:
                        queue(res)
                        continue
                    defer = False
                    self._log(
                        "defer_fetch: configuration needs a host step per "
                        "batch; falling back to blocking run_task"
                    )
                with timer.phase("method"):
                    logs = method.run_task(tasks)
                batches_since_guard = 0
                results_task.append(logs["acc"][:, -1])
                results_time.append(logs["timestamps"])
                if defer:
                    t_tail0 = time.perf_counter()   # a new deferred window

        if deferred:
            settle()
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
