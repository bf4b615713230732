"""Shared machinery for transductive methods (counterpart of
transductive_clip_tpu/methods/base.py).

Every method's math is a function of tensors on ``self.device`` (the card,
unless the caller passed ``device="cpu"``), batched over the leading task
axis. The classes here are thin host-side wrappers that provide the
reference-compatible ``run_task(task_dic) -> logs`` API
(reference: src/methods/zero_shot/em_dirichlet.py:100-121), time the method,
and run the once-per-batch cluster->class matching: on the host (the JV
solver, ``matching_backend: host``) or on the device (the batched auction
kernel, ``matching_backend: device``).

Besides the blocking ``run_task`` there are the evaluator pipelines:
``run_task_deferred`` queues the accuracy, matching and rename behind the
method and fetches nothing, and ``run_task_fused`` does the same for a
batch gathered on the device from resident feature and label tables. Both
return a ``DeferredTaskResult`` whose handles the evaluator fetches for
many batches in one transfer; accuracies and predictions are bit-equal to
``run_task``'s.

Under a task group (``set_task_group``, parallel/) ``run_task`` and the
pipelines take this rank's share of a batch; the methods' batch-wide
decisions and criterion traces are the whole batch's, and ``run_task``
returns the whole batch's accuracies and predictions.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..core.logger import Logger
from ..ops import cuda_auction
from ..ops.common import (
    EPS,
    device_sync,
    get_one_hot,
    rank_select_rows,
    resolve_device,
    to_host,
    top_rows,
)
from ..ops.matching import (
    basic_matching,
    cluster_prototypes,
    hungarian_matching,
    hungarian_matching_rows,
)
from ..parallel.task_parallel import gather_host, group_max, group_sum

# what ``matching_backend: auto`` resolves to on a CUDA device (on the CPU
# it is 'host', as the JAX package resolves it off the TPU). Chosen by the
# zero_shot_pipelines phase of chip_smoke.py, which times the steady
# zero-shot soft 'pallas' batch on both routes in turns: over three runs,
# five paired readings of 0.2523, 0.3192, 0.2643, 0.2300 and 0.2584 ms per
# task with the auction against 0.5098, 0.4173, 0.4365, 0.3855 and 0.4449
# with the host JV solver, whose [100, 75, 1000] prototype rows cross to
# the host every batch (H100 80GB HBM3, 700 W; PERF.md)
AUTO_MATCHING_CUDA = "device"


def unported(what: str, roadmap_item: str):
    """The error every entry point raises for a path still to port."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch/CUDA package yet "
        f"(ROADMAP.md: {roadmap_item})"
    )


def init_soft_assignments(query, cfg, text_features=None):
    """Initial soft assignments u0: the features themselves for softmax
    features, else softmax(T * normalize(q) @ text_features^T)
    (reference: soft_kmeans.py:185-197)."""
    if cfg.use_softmax_feature:
        return query
    if text_features is None:
        raise ValueError(
            "Visual-feature initialization requires CLIP text features; "
            "pass them in the task dict under 'text_features'."
        )
    q = query / torch.linalg.norm(query, dim=-1, keepdim=True)
    sims = torch.einsum("tnd,kd->tnk", q, text_features)
    return torch.softmax(cfg.T * sims, dim=-1)


def _select_impl(cfg, key):
    """Shared validate-and-resolve for the row-selection knobs ('auto' ->
    'topk'; 'rank' = the sort-free selection)."""
    v = str(cfg.get(key, "auto"))
    if v == "auto":
        return "topk"
    if v not in ("topk", "rank"):
        raise ValueError(
            f"unknown {key} {v!r}; expected 'auto', 'topk' or 'rank'"
        )
    return v


def _proto_select(cfg):
    """Row-selection implementation of the accuracy path."""
    return _select_impl(cfg, "proto_select")


def compact_select_impl(cfg):
    """Row-selection implementation of the EM compact step: 'topk'
    (mass-ordered) or 'rank' (sort-free covering selection,
    ops.common.rank_select_rows); 'auto' resolves to 'topk'."""
    return _select_impl(cfg, "compact_select")


def _matching_backend(cfg, device=None):
    """'host' (the JV solver) or 'device' (the batched auction kernel).
    'auto' (default) resolves to AUTO_MATCHING_CUDA on a CUDA ``device`` and
    to 'host' elsewhere, as the JAX package resolves it off the TPU."""
    backend = str(cfg.get("matching_backend", "auto"))
    if backend == "auto":
        on_cuda = device is not None and torch.device(device).type == "cuda"
        backend = AUTO_MATCHING_CUDA if on_cuda else "host"
    return backend


def fetch_tree(tree):
    """Host values of every tensor in ``tree`` (nested tuples and lists) in
    one counted transfer; everything else passes through."""
    tensors = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)

    walk(tree)
    got = to_host(*tensors) if tensors else ()
    host = iter(got if len(tensors) > 1 else (got,))

    def build(x):
        if isinstance(x, torch.Tensor):
            return next(host)
        if isinstance(x, (list, tuple)):
            return type(x)(build(y) for y in x)
        return x

    return build(tree)


def _fetch(*items):
    """Host values of ``items`` in one transfer (``fetch_tree``)."""
    return list(fetch_tree(list(items)))


def _host_accuracy(preds, y_q):
    """Per-task accuracy [N, 1] fp32 of host predictions, computed on the
    host on every route, so that the routes' accuracies are bit-equal."""
    acc = (np.asarray(preds) == np.asarray(y_q)).mean(axis=1, keepdims=True)
    return acc.astype(np.float32)


def _proto_rows_device(u, query, T, text_features, use_softmax: bool, R: int,
                       select: str = "topk"):
    """Cluster prototypes -> class probabilities on the device, compressed
    to the top-R clusters by population (R = min(K, n_query) always covers
    every cluster present in the predictions — exact, see ops/matching.py).

    Returns (preds [N,n], row_idx [N,R], row_probs [N,R,C], present [N,R]).
    """
    n_class = u.shape[2]
    preds = torch.argmax(u, dim=2)
    one_hot = get_one_hot(preds, n_class)                       # [N, n, K]
    counts = one_hot.sum(1)                                     # [N, K]
    if select == "rank":
        cnt_c, idx, _ = rank_select_rows(counts, R, thresh=EPS)
    else:
        cnt_c, idx = top_rows(counts, R)                        # [N, R]
    oh_c = torch.gather(one_hot, 2, idx[:, None, :].expand(-1, u.shape[1], -1))
    protos = torch.einsum("tnr,tnd->trd", oh_c, query)          # [N, R, d]
    present = cnt_c > EPS
    protos = protos / torch.clamp_min(cnt_c, EPS)[..., None]
    protos = protos * present[..., None]                        # empty -> 0
    if use_softmax:
        probs = protos
    else:
        norms = torch.linalg.norm(protos, dim=-1, keepdim=True)
        protos_n = protos / torch.clamp_min(norms, EPS)
        probs = torch.softmax(
            T * torch.einsum("trd,cd->trc", protos_n, text_features), dim=-1
        )
    return preds, idx, probs, present


def _accuracy_device(u, query, T, text_features, use_softmax: bool, R: int,
                     graph_matching: bool, select: str = "topk", group=None):
    """The zero-shot accuracy reduction on the device: prototypes ->
    cluster->class matching (the batched auction kernel, or the per-row
    argmax without ``graph_matching``) -> rename. Only the [N, n]
    predictions and the ``ok`` flag need to cross to the host; the [N, R, C]
    prototype rows stay on the device unless the rare budget-exhausted
    auction needs them (reference: eval_zero_shot.py:176-184 +
    utils.py:380-417).

    Returns (new_preds [N, n], ok 0-d bool tensor or None, preds [N, n],
    idx [N, R], probs [N, R, C]). Under a task ``group`` ``ok`` is the
    whole batch's, so every rank takes the host solver together, as the
    single-process batch would.
    """
    preds, idx, probs, present = _proto_rows_device(
        u, query, T, text_features, use_softmax, R, select)
    ok = None
    if graph_matching:
        cols = cuda_auction.auction_assign(probs * present[..., None])
        ok = (cols >= 0).all()
        if group is not None:
            ok = group_max((~ok).to(torch.int32), group) == 0
        cols = torch.clamp_min(cols, 0)
    else:
        cols = torch.argmax(probs, dim=-1)
    # rename via a dense match-select: each pred matches at most one present
    # row (top rows are distinct); unmatched preds -> 0, like the zero-filled
    # LUT of the host path
    match = ((preds[:, :, None] == idx[:, None, :])
             & present[:, None, :])                             # [N, n, R]
    new_preds = torch.where(match, cols[:, None, :].to(preds.dtype), 0).sum(2)
    return new_preds, ok, preds, idx, probs


def _accuracy_inputs(u, query, cfg, text_features):
    """Shared input preparation for the clustering-accuracy paths."""
    n_class = int(cfg.n_class)
    use_softmax = bool(cfg.use_softmax_feature)
    R = min(n_class, u.shape[1], u.shape[2])
    tf = None if use_softmax else torch.as_tensor(
        text_features, dtype=torch.float32, device=u.device)
    return u, query.to(torch.float32), tf, use_softmax, R, n_class


def clustering_accuracy(u, query, y_q, cfg, text_features=None, extras=(),
                        logger=None, group=None):
    """Zero-shot clustering accuracy with cluster->class matching
    (reference: em_dirichlet.py:61-92).

    Prototypes and their class probabilities are computed on the device
    over the present-cluster rows only (``proto_device: False`` switches to
    the all-host reference-shaped path). With ``graph_matching`` and the
    host backend the rows come back to the host for the JV solver; with the
    device backend the auction kernel matches them on the device
    (``_accuracy_device``), and only when its budget ran out (``ok``
    False) do they come back for the JV solver (``note_host_fallback``
    counts and reports it to ``logger``). ``extras`` (tensors or host
    values) ride the same host transfer. Returns (acc [N, 1], matched_preds
    [N, n]) and, when ``extras`` is non-empty, their host values as a third
    element. ``group``: the task group whose ranks hold the rest of the
    batch (the auction's fallback is decided for the whole batch).
    """
    y_q = np.asarray(y_q)
    if not bool(cfg.get("proto_device", True)):
        out = _clustering_accuracy_host(u, query, y_q, cfg, text_features,
                                        logger, group)
        return out + (_fetch(*extras),) if extras else out

    graph_matching = bool(cfg.graph_matching)
    u, query, tf, use_softmax, R, n_class = _accuracy_inputs(
        u, query, cfg, text_features
    )
    if graph_matching and _matching_backend(cfg, u.device) != "device":
        # host JV matching: the [N, R, C] prototype rows come back
        preds_d, idx_d, probs_d, _ = _proto_rows_device(
            u, query, float(cfg.T), tf, use_softmax, R, _proto_select(cfg))
        preds, idx_h, probs_h, *extras_h = _fetch(preds_d, idx_d, probs_d,
                                                  *extras)
        new_preds = hungarian_matching_rows(preds, idx_h, probs_h, n_class)
    else:
        new_preds_d, ok, preds_d, idx_d, probs_d = _accuracy_device(
            u, query, float(cfg.T), tf, use_softmax, R, graph_matching,
            _proto_select(cfg), group)
        new_preds, ok_h, *extras_h = _fetch(new_preds_d, ok, *extras)
        if ok_h is not None and not bool(ok_h):
            # the auction hit its round budget with unassigned rows
            # (pathological ties): the exact host solver instead of wrong
            # labels
            note_host_fallback(u.shape[0], logger)
            new_preds = hungarian_matching_rows(
                *_fetch(preds_d, idx_d, probs_d), n_class)
    acc = _host_accuracy(new_preds, y_q)
    return (acc, new_preds, extras_h) if extras else (acc, new_preds)


def _clustering_accuracy_host(u, query, y_q, cfg, text_features=None,
                              logger=None, group=None):
    """All-host accuracy path, shaped exactly like the reference
    (full-width float64 prototypes; reference: em_dirichlet.py:61-92)."""
    device = u.device
    u, query_np = _fetch(u, query)
    n_class = int(cfg.n_class)
    preds = u.argmax(axis=2)
    one_hot = (preds[..., None] == np.arange(n_class)).astype(np.float64)
    prototypes = cluster_prototypes(one_hot, query_np)

    if cfg.use_softmax_feature:
        probs = prototypes
    else:
        tf = np.asarray(text_features)
        norms = np.linalg.norm(prototypes, axis=-1, keepdims=True)
        protos_n = prototypes / np.maximum(norms, EPS)
        logits = cfg.T * protos_n @ tf.T
        logits -= logits.max(axis=-1, keepdims=True)
        e = np.exp(logits)
        probs = e / e.sum(axis=-1, keepdims=True)

    if bool(cfg.graph_matching):
        if _matching_backend(cfg, device) == "device":
            new_preds = device_matching(preds, one_hot, probs, device,
                                        logger, group)
        else:
            new_preds = hungarian_matching(preds, probs)
    else:
        new_preds = basic_matching(preds, probs)
    return _host_accuracy(new_preds, y_q), new_preds


def device_matching(preds, one_hot, probs, device, logger=None, group=None):
    """Cluster->class matching of the all-host path through the batched
    auction on ``device``: rows = the top-n_query clusters by population
    (absent clusters get constant-zero value rows, which cannot displace
    real rows from their optimum); the exact host solver when the auction's
    budget ran out in any task of the ``group``'s batch
    (``note_host_fallback``)."""
    n_task, n_query, n_class = one_hot.shape
    counts = one_hot.sum(axis=1)                              # [N, K]
    r = min(n_class, n_query)
    idx = np.argsort(-counts, axis=1)[:, :r]                  # [N, R]
    vals = np.take_along_axis(probs, idx[..., None], axis=1)  # [N, R, C]
    present = np.take_along_axis(counts, idx, axis=1) > 0
    vals = vals * present[..., None]
    cols = cuda_auction.auction_assign(
        torch.as_tensor(vals, dtype=torch.float32, device=device))
    cols, bad = to_host(cols, group_max((cols < 0).any().to(torch.int32),
                                        group))
    if bad:
        note_host_fallback(n_task, logger)
        return hungarian_matching(preds, probs)
    lut = np.zeros((n_task, n_class), preds.dtype)
    np.put_along_axis(lut, idx, cols.astype(preds.dtype), axis=1)
    return np.take_along_axis(lut, preds, axis=1)


def note_host_fallback(n_task, logger=None):
    """Count and report a batch whose auction ran out of rounds with rows
    unassigned (``ok`` False, pathological ties): its matching is then
    solved by the host JV solver, off the card, as the JAX package does.
    ``note_host_fallback.count`` counts such batches, so that a run can
    show that none of its batches left the card."""
    note_host_fallback.count += 1
    msg = (f"the device auction ran out of rounds in a batch of {n_task} "
           "tasks; its matching was solved by the host JV solver")
    if logger is not None:
        logger.warning(msg)
    else:
        warnings.warn(msg)


note_host_fallback.count = 0


def _warn_compaction(populated, n_compact, logger=None):
    if populated > n_compact:
        msg = (
            f"cluster compaction solved {n_compact} rows but up to "
            f"{populated} clusters carry mass at some iteration; results "
            "may deviate from the exact path — set compact_clusters False "
            "to verify"
        )
        if logger is not None:
            logger.warning(msg)
        else:
            warnings.warn(msg)


class PendingCompactionCheck:
    """The compaction sparsity check with its host fetch deferred to the
    accuracy transfer of ``run_task``. ``populated`` is the max
    populated-cluster count over every compact EM iteration (a host int or
    a device scalar), so an intermediate over-capacity iteration cannot
    pass a final-u-only check."""

    def __init__(self, populated, n_compact, logger=None):
        self.n_compact = n_compact
        self.logger = logger
        self.populated = populated

    def finish(self, populated_host=None):
        populated = int(self.populated if populated_host is None
                        else populated_host)
        _warn_compaction(populated, self.n_compact, self.logger)
        return populated


def direct_accuracy(u, y_q, extras=()):
    """Plain argmax accuracy (reference: few_shot/em_dirichlet.py:50-58);
    only [N, n] predictions cross to the host. ``extras`` ride the same
    transfer (see ``clustering_accuracy``)."""
    preds, *extras_h = _fetch(torch.argmax(torch.as_tensor(u), dim=2), *extras)
    acc = (preds == np.asarray(y_q)).mean(axis=1, keepdims=True)
    acc = acc.astype(np.float32)
    return (acc, preds, extras_h) if extras else (acc, preds)


class DeferredTaskResult:
    """One batch's ``run_task`` outputs with every host fetch deferred.

    ``handles`` is a tree of tensors on the device (plus host passthroughs
    like ``None``); the evaluator fetches the handles of many batches in one
    transfer (``fetch_tree``), so no host sync waits on batch b while batch
    b + 1 is sampled. ``finalize(host_values, elapsed_per_task)`` then
    builds the logs dict ``run_task`` returns; accuracy and predictions are
    bit-equal to the blocking path. Under a task group they are this rank's
    tasks': the evaluator gathers a window's over the group after its fetch
    (``eval.zero_shot.finalize_deferred``)."""

    def __init__(self, handles, finalize):
        self.handles = handles
        self._finalize = finalize

    def finalize(self, host_values, elapsed_per_task):
        return self._finalize(host_values, elapsed_per_task)


def split_infer_out(out):
    """Normalise an ``_infer`` result to (u, criterions, n_exec): methods
    with early stopping return the executed outer-iteration count as a
    third element; fixed-schedule ones return two, and ``n_exec`` is None."""
    if isinstance(out, tuple) and len(out) == 3:
        return out
    u, criterions = out
    return u, criterions, None


def timing_logs(elapsed, n_task, n_iter, iter_widths=None):
    """Timing metrics for ``run_task`` logs.

    ``timestamps`` is the honest total wall-clock per task. The reference
    records the *cumulative* elapsed time at the end of every outer
    iteration and reports their mean (reference: zero_shot/em_dirichlet.py:
    211,242-244 and get_logs :97); ``timestamps_cumulative`` and
    ``timestamps_ref`` synthesise that from a per-iteration cost model:
    uniform, or ``iter_widths`` (length ``n_iter``, each iteration's
    relative cost) when task compaction ran narrow iterations.
    """
    per_task = elapsed / n_task
    n = max(int(round(float(n_iter))), 1)
    if iter_widths is not None:
        if len(iter_widths) != n:
            raise ValueError(
                f"iter_widths length {len(iter_widths)} != executed count {n}")
        w = np.asarray(iter_widths, np.float64)
        cumulative = per_task * (np.cumsum(w) / w.sum())
    else:
        cumulative = per_task * (np.arange(1, n + 1) / n)
    return {
        "timestamps": per_task,
        "timestamps_cumulative": cumulative,
        "timestamps_ref": float(cumulative.mean()),
    }


def narrow_phase_widths(n_used, n_full, n_task, task_chunk, narrow):
    """Per-iteration relative costs for ``timing_logs`` when a method ran
    its first ``n_full`` iterations at the full batch width (the chunk
    width under ``task_chunk``) and the rest at a narrow straggler width
    ``narrow``; None (uniform) when no narrow phase ran."""
    n = max(int(round(float(n_used))), 1)
    if n_full is None or n_full >= n:
        return None
    full_w = int(n_task)
    if 0 < task_chunk < n_task and n_task % task_chunk == 0:
        full_w = task_chunk
    w = np.full(n, float(min(max(int(narrow), 1), full_w)))
    w[:max(int(n_full), 0)] = float(full_w)
    return w


def resolve_exec_count(n_exec):
    """Normalise a method's executed-count output to (n_used, n_full):
    a length-2 ``[total, full_width]`` vector (task compaction) or a
    scalar, whose ``n_full`` is None."""
    if n_exec is None:
        return None, None
    arr = np.asarray(n_exec)
    if arr.ndim == 1 and arr.size == 2:
        return float(arr[0]), int(arr[1])
    return float(arr), None


class TransductiveMethod:
    """Base wrapper. Subclasses set ``acc_mode`` and implement ``_infer``.

    ``device``: where the method runs — ``cuda:{args.device}`` when None
    (raises without a CUDA device), or whatever the caller passes, e.g.
    ``"cpu"``."""

    #: "clustering" -> matched clustering accuracy; "direct" -> argmax accuracy
    acc_mode = "clustering"
    #: True where ``_infer`` hands ``self.group`` to its loop, which then
    #: reduces its own decisions and criterion trace over the group; else
    #: the trace is a mean over the rank's tasks, which ``_infer_group``
    #: makes the whole batch's
    reduces_over_group = False

    def __init__(self, model=None, device=None, log_file=None, args=None):
        self.model = model
        self.device = resolve_device(device, args)
        self.args = args
        self.log_file = log_file
        self.logger = Logger(type(self).__name__, log_file) if log_file else None
        self.eps = EPS
        #: seconds of verification work (the compact_first guard) a method
        #: performed inside _infer that must not count toward its timing
        self._untimed_overhead_s = 0.0
        #: a PendingCompactionCheck made inside _infer; run_task fetches its
        #: scalar with the accuracy transfer
        self._pending_check = None
        #: True only while a blocking run_task executes _infer: exactness
        #: guards (a duplicate solve + host comparison) may only fire there
        self._guard_allowed = False
        #: the task group a batch is spread over (``set_task_group``)
        self.group = None

    def set_task_group(self, group):
        """Spread every batch over ``group`` (a parallel.TaskGroup; None:
        one device), the counterpart of the JAX ``set_mesh``: ``run_task``
        and the pipelines then take this rank's contiguous share of the
        tasks (``parallel.shard_task_batch``), the method's batch-wide
        decisions and criterion trace are the whole batch's, and
        ``run_task`` returns the whole batch's accuracies and predictions
        and the slowest rank's time."""
        self.group = group
        return self

    def _timing_iter_widths(self, n_used, n_full, n_task):
        """Per-iteration relative costs for ``timing_logs``, or None for
        uniform."""
        return None

    def _timing_logs_for(self, elapsed, n_task, n_exec, criterions):
        n_used, n_full = resolve_exec_count(n_exec)
        if n_used is None:
            n_used = len(criterions)
        return timing_logs(
            elapsed, n_task, n_used,
            iter_widths=self._timing_iter_widths(n_used, n_full, n_task),
        )

    # -- evaluator guard protocol ------------------------------------------
    def guard_recheck_batches(self):
        """Batches between evaluator-routed blocking guard re-checks; 0
        (default) = the method has no periodic exactness guard. Methods whose
        guard needs a host step (EM-Dirichlet's compact_first_iter) override
        it: the evaluator routes every M-th batch through the blocking
        ``run_task`` after :meth:`request_guard_check`, because the guard
        never fires inside the deferred and fused pipelines."""
        return 0

    def request_guard_check(self):
        """Ask the next blocking ``_infer`` to re-run its exactness guard;
        no-op for methods without one."""

    # -- subclass hook ----------------------------------------------------
    def _infer(self, task):
        """Run the method. Returns (u, criterions[, n_exec])."""
        raise NotImplementedError

    def _infer_group(self, task):
        """``_infer``, with the criterion trace made the whole batch's under
        a task group where the method's loop does not do it itself: every
        rank holds as many tasks, so the batch mean is the mean of the
        ranks' means."""
        out = self._infer(task)
        if self.group is None or self.reduces_over_group:
            return out
        u, criterions, n_exec = split_infer_out(out)
        criterions = group_sum(criterions, self.group) / self.group.world
        return u, criterions, n_exec

    def _infer_chunked(self, task):
        """Run ``_infer``, splitting the (independent) task axis into
        ``task_chunk``-sized slices when configured; criterion traces and
        executed counts are averaged across chunks. Under a task group each
        rank chunks its own share, and the ranks' i-th chunks run together
        as one batch: exact for the fixed-schedule methods; for the
        early-stopping ones, the tasks that share a stop test are those
        chunks'."""
        chunk = int(self.args.get("task_chunk", 0) or 0)
        n_task = task["x_q"].shape[0]
        if chunk <= 0 or n_task <= chunk or n_task % chunk != 0:
            if chunk > 0 and n_task % chunk != 0:
                self._log(
                    f"task_chunk={chunk} does not divide n_task={n_task}; "
                    "running unchunked"
                )
            return self._infer_group(task)
        sliced_keys = [
            k for k, v in task.items()
            if hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] == n_task
            and k != "text_features"
        ]
        us, crits, n_execs = [], [], []
        for s in range(0, n_task, chunk):
            sub = dict(task)
            for k in sliced_keys:
                sub[k] = task[k][s:s + chunk]
            u, crit, n_exec = split_infer_out(self._infer_group(sub))
            if self._pending_check is not None:
                # chunks would overwrite each other's deferred check
                pend = self._pending_check
                pend.finish(_fetch(pend.populated)[0])
                self._pending_check = None
            us.append(u)
            crits.append(np.asarray(_fetch(crit)[0]))
            n_execs.append(n_exec)
        u_all = torch.cat(us)
        crit_mean = np.mean(crits, axis=0)
        if all(n is not None for n in n_execs):
            return u_all, crit_mean, np.mean(
                [np.asarray(n) for n in n_execs], axis=0)
        return u_all, crit_mean

    # -- helpers ----------------------------------------------------------
    def _log(self, msg):
        if self.logger is not None:
            self.logger.info(msg)

    def _prepare_zero_shot(self, task_dic):
        query = torch.as_tensor(task_dic["x_q"], dtype=torch.float32,
                                device=self.device)
        # with softmax features the feature axis IS the class axis — a
        # mismatched K would otherwise surface as an opaque IndexError deep
        # in the cluster->class matching (ops/matching.py)
        n_class = self.args.get("n_class")
        if (n_class is not None and bool(self.args.get("use_softmax_feature", False))
                and query.shape[-1] != int(n_class)):
            raise ValueError(
                f"x_q feature dim {query.shape[-1]} != n_class {n_class}: "
                "softmax features must have one column per dataset class "
                "(set n_class / dataset to match the feature table)")
        y_q = np.asarray(task_dic["y_q"])
        if y_q.ndim == 3:
            y_q = y_q.squeeze(2)
        text_features = task_dic.get("text_features")
        if text_features is not None:
            text_features = torch.as_tensor(text_features, dtype=torch.float32,
                                            device=self.device)
        return query, y_q, text_features

    def _prepare_task(self, task_dic):
        """The task dict ``_infer`` takes (tensors on ``self.device``) and
        the host query labels [N, n]."""
        query, y_q, text_features = self._prepare_zero_shot(task_dic)
        task = dict(task_dic)
        task["x_q"] = query
        task["text_features"] = text_features
        return task, y_q

    def run_task(self, task_dic, shot=None):
        task, y_q = self._prepare_task(task_dic)
        query, text_features = task["x_q"], task["text_features"]

        t0 = time.perf_counter()
        self._untimed_overhead_s = 0.0
        self._pending_check = None
        self._guard_allowed = True
        try:
            u, criterions, n_exec = split_infer_out(self._infer_chunked(task))
        finally:
            self._guard_allowed = False
        u = device_sync(u)
        elapsed = time.perf_counter() - t0 - self._untimed_overhead_s

        # everything small rides ONE host transfer with the accuracy
        # outputs: the criterion trace, the executed-iteration count, and
        # the deferred compaction-check scalar
        pend = self._pending_check
        extras = (criterions, n_exec) + (
            (pend.populated,) if pend is not None else ()
        )
        if self.acc_mode == "clustering":
            acc, preds, extras = clustering_accuracy(
                u, query, y_q, self.args, text_features=text_features,
                extras=extras, logger=self.logger, group=self.group,
            )
        else:
            acc, preds, extras = direct_accuracy(u, y_q, extras=extras)
        criterions, n_exec = extras[0], extras[1]
        if pend is not None:
            pend.finish(extras[2])
        criterions = np.asarray(criterions)
        acc, preds, elapsed = self._whole_batch(acc, preds, elapsed)
        n_task = acc.shape[0]
        return {
            "acc": acc,
            "preds": preds,
            "criterions": criterions,
            **self._timing_logs_for(elapsed, n_task, n_exec, criterions),
        }

    def _whole_batch(self, acc, preds, elapsed):
        """Under a task group: every rank's per-task accuracies and
        predictions in task order, and the slowest rank's time (one gather
        of host values); else the arguments."""
        if self.group is None:
            return acc, preds, elapsed
        parts = gather_host((acc, preds, elapsed), self.group)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                max(p[2] for p in parts))

    # -- the evaluator pipelines -------------------------------------------
    def _declines_pipelines(self) -> bool:
        """Whether this configuration needs a host step per batch (task
        chunking, the host prototype path or host JV matching): the deferred
        and fused pipelines then return None and the evaluator runs
        ``run_task``."""
        cfg = self.args
        if int(cfg.get("task_chunk", 0) or 0) > 0:
            return True
        if self.acc_mode == "clustering":
            if not bool(cfg.get("proto_device", True)):
                return True
            if (bool(cfg.get("graph_matching", False))
                    and _matching_backend(cfg, self.device) != "device"):
                return True
        return False

    def _infer_untimed(self, task):
        """``_infer`` outside a blocking ``run_task``: no exactness guard
        fires (``_guard_allowed`` stays False); returns (u, criterions,
        n_exec, the pending compaction check)."""
        self._pending_check = None
        u, criterions, n_exec = split_infer_out(self._infer_group(task))
        pend, self._pending_check = self._pending_check, None
        return u, criterions, n_exec, pend

    def _deferred_result(self, u, query, y_q, text_features, criterions,
                         n_exec, pend):
        """Queue the accuracy behind the method and wrap the handles.

        ``y_q``: host labels or a tensor on the device. With
        ``graph_matching`` the [N, R, C] prototype rows stay held on the
        device until the finalizer has run: a budget-exhausted auction
        needs them for the host JV solver (the evaluator's
        ``defer_flush_batches`` bounds what they hold)."""
        cfg = self.args
        n_task = u.shape[0]
        populated = pend.populated if pend is not None else None
        held = None
        graph_matching = False
        if self.acc_mode == "clustering":
            graph_matching = bool(cfg.graph_matching)
            u, query, tf, use_softmax, R, n_class = _accuracy_inputs(
                u, query, cfg, text_features)
            new_preds, ok, preds, idx, probs = _accuracy_device(
                u, query, float(cfg.T), tf, use_softmax, R, graph_matching,
                _proto_select(cfg), self.group)
            if graph_matching:
                held = (preds, idx, probs)
        else:
            new_preds, ok = torch.argmax(u, dim=2), None
        handles = (new_preds, ok, y_q, criterions, n_exec, populated)

        def finalize(host, elapsed_per_task):
            new_preds, ok_h, y_q_h, crit, n_ex, populated_h = host
            if graph_matching and not bool(ok_h):
                note_host_fallback(n_task, self.logger)
                new_preds = hungarian_matching_rows(*fetch_tree(held),
                                                    int(cfg.n_class))
            return self._deferred_logs(
                _host_accuracy(new_preds, y_q_h), new_preds, crit, n_ex,
                populated_h, pend, elapsed_per_task, n_task)

        return DeferredTaskResult(handles, finalize)

    def run_task_deferred(self, task_dic, shot=None):
        """Run the method and queue the accuracy programs with no host sync
        after ``_infer`` (the method's own loop still reads its stop tests).

        Returns a :class:`DeferredTaskResult`, or ``None`` when this
        configuration needs a host step per batch (``_declines_pipelines``)
        — the caller then runs the blocking ``run_task``. Accuracy and
        predictions are bit-equal to ``run_task``; the per-batch method time
        is not measured (the caller gives ``finalize`` an amortised
        per-task time).
        """
        if self._declines_pipelines():
            return None
        task, y_q = self._prepare_task(task_dic)
        u, criterions, n_exec, pend = self._infer_untimed(task)
        return self._deferred_result(u, task["x_q"], y_q,
                                     task["text_features"], criterions,
                                     n_exec, pend)

    def _tf_device(self, text_features):
        """Text features on the device for the fused path, copied once per
        distinct host array (identity-keyed; the cache holds the array so
        its id cannot be reused)."""
        if text_features is None:
            return None
        cached = getattr(self, "_tf_dev_cache", None)
        if cached is not None and cached[0] is text_features:
            return cached[1]
        tf = torch.as_tensor(text_features, dtype=torch.float32,
                             device=self.device)
        self._tf_dev_cache = (text_features, tf)
        return tf

    def run_task_fused(self, features_dev, labels_dev, idx, shot=None,
                       text_features=None):
        """A batch fed from tables on the device: the query rows and labels
        are gathered on the device from ``features_dev`` [M, d] and
        ``labels_dev`` [M] by the host [n_task, n_query] index matrix ``idx``
        — the only per-batch input that crosses — then the method and the
        accuracy are queued as in ``run_task_deferred`` (same contract,
        same ``None``). JAX folds this into one jitted program; eager torch
        has no such trace, so it is the same work on device-resident inputs.
        """
        if self._declines_pipelines():
            return None
        if text_features is None and not bool(self.args.use_softmax_feature):
            return None     # visual-feature methods need the text prototypes
        tf = self._tf_device(text_features)
        idx_d = torch.as_tensor(idx, device=self.device)
        task = {"x_q": features_dev[idx_d], "y_q": labels_dev[idx_d],
                "text_features": tf}
        u, criterions, n_exec, pend = self._infer_untimed(task)
        return self._deferred_result(u, task["x_q"], task["y_q"], tf,
                                     criterions, n_exec, pend)

    def _deferred_logs(self, acc, preds, criterions, n_exec, populated,
                       pend, elapsed_per_task, n_task):
        if pend is not None:
            pend.finish(populated)
        criterions = np.asarray(criterions)
        return {
            "acc": np.asarray(acc),
            "preds": np.asarray(preds),
            "criterions": criterions,
            **self._timing_logs_for(
                elapsed_per_task * n_task, n_task, n_exec, criterions),
        }


class FewShotMethod(TransductiveMethod):
    """Base of the few-shot methods: support features and labels ride with
    the query, and accuracy is the direct argmax."""

    acc_mode = "direct"

    def _prepare_task(self, task_dic):
        task, y_q = super()._prepare_task(task_dic)
        y_s = np.asarray(task_dic["y_s"])
        if y_s.ndim == 3:
            y_s = y_s.squeeze(2)
        task["x_s"] = torch.as_tensor(task_dic["x_s"], dtype=torch.float32,
                                      device=self.device)
        task["y_s"] = torch.as_tensor(y_s, dtype=torch.int64,
                                      device=self.device)
        return task, y_q

    def run_task_fused(self, feats_s_dev, feats_q_dev, labels_s_dev,
                       labels_q_dev, idx_s, idx_q, shot=None,
                       text_features=None):
        """A few-shot batch fed from tables on the device (see
        ``TransductiveMethod.run_task_fused``): support and query rows and
        labels gathered on the device by the two host index matrices. The
        tables are in the method's label space already: the evaluator
        applies the softmax remap (label flip, column reversal) to them
        once."""
        if self._declines_pipelines():
            return None
        if text_features is None and not bool(self.args.use_softmax_feature):
            # visual-feature methods need the text prototypes; planting
            # zeros would give a uniform init where run_task raises
            return None
        idx_s = torch.as_tensor(idx_s, device=self.device)
        idx_q = torch.as_tensor(idx_q, device=self.device)
        task = {"x_s": feats_s_dev[idx_s], "y_s": labels_s_dev[idx_s],
                "x_q": feats_q_dev[idx_q], "y_q": labels_q_dev[idx_q],
                "text_features": self._tf_device(text_features)}
        u, criterions, n_exec, pend = self._infer_untimed(task)
        return self._deferred_result(u, task["x_q"], task["y_q"], None,
                                     criterions, n_exec, pend)
