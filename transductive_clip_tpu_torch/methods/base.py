"""Shared machinery for transductive methods (counterpart of
transductive_clip_tpu/methods/base.py, along its blocking path).

Every method's math is a function of tensors on ``self.device`` (the card,
unless the caller passed ``device="cpu"``), batched over the leading task
axis. The classes here are thin host-side wrappers that provide the
reference-compatible ``run_task(task_dic) -> logs`` API
(reference: src/methods/zero_shot/em_dirichlet.py:100-121), time the method,
and run the once-per-batch cluster->class matching on the host.

Not ported yet (ROADMAP.md): the deferred and fused evaluator pipelines
(``run_task_deferred``, ``run_task_fused`` raise) and the device auction
(``matching_backend: device``).
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..core.logger import Logger
from ..ops.common import (
    EPS,
    device_sync,
    get_one_hot,
    rank_select_rows,
    resolve_device,
    to_host,
    top_rows,
)
from ..ops.matching import basic_matching, cluster_prototypes, hungarian_matching


# the ROADMAP.md item of the deferred and fused pipelines and the auction
PIPELINES = "'evaluator pipelines and device auction'"


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


def _matching_backend(cfg):
    """'auto' (default) resolves to the host JV solver, as it does in the
    JAX package off the TPU; the device auction is not ported yet."""
    backend = str(cfg.get("matching_backend", "auto"))
    if backend == "auto":
        backend = "host"
    if backend == "device":
        raise unported("matching_backend: device (the batched auction)",
                       PIPELINES)
    return backend


def _fetch(*items):
    """Host values of ``items`` in one transfer: tensors are copied
    together (one counted sync), everything else passes through."""
    pos = [i for i, x in enumerate(items) if isinstance(x, torch.Tensor)]
    host = list(items)
    if pos:
        got = to_host(*(items[i] for i in pos))
        got = got if len(pos) > 1 else (got,)
        for i, v in zip(pos, got):
            host[i] = v
    return host


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


def _accuracy_inputs(u, query, cfg, text_features):
    """Shared input preparation for the clustering-accuracy paths."""
    n_class = int(cfg.n_class)
    use_softmax = bool(cfg.use_softmax_feature)
    R = min(n_class, u.shape[1], u.shape[2])
    tf = None if use_softmax else torch.as_tensor(
        text_features, dtype=torch.float32, device=u.device)
    return u, query.to(torch.float32), tf, use_softmax, R, n_class


def clustering_accuracy(u, query, y_q, cfg, text_features=None, extras=()):
    """Zero-shot clustering accuracy with cluster->class matching
    (reference: em_dirichlet.py:61-92).

    Prototypes and their class probabilities are computed on the device
    over the present-cluster rows only (``proto_device: False`` switches to
    the all-host reference-shaped path). With ``graph_matching`` the rows
    come back to the host for the JV solver; without it the per-row argmax
    runs on the device. ``extras`` (tensors or host values) ride the same
    host transfer. Returns (acc [N, 1], matched_preds [N, n]) and, when
    ``extras`` is non-empty, their host values as a third element.
    """
    y_q = np.asarray(y_q)
    if not bool(cfg.get("proto_device", True)):
        out = _clustering_accuracy_host(u, query, y_q, cfg, text_features)
        return out + (_fetch(*extras),) if extras else out

    from ..ops.matching import hungarian_matching_rows

    graph_matching = bool(cfg.graph_matching)
    u, query, tf, use_softmax, R, n_class = _accuracy_inputs(
        u, query, cfg, text_features
    )
    preds_d, idx_d, probs_d, present = _proto_rows_device(
        u, query, float(cfg.T), tf, use_softmax, R, _proto_select(cfg),
    )
    if graph_matching:
        _matching_backend(cfg)
        # host JV matching: the [N, R, C] prototype rows come back
        preds, idx_h, probs_h, *extras_h = _fetch(preds_d, idx_d, probs_d,
                                                  *extras)
        new_preds = hungarian_matching_rows(preds, idx_h, probs_h, n_class)
    else:
        # rename via a match-select: each pred matches at most one present
        # row (top rows are distinct); unmatched preds -> 0
        cols = torch.argmax(probs_d, dim=-1)
        match = ((preds_d[:, :, None] == idx_d[:, None, :])
                 & present[:, None, :])                         # [N, n, R]
        new_preds_d = torch.where(match, cols[:, None, :], 0).sum(2)
        new_preds, *extras_h = _fetch(new_preds_d, *extras)
    acc = (new_preds == y_q).mean(axis=1, keepdims=True).astype(np.float32)
    return (acc, new_preds, extras_h) if extras else (acc, new_preds)


def _clustering_accuracy_host(u, query, y_q, cfg, text_features=None):
    """All-host accuracy path, shaped exactly like the reference
    (full-width float64 prototypes; reference: em_dirichlet.py:61-92)."""
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
        _matching_backend(cfg)
        new_preds = hungarian_matching(preds, probs)
    else:
        new_preds = basic_matching(preds, probs)

    acc = (new_preds == y_q).mean(axis=1, keepdims=True)
    return acc.astype(np.float32), new_preds


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

    # -- subclass hook ----------------------------------------------------
    def _infer(self, task):
        """Run the method. Returns (u, criterions[, n_exec])."""
        raise NotImplementedError

    def _infer_chunked(self, task):
        """Run ``_infer``, splitting the (independent) task axis into
        ``task_chunk``-sized slices when configured; criterion traces and
        executed counts are averaged across chunks."""
        chunk = int(self.args.get("task_chunk", 0) or 0)
        n_task = task["x_q"].shape[0]
        if chunk <= 0 or n_task <= chunk or n_task % chunk != 0:
            if chunk > 0 and n_task % chunk != 0:
                self._log(
                    f"task_chunk={chunk} does not divide n_task={n_task}; "
                    "running unchunked"
                )
            return self._infer(task)
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
            u, crit, n_exec = split_infer_out(self._infer(sub))
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
        n_task = query.shape[0]

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
                extras=extras,
            )
        else:
            acc, preds, extras = direct_accuracy(u, y_q, extras=extras)
        criterions, n_exec = extras[0], extras[1]
        if pend is not None:
            pend.finish(extras[2])
        criterions = np.asarray(criterions)
        return {
            "acc": acc,
            "preds": preds,
            "criterions": criterions,
            **self._timing_logs_for(elapsed, n_task, n_exec, criterions),
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

    def run_task_fused(self, *args, **kwargs):
        raise unported("run_task_fused (the fused one-dispatch pipeline)",
                       PIPELINES)

    def run_task_deferred(self, *args, **kwargs):
        raise unported("run_task_deferred (the deferred-fetch pipeline)",
                       PIPELINES)
