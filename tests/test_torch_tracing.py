"""The port's span and counter registry (core/profiling.py): the counts a
zero-shot EM-Dirichlet evaluation records in its evaluator's PhaseTimer
equal hand counts of the same work, the spans enter a profiler range only
while a profiler records, and ``span``/``count`` are inert with no timer
active. Each EM iteration is one span ``em.step`` with the solver's spans
inside it, and each evaluation's feature upload and sampler pools one
phase each, ``upload`` and ``class_pools``, in the zero-shot and the
few-shot evaluator."""

import os

import numpy as np
import pytest
import torch

from transductive_clip_tpu_torch.core import profiling
from transductive_clip_tpu_torch.core.config import load_full_config
from transductive_clip_tpu_torch.core.profiling import PhaseTimer, count, span
from transductive_clip_tpu_torch.eval import (
    EvaluatorFewShot,
    EvaluatorZeroShot,
)
from transductive_clip_tpu_torch.eval import few_shot as fs_eval
from transductive_clip_tpu_torch.eval import zero_shot as zs_eval
from transductive_clip_tpu_torch.methods.few_shot import em_dirichlet as fs_em
from transductive_clip_tpu_torch.methods.zero_shot import em_dirichlet as zs_em
from transductive_clip_tpu_torch.ops import common
from transductive_clip_tpu_torch.ops import dirichlet as td
from transductive_clip_tpu_torch.parallel import task_parallel as tp
from transductive_clip_tpu_torch.utils.synthetic import make_few_shot_tasks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASS = 47          # dtd: wide enough that cluster compaction engages
N_QUERY = 5           # compact width min(47, 5 + 16) = 21


def _features(seed, n_per_class=8):
    rng = np.random.default_rng(seed)
    feats, labels = [], []
    for c in range(N_CLASS):
        alpha = np.ones(N_CLASS)
        alpha[c] += 60.0
        feats.append(rng.dirichlet(alpha, size=n_per_class).astype(np.float32))
        labels.append(np.full(n_per_class, c, np.int64))
    return np.concatenate(feats), np.concatenate(labels)


def _cfg(batches=2, batch_size=3):
    return load_full_config(
        opts=["dataset", "dtd", "method", "em_dirichlet", "shots", "0",
              "n_query", str(N_QUERY), "batch_size", str(batch_size),
              "number_tasks", str(batches * batch_size), "iter", "8",
              "save_results", "False"],
        config_root=os.path.join(REPO, "config"))


@pytest.fixture
def evaluator_timers(monkeypatch):
    """Every PhaseTimer the zero-shot evaluator makes, as the benchmark's
    harness records them."""
    made = []

    class Recorded(PhaseTimer):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(zs_eval, "PhaseTimer", Recorded)
    return made


@pytest.fixture
def hand_counts(monkeypatch):
    """Hand counts of the solves under the evaluator: each EM solve's
    executed iterations (``return_iter_split``), each Newton-Minka solve's
    steps (its calls of ``inv_digamma_and_deriv``, one a step) and row
    width."""
    got = {"em": [], "newton": []}
    infer = zs_em.em_dirichlet_infer
    newton = td.minka_newton_update_alpha
    step = td.inv_digamma_and_deriv
    calls = [0]

    def counted_infer(*args, **kw):
        out = infer(*args, **kw)
        if kw.get("return_iter_split"):
            got["em"].append(int(out[2][0]))
        return out

    def counted_step(*args, **kw):
        calls[0] += 1
        return step(*args, **kw)

    def counted_newton(alpha0, *args, **kw):
        before = calls[0]
        out = newton(alpha0, *args, **kw)
        got["newton"].append((calls[0] - before, alpha0.shape[-2]))
        return out

    monkeypatch.setattr(zs_em, "em_dirichlet_infer", counted_infer)
    monkeypatch.setattr(td, "minka_newton_update_alpha", counted_newton)
    monkeypatch.setattr(td, "inv_digamma_and_deriv", counted_step)
    return got


def test_zero_shot_evaluation_counts_match_hand_counts(evaluator_timers,
                                                       hand_counts):
    feats, labels = _features(1)
    syncs0 = common.to_host.syncs
    EvaluatorZeroShot(device="cpu", args=_cfg()).evaluate_tasks(feats,
                                                                labels)
    syncs = common.to_host.syncs - syncs0
    (timer,) = evaluator_timers
    tot = timer.totals
    # batch 0 hosts the compact_first guard: its exact re-solve counts
    assert len(hand_counts["em"]) == 3
    assert tot["em.iterations"] == sum(hand_counts["em"])
    steps = [s for s, _ in hand_counts["newton"]]
    assert tot["newton.steps"] == sum(steps) > 0
    assert tot["newton.row_steps"] == sum(s * w for s, w in
                                          hand_counts["newton"])
    # full width (the guard's exact first iteration) and compact
    assert {N_CLASS, N_QUERY + 16} <= {w for _, w in hand_counts["newton"]}
    assert timer.counts["newton"] == len(hand_counts["newton"])
    assert timer.counts["host_wait"] == syncs > 0
    assert 0 < tot["host_wait"] < tot["method"]
    assert 0 < tot["newton"] < tot["method"]
    assert "em.iterations: " in timer.summary()
    assert f"em.iterations: {sum(hand_counts['em'])} counted" in (
        timer.summary())


def test_a_timer_active_around_an_evaluation_sees_what_it_recorded(
        evaluator_timers):
    feats, labels = _features(2)
    with PhaseTimer().active() as outer:
        EvaluatorZeroShot(device="cpu", args=_cfg(batches=1)).evaluate_tasks(
            feats, labels)
    (inner,) = evaluator_timers
    assert profiling._sink is None
    for name in ("em.iterations", "newton.steps", "newton.row_steps",
                 "host_wait", "newton", "method"):
        assert outer.totals[name] == inner.totals[name] > 0, name
        assert outer.counts[name] == inner.counts[name], name
    assert outer.counters == inner.counters


def test_few_shot_em_counts_its_iterations():
    rng = np.random.default_rng(3)
    xs, ys, xq, _ = make_few_shot_tasks(rng, 2, 10, 12, 2)
    with PhaseTimer().active() as timer:
        _, _, n_exec, _ = fs_em.em_dirichlet_fs_infer(
            torch.as_tensor(xs), torch.as_tensor(xq), torch.as_tensor(ys),
            50.0, n_iter=6, iter_mm=100, n_class=12, hard=False,
            solver="minka", return_n_iter=True)
    assert timer.totals["em.iterations"] == n_exec > 0
    assert timer.totals["newton.steps"] > 0


def _newton_solve():
    rng = np.random.default_rng(4)
    a0 = torch.ones((2, 6, 6))
    y = torch.as_tensor(np.log(rng.dirichlet(np.ones(6), size=(2, 6))),
                        dtype=torch.float32)
    return td.minka_newton_update_alpha(a0, y)


def test_no_profiler_range_is_entered_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with PhaseTimer().active() as timer:
        with timer.phase("sampling"):
            _newton_solve()
        with span("outside"):
            pass
    assert {"sampling", "newton", "host_wait", "outside"} <= set(timer.totals)
    feats, labels = _features(5)
    EvaluatorZeroShot(device="cpu", args=_cfg(batches=1)).evaluate_tasks(
        feats, labels)


def test_spans_are_profiler_ranges_while_a_profiler_records():
    from torch.profiler import ProfilerActivity, profile

    feats, labels = _features(6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        EvaluatorZeroShot(device="cpu", args=_cfg(batches=1)).evaluate_tasks(
            feats, labels)
    annotated = {e.name() for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation()}
    assert {"newton", "host_wait", "sampling", "method"} <= annotated


def test_span_and_count_without_a_timer_record_nothing():
    assert profiling._sink is None
    idle = PhaseTimer()
    with span("host_wait"):
        count("em.iterations", 5)
    count("newton.steps")
    _newton_solve()
    common.to_host(torch.ones(2))
    assert not idle.totals and not idle.counts
    assert profiling._sink is None


def test_active_restores_the_previous_sink():
    outer, inner = PhaseTimer(), PhaseTimer()
    with outer.active():
        assert profiling._sink is outer
        with inner.active():
            assert profiling._sink is inner
            count("a", 2)
        assert profiling._sink is outer
        with pytest.raises(RuntimeError):
            with inner.active():
                count("a", 3)
                raise RuntimeError("inside")
        assert profiling._sink is outer
        count("b")
    assert profiling._sink is None
    assert inner.totals == {"a": 5}
    assert outer.totals == {"a": 5, "b": 1}
    assert outer.counts == {"a": 2, "b": 1}
    assert outer.counters == {"a", "b"}
    with outer.active():
        with span("s"):
            pass
    assert "s: " in outer.summary() and "s over 1 calls" in outer.summary()
    assert "a: 5 counted" in outer.summary()


def test_parallel_counters_land_in_the_active_timer(tmp_path):
    from transductive_clip_tpu_torch.parallel import (
        destroy_task_group,
        make_task_group,
    )

    for fn, attrs in ((tp.all_reduce, ("calls", "bytes")),
                      (tp.gather_host, ("calls",))):
        assert not any(hasattr(fn, a) for a in attrs)
    group = make_task_group(0, 1, str(tmp_path / "store"), device="cpu")
    try:
        with PhaseTimer().active() as timer:
            tp.group_max(torch.ones(3, dtype=torch.float32), group)
            tp.gather_host({"x": 1}, group)
    finally:
        destroy_task_group(group)
    assert timer.totals["parallel.all_reduce_calls"] == 1
    assert timer.totals["parallel.all_reduce_bytes"] == 12
    assert timer.totals["parallel.gather_host_calls"] == 1
    assert timer.counters == {"parallel.all_reduce_calls",
                              "parallel.all_reduce_bytes",
                              "parallel.gather_host_calls"}


def _fs_cfg(batches=2, batch_size=3):
    return load_full_config(
        opts=["dataset", "dtd", "method", "em_dirichlet", "shots", "2",
              "n_query", str(N_QUERY), "batch_size", str(batch_size),
              "number_tasks", str(batches * batch_size), "iter", "8",
              "save_results", "False"],
        config_root=os.path.join(REPO, "config"))


def _evaluate(kind, seed, batches=2):
    """One CPU evaluation of EM-Dirichlet through the ``kind`` evaluator
    (the few-shot one draws its support from a second table)."""
    feats, labels = _features(seed)
    if kind == "zero_shot":
        EvaluatorZeroShot(device="cpu", args=_cfg(batches)).evaluate_tasks(
            feats, labels)
    else:
        support, support_labels = _features(seed + 100)
        EvaluatorFewShot(device="cpu", args=_fs_cfg(batches)).evaluate_tasks(
            support, support_labels, feats, labels)


@pytest.fixture
def timers_of_both(monkeypatch):
    """Every PhaseTimer either evaluator makes."""
    made = []

    class Recorded(PhaseTimer):
        def __init__(self):
            super().__init__()
            made.append(self)

    monkeypatch.setattr(zs_eval, "PhaseTimer", Recorded)
    monkeypatch.setattr(fs_eval, "PhaseTimer", Recorded)
    return made


def test_em_step_spans_every_iteration_the_guard_included(evaluator_timers,
                                                           hand_counts):
    feats, labels = _features(7)
    EvaluatorZeroShot(device="cpu", args=_cfg()).evaluate_tasks(feats,
                                                                labels)
    (timer,) = evaluator_timers
    # batch 0 hosts the compact_first guard: its exact re-solve runs the
    # same loop
    assert len(hand_counts["em"]) == 3
    assert timer.counts["em.step"] == timer.totals["em.iterations"] == sum(
        hand_counts["em"])
    # the solves lie inside the steps, the steps inside the method
    assert 0 < timer.totals["newton"] < timer.totals["em.step"]
    assert timer.totals["em.step"] < timer.totals["method"]


@pytest.mark.parametrize("kind", ["zero_shot", "few_shot"])
def test_em_step_count_equals_the_em_iterations(kind, timers_of_both):
    _evaluate(kind, 8)
    (timer,) = timers_of_both
    assert timer.counts["em.step"] == timer.totals["em.iterations"] > 0
    assert "em.step" not in timer.counters


@pytest.mark.parametrize("n_class,compact", [(12, True), (47, True),
                                             (47, False)])
def test_few_shot_em_step_count_equals_its_iterations(n_class, compact):
    """At 47 classes and 5 queries cluster compaction engages, so the
    transition step and the compact steps run; at 12 it does not."""
    rng = np.random.default_rng(9)
    xs, ys, xq, _ = make_few_shot_tasks(rng, 2, N_QUERY, n_class, 2)
    with PhaseTimer().active() as timer:
        _, _, n_exec, _ = fs_em.em_dirichlet_fs_infer(
            torch.as_tensor(xs), torch.as_tensor(xq), torch.as_tensor(ys),
            50.0, n_iter=6, iter_mm=100, n_class=n_class, hard=False,
            solver="minka", early_stop=False, compact=compact,
            return_n_iter=True)
    assert timer.counts["em.step"] == timer.totals["em.iterations"] == (
        n_exec) == 6


@pytest.mark.parametrize("kind,phase", [("zero_shot", "upload"),
                                        ("few_shot", "upload"),
                                        ("zero_shot", "class_pools"),
                                        ("few_shot", "class_pools")])
def test_a_set_up_phase_is_recorded_once_an_evaluation(kind, phase,
                                                       timers_of_both):
    with PhaseTimer().active() as outer:
        _evaluate(kind, 10)
    (timer,) = timers_of_both
    assert timer.counts[phase] == outer.counts[phase] == 1
    assert timer.totals[phase] == outer.totals[phase] > 0
    assert f"{phase}: " in timer.summary()
    assert phase not in timer.counters
    assert profiling._sink is None


def _ranges(prof, name):
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name() == name]


def _inside(inner, outers):
    return any(s <= inner[0] and inner[1] <= t for s, t in outers)


@pytest.mark.parametrize("kind", ["zero_shot", "few_shot"])
def test_em_step_and_upload_are_ranges_around_the_solver_spans(kind):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _evaluate(kind, 11, batches=1)
    steps, uploads = _ranges(prof, "em.step"), _ranges(prof, "upload")
    newton, waits = _ranges(prof, "newton"), _ranges(prof, "host_wait")
    assert len(uploads) == len(_ranges(prof, "class_pools")) == 1
    assert steps and newton and waits
    assert any(_inside(w, steps) for w in waits)
    inside = [_inside(n, steps) for n in newton]
    if kind == "zero_shot":
        # every zero-shot solve is an EM iteration's
        assert all(inside)
    else:
        # the few-shot pure-support solve runs between iterations 1 and 2
        assert any(inside)
    assert not any(_inside(u, steps) for u in uploads)


@pytest.mark.parametrize("kind", ["zero_shot", "few_shot"])
def test_em_step_and_upload_enter_no_range_without_a_profiler(kind,
                                                              monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _evaluate(kind, 12, batches=1)
    assert profiling._sink is None


@pytest.mark.parametrize("kind", ["zero_shot", "few_shot"])
def test_em_step_records_nothing_without_a_timer(kind, monkeypatch):
    def refuse(self, *args, **kwargs):
        raise AssertionError("recorded with no timer active")

    monkeypatch.setattr(PhaseTimer, "_record", refuse)
    assert profiling._sink is None
    rng = np.random.default_rng(13)
    if kind == "zero_shot":
        feats, _ = _features(13)
        x = torch.as_tensor(feats[rng.choice(len(feats), (2, N_QUERY))])
        zs_em.em_dirichlet_infer(x, 50.0, n_iter=4, iter_mm=100, hard=False,
                                 solver="minka", compact_first=True)
    else:
        xs, ys, xq, _ = make_few_shot_tasks(rng, 2, N_QUERY, N_CLASS, 2)
        fs_em.em_dirichlet_fs_infer(
            torch.as_tensor(xs), torch.as_tensor(xq), torch.as_tensor(ys),
            50.0, n_iter=4, iter_mm=100, n_class=N_CLASS, hard=False,
            solver="minka")
