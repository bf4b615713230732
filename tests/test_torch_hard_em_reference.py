"""The port's zero-shot EM-Dirichlet, soft and hard, against the plain
reference that the benchmark's task cells check it with
(``benchmark/reference/em_dirichlet.py``, loaded by path: it imports
nothing of the port and no JAX), on seeded tasks of Dirichlet-drawn
softmax features.

The method runs through its entry points as the evaluator drives them:
the blocking ``run_task`` and the fused ``run_task_fused`` (query rows
gathered on the device, the device auction's matching), with cluster
compaction on (its ``compact_first`` guard too) and off, at two sizes:
[6, 20, 80], where compaction engages and every hard step after the first
fits the 32-row fast tier, and [6, 10, 60], where compaction engages and
the compact width (26 rows) leaves no fast tier. Required: the matched
predictions equal the reference's, every EM solve runs as many iterations
as the reference's longest task, and on hard assignments a cluster of one
query takes the Newton-Minka solve to its 30-step cap, as it takes the
reference's. The compact counters (``em.compact_steps``,
``em.fast_steps``, ``em.populated``) are held to what the steps saw."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from transductive_clip_tpu_torch.core.config import load_full_config
from transductive_clip_tpu_torch.core.profiling import PhaseTimer
from transductive_clip_tpu_torch.methods import get_zero_shot_method
from transductive_clip_tpu_torch.methods.base import fetch_tree
from transductive_clip_tpu_torch.methods.zero_shot import em_dirichlet as tem
from transductive_clip_tpu_torch.ops import dirichlet as tdir

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO, "config")
SEED = 2 ** 31 + 2701
NEWTON_CAP = 30


def load_reference():
    """benchmark/reference/em_dirichlet.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "bench_reference_em_dirichlet_under_test",
        os.path.join(REPO, "benchmark", "reference", "em_dirichlet.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = load_reference()


def dirichlet_tasks(seed, n_task, n_query, n_class, k_eff=5,
                    concentration=30.0):
    """Tasks of ``k_eff`` classes each: every query a Dirichlet draw with
    ``concentration`` added at its class. Returns the features as a table
    [n_task * n_query, K] (task t's queries at rows t n .. (t+1) n - 1),
    its labels, and the [n_task, n_query] row indices of each task."""
    rng = np.random.default_rng(seed)
    feats, labels = [], []
    for _ in range(n_task):
        classes = rng.choice(n_class, size=k_eff, replace=False)
        y = classes[rng.integers(0, k_eff, size=n_query)]
        a = np.ones((n_query, n_class))
        a[np.arange(n_query), y] += concentration
        feats.append(np.stack([rng.dirichlet(r) for r in a]))
        labels.append(y)
    idx = np.arange(n_task * n_query).reshape(n_task, n_query)
    return (np.concatenate(feats).astype(np.float32),
            np.concatenate(labels).astype(np.int64), idx)


def method(hard, n_query, n_class, n_task, compact):
    cfg = load_full_config(opts=[
        "dataset", "imagenet",
        "method", "hard_em_dirichlet" if hard else "em_dirichlet",
        "shots", "0", "num_classes_test", str(n_class),
        "n_query", str(n_query), "batch_size", str(n_task), "T", "30",
        "matching_backend", "device", "compact_clusters", str(compact)],
        config_root=CONFIG_ROOT)
    return get_zero_shot_method(cfg.name_method, device="cpu", args=cfg)


def run_route(m, route, feats, labels, idx):
    """The batch's logs through the blocking or the fused entry."""
    if route == "blocking":
        return m.run_task({"x_q": feats[idx], "y_q": labels[idx]})
    res = m.run_task_fused(torch.as_tensor(feats), torch.as_tensor(labels),
                           idx)
    assert res is not None, "the fused route declined the batch"
    return res.finalize(fetch_tree(res.handles), 0.0)


@pytest.fixture
def solves(monkeypatch):
    """Every count the EM loop and the Newton-Minka solve make, in order:
    [(name, n)]."""
    seen = []

    def recorder(count):
        def record(name, n=1):
            seen.append((name, n))
            count(name, n)
        return record

    monkeypatch.setattr(tem, "count", recorder(tem.count))
    monkeypatch.setattr(tdir, "count", recorder(tdir.count))
    return seen


SHAPES = {"fast-tier": (6, 20, 80), "no-fast-tier": (6, 10, 60)}


@functools.lru_cache(maxsize=None)
def reference(hard, shape, n_iter):
    """The reference's (matched predictions [N, n], iterations each task
    ran [N], final assignments u [N, n, K]) on the shape's tasks."""
    n_task, n_query, n_class = SHAPES[shape]
    feats, _, idx = dirichlet_tasks(SEED, n_task, n_query, n_class)
    x = torch.as_tensor(feats[idx])
    u, iters = REF.em_dirichlet(x, REF.lambda_(n_class, n_query, 5),
                                n_iter=n_iter, hard=hard, tol=1e-6,
                                newton_steps=NEWTON_CAP)
    return REF.matched_predictions(u, x), iters.numpy(), u


def counted(seen, name):
    return [n for k, n in seen if k == name]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("route", ["blocking", "fused"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
def test_the_port_gives_the_references_answers(solves, hard, compact, route,
                                               shape):
    n_task, n_query, n_class = SHAPES[shape]
    _, engaged = tem.compaction_geometry(n_query, n_class)
    assert engaged
    feats, labels, idx = dirichlet_tasks(SEED, n_task, n_query, n_class)
    m = method(hard, n_query, n_class, n_task, compact)
    logs = run_route(m, route, feats, labels, idx)

    ref_preds, ref_iters, ref_u = reference(hard, shape, m.n_iter)
    np.testing.assert_array_equal(logs["preds"], ref_preds)
    # the port stops the batch when its last task stops: every solve (the
    # guard's exact re-solve of the blocking route too) runs the
    # reference's longest task's iterations
    iters = counted(solves, "em.iterations")
    assert iters and all(it == ref_iters.max() for it in iters), (
        iters, ref_iters)

    steps = counted(solves, "newton.steps")
    assert max(steps) <= NEWTON_CAP
    if hard:
        # one-hot assignments leave a cluster of one query, whose
        # Dirichlet fit has no finite maximum: the reference's solve and
        # the port's run to the cap
        assert (ref_u.sum(1) == 1).any()
        assert max(steps) == NEWTON_CAP

    # compaction on: every iteration after a solve's first is a compact
    # step (the first too under compact_first); off: none is
    n_compact_steps = len(counted(solves, "em.compact_steps"))
    if compact:
        assert n_compact_steps >= len(iters) * (ref_iters.max() - 1)
    else:
        assert n_compact_steps == 0


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_the_compact_counters_on_hard_assignments(shape):
    """A hard run's counters in an active timer: every iteration is a
    compact step under ``compact_first``; the first step reads the
    compact width (raw features populate every cluster), each later one
    at most n_query; the later steps take the fast tier wherever the
    compact width leaves one."""
    n_task, n_query, n_class = SHAPES[shape]
    n_compact, _ = tem.compaction_geometry(n_query, n_class)
    feats, labels, idx = dirichlet_tasks(SEED + 1, n_task, n_query, n_class)
    m = method(True, n_query, n_class, n_task, True)
    with PhaseTimer().active() as timer:
        run_route(m, "fused", feats, labels, idx)
    tot = timer.totals
    n_steps, n_fast = tot["em.compact_steps"], tot["em.fast_steps"]
    # compact_first: every iteration of the solve is a compact step
    assert n_steps == tot["em.iterations"] > 1
    assert 0 <= n_fast <= n_steps
    assert tot["em.populated"] <= n_compact + (n_steps - 1) * n_query
    assert tot["em.populated"] / n_steps <= n_query
    if n_compact > tem._COMPACT_FAST:
        # after the first step every task holds at most n_query <= 32
        # populated clusters: the rest took the 32-row fast tier
        assert n_fast == n_steps - 1
    else:
        assert n_fast == 0
    assert {"em.compact_steps", "em.fast_steps",
            "em.populated"} <= timer.counters


def test_no_compact_step_counts_nothing():
    """With compaction off the compact counters stay out of the timer."""
    n_task, n_query, n_class = SHAPES["fast-tier"]
    feats, labels, idx = dirichlet_tasks(SEED, n_task, n_query, n_class)
    m = method(True, n_query, n_class, n_task, False)
    with PhaseTimer().active() as timer:
        run_route(m, "fused", feats, labels, idx)
    assert timer.totals["em.iterations"] > 0
    assert not {"em.compact_steps", "em.fast_steps",
                "em.populated"} & set(timer.totals)
