"""The port's evaluator pipelines (the cases of tests/test_eval_e2e.py's
deferred and fused tests): ``defer_fetch`` and ``fused_dispatch`` give the
blocking path's per-batch accuracies and predictions bit for bit, zero- and
few-shot; host matching and the other host steps fall through to the
blocking path; a budget-exhausted auction falls back to the host JV solver
from the prototype rows each route holds, counted and reported; flushing
the window is
exact; the periodic compact_first guard is routed through blocking batches;
and each evaluator's accuracies equal the JAX evaluator's for the same
route, with ``matching_backend`` host and device on both sides."""

import os

import numpy as np
import pytest
import torch

from transductive_clip_tpu.core.config import load_full_config as jax_config
from transductive_clip_tpu.eval import EvaluatorFewShot as JaxFewShot
from transductive_clip_tpu.eval import EvaluatorZeroShot as JaxZeroShot
from transductive_clip_tpu.methods.base import TransductiveMethod as JaxMethod
from transductive_clip_tpu_torch.core.config import CfgNode, load_full_config
from transductive_clip_tpu_torch.eval import EvaluatorFewShot, EvaluatorZeroShot
from transductive_clip_tpu_torch.eval.zero_shot import (
    resolve_defer_fetch,
    resolve_fused_dispatch,
)
from transductive_clip_tpu_torch.methods import base as tbase
from transductive_clip_tpu_torch.ops import cuda_auction

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO, "config")


def synth_features(rng, n_per_class=40, n_class=10, concentration=60.0):
    feats, labels = [], []
    for c in range(n_class):
        alpha = np.ones(n_class)
        alpha[c] += concentration
        feats.append(rng.dirichlet(alpha, size=n_per_class).astype(np.float32))
        labels.append(np.full(n_per_class, c, np.int64))
    return np.concatenate(feats), np.concatenate(labels)


def _cfg(loader=load_full_config, **over):
    """A config from ``--opts`` pairs; the 'auto'-or-boolean keys take the
    lower-case spelling (a literal ``True`` does not fit their string
    slot)."""
    opts = []
    for k, v in over.items():
        opts += [k, str(v).lower() if k in ("defer_fetch", "fused_dispatch")
                 else str(v)]
    return loader(opts=opts, config_root=CONFIG_ROOT)


@pytest.fixture
def routes(monkeypatch):
    """Each batch's logs with the route that made them: 'blocking'
    (run_task), 'deferred' or 'fused' (finalized handles), in batch
    order."""
    seen = []
    run_task = tbase.TransductiveMethod.run_task
    deferred = tbase.TransductiveMethod.run_task_deferred
    fused_zs = tbase.TransductiveMethod.run_task_fused
    fused_fs = tbase.FewShotMethod.run_task_fused

    def spy_run_task(self, task_dic, shot=None):
        logs = run_task(self, task_dic, shot)
        seen.append(("blocking", logs))
        return logs

    def wrap(pipeline, label):
        def spy(self, *args, **kwargs):
            res = pipeline(self, *args, **kwargs)
            if res is not None:
                finalize = res.finalize

                def finalize_logged(host, per_task):
                    logs = finalize(host, per_task)
                    seen.append((label, logs))
                    return logs

                res.finalize = finalize_logged
            return res
        return spy

    monkeypatch.setattr(tbase.TransductiveMethod, "run_task", spy_run_task)
    monkeypatch.setattr(tbase.TransductiveMethod, "run_task_deferred",
                        wrap(deferred, "deferred"))
    monkeypatch.setattr(tbase.TransductiveMethod, "run_task_fused",
                        wrap(fused_zs, "fused"))
    monkeypatch.setattr(tbase.FewShotMethod, "run_task_fused",
                        wrap(fused_fs, "fused"))
    return seen


def _evaluate(routes, cfg, feats, labels, support=None):
    routes.clear()
    if support is None:
        acc, t = EvaluatorZeroShot(device="cpu", args=cfg).evaluate_tasks(
            feats, labels)
    else:
        acc, t = EvaluatorFewShot(device="cpu", args=cfg).evaluate_tasks(
            *support, feats, labels)
    return acc, t, list(routes)


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g["preds"], w["preds"])
        np.testing.assert_array_equal(g["acc"], w["acc"])


def _labels(run):
    return [label for label, _ in run]


ZS = dict(dataset="eurosat", shots=0, number_tasks=8, batch_size=2,
          n_query=30, iter=6, iter_mm=100)
FS = dict(dataset="eurosat", shots=2, number_tasks=6, batch_size=2,
          n_query=30, iter=6, iter_mm=100, tunable=False)


@pytest.mark.parametrize("method", ["em_dirichlet", "hard_em_dirichlet"])
def test_zero_shot_pipelines_match_blocking(rng, routes, method):
    """Blocking, deferred and fused runs of the same evaluation (device
    auction) give the same per-batch predictions and accuracies; the
    deferred and fused runs really took their routes."""
    feats, labels = synth_features(rng)
    runs = {}
    for name, defer, fused in (("blocking", False, False),
                               ("deferred", True, False),
                               ("fused", True, True)):
        cfg = _cfg(method=method, seed=3, matching_backend="device",
                   defer_fetch=defer, fused_dispatch=fused, **ZS)
        acc, t, runs[name] = _evaluate(routes, cfg, feats, labels)
        assert acc > 0.9 and t > 0
    assert _labels(runs["blocking"]) == ["blocking"] * 4
    assert _labels(runs["deferred"]) == ["blocking"] + ["deferred"] * 3
    assert _labels(runs["fused"]) == ["blocking"] + ["fused"] * 3
    _assert_same_batches(runs["deferred"], runs["blocking"])
    _assert_same_batches(runs["fused"], runs["blocking"])


@pytest.mark.parametrize("method", ["em_dirichlet", "alpha_tim"])
def test_few_shot_pipelines_match_blocking(rng, routes, method):
    feats_q, labels_q = synth_features(rng)
    support = synth_features(rng)
    runs = {}
    for name, defer, fused in (("blocking", False, False),
                               ("deferred", True, False),
                               ("fused", True, True)):
        cfg = _cfg(method=method, seed=13, defer_fetch=defer,
                   fused_dispatch=fused, **FS)
        cfg.iter = 6 if method == "em_dirichlet" else 40
        _, _, runs[name] = _evaluate(routes, cfg, feats_q, labels_q, support)
    assert _labels(runs["deferred"]) == ["blocking"] + ["deferred"] * 2
    assert _labels(runs["fused"]) == ["blocking"] + ["fused"] * 2
    _assert_same_batches(runs["deferred"], runs["blocking"])
    _assert_same_batches(runs["fused"], runs["blocking"])


@pytest.mark.parametrize("fused", [False, True])
def test_host_matching_falls_through_to_blocking(rng, routes, fused):
    """The host JV solver needs the rows on the host every batch: both
    pipelines decline and every batch runs blocking, exactly."""
    feats, labels = synth_features(rng)
    want = None
    for defer in (False, True):
        cfg = _cfg(method="em_dirichlet", seed=5, matching_backend="host",
                   defer_fetch=defer, fused_dispatch=fused, **ZS)
        _, _, run = _evaluate(routes, cfg, feats, labels)
        assert _labels(run) == ["blocking"] * 4
        want = want or run
        _assert_same_batches(run, want)


@pytest.mark.parametrize("over,want_route", [
    (dict(device_gather=False), "deferred"),
    (dict(task_chunk=1), "blocking"),
])
def test_pipelines_fall_through_where_a_host_step_is_needed(rng, routes, over,
                                                           want_route):
    """fused_dispatch needs device_gather (without it the batches take the
    deferred path), and task_chunk a host step (the batches run blocking);
    either way the results are the blocking run's."""
    feats, labels = synth_features(rng)
    runs = {}
    for defer in (False, True):
        cfg = _cfg(method="em_dirichlet", seed=5, matching_backend="device",
                   defer_fetch=defer, fused_dispatch=True, **ZS, **over)
        _, _, runs[defer] = _evaluate(routes, cfg, feats, labels)
    assert _labels(runs[True]) == ["blocking"] + [want_route] * 3
    _assert_same_batches(runs[True], runs[False])


@pytest.mark.parametrize("fused", [False, True])
def test_exhausted_auction_falls_back_to_host_solver(rng, routes, monkeypatch,
                                                     fused):
    """When the auction's budget runs out (ok False) the blocking batch and
    the finalizers solve the exact matching on the host, from the prototype
    rows the deferred and the fused route both hold. The result is the host
    route's, and every batch that left the card is counted and warned
    of."""
    feats, labels = synth_features(rng)
    cfg = _cfg(method="em_dirichlet", seed=23, matching_backend="host", **ZS)
    _, _, want = _evaluate(routes, cfg, feats, labels)

    def exhausted(values, *a, **kw):
        return torch.full(values.shape[:2], -1, dtype=torch.int32)

    monkeypatch.setattr(cuda_auction, "auction_assign", exhausted)
    cfg = _cfg(method="em_dirichlet", seed=23, matching_backend="device",
               defer_fetch=True, fused_dispatch=fused, **ZS)
    monkeypatch.setattr(tbase.note_host_fallback, "count", 0)
    with pytest.warns(UserWarning, match="ran out of rounds"):
        _, _, run = _evaluate(routes, cfg, feats, labels)
    assert _labels(run)[1:] == ["fused" if fused else "deferred"] * 3
    _assert_same_batches(run, want)
    assert tbase.note_host_fallback.count == len(run)


def test_no_fallback_is_counted_when_the_auction_settles(rng, routes,
                                                         monkeypatch):
    """A run whose auctions all settle counts no host fallback: the count
    is what a run on the card reads to show that no batch's matching left
    the card."""
    feats, labels = synth_features(rng)
    monkeypatch.setattr(tbase.note_host_fallback, "count", 0)
    cfg = _cfg(method="em_dirichlet", seed=23, matching_backend="device",
               defer_fetch=True, **ZS)
    _evaluate(routes, cfg, feats, labels)
    assert tbase.note_host_fallback.count == 0


def test_defer_flush_batches_is_exact(rng, routes):
    """Flushing the window every batch or every two gives the one fetch at
    the end's results, and each flushed window is timed on its own."""
    feats, labels = synth_features(rng)
    runs = {}
    for flush in (0, 1, 2):
        cfg = _cfg(method="em_dirichlet", seed=17, matching_backend="device",
                   defer_fetch=True, defer_flush_batches=flush, **ZS)
        acc, t, runs[flush] = _evaluate(routes, cfg, feats, labels)
        assert t > 0
    _assert_same_batches(runs[1], runs[0])
    _assert_same_batches(runs[2], runs[0])
    tails = [logs["timestamps"] for _, logs in runs[1][1:]]
    assert len(set(tails)) == len(tails)       # one window a batch
    assert len({logs["timestamps"] for _, logs in runs[0][1:]}) == 1


def test_config_parsing():
    """--opts deliver flags as strings: 'false' turns the fused path off
    (bool('false') is True), 'auto' resolves as off the TPU on the CPU,
    and fused dispatch needs device_gather."""
    assert resolve_fused_dispatch(CfgNode({}), True) is True
    assert resolve_fused_dispatch(CfgNode({}), False) is False
    for spelling in ("false", "False", False, "off", "0"):
        cfg = CfgNode({"fused_dispatch": spelling, "defer_fetch": spelling})
        assert resolve_fused_dispatch(cfg, True) is False
        assert resolve_defer_fetch(cfg, "cpu") is False
    for spelling in ("true", "True", True, "on", "1"):
        cfg = CfgNode({"fused_dispatch": spelling, "defer_fetch": spelling})
        assert resolve_fused_dispatch(cfg, True) is True
        assert resolve_fused_dispatch(cfg, False) is False
        assert resolve_defer_fetch(cfg, "cpu") is True
    assert resolve_defer_fetch(CfgNode({}), "cpu") is False
    assert tbase._matching_backend(CfgNode({}), "cpu") == "host"
    # on the card 'auto' takes what chip_smoke.py's routes measured faster:
    # deferral only where the fused route applies
    assert resolve_defer_fetch(CfgNode({}), "cuda:0", fused=True) is True
    assert resolve_defer_fetch(CfgNode({}), "cuda:0", fused=False) is False
    assert resolve_defer_fetch(CfgNode({}), "cpu", fused=True) is False
    assert resolve_defer_fetch(CfgNode({"defer_fetch": "true"}), "cuda:0",
                               fused=False) is True
    assert tbase._matching_backend(CfgNode({}), "cuda:0") == "device"
    assert tbase._matching_backend(CfgNode({"matching_backend": "host"}),
                                   "cuda:0") == "host"
    with pytest.raises(ValueError, match="defer_fetch"):
        resolve_defer_fetch(CfgNode({"defer_fetch": "maybe"}), "cpu")


def test_few_shot_fused_visual_features_need_text():
    """A visual-feature method refuses the fused path without text
    features (run_task raises there; zeros would be a uniform init)."""
    from transductive_clip_tpu_torch.methods import get_few_shot_method

    cfg = _cfg(dataset="eurosat", method="alpha_tim", shots=2, tunable=False)
    cfg.use_softmax_feature = False
    method = get_few_shot_method(cfg.name_method, device="cpu", args=cfg)
    feats, labs = torch.zeros(40, 8), torch.zeros(40, dtype=torch.int64)
    idx = np.zeros((2, 20), np.int64)
    assert method.run_task_fused(feats, feats, labs, labs, idx, idx) is None


def test_evaluator_routes_periodic_guard_through_blocking_batches(
        rng, routes, monkeypatch):
    """The pipelines never host the compact_first guard, so the evaluator
    routes every compact_first_recheck-th batch through the blocking
    run_task with the guard forced. 6 fused batches at recheck 2: the
    first-batch guard (batch 0) and the routed re-check (batch 3) each run
    one exact duplicate solve, the fused batches none."""
    from transductive_clip_tpu_torch.methods.zero_shot import em_dirichlet as em

    calls = []
    orig = em.EM_DIRICHLET._run_infer

    def spy(self, x_q, compact_first):
        calls.append(bool(compact_first))
        return orig(self, x_q, compact_first)

    monkeypatch.setattr(em.EM_DIRICHLET, "_run_infer", spy)
    feats, labels = synth_features(rng, n_per_class=10, n_class=120)
    cfg = _cfg(method="em_dirichlet", dataset="eurosat", shots=0,
               number_tasks=12, batch_size=2, n_query=20, seed=3, iter=6,
               iter_mm=100, matching_backend="device", defer_fetch=True,
               compact_first_recheck=2)
    cfg.n_class = cfg.num_classes_test = 120
    acc, _, run = _evaluate(routes, cfg, feats, labels)
    assert acc > 0.9
    assert _labels(run) == ["blocking", "fused", "fused", "blocking",
                            "fused", "fused"]
    assert calls.count(False) == 2


@pytest.mark.parametrize("backend", ["host", "device"])
def test_zero_shot_evaluator_matches_jax(tmp_path, rng, monkeypatch, backend):
    """The port's evaluator and the JAX one on the same cache and seed, with
    the same matching backend: the same per-batch accuracies (the port
    deferred and fused, the JAX one blocking, as it runs on the CPU)."""
    feats, labels = synth_features(rng)
    seen_jax = []
    jax_run_task = JaxMethod.run_task

    def spy(self, task_dic, shot=None):
        logs = jax_run_task(self, task_dic, shot)
        seen_jax.append(np.asarray(logs["acc"]).copy())
        return logs

    monkeypatch.setattr(JaxMethod, "run_task", spy)
    monkeypatch.chdir(tmp_path)
    opts = dict(method="em_dirichlet", seed=0, matching_backend=backend, **ZS)
    acc_j, _ = JaxZeroShot(args=_cfg(jax_config, **opts)).evaluate_tasks(
        feats, labels)
    cfg = _cfg(defer_fetch=True, **opts)
    seen = []
    finalize = tbase.DeferredTaskResult.finalize

    def spy_finalize(self, host, per_task):
        logs = finalize(self, host, per_task)
        seen.append(np.asarray(logs["acc"]).copy())
        return logs

    monkeypatch.setattr(tbase.DeferredTaskResult, "finalize", spy_finalize)
    acc_t, _ = EvaluatorZeroShot(device="cpu", args=cfg).evaluate_tasks(
        feats, labels)
    assert acc_t == acc_j and acc_t > 0.9
    assert len(seen_jax) == 4
    if backend == "device":
        assert len(seen) == 3           # the port's batches 1-3 were fused
    else:
        assert not seen                 # host matching: blocking throughout
    for got, want in zip(seen, seen_jax[1:]):
        np.testing.assert_array_equal(got, want)


def test_few_shot_evaluator_matches_jax(rng):
    """Few-shot: the port deferred and fused against the JAX evaluator
    blocking, on the same caches and seed."""
    feats_q, labels_q = synth_features(rng)
    support = synth_features(rng)
    opts = dict(method="em_dirichlet", seed=13, **FS)
    acc_j, _ = JaxFewShot(args=_cfg(jax_config, **opts)).evaluate_tasks(
        *support, feats_q, labels_q)
    for fused in (False, True):
        cfg = _cfg(defer_fetch=True, fused_dispatch=fused, **opts)
        acc_t, _ = EvaluatorFewShot(device="cpu", args=cfg).evaluate_tasks(
            *support, feats_q, labels_q)
        assert acc_t == acc_j and acc_t > 0.9


@pytest.mark.parametrize("backend", ["host", "device"])
def test_all_host_prototype_path_matches_jax(rng, backend):
    """``proto_device: False`` (the reference-shaped all-host path): its
    host JV matching and its auction matching (``device_matching``) give
    the JAX package's predictions and accuracies."""
    from transductive_clip_tpu.core.config import CfgNode as JaxCfg
    from transductive_clip_tpu.methods.base import clustering_accuracy as jax_acc

    from conftest import make_simplex_tasks

    x, y = make_simplex_tasks(rng, n_task=3, n_query=30, n_class=12, k_eff=4)
    u = x ** 4 / (x ** 4).sum(-1, keepdims=True)
    opts = dict(n_class=12, T=30, use_softmax_feature=True,
                graph_matching=True, proto_device=False,
                matching_backend=backend)
    acc_j, preds_j = jax_acc(u, x, y, JaxCfg(opts))
    acc_t, preds_t = tbase.clustering_accuracy(
        torch.as_tensor(u), torch.as_tensor(x), y, CfgNode(opts))
    np.testing.assert_array_equal(preds_t, preds_j)
    np.testing.assert_array_equal(acc_t, acc_j)


@pytest.mark.parametrize("shots", [0, 2])
def test_cli_runs_the_pipelines_to_the_tsv_row(tmp_path, monkeypatch, rng,
                                               shots):
    """``python -m transductive_clip_tpu_torch.cli`` with the device auction
    and deferred, fused batches (the spellings a user types after --opts)
    writes the JAX evaluator's TSV row (the JAX one blocking, as it runs on
    the CPU); ``data_parallel True`` still raises, naming its item."""
    import functools

    from transductive_clip_tpu.features.cache import save_feature_cache
    from transductive_clip_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    saved = os.path.join("data", "eurosat", "saved_features")
    for split in ("test", "train"):
        feats, labels = synth_features(rng)
        save_feature_cache(os.path.join(saved, f"{split}_softmax_RN50_T30.plk"),
                           feats, labels)
    opts = ["dataset", "eurosat", "method", "em_dirichlet", "shots",
            str(shots), "number_tasks", "6", "batch_size", "2", "n_query",
            "30", "seed", "0", "iter", "6", "iter_mm", "100", "tunable",
            "False", "save_results", "True"]
    pipelines = ["matching_backend", "device", "defer_fetch", "true",
                 "fused_dispatch", "true"]
    if shots:
        folder, name = "results_few_shot", "EM_DIRICHLET_softmax_s2.txt"
        JaxEvaluator, monkeyed = JaxFewShot, "EvaluatorFewShot"
        TorchEvaluator = EvaluatorFewShot
    else:
        folder, name = "results_zero_shot", "EM_DIRICHLET_softmax_0shot.txt"
        JaxEvaluator, monkeyed = JaxZeroShot, "EvaluatorZeroShot"
        TorchEvaluator = EvaluatorZeroShot
    tsv = os.path.join(folder, "test", "eurosat", name)
    JaxEvaluator(args=jax_config(opts=opts + pipelines[:2],
                                 config_root=CONFIG_ROOT)).run_full_evaluation()
    want = open(tsv).read()
    os.remove(tsv)
    monkeypatch.setattr(cli, monkeyed,
                        functools.partial(TorchEvaluator, device="cpu"))
    argv = ["--config-root", CONFIG_ROOT, "--opts", *opts, *pipelines,
            "log_path", str(tmp_path / "logs")]
    acc, sec_per_task = cli.main(argv)
    assert open(tsv).read() == want and acc > 0.9 and sec_per_task > 0
    # JAX's one-device rule: data_parallel in one process with no task
    # group (no card to spread over) writes the same row
    os.remove(tsv)
    cli.main(argv + ["data_parallel", "True"])
    assert open(tsv).read() == want
