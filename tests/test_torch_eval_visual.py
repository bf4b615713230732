"""The port's evaluators on visual features (``use_softmax_feature: False``:
L2-normalized CLIP embeddings plus the text prototypes of
``text_<backbone>.plk``) against the JAX evaluators, as
tests/test_eval_e2e.py::test_zero_shot_visual_features_end_to_end runs
them: tiny caches written in a temporary working directory, the same mean
accuracy and TSV row. And LaplacianShot on the blocking, deferred and fused
routes of the port's few-shot evaluator, each equal to the JAX package's
blocking run."""

import os

import numpy as np
import pytest
import torch

from transductive_clip_tpu.core.config import load_full_config as jax_config
from transductive_clip_tpu.core.io import save_pickle as jax_save_pickle
from transductive_clip_tpu.eval import EvaluatorFewShot as JaxFewShot
from transductive_clip_tpu.eval import EvaluatorZeroShot as JaxZeroShot
from transductive_clip_tpu.features.cache import save_feature_cache as jax_save
from transductive_clip_tpu.methods.few_shot.laplacian_shot import (
    LAPLACIAN_SHOT as JaxLaplacianShot,
)
from transductive_clip_tpu_torch.core.config import load_full_config
from transductive_clip_tpu_torch.eval import EvaluatorFewShot, EvaluatorZeroShot
from transductive_clip_tpu_torch.methods.few_shot.laplacian_shot import (
    LAPLACIAN_SHOT,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO, "config")
FEATURES = os.path.join("data", "eurosat", "saved_features")
GRID = "val_param\tacc\n1.5\t90.0\t\n2.0\t60.0\t\n3.0\t80.0\t\n5.0\t80.0\t\n"
D, K = 16, 10


def _opts(**over):
    opts = []
    for k, v in over.items():
        opts += [k, str(v)]
    return opts


def visual_caches(rng, splits=("test",)):
    """tests/test_eval_e2e.py's visual data: unit text directions, each
    image its class's direction plus noise, L2-normalized; 40 a class."""
    text = rng.normal(size=(K, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    caches = {}
    for split in splits:
        feats, labels = [], []
        for c in range(K):
            f = text[c] + 0.05 * rng.normal(size=(40, D)).astype(np.float32)
            feats.append(f / np.linalg.norm(f, axis=-1, keepdims=True))
            labels.append(np.full(40, c, np.int64))
        caches[split] = (np.concatenate(feats), np.concatenate(labels))
    return text, caches


def _write(text, caches, grids=()):
    for split, (f, lab) in caches.items():
        jax_save(os.path.join(FEATURES, f"{split}_visual_RN50.plk"), f, lab)
    jax_save_pickle(os.path.join(FEATURES, "text_RN50.plk"),
                    {"text_features": text})
    os.makedirs(os.path.join("results_few_shot", "val", "eurosat"),
                exist_ok=True)
    for name in grids:
        with open(os.path.join("results_few_shot", "val", "eurosat", name),
                  "w") as f:
            f.write(GRID)


def _both(tmp_path, monkeypatch, opts, write, jax_cls, torch_cls, sink):
    """Run the JAX and the port's evaluator, each in its own working
    directory holding the same caches; returns {side: (acc, TSV text)}."""
    out = {}
    for side in ("jax", "torch"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        write()
        if side == "jax":
            ev = jax_cls(args=jax_config(opts=opts, config_root=CONFIG_ROOT))
        else:
            ev = torch_cls(device="cpu", args=load_full_config(
                opts=opts, config_root=CONFIG_ROOT))
        acc, _ = ev.run_full_evaluation()   # model=None: all from caches
        with open(sink) as f:
            out[side] = (acc, f.read())
    return out


@pytest.mark.parametrize("method", ["soft_kmeans", "em_gaussian",
                                    "hard_kmeans"])
def test_zero_shot_visual_features_match_jax(tmp_path, monkeypatch, rng,
                                             method):
    """Cached visual features and text prototypes through init, clustering
    and text-similarity matching: the JAX evaluator's mean accuracy and TSV
    row (the deferred and fused routes are the JAX package's defaults off
    the TPU: blocking here). Four iterations: by the eighth, soft k-means
    lets the clusters of a 3-class task's absent classes collapse onto
    present ones (27 of its 30 queries then have their top two u within
    1e-5), and the argmax between two such columns follows each package's
    order of fp32 sums; tests/test_torch_kmeans.py holds that case with
    its tie-aware check."""
    text, caches = visual_caches(rng)
    opts = _opts(dataset="eurosat", method=method, shots=0, number_tasks=4,
                 batch_size=2, n_query=30, seed=0, iter=4,
                 use_softmax_feature=False, save_results=True)
    sink = os.path.join("results_zero_shot", "test", "eurosat",
                        f"{method.upper()}_visual_0shot.txt")
    out = _both(tmp_path, monkeypatch, opts, lambda: _write(text, caches),
                JaxZeroShot, EvaluatorZeroShot, sink)
    assert out["torch"] == out["jax"]
    # soft k-means splits a class between collapsed clusters, and the
    # matching gives one of them a wrong class (0.775 on these tasks, in
    # both packages)
    assert out["torch"][0] > (0.7 if method == "soft_kmeans" else 0.9)


@pytest.mark.parametrize("route", [
    ["defer_fetch", "false"],
    ["defer_fetch", "true", "fused_dispatch", "false"],
    ["defer_fetch", "true", "fused_dispatch", "true"],
])
def test_zero_shot_visual_routes_equal_blocking(rng, route):
    """soft k-means on visual features through the port's three routes
    (the deferred and fused ones carry the text prototypes to the device
    accuracy): the same mean accuracy as blocking, bit for bit."""
    text, caches = visual_caches(rng)
    feats, labels = caches["test"]
    accs = []
    for opts in (["defer_fetch", "false"], route):
        cfg = load_full_config(opts=_opts(
            dataset="eurosat", method="soft_kmeans", shots=0, number_tasks=6,
            batch_size=2, n_query=30, seed=0, iter=4,
            use_softmax_feature=False, matching_backend="host") + opts,
            config_root=CONFIG_ROOT)
        accs.append(EvaluatorZeroShot(device="cpu", args=cfg).evaluate_tasks(
            feats, labels, text_features=text)[0])
    assert accs[1] == accs[0] and accs[0] > 0.7     # 0.7167 on these tasks


def test_zero_shot_visual_features_refused_by_em_dirichlet(tmp_path,
                                                           monkeypatch, rng):
    """EM-Dirichlet needs features on the simplex: with visual features it
    refuses, as in the JAX package."""
    monkeypatch.chdir(tmp_path)
    text, caches = visual_caches(rng)
    _write(text, caches)
    for method in ("em_dirichlet", "hard_em_dirichlet"):
        opts = _opts(dataset="eurosat", method=method, shots=0,
                     number_tasks=2, batch_size=2, n_query=30, seed=0,
                     use_softmax_feature=False, save_results=False)
        for ev in (JaxZeroShot(args=jax_config(opts=opts,
                                               config_root=CONFIG_ROOT)),
                   EvaluatorZeroShot(device="cpu", args=load_full_config(
                       opts=opts, config_root=CONFIG_ROOT))):
            with pytest.raises(ValueError, match="simplex"):
                ev.run_full_evaluation()


@pytest.mark.parametrize("method,grid", [
    ("paddle", "PADDLE_visual_s2.txt"),
    ("bdcspn", "BDCSPN_visual_s2.txt"),
    ("laplacian_shot", "LAPLACIAN_SHOT_visual_s2.txt"),
])
def test_few_shot_visual_features_match_jax(tmp_path, monkeypatch, rng,
                                            method, grid):
    """Visual train and test caches, the text prototypes and a val grid
    for the tuned parameter: the JAX evaluator's mean accuracy and TSV
    row."""
    text, caches = visual_caches(rng, splits=("test", "train"))
    opts = _opts(dataset="eurosat", method=method, shots=2, number_tasks=4,
                 batch_size=2, n_query=30, seed=0, iter=10,
                 use_softmax_feature=False, save_results=True)
    sink = os.path.join("results_few_shot", "test", "eurosat",
                        f"{method.upper()}_visual_s2.txt")
    out = _both(tmp_path, monkeypatch, opts,
                lambda: _write(text, caches, grids=(grid,)),
                JaxFewShot, EvaluatorFewShot, sink)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] > 0.9


def _record(monkeypatch, cls):
    seen = []
    orig = cls.run_task

    def spy(self, task_dic, shot=None):
        logs = orig(self, task_dic, shot)
        seen.append(np.asarray(logs["acc"]).copy())
        return logs

    monkeypatch.setattr(cls, "run_task", spy)
    return seen


def synth_softmax(rng, n_per_class=40, n_class=K, concentration=60.0):
    feats, labels = [], []
    for c in range(n_class):
        alpha = np.ones(n_class)
        alpha[c] += concentration
        feats.append(rng.dirichlet(alpha, size=n_per_class).astype(np.float32))
        labels.append(np.full(n_per_class, c, np.int64))
    return np.concatenate(feats), np.concatenate(labels)


def test_laplacian_shot_every_route_gives_jax_blocking(tmp_path, monkeypatch,
                                                       rng):
    """The port's LaplacianShot on the blocking, deferred and fused routes
    (softmax caches, device_gather on): every route runs the blocking
    run_task on every batch, and each batch's [N, iter] accuracy trace and
    the mean equal the JAX package's blocking run. (The JAX package's
    deferred and fused routes raise for this method: ROADMAP.md, F5.)"""
    caches = {"test": synth_softmax(rng), "train": synth_softmax(rng)}
    base = _opts(dataset="eurosat", method="laplacian_shot", shots=2,
                 number_tasks=6, batch_size=2, n_query=30, seed=0, iter=10)

    def write():
        for split, (f, lab) in caches.items():
            jax_save(os.path.join(FEATURES, f"{split}_softmax_RN50_T30.plk"),
                     f, lab)
        os.makedirs(os.path.join("results_few_shot", "val", "eurosat"))
        with open(os.path.join("results_few_shot", "val", "eurosat",
                               "LAPLACIAN_SHOT_softmax_s2.txt"), "w") as f:
            f.write(GRID)

    os.makedirs(tmp_path / "jax")
    monkeypatch.chdir(tmp_path / "jax")
    write()
    seen_j = _record(monkeypatch, JaxLaplacianShot)
    acc_j, _ = JaxFewShot(args=jax_config(
        opts=base + ["defer_fetch", "false"],
        config_root=CONFIG_ROOT)).run_full_evaluation()
    assert len(seen_j) == 3 and acc_j > 0.9
    for name, route in (
            ("blocking", ["defer_fetch", "false"]),
            ("deferred", ["defer_fetch", "true", "fused_dispatch", "false"]),
            ("fused", ["defer_fetch", "true", "fused_dispatch", "true"])):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        write()
        seen = _record(monkeypatch, LAPLACIAN_SHOT)
        acc, _ = EvaluatorFewShot(device="cpu", args=load_full_config(
            opts=base + route, config_root=CONFIG_ROOT)).run_full_evaluation()
        assert acc == acc_j, name
        assert len(seen) == 3, name
        for b_t, b_j in zip(seen, seen_j):
            assert b_t.shape == (2, 10)
            np.testing.assert_array_equal(b_t, b_j)
