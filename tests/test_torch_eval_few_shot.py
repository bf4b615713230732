"""The port's few-shot sampler, task generator, evaluator and CLI against the
JAX package's: the same sampled indices from the same seed (both support
draws), the same generated tasks, and the same per-batch accuracies, tuned
parameter and TSV row from EvaluatorFewShot on small synthetic train/test
caches (the shapes of tests/test_eval_e2e.py), along the device-gather and
the host-generator branches."""

import functools
import os

import numpy as np
import pytest
import torch

from transductive_clip_tpu.core.config import load_full_config as jax_config
from transductive_clip_tpu.eval import EvaluatorFewShot as JaxEvaluator
from transductive_clip_tpu.features.cache import save_feature_cache as jax_save
from transductive_clip_tpu.methods.base import FewShotMethod as JaxMethod
from transductive_clip_tpu.tasks import (
    CategoriesSamplerFewShot as JaxSampler,
    SamplerQueryFewShot as JaxQuery,
    SamplerSupportFewShot as JaxSupport,
    TasksGeneratorFewShot as JaxGenerator,
)
from transductive_clip_tpu_torch import cli
from transductive_clip_tpu_torch.core.config import load_full_config
from transductive_clip_tpu_torch.eval import EvaluatorFewShot
from transductive_clip_tpu_torch.methods import base as tbase
from transductive_clip_tpu_torch.methods import get_few_shot_method
from transductive_clip_tpu_torch.tasks import (
    CategoriesSamplerFewShot,
    SamplerQueryFewShot,
    SamplerSupportFewShot,
    TasksGeneratorFewShot,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO, "config")
FEATURES = os.path.join("data", "eurosat", "saved_features")
GRID = "val_param\tacc\n1.5\t90.0\t\n2.0\t60.0\t\n3.0\t80.0\t\n5.0\t80.0\t\n"


def synth_features(rng, n_per_class=40, n_class=10, concentration=60.0):
    feats, labels = [], []
    for c in range(n_class):
        alpha = np.ones(n_class)
        alpha[c] += concentration
        feats.append(rng.dirichlet(alpha, size=n_per_class).astype(np.float32))
        labels.append(np.full(n_per_class, c, np.int64))
    return np.concatenate(feats), np.concatenate(labels)


def _opts(**over):
    opts = []
    for k, v in over.items():
        opts += [k, str(v)]
    return opts


@pytest.mark.parametrize("support_draw", ["vectorized", "per_task"])
def test_sampler_indices_match_jax(support_draw):
    """Query first, then support, for three batches from one seed; class 6
    is missing from the train split (an empty support pool)."""
    labels_q = np.repeat(np.arange(8), 9)
    labels_s = np.repeat(np.arange(8), 5)
    labels_s[labels_s == 6] = 7
    draws = []
    for cls, query, support in ((JaxSampler, JaxQuery, JaxSupport),
                                (CategoriesSamplerFewShot, SamplerQueryFewShot,
                                 SamplerSupportFewShot)):
        s = cls(4, 3, 8, 2, 10, force_query_size=True,
                rng=np.random.default_rng(11), support_draw=support_draw)
        s.create_list_classes(labels_s, labels_q)
        draws.append([(np.stack(list(query(s))), np.stack(list(support(s))))
                      for _ in range(3)])
    for (q_j, s_j), (q_t, s_t) in zip(*draws):
        np.testing.assert_array_equal(q_t, q_j)
        np.testing.assert_array_equal(s_t, s_j)


@pytest.mark.parametrize("softmax", [True, False])
def test_generator_matches_jax(rng, softmax):
    """The flipped-unique remap (and, for softmax features, the column
    permutation) on unsorted support covering every class."""
    n_class, shots = 6, 2
    loaders = []
    for _ in range(3):
        idx_s = rng.permutation(np.repeat(np.arange(n_class), shots))
        loaders.append(((rng.random((idx_s.size, n_class)).astype(np.float32),
                         idx_s),
                        (rng.random((7, n_class)).astype(np.float32),
                         rng.integers(0, n_class, 7))))
    args = {"use_softmax_feature": softmax}
    out = []
    for gen, cfg in ((JaxGenerator, jax_config), (TasksGeneratorFewShot,
                                                  load_full_config)):
        c = cfg(opts=[], config_root=CONFIG_ROOT)
        c.update(args)
        out.append(gen(3, shots, 7, n_class,
                       loader_support=[s for s, _ in loaders],
                       loader_query=[q for _, q in loaders],
                       args=c).generate_tasks())
    assert out[0].keys() == out[1].keys()
    for key in out[0]:
        np.testing.assert_array_equal(out[1][key], out[0][key])


def _record_batches(monkeypatch, cls):
    seen = []
    orig = cls.run_task

    def spy(self, task_dic, shot=None):
        logs = orig(self, task_dic, shot)
        seen.append(np.asarray(logs["acc"]).copy())
        return logs

    monkeypatch.setattr(cls, "run_task", spy)
    return seen


def _write_caches(rng, split="test"):
    feats_q, labels_q = synth_features(rng)
    feats_s, labels_s = synth_features(rng)
    return {split: (feats_q, labels_q), "train": (feats_s, labels_s)}


@pytest.mark.parametrize("method,device_gather,split", [
    ("alpha_tim", True, "test"),
    ("em_dirichlet", True, "test"),
    ("hard_em_dirichlet", False, "test"),
    ("alpha_tim", False, "val"),
])
def test_evaluator_matches_jax(tmp_path, monkeypatch, rng, method,
                               device_gather, split):
    """Per-batch accuracies, the mean, the tuned alpha_value (the val grid's
    argmax row after the skipped first row: 3.0 and 5.0 tie, the later
    wins) and the TSV row — or, for used_test_set val, the appended grid
    line."""
    opts = _opts(dataset="eurosat", method=method, shots=2, number_tasks=4,
                 batch_size=2, n_query=30, seed=0, iter=12, iter_mm=100,
                 device_gather=device_gather, used_test_set=split,
                 save_results=True)
    caches = _write_caches(rng, split)
    rows = {}
    for side in ("jax", "torch"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        for name, (f, lab) in caches.items():
            jax_save(os.path.join(FEATURES, f"{name}_softmax_RN50_T30.plk"),
                     f, lab)
        os.makedirs(os.path.join("results_few_shot", "val", "eurosat"))
        with open(os.path.join("results_few_shot", "val", "eurosat",
                               "ALPHA_TIM_softmax_s2.txt"), "w") as f:
            f.write(GRID)
        if side == "jax":
            seen = _record_batches(monkeypatch, JaxMethod)
            cfg = jax_config(opts=opts, config_root=CONFIG_ROOT)
            ev = JaxEvaluator(args=cfg)
        else:
            seen = _record_batches(monkeypatch, tbase.FewShotMethod)
            cfg = load_full_config(opts=opts, config_root=CONFIG_ROOT)
            ev = EvaluatorFewShot(device="cpu", args=cfg)
        acc, _ = ev.run_full_evaluation()
        sink = os.path.join("results_few_shot", split, "eurosat",
                            f"{cfg.name_method}_softmax_s2.txt")
        with open(sink) as f:
            rows[side] = (acc, [a.copy() for a in seen], f.read(),
                          cfg.get("alpha_value"))
    acc_j, batches_j, tsv_j, alpha_j = rows["jax"]
    acc_t, batches_t, tsv_t, alpha_t = rows["torch"]
    assert len(batches_t) == len(batches_j) == 2
    for b_t, b_j in zip(batches_t, batches_j):
        np.testing.assert_array_equal(b_t, b_j)
    assert acc_t == acc_j and acc_t > 0.9
    assert tsv_t == tsv_j
    assert alpha_t == alpha_j
    if method == "alpha_tim" and split == "test":
        assert alpha_t == 5.0


def test_branches_draw_the_same_tasks(rng, monkeypatch):
    """device_gather False (host generator) draws and remaps the same tasks
    as the device gather with its constant flip, and prefetch_sampling (a
    worker thread sampling the next batch) keeps the draw order."""
    (fq, lq), (fs, ls) = _write_caches(rng).values()
    runs = []
    for dg, prefetch in ((True, False), (False, False), (True, True)):
        seen = _record_batches(monkeypatch, tbase.FewShotMethod)
        cfg = load_full_config(opts=_opts(
            dataset="eurosat", method="hard_em_dirichlet", shots=2,
            number_tasks=6, batch_size=2, n_query=30, seed=7, iter=6,
            iter_mm=100, device_gather=dg, prefetch_sampling=prefetch),
            config_root=CONFIG_ROOT)
        EvaluatorFewShot(device="cpu", args=cfg).evaluate_tasks(fs, ls, fq, lq)
        runs.append(np.concatenate(seen))
        monkeypatch.undo()
    np.testing.assert_array_equal(runs[1], runs[0])
    np.testing.assert_array_equal(runs[2], runs[0])


def test_cli_few_shot_path(tmp_path, monkeypatch, rng):
    """shots > 0 runs the few-shot evaluator: without a CUDA device the
    CLI raises instead of falling back; run on the CPU it gives the JAX
    evaluator's accuracy."""
    monkeypatch.chdir(tmp_path)
    for name, (f, lab) in _write_caches(rng).items():
        jax_save(os.path.join(FEATURES, f"{name}_softmax_RN50_T30.plk"), f, lab)
    opts = _opts(dataset="eurosat", method="em_dirichlet", shots=2,
                 number_tasks=4, batch_size=2, n_query=30, seed=0, iter=6,
                 iter_mm=100, save_results=False)
    argv = ["--config-root", CONFIG_ROOT, "--opts", *opts, "log_path",
            str(tmp_path / "logs")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    monkeypatch.setattr(cli, "EvaluatorFewShot",
                        functools.partial(EvaluatorFewShot, device="cpu"))
    acc, sec_per_task = cli.main(argv)
    ref, _ = JaxEvaluator(args=jax_config(
        opts=opts, config_root=CONFIG_ROOT)).run_full_evaluation()
    assert acc == ref and acc > 0.9 and sec_per_task > 0


@pytest.mark.parametrize("key,value", [
    ("defer_fetch", True), ("fused_dispatch", True), ("data_parallel", True),
])
def test_unported_evaluator_options_raise(rng, key, value):
    cfg = load_full_config(opts=_opts(dataset="eurosat", method="em_dirichlet",
                                      shots=2, number_tasks=2, batch_size=2,
                                      n_query=30), config_root=CONFIG_ROOT)
    cfg[key] = value
    (fq, lq), (fs, ls) = _write_caches(rng).values()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        EvaluatorFewShot(device="cpu", args=cfg).evaluate_tasks(fs, ls, fq, lq)


def test_registry_and_pipelines_name_the_roadmap_item():
    cfg = load_full_config(opts=_opts(dataset="eurosat", method="paddle",
                                      shots=2), config_root=CONFIG_ROOT)
    for name in ("PADDLE", "BDCSPN", "LAPLACIAN_SHOT"):
        with pytest.raises(NotImplementedError, match="remaining few-shot"):
            get_few_shot_method(name, device="cpu", args=cfg)
    with pytest.raises(ValueError, match="Unknown few-shot method"):
        get_few_shot_method("NOPE", device="cpu", args=cfg)
    method = get_few_shot_method("ALPHA_TIM", device="cpu", args=cfg)
    for call in (method.run_task_fused, method.run_task_deferred):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call({})
