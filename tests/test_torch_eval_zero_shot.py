"""The port's zero-shot evaluator and what crosses from the JAX package:
the same per-batch accuracies and TSV row as the JAX evaluator on a
synthetic .plk cache (the shapes of tests/test_eval_e2e.py), the .plk and
config readers, and the entry points' refusal to fall back to the CPU."""

import os

import numpy as np
import pytest
import torch

from transductive_clip_tpu.core.config import load_full_config as jax_config
from transductive_clip_tpu.eval import EvaluatorZeroShot as JaxEvaluator
from transductive_clip_tpu.features.cache import save_feature_cache as jax_save
from transductive_clip_tpu.methods.base import TransductiveMethod as JaxMethod
from transductive_clip_tpu_torch.core.config import load_full_config
from transductive_clip_tpu_torch.eval import EvaluatorZeroShot
from transductive_clip_tpu_torch.features.cache import (
    load_feature_cache,
    save_feature_cache,
)
from transductive_clip_tpu_torch.methods import base as tbase
from transductive_clip_tpu_torch.methods import get_zero_shot_method

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO, "config")
CACHE = os.path.join("data", "eurosat", "saved_features",
                     "test_softmax_RN50_T30.plk")


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


def _record_batches(monkeypatch, cls):
    """Per-batch accuracies of every run_task on ``cls``."""
    seen = []
    orig = cls.run_task

    def spy(self, task_dic, shot=None):
        logs = orig(self, task_dic, shot)
        seen.append(np.asarray(logs["acc"]).copy())
        return logs

    monkeypatch.setattr(cls, "run_task", spy)
    return seen


@pytest.mark.parametrize("method,solver", [("hard_em_dirichlet", "auto"),
                                           ("em_dirichlet", "pallas")])
def test_evaluator_matches_jax(tmp_path, monkeypatch, rng, method, solver):
    opts = _opts(dataset="eurosat", method=method, shots=0, number_tasks=4,
                 batch_size=2, n_query=30, seed=0, iter=6, iter_mm=100,
                 matching_backend="host", dirichlet_solver=solver)
    feats, labels = synth_features(rng)
    rows = {}
    for side in ("jax", "torch"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        jax_save(CACHE, feats, labels)
        if side == "jax":
            seen = _record_batches(monkeypatch, JaxMethod)
            ev = JaxEvaluator(args=jax_config(opts=opts,
                                              config_root=CONFIG_ROOT))
        else:
            seen = _record_batches(monkeypatch, tbase.TransductiveMethod)
            ev = EvaluatorZeroShot(device="cpu", args=load_full_config(
                opts=opts, config_root=CONFIG_ROOT))
        acc, _ = ev.run_full_evaluation()
        name = f"{method.upper()}_softmax_0shot.txt"
        with open(os.path.join("results_zero_shot", "test", "eurosat",
                               name)) as f:
            rows[side] = (acc, [a.copy() for a in seen], f.read())
    acc_j, batches_j, tsv_j = rows["jax"]
    acc_t, batches_t, tsv_t = rows["torch"]
    assert len(batches_t) == len(batches_j) == 2
    for b_t, b_j in zip(batches_t, batches_j):
        np.testing.assert_array_equal(b_t, b_j)
    assert acc_t == acc_j and acc_t > 0.9
    assert tsv_t == tsv_j


def test_host_gather_path_matches_device_gather(tmp_path, monkeypatch, rng):
    """device_gather False (host gather + stack) draws the same tasks."""
    feats, labels = synth_features(rng)
    accs = []
    for dg in (True, False):
        cfg = load_full_config(opts=_opts(
            dataset="eurosat", method="hard_em_dirichlet", shots=0,
            number_tasks=4, batch_size=2, n_query=30, seed=7, iter=6,
            iter_mm=100, device_gather=dg), config_root=CONFIG_ROOT)
        accs.append(EvaluatorZeroShot(device="cpu", args=cfg)
                    .evaluate_tasks(feats, labels)[0])
    assert accs[0] == accs[1]


def test_entry_points_do_not_fall_back_to_cpu(tmp_path, monkeypatch, rng):
    """Without device='cpu' every entry point runs on cuda:{device} and
    raises where there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from transductive_clip_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    feats, labels = synth_features(rng)
    save_feature_cache(CACHE, feats, labels)
    opts = _opts(dataset="eurosat", method="em_dirichlet", shots=0,
                 number_tasks=2, batch_size=2, n_query=30)
    cfg = load_full_config(opts=opts, config_root=CONFIG_ROOT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EvaluatorZeroShot(args=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_zero_shot_method(cfg.name_method, args=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config-root", CONFIG_ROOT, "--opts", *opts,
                  "log_path", str(tmp_path / "logs")])


@pytest.mark.parametrize("key,value", [("data_parallel", True)])
def test_unported_evaluator_options_raise(rng, key, value):
    """JAX's one-device rule (its ``_maybe_task_mesh``): ``data_parallel``
    in one process with no task group runs the single-device path and
    gives exactly the ``data_parallel False`` result."""
    cfg = load_full_config(opts=_opts(dataset="eurosat", method="em_dirichlet",
                                      shots=0, number_tasks=4, batch_size=2,
                                      n_query=30), config_root=CONFIG_ROOT)
    feats, labels = synth_features(rng)
    want = EvaluatorZeroShot(device="cpu", args=cfg).evaluate_tasks(
        feats, labels)[0]
    cfg[key] = value
    ev = EvaluatorZeroShot(device="cpu", args=cfg)
    assert ev.evaluate_tasks(feats, labels)[0] == want


def test_registry_names_the_roadmap_item():
    """Every zero-shot name of the JAX registry resolves to the port's
    class of the same name (the roadmap's zero-shot items are all ported);
    an unknown name is refused."""
    from transductive_clip_tpu.methods import ZERO_SHOT_METHODS as JAX_ZS

    cfg = load_full_config(opts=_opts(dataset="eurosat", method="soft_kmeans"),
                           config_root=CONFIG_ROOT)
    assert len(JAX_ZS) == 8
    for name, jax_cls in JAX_ZS.items():
        config = {"CLIP": "inductive_clip"}.get(name, name.lower())
        method = get_zero_shot_method(name, device="cpu", args=load_full_config(
            opts=_opts(dataset="eurosat", method=config),
            config_root=CONFIG_ROOT))
        assert type(method).__name__ == jax_cls.__name__
    with pytest.raises(ValueError, match="Unknown zero-shot method"):
        get_zero_shot_method("NOPE", device="cpu", args=cfg)


def test_jax_written_cache_reads_equal(tmp_path, rng):
    """A .plk cache written by the JAX package's save_feature_cache reads
    back into equal arrays; npz too; orbax is refused."""
    feats, labels = synth_features(rng, n_per_class=5)
    plk = str(tmp_path / "ds" / "saved_features" / "test_softmax_RN50_T30.plk")
    jax_save(plk, feats, labels)
    f, lab = load_feature_cache(plk)
    np.testing.assert_array_equal(f, feats)
    np.testing.assert_array_equal(lab, labels)
    assert f.dtype == np.float32 and lab.dtype == np.int64
    npz = plk[:-4] + ".npz"
    jax_save(npz, feats, labels)
    f, lab = load_feature_cache(npz)
    np.testing.assert_array_equal(f, feats)
    with pytest.raises(NotImplementedError, match="orbax"):
        load_feature_cache(plk[:-4] + ".orbax")


@pytest.mark.parametrize("opts", [
    [],
    ["dataset", "imagenet", "method", "hard_em_dirichlet", "shots", "0",
     "number_tasks", "300", "batch_size", "100", "dirichlet_solver",
     "mm_pallas", "save_results", "False"],
])
def test_config_matches_jax(opts):
    jax_cfg = jax_config(opts=opts, config_root=CONFIG_ROOT)
    cfg = load_full_config(opts=opts, config_root=CONFIG_ROOT)
    assert dict(cfg) == dict(jax_cfg)
