"""The port's own copies of the JAX package's substrate against the
originals, on the same numpy inputs: task sampling and generation draw the
same tasks from the same seed, the synthetic tasks, the cluster->class
matching, the row selections of ops/common.py and the initial soft
assignments."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu import tasks as jtasks
from transductive_clip_tpu.methods import base as jbase
from transductive_clip_tpu.ops import common as jcommon
from transductive_clip_tpu.ops import matching as jmatching
from transductive_clip_tpu.utils import synthetic as jsynth
from transductive_clip_tpu_torch import tasks as ttasks
from transductive_clip_tpu_torch.methods import base as tbase
from transductive_clip_tpu_torch.ops import common as tcommon
from transductive_clip_tpu_torch.ops import matching as tmatching
from transductive_clip_tpu_torch.utils import synthetic as tsynth

torch.set_num_threads(2)


def _draw(pkg, labels, feats, seed, force):
    sampler = pkg.CategoriesSamplerZeroShot(5, 4, 12, 30, force_query_size=force,
                                            rng=np.random.default_rng(seed))
    sampler.create_list_classes(labels)
    idx = list(pkg.SamplerQueryZeroShot(sampler))
    loader = [(feats[i], labels[i]) for i in idx]
    tasks = pkg.TasksGeneratorZeroShot(k_eff=4, n_query=30, n_class=12,
                                       loader_query=loader).generate_tasks()
    return idx, tasks


@pytest.mark.parametrize("force", [True, False])
def test_sampler_and_generator_draw_as_jax(rng, force):
    labels = rng.permutation(np.repeat(np.arange(12), 15))
    feats = rng.random((labels.size, 12)).astype(np.float32)
    idx_t, tasks_t = _draw(ttasks, labels, feats, 11, force)
    idx_j, tasks_j = _draw(jtasks, labels, feats, 11, force)
    assert len(idx_t) == len(idx_j) == 5
    for a, b in zip(idx_t, idx_j):
        np.testing.assert_array_equal(a, b)
    for key in ("x_q", "y_q"):
        np.testing.assert_array_equal(tasks_t[key], tasks_j[key])


@pytest.mark.parametrize("k_eff", [None, 4])
def test_synthetic_tasks_match_jax(k_eff):
    got = tsynth.make_zero_shot_tasks(np.random.default_rng(3), 3, 20, 9,
                                      k_eff=k_eff)
    ref = jsynth.make_zero_shot_tasks(np.random.default_rng(3), 3, 20, 9,
                                      k_eff=k_eff)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _matching_inputs(rng, n_task=4, n=20, k=8):
    preds = rng.integers(0, k, size=(n_task, n))
    probs = rng.dirichlet(np.ones(k), size=(n_task, k))          # [N, K, C]
    return preds, probs


@pytest.mark.parametrize("name", ["hungarian_matching", "basic_matching"])
def test_matching_matches_jax(rng, name):
    preds, probs = _matching_inputs(rng)
    np.testing.assert_array_equal(getattr(tmatching, name)(preds, probs),
                                  getattr(jmatching, name)(preds, probs))


def test_row_matching_and_prototypes_match_jax(rng):
    n_task, n, k = 4, 20, 8
    _, probs = _matching_inputs(rng, n_task, n, k)
    # at most 5 clusters present, so the top 6 rows by count cover them
    preds = np.stack([rng.choice(rng.choice(k, 5, replace=False), n)
                      for _ in range(n_task)])
    counts = (preds[..., None] == np.arange(k)).sum(1)
    row_idx = np.argsort(-counts, axis=-1, kind="stable")[:, :6]
    present = np.take_along_axis(counts, row_idx, -1) > 0
    assert all(np.isin(preds[t], row_idx[t][present[t]]).all()
               for t in range(n_task))
    row_probs = np.take_along_axis(probs, row_idx[..., None], 1)
    np.testing.assert_array_equal(
        tmatching.hungarian_matching_rows(preds, row_idx, row_probs, k),
        jmatching.hungarian_matching_rows(preds, row_idx, row_probs, k))
    cols = np.stack([rng.permutation(k)[:6] for _ in range(n_task)])
    np.testing.assert_array_equal(
        tmatching.scatter_matching_rows(preds, row_idx, cols, k),
        jmatching.scatter_matching_rows(preds, row_idx, cols, k))
    one_hot = (preds[..., None] == np.arange(k)).astype(np.float32)
    query = rng.random((n_task, n, 5))
    np.testing.assert_array_equal(
        tmatching.cluster_prototypes(one_hot, query),
        jmatching.cluster_prototypes(one_hot, query))


def _counts(rng, populated):
    """[3, 40] cluster masses, ``populated`` rows per task carrying mass
    (some of them tied) and the rest tied at 0."""
    counts = np.zeros((3, 40), np.float32)
    for t in range(3):
        rows = rng.choice(40, size=populated, replace=False)
        counts[t, rows] = rng.integers(1, 4, size=populated)
    return counts


@pytest.mark.parametrize("impl", ["topk", "rank"])
@pytest.mark.parametrize("populated", [7, 25])
def test_row_selection_matches_jax(rng, impl, populated):
    counts = _counts(rng, populated)
    cnt_t, idx_t = tcommon.select_rows_covering(torch.as_tensor(counts), 10,
                                                1e-15, impl)
    cnt_j, idx_j = jcommon.select_rows_covering(jnp.asarray(counts), 10,
                                                1e-15, impl)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    got = tcommon.rank_select_rows(torch.as_tensor(counts), 10)
    ref = jcommon.rank_select_rows(jnp.asarray(counts), 10)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("softmax", [True, False])
def test_init_soft_assignments_match_jax(rng, softmax):
    cfg = SimpleNamespace(use_softmax_feature=softmax, T=30.0)
    query = rng.random((2, 6, 5)).astype(np.float32)
    text = None if softmax else rng.normal(size=(4, 5)).astype(np.float32)
    got = tbase.init_soft_assignments(
        torch.as_tensor(query), cfg,
        None if text is None else torch.as_tensor(text))
    ref = jbase.init_soft_assignments(
        jnp.asarray(query), cfg, None if text is None else jnp.asarray(text))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
