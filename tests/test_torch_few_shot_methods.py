"""The port's PADDLE, BD-CSPN and LaplacianShot against the JAX package's, on
the same numpy inputs (the shapes of tests/test_method_oracles.py and
tests/test_methods_few_shot.py).

Required: equal predictions and LaplacianShot accuracy traces, soft ``u``
and criterion traces within 1e-5 absolute. The tasks are well separated
(Dirichlet-peaked softmax features) for the default ``matmul`` distances;
``direct`` runs on the same tasks and on overlapping ones.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu.core.config import CfgNode as JCfg
from transductive_clip_tpu.core.config import load_full_config as jax_config
from transductive_clip_tpu.methods import FEW_SHOT_METHODS as JAX_FS
from transductive_clip_tpu.methods import get_few_shot_method as jax_get
from transductive_clip_tpu.methods.few_shot import bdcspn as jbd
from transductive_clip_tpu.methods.few_shot import laplacian_shot as jls
from transductive_clip_tpu.methods.few_shot import paddle as jpd
from transductive_clip_tpu.utils.synthetic import make_few_shot_tasks
from transductive_clip_tpu_torch.core.config import CfgNode
from transductive_clip_tpu_torch.core.config import load_full_config
from transductive_clip_tpu_torch.methods import FEW_SHOT_METHODS
from transductive_clip_tpu_torch.methods import get_few_shot_method
from transductive_clip_tpu_torch.methods.few_shot import bdcspn as tbd
from transductive_clip_tpu_torch.methods.few_shot import laplacian_shot as tls
from transductive_clip_tpu_torch.methods.few_shot import paddle as tpd

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO, "config")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "reference_traces.npz")
ATOL = 1e-5


def make_fs(rng, n_task=2, n_class=5, shots=2, n_query=12, conc=40.0):
    """tests/test_method_oracles.py's tasks, in fp32."""
    y_s = np.tile(np.repeat(np.arange(n_class), shots), (n_task, 1))

    def feats(labels):
        out = np.zeros((*labels.shape, n_class))
        for t in range(labels.shape[0]):
            for i, c in enumerate(labels[t]):
                a = np.ones(n_class)
                a[c] += conc
                out[t, i] = rng.dirichlet(a)
        return out.astype(np.float32)

    y_q = rng.integers(0, n_class, (n_task, n_query))
    return feats(y_s), y_s, feats(y_q), y_q


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _assert_u(u_t, u_j):
    u_t, u_j = u_t.numpy(), np.asarray(u_j)
    assert u_t.shape == u_j.shape and u_t.dtype == np.float32
    np.testing.assert_array_equal(u_t.argmax(-1), u_j.argmax(-1))
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=ATOL)


TASKS = {"oracles": dict(), "overlapping": dict(n_class=8, n_query=30,
                                                conc=4.0)}


@pytest.mark.parametrize("tasks", list(TASKS))
@pytest.mark.parametrize("impl", ["matmul", "direct"])
def test_paddle_matches_jax(rng, tasks, impl):
    """paddle_infer, u0 = the query features, lambda 7, 5 iterations; the
    overlapping tasks run ``direct`` only (see the module docstring)."""
    if tasks == "overlapping" and impl == "matmul":
        impl = "direct"
    xs, ys, xq, _ = make_fs(rng, **TASKS[tasks])
    K = xq.shape[-1]
    u_j, c_j = jpd.paddle_infer(*_j(xs, xq, ys, xq), jnp.float32(7.0),
                                n_iter=5, n_class=K, dist_impl=impl)
    xs_t, xq_t, ys_t = _t(xs, xq, ys)
    u_t, c_t = tpd.paddle_infer(xs_t, xq_t, ys_t, xq_t, 7.0, n_iter=5,
                                n_class=K, dist_impl=impl)
    _assert_u(u_t, u_j)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("norm_type", ["L2N", "CL2N", "none"])
@pytest.mark.parametrize("impl", ["matmul", "direct"])
def test_bdcspn_matches_jax(rng, norm_type, impl):
    """bdcspn_infer at temp 20, every normalization, both impls; and the
    cosine logits alone."""
    xs, ys, xq, _ = make_fs(rng)
    K = xq.shape[-1]
    u_j = jbd.bdcspn_infer(*_j(xs, xq, ys), jnp.float32(20.0), n_class=K,
                           norm_type=norm_type, dist_impl=impl)
    u_t = tbd.bdcspn_infer(*_t(xs, xq, ys), 20.0, n_class=K,
                           norm_type=norm_type, dist_impl=impl)
    _assert_u(u_t, u_j)
    w = rng.normal(size=(2, 5, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tbd._cosine_logits(*_t(w, xq), dist_impl=impl).numpy(),
        np.asarray(jbd._cosine_logits(*_j(w, xq), dist_impl=impl)),
        rtol=0, atol=1e-6)


def _laplacian(xs, ys, xq, yq, **kw):
    """The two packages' laplacian_shot_infer on the same inputs."""
    kw = dict(dict(n_iter=8, knn=3, n_class=xq.shape[-1]), **kw)
    acc_j, Y_j = jls.laplacian_shot_infer(*_j(xs, xq, ys, yq),
                                          jnp.float32(0.7), **kw)
    acc_t, Y_t = tls.laplacian_shot_infer(*_t(xs, xq, ys, yq), 0.7, **kw)
    return (np.asarray(acc_j), Y_j), (acc_t.numpy(), Y_t)


@pytest.mark.parametrize("norm_type", ["L2N", "CL2N", "none"])
@pytest.mark.parametrize("impl", ["matmul", "direct"])
def test_laplacian_shot_matches_jax(rng, norm_type, impl):
    """laplacian_shot_infer, tests/test_method_oracles.py's tasks
    (10 queries), lmd 0.7, knn 3, 8 iterations: equal accuracy traces and
    predictions, Y within 1e-5."""
    xs, ys, xq, yq = make_fs(rng, n_query=10)
    (acc_j, Y_j), (acc_t, Y_t) = _laplacian(xs, ys, xq, yq,
                                           norm_type=norm_type,
                                           dist_impl=impl)
    assert acc_t.shape == (2, 8) and acc_t.dtype == np.float32
    np.testing.assert_array_equal(acc_t, acc_j)
    _assert_u(Y_t, Y_j)


@pytest.mark.parametrize("impl", ["matmul", "direct"])
def test_knn_affinity_duplicated_queries_tie_to_the_lower_index(rng, impl):
    """Queries 2, 5 and 7 are one point: each is at distance 0 from the
    other two, so with knn = 2 (one neighbour) the tie decides the graph.
    jax.lax.top_k takes the lower index, and so does the port (query 2 ->
    5, 5 -> 2, 7 -> 2); the whole graph equals the JAX one, and W is the
    actual nearest neighbours elsewhere (knn = 3)."""
    from scipy.spatial.distance import cdist

    x = rng.normal(size=(2, 10, 6)).astype(np.float32)
    x[:, 5] = x[:, 2]
    x[:, 7] = x[:, 2]
    for knn in (2, 3):
        W_t = tls.knn_affinity(torch.as_tensor(x), knn, dist_impl=impl)
        W_j = jls.knn_affinity(jnp.asarray(x), knn, dist_impl=impl)
        np.testing.assert_array_equal(W_t.numpy(), np.asarray(W_j))
        assert (W_t.sum(-1) == knn - 1).all()
    W = tls.knn_affinity(torch.as_tensor(x), 2, dist_impl=impl).numpy()
    for i, j in ((2, 5), (5, 2), (7, 2)):
        assert (np.flatnonzero(W[0, i]) == [j]).all()
    W = tls.knn_affinity(torch.as_tensor(x), 3, dist_impl=impl).numpy()
    for t in range(2):
        d = cdist(x[t], x[t])
        np.fill_diagonal(d, np.inf)
        for i in (0, 1, 3, 4, 6, 8, 9):
            want = set(np.argsort(d[i], kind="stable")[:2])
            assert set(np.flatnonzero(W[t, i])) == want


def test_laplacian_shot_duplicated_queries_match_jax(rng):
    """The whole method on tasks whose queries repeat (every query twice):
    the tied graph, then the bound updates, give the JAX traces."""
    xs, ys, xq, yq = make_fs(rng, n_query=6)
    xq, yq = np.concatenate([xq, xq], 1), np.concatenate([yq, yq], 1)
    (acc_j, Y_j), (acc_t, Y_t) = _laplacian(xs, ys, xq, yq, knn=2)
    np.testing.assert_array_equal(acc_t, acc_j)
    _assert_u(Y_t, Y_j)


def make_cfg(cls=CfgNode, n_class=8, **over):
    """tests/test_methods_few_shot.py's configuration."""
    cfg = cls(dict(
        num_classes_test=n_class, n_class=n_class, n_query=30, k_eff=4,
        iter=15, iter_mm=300, T=30, use_softmax_feature=True, shots=2,
        batch_size=3, seed=0, lambd=5.0, temp=30.0, norm_type="L2N", knn=3,
        lmd=0.7, device=0))
    cfg.update(over)
    return cfg


def _fs_tasks(rng, concentration=60.0):
    """tests/test_methods_few_shot.py's tasks [3, 2 x 8 support, 30
    queries on 4 classes]."""
    xs, ys, xq, yq = make_few_shot_tasks(rng, 3, n_query=30, n_class=8,
                                         shots=2, k_eff=4,
                                         concentration=concentration)
    return {"x_s": xs, "y_s": ys, "x_q": xq, "y_q": yq}


@pytest.mark.parametrize("name,over", [
    ("PADDLE", {}), ("BDCSPN", {}), ("BDCSPN", {"norm_type": "CL2N"}),
    ("LAPLACIAN_SHOT", {"iter": 20}),
    ("LAPLACIAN_SHOT", {"iter": 20, "norm_type": "CL2N"}),
])
def test_run_task_matches_jax(rng, name, over):
    """The method classes through run_task: the JAX package's accuracies
    (LaplacianShot: the [N, iter] trace), predictions and criterion
    trace, and accuracy > 0.9 on these separable tasks."""
    task = _fs_tasks(rng)
    logs_j = jax_get(name, args=make_cfg(JCfg, **over)).run_task(task, shot=2)
    logs_t = get_few_shot_method(name, device="cpu",
                                 args=make_cfg(**over)).run_task(task, shot=2)
    assert logs_t["acc"].shape == logs_j["acc"].shape
    np.testing.assert_array_equal(logs_t["acc"], logs_j["acc"])
    np.testing.assert_array_equal(logs_t["preds"], logs_j["preds"])
    np.testing.assert_allclose(np.asarray(logs_t["criterions"]),
                               np.asarray(logs_j["criterions"]), rtol=0,
                               atol=ATOL)
    assert logs_t["acc"][:, -1].mean() > 0.9
    assert logs_t["timestamps"] > 0


def test_laplacian_shot_freeze_trace(rng):
    """tests/test_methods_few_shot.py's case: once a task converges its
    accuracy trace stays constant; the trace is [N, iter] and equals the
    JAX one."""
    task = _fs_tasks(rng, concentration=100.0)
    logs = get_few_shot_method("LAPLACIAN_SHOT", device="cpu",
                               args=make_cfg(iter=20)).run_task(task, shot=2)
    acc = logs["acc"]
    assert acc.shape == (3, 20)
    np.testing.assert_array_equal(acc[:, -1], acc[:, -2])
    logs_j = jax_get("LAPLACIAN_SHOT", args=make_cfg(JCfg, iter=20)).run_task(
        task, shot=2)
    np.testing.assert_array_equal(acc, logs_j["acc"])


def test_laplacian_shot_task_chunk(rng):
    """task_chunk 1 runs the three tasks one at a time: the same trace and
    predictions as one batch, and as the JAX package's chunked run."""
    task = _fs_tasks(rng)
    whole = get_few_shot_method("LAPLACIAN_SHOT", device="cpu",
                                args=make_cfg(iter=10)).run_task(task, shot=2)
    chunked = get_few_shot_method(
        "LAPLACIAN_SHOT", device="cpu",
        args=make_cfg(iter=10, task_chunk=1)).run_task(task, shot=2)
    ref = jax_get("LAPLACIAN_SHOT",
                  args=make_cfg(JCfg, iter=10, task_chunk=1)).run_task(
        task, shot=2)
    for logs in (chunked, ref):
        np.testing.assert_array_equal(logs["acc"], whole["acc"])
        np.testing.assert_array_equal(logs["preds"], whole["preds"])


def test_laplacian_shot_declines_the_pipelines():
    """The JAX class has no _infer, so its deferred and fused routes raise
    (ROADMAP.md, fault F5); the port's returns None from both, and the
    evaluator runs the blocking run_task on every route."""
    method = get_few_shot_method("LAPLACIAN_SHOT", device="cpu",
                                 args=make_cfg())
    assert method.run_task_deferred({}) is None
    assert method.run_task_fused(None, None, None, None, None, None) is None
    jax_method = jax_get("LAPLACIAN_SHOT", args=make_cfg(JCfg))
    with pytest.raises(NotImplementedError):
        jax_method._infer({})


@pytest.fixture(scope="module")
def traces():
    return dict(np.load(FIXTURE))


@pytest.mark.parametrize("method", ["paddle", "bdcspn", "laplacian_shot"])
def test_few_shot_golden_traces(traces, method):
    """tests/test_golden_traces.py's few-shot inputs and configuration: the
    reference's accuracies."""
    rng = np.random.default_rng(1)
    xs, ys, xq, yq = make_few_shot_tasks(rng, 4, n_query=40, n_class=8,
                                         shots=2, k_eff=4,
                                         concentration=12.0)
    cfg = load_full_config(
        opts=["dataset", "eurosat", "method", method, "shots", "2",
              "num_classes_test", "8", "n_query", "40", "k_eff", "4",
              "batch_size", "4"], config_root=CONFIG_ROOT)
    logs = get_few_shot_method(cfg.name_method, device="cpu",
                               args=cfg).run_task(
        {"x_s": xs, "y_s": ys, "x_q": xq, "y_q": yq}, shot=2)
    np.testing.assert_array_equal(logs["acc"][:, -1],
                                  traces[f"fs_{method}_acc"])


def test_registry_and_lambda_match_jax():
    """All seven few-shot names of the JAX registry, the same classes'
    names, and PADDLE's lambda from the config."""
    assert set(FEW_SHOT_METHODS) == set(JAX_FS)
    for name, cls in FEW_SHOT_METHODS.items():
        assert cls.__name__ == JAX_FS[name].__name__
    cfg = jax_config(opts=["method", "paddle", "shots", "4"],
                     config_root=CONFIG_ROOT)
    assert tpd.PADDLE(device="cpu", args=load_full_config(
        opts=["method", "paddle", "shots", "4"],
        config_root=CONFIG_ROOT)).lambd == jax_get("PADDLE", args=cfg).lambd
