"""The port's ``em_dirichlet_infer`` against the JAX package's on the same
numpy tasks (the shapes of tests/test_compaction.py, plus a 12-task batch
so that task compaction, ``compact_tasks = 8``, engages), for the solvers
'minka', 'pallas' and 'mm_pallas' (the latter two through their plain
versions on the CPU, against the Pallas kernels in interpret mode).

Required: identical predictions, u within atol 1e-4, the same executed
iteration split [total, full-batch] and the same max populated-cluster
count."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu.methods.zero_shot.em_dirichlet import (
    em_dirichlet_infer as jax_infer,
)
from transductive_clip_tpu_torch.methods.zero_shot import em_dirichlet as tem
from transductive_clip_tpu_torch.ops import cuda_dirichlet as cd

from conftest import make_simplex_tasks

torch.set_num_threads(2)

SOLVERS = ("minka", "pallas", "mm_pallas")


def _both(x, lambd, **kw):
    u_j, c_j, split_j, pop_j = jax_infer(
        jnp.asarray(x), jnp.float32(lambd), return_iter_split=True, **kw)
    u_t, c_t, split_t, pop_t = tem.em_dirichlet_infer(
        torch.as_tensor(x), lambd, return_iter_split=True, **kw)
    return ((np.asarray(u_j), np.asarray(c_j), np.asarray(split_j),
             int(pop_j)),
            (u_t.numpy(), c_t.numpy(), np.asarray(split_t), int(pop_t)))


def _assert_same(jax_out, torch_out):
    (u_j, c_j, split_j, pop_j), (u_t, c_t, split_t, pop_t) = jax_out, torch_out
    assert u_t.shape == u_j.shape and c_t.shape == c_j.shape
    np.testing.assert_array_equal(u_t.argmax(-1), u_j.argmax(-1))
    np.testing.assert_allclose(u_t, u_j, atol=1e-4)
    np.testing.assert_array_equal(split_t, split_j)
    assert pop_t == pop_j


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_em_matches_jax_k120(rng, solver, hard, compact):
    """[3, 20, 120]: compaction on and off, soft and hard.

    With 'minka' the early-stop test runs at 1e-5, not the default 1e-6:
    once u is saturated, a re-solve of the Newton-Minka solve moves alpha by
    its own stopping noise (its tol 1e-11 on ||ds||^2/||s||^2 accepts a
    relative change of ~3e-6 in the row sums), so the per-task change sits
    at ~1e-7..1.3e-6 on both sides and the default test fires one iteration
    apart on fp32 noise alone (JAX 3 iterations, the port 4, on this case).
    """
    x, _ = make_simplex_tasks(rng, n_task=3, n_query=20, n_class=120,
                              k_eff=5, concentration=80.0)
    lambd = float(int(120 / 5) * 20)
    tol = 1e-5 if solver == "minka" else 1e-6
    _assert_same(*_both(x, lambd, n_iter=6, iter_mm=200, hard=hard,
                        solver=solver, compact=compact, early_stop_tol=tol))


@pytest.mark.parametrize("solver", SOLVERS)
def test_em_matches_jax_compact_first_fast_tier(rng, solver):
    """[4, 20, 300]: iteration-1 compaction and the two-tier solve (the
    populated count falls under n_fast = 32, so the fast tier runs)."""
    x, _ = make_simplex_tasks(rng, n_task=4, n_query=20, n_class=300,
                              k_eff=6, concentration=60.0)
    lambd = float(int(300 / 5) * 20)
    jax_out, torch_out = _both(x, lambd, n_iter=8, iter_mm=300, hard=False,
                               solver=solver, compact=True,
                               compact_first=True, early_stop=False)
    _assert_same(jax_out, torch_out)
    assert torch_out[3] <= tem._COMPACT_FAST < 20 + tem._COMPACT_MARGIN


@pytest.mark.parametrize("solver", SOLVERS)
def test_em_matches_jax_task_compaction(rng, solver):
    """12 tasks with compact_tasks = 8: phase 2 continues the stragglers in
    the narrow buffer (the split shows fewer full-batch iterations than
    iterations in all)."""
    x, _ = make_simplex_tasks(rng, n_task=12, n_query=20, n_class=120,
                              k_eff=5, concentration=80.0)
    lambd = float(int(120 / 5) * 20)
    jax_out, torch_out = _both(x, lambd, n_iter=10, iter_mm=200, hard=False,
                               solver=solver, compact=True,
                               compact_first=True, compact_tasks=8)
    _assert_same(jax_out, torch_out)


def test_task_compaction_engages(rng):
    """The 12-task case really runs a narrow phase: fewer full-batch
    iterations than iterations in all."""
    x, _ = make_simplex_tasks(rng, n_task=12, n_query=20, n_class=120,
                              k_eff=5, concentration=80.0)
    lambd = float(int(120 / 5) * 20)
    _, _, split, _ = tem.em_dirichlet_infer(
        torch.as_tensor(x), lambd, n_iter=10, iter_mm=200, hard=False,
        solver="minka", compact=True, compact_first=True, compact_tasks=8,
        return_iter_split=True)
    assert split[1] < split[0]


def test_fast_tier_equals_wide_tier(rng, monkeypatch):
    """The fast tier (n_fast rows solved) gives bit-identical results to the
    wide tier whenever its gate lets it engage."""
    x, _ = make_simplex_tasks(rng, n_task=4, n_query=20, n_class=300,
                              k_eff=6, concentration=60.0)
    kw = dict(n_iter=8, iter_mm=300, hard=False, solver="pallas",
              compact=True, compact_first=True, early_stop=False)
    q = torch.as_tensor(x)
    u_fast, c_fast = tem.em_dirichlet_infer(q, 1200.0, **kw)
    monkeypatch.setattr(tem, "_COMPACT_FAST", 10 ** 9)
    u_wide, c_wide = tem.em_dirichlet_infer(q, 1200.0, **kw)
    assert torch.equal(u_fast, u_wide)
    assert torch.equal(c_fast, c_wide)


def test_compact_state_update_is_in_place(rng):
    """The compact step writes the solved rows into the [N, K, K] state in
    place (no copy of the state per iteration)."""
    x, _ = make_simplex_tasks(rng, n_task=2, n_query=20, n_class=120,
                              k_eff=4, concentration=80.0)
    q = torch.as_tensor(x)
    lq = torch.log(q + tem.EPS)
    alpha = torch.ones(2, 120, 120)
    l12 = torch.zeros(2, 120)
    l3 = torch.zeros(2, 20, 120)
    out = tem._em_step_compact(q, alpha, l12, l3, lq, 480.0, 20, 120, 200,
                               "pallas", False, 36, pop_max=120, n_fast=32)
    assert out[1].data_ptr() == alpha.data_ptr()
    assert not torch.equal(alpha, torch.ones(2, 120, 120))


def test_method_guard_and_launch_counts_on_cpu(rng):
    """The method wrapper with solver 'pallas' on the CPU: the first-batch
    guard runs, the plain version serves every solve (no launch counted),
    and the predictions match the JAX method's."""
    from transductive_clip_tpu.core.config import CfgNode as JCfg
    from transductive_clip_tpu.methods import get_zero_shot_method as jget
    from transductive_clip_tpu_torch.core.config import CfgNode
    from transductive_clip_tpu_torch.methods import get_zero_shot_method

    x, y = make_simplex_tasks(rng, n_task=4, n_query=20, n_class=300,
                              k_eff=6, concentration=60.0)
    opts = dict(
        name_method="HARD_EM_DIRICHLET", n_class=300, num_classes_test=300,
        n_query=20, T=30, use_softmax_feature=True, graph_matching=True,
        matching_backend="host", iter=8, iter_mm=300,
        dirichlet_solver="pallas", compact_clusters=True,
    )
    method = get_zero_shot_method("HARD_EM_DIRICHLET", device="cpu",
                                  args=CfgNode(opts))
    launches = cd.dirichlet_row_solve.launches
    logs = method.run_task({"x_q": x, "y_q": y[..., None]})
    assert method.compact_first and not method._cf_guard_pending
    assert cd.dirichlet_row_solve.launches == launches
    ref = jget("HARD_EM_DIRICHLET", args=JCfg(opts)).run_task(
        {"x_q": x, "y_q": y[..., None]})
    np.testing.assert_array_equal(logs["preds"], ref["preds"])
    np.testing.assert_array_equal(logs["acc"], ref["acc"])
    assert logs["criterions"].shape == ref["criterions"].shape


def _pipeline_task(rng, shots, n_class=10, n_task=3, n_query=20):
    """A batch as host tables plus index matrices: query rows [M, K] with
    labels, and for few-shot the support rows (every class x shots)."""
    x, y = make_simplex_tasks(rng, n_task=n_task, n_query=n_query,
                              n_class=n_class, k_eff=3, concentration=60.0)
    tables = {"q": (x.reshape(-1, n_class), y.reshape(-1))}
    idx = {"q": np.arange(x.shape[0] * n_query).reshape(n_task, n_query)}
    task = {"x_q": x, "y_q": y[..., None]}
    if shots:
        y_s = np.tile(np.repeat(np.arange(n_class), shots), (n_task, 1))
        conc = np.ones((*y_s.shape, n_class))
        np.put_along_axis(conc, y_s[..., None], 61.0, axis=-1)
        x_s = rng.gamma(conc).astype(np.float32)
        x_s /= x_s.sum(-1, keepdims=True)
        tables["s"] = (x_s.reshape(-1, n_class), y_s.reshape(-1))
        idx["s"] = np.arange(y_s.size).reshape(y_s.shape)
        task.update(x_s=x_s, y_s=y_s[..., None])
    return task, tables, idx


@pytest.mark.parametrize("pipeline", ["run_task_fused", "run_task_deferred"])
@pytest.mark.parametrize("shots,name", [(0, "EM_DIRICHLET"),
                                        (0, "HARD_EM_DIRICHLET"),
                                        (4, "EM_DIRICHLET"),
                                        (4, "ALPHA_TIM")])
def test_pipelines_match_run_task(rng, shots, name, pipeline):
    """Zero- and few-shot methods alike: the deferred and the fused
    pipelines queue the batch, and their fetched handles finalize into the
    accuracies, predictions and criterion trace of the blocking run_task on
    the same batch (the zero-shot ones with the device auction)."""
    from transductive_clip_tpu_torch.core.config import load_full_config
    from transductive_clip_tpu_torch.methods import (
        get_few_shot_method,
        get_zero_shot_method,
    )
    from transductive_clip_tpu_torch.methods.base import fetch_tree

    cfg = load_full_config(opts=["dataset", "eurosat", "method", name.lower(),
                                 "shots", str(shots), "n_query", "20",
                                 "iter", "30", "matching_backend", "device"],
                           config_root="config")
    get = get_zero_shot_method if shots == 0 else get_few_shot_method
    task, tables, idx = _pipeline_task(rng, shots)
    blocking = get(name, device="cpu", args=cfg).run_task(task)
    method = get(name, device="cpu", args=cfg)
    if pipeline == "run_task_deferred":
        res = method.run_task_deferred(task)
    else:
        dev = {k: tuple(torch.as_tensor(a) for a in t)
               for k, t in tables.items()}
        if shots == 0:
            res = method.run_task_fused(*dev["q"], idx["q"])
        else:
            res = method.run_task_fused(dev["s"][0], dev["q"][0], dev["s"][1],
                                        dev["q"][1], idx["s"], idx["q"])
    logs = res.finalize(fetch_tree(res.handles), 1e-3)
    np.testing.assert_array_equal(logs["preds"], blocking["preds"])
    np.testing.assert_array_equal(logs["acc"], blocking["acc"])
    np.testing.assert_array_equal(logs["criterions"], blocking["criterions"])
    assert logs["timestamps"] == 1e-3
