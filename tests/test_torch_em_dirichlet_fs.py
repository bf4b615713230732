"""The port's few-shot EM-Dirichlet against the JAX package's on the same
numpy tasks (the shapes of tests/test_compaction.py): soft and hard, with
compaction on and off, for the solvers 'minka', 'pallas' and 'mm_pallas'
(the kernels through their plain versions on the CPU, against the Pallas
kernels in interpret mode); the shots = 1 drained-row case the JAX
docstring describes; the two-tier solve; and the method through run_task.

Required: identical predictions, u within atol 1e-4, the same executed
iteration count and max populated-cluster count, and the criterion trace
within rtol 1e-4, atol 1e-6 — the solvers stop at a relative tolerance of
1e-11 on squared changes, so a trace entry of a converged iteration is that
stopping noise (~1e-7 on either side, in another order of fp32 sums)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu.core.config import CfgNode as JCfg
from transductive_clip_tpu.methods import get_few_shot_method as jget
from transductive_clip_tpu.methods.few_shot.em_dirichlet import (
    em_dirichlet_fs_infer as jax_infer,
)
from transductive_clip_tpu.utils.synthetic import make_few_shot_tasks
from transductive_clip_tpu_torch.core.config import CfgNode
from transductive_clip_tpu_torch.methods import get_few_shot_method
from transductive_clip_tpu_torch.methods.few_shot import em_dirichlet as tem
from transductive_clip_tpu_torch.ops import cuda_dirichlet as cd

torch.set_num_threads(2)

SOLVERS = ("minka", "pallas", "mm_pallas")


def _both(xs, ys, xq, lambd, **kw):
    u_j, c_j, it_j, pop_j = jax_infer(
        jnp.asarray(xs), jnp.asarray(xq), jnp.asarray(ys), jnp.float32(lambd),
        return_n_iter=True, **kw)
    u_t, c_t, it_t, pop_t = tem.em_dirichlet_fs_infer(
        torch.as_tensor(xs), torch.as_tensor(xq), torch.as_tensor(ys), lambd,
        return_n_iter=True, **kw)
    return ((np.asarray(u_j), np.asarray(c_j), int(it_j), int(pop_j)),
            (u_t.numpy(), c_t.numpy(), it_t, pop_t))


def _assert_same(jax_out, torch_out):
    (u_j, c_j, it_j, pop_j), (u_t, c_t, it_t, pop_t) = jax_out, torch_out
    assert u_t.shape == u_j.shape and c_t.shape == c_j.shape
    np.testing.assert_array_equal(u_t.argmax(-1), u_j.argmax(-1))
    np.testing.assert_allclose(u_t, u_j, atol=1e-4)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-6)
    assert (it_t, pop_t) == (it_j, pop_j)


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_fs_em_matches_jax_k120(rng, solver, hard, compact):
    """[3 tasks, 2 shots x 120 classes support, 20 queries]: compaction
    engages (120 > 2 x (20 + 16)) when on; early stop at the default 1e-6."""
    xs, ys, xq, _ = make_few_shot_tasks(rng, 3, 20, 120, 2, k_eff=5)
    _assert_same(*_both(xs, ys, xq, float(int(120 / 5) * 20), n_iter=6,
                        iter_mm=200, n_class=120, hard=hard, solver=solver,
                        compact=compact))


def _feats(rng, labels, K, conc):
    out = np.zeros((*labels.shape, K), np.float32)
    for t in range(labels.shape[0]):
        for i, c in enumerate(labels[t]):
            a = np.ones(K)
            a[c] += conc
            out[t, i] = rng.dirichlet(a)
    return out


@pytest.fixture
def flush_denormal():
    """torch's CPU flushing fp32 denormals to zero, as XLA's CPU backend
    does: the compaction's populated predicate is ``mass > 0``, and with
    denormals kept a row whose query mass is ~1e-40 counts as populated in
    the port and not in the JAX package (ROADMAP.md, "Faults")."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("hard", [False, True])
def test_fs_em_shots1_drained_rows_match_jax(rng, hard, flush_denormal):
    """shots = 1 on near-flat queries: the single-sample Dirichlet MLE
    diverges, so the drained rows take ``alpha_base``, one capped solve's
    worth of the reference's creep. The port and the JAX package apply the
    same substitution; the compact path keeps the exact path's predictions,
    as tests/test_compaction.py asserts for JAX."""
    n_task, K, n = 3, 300, 25
    ys = np.tile(np.arange(K), (n_task, 1))
    xs = _feats(rng, ys, K, 80.0)
    xq = _feats(rng, rng.integers(0, 8, (n_task, n)), K, 5.0)
    kw = dict(n_iter=8, iter_mm=300, n_class=K, hard=hard, solver="minka",
              early_stop=False)
    lambd = float(int(K / 5) * n)
    jax_out, torch_out = _both(xs, ys, xq, lambd, compact=True, **kw)
    _assert_same(jax_out, torch_out)
    u_full, _ = tem.em_dirichlet_fs_infer(
        torch.as_tensor(xs), torch.as_tensor(xq), torch.as_tensor(ys), lambd,
        compact=False, **kw)
    np.testing.assert_array_equal(u_full.numpy().argmax(-1),
                                  torch_out[0].argmax(-1))


@pytest.mark.parametrize("solver", ["minka", "pallas"])
def test_fs_fast_tier_matches_jax_and_wide_tier(rng, solver, monkeypatch):
    """[3, 20, 300], shots = 1: the populated count falls under n_fast = 32,
    so the fast tier runs; it equals the JAX package and, bit for bit, the
    wide tier."""
    xs, ys, xq, _ = make_few_shot_tasks(rng, 3, 20, 300, 1, k_eff=5)
    lambd = float(int(300 / 5) * 20)
    kw = dict(n_iter=8, iter_mm=300, n_class=300, hard=False, solver=solver,
              early_stop=False, compact=True)
    jax_out, torch_out = _both(xs, ys, xq, lambd, **kw)
    _assert_same(jax_out, torch_out)
    assert torch_out[3] <= tem._COMPACT_FAST < 20 + tem._COMPACT_MARGIN
    args = (torch.as_tensor(xs), torch.as_tensor(xq), torch.as_tensor(ys),
            lambd)
    u_fast, c_fast = tem.em_dirichlet_fs_infer(*args, **kw)
    monkeypatch.setattr(tem, "_COMPACT_FAST", 10 ** 9)
    u_wide, c_wide = tem.em_dirichlet_fs_infer(*args, **kw)
    assert torch.equal(u_fast, u_wide) and torch.equal(c_fast, c_wide)


def test_fs_compact_select_rank_matches_jax(rng):
    xs, ys, xq, _ = make_few_shot_tasks(rng, 3, 20, 120, 2, k_eff=5)
    _assert_same(*_both(xs, ys, xq, float(int(120 / 5) * 20), n_iter=6,
                        iter_mm=200, n_class=120, hard=True, solver="minka",
                        select="rank"))


@pytest.mark.parametrize("name,solver", [("EM_DIRICHLET", "pallas"),
                                         ("HARD_EM_DIRICHLET", "mm_pallas")])
def test_fs_methods_run_task_match_jax(rng, name, solver):
    """The method wrappers: the same predictions and accuracies as the JAX
    methods; on the CPU the plain versions serve every solve."""
    xs, ys, xq, yq = make_few_shot_tasks(rng, 3, 20, 120, 2, k_eff=5)
    opts = dict(name_method=name, num_classes_test=120, n_class=120,
                n_query=20, k_eff=5, T=30, use_softmax_feature=True, iter=6,
                iter_mm=200, dirichlet_solver=solver, shots=2)
    task = {"x_s": xs, "y_s": ys, "x_q": xq, "y_q": yq}
    launches = (cd.dirichlet_row_solve.launches, cd.mm_row_solve.launches)
    logs = get_few_shot_method(name, device="cpu",
                               args=CfgNode(opts)).run_task(dict(task))
    assert (cd.dirichlet_row_solve.launches,
            cd.mm_row_solve.launches) == launches
    ref = jget(name, args=JCfg(opts)).run_task(dict(task))
    np.testing.assert_array_equal(logs["preds"], ref["preds"])
    np.testing.assert_array_equal(logs["acc"], ref["acc"])
    assert logs["criterions"].shape == ref["criterions"].shape
    assert logs["acc"].mean() > 0.9
