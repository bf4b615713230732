"""The port's ``tim_infer`` and the TIM methods against the JAX package's on
the same numpy tasks (the shapes of tests/test_methods_few_shot.py): the
three gradient implementations ('pallas' through K3's plain version on the
CPU, against the Pallas kernel in interpret mode), both entropy tuples, 40
Adam steps; the opt-in early stop with and without its straggler phase;
bf16 Adam moments; the one-hot CE; the ``resolve_*`` functions; and
ALPHA_TIM / TIM-GD through ``run_task``.

Tolerances are the JAX tests' own for two gradient implementations of the
same trajectory (tests/test_methods_few_shot.py:227-230): u within rtol
1e-4, atol 1e-5; the criterion trace within rtol 5e-3, atol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu.core.config import CfgNode as JCfg
from transductive_clip_tpu.methods import get_few_shot_method as jget
from transductive_clip_tpu.methods.few_shot import tim as jtim
from transductive_clip_tpu.utils.synthetic import make_few_shot_tasks
from transductive_clip_tpu_torch.core.config import CfgNode
from transductive_clip_tpu_torch.methods import get_few_shot_method
from transductive_clip_tpu_torch.methods.few_shot import tim as ttim
from transductive_clip_tpu_torch.ops import cuda_tim as ct

torch.set_num_threads(2)

ENTROPIES = [("Shannon", "Alpha", "Alpha"), ("Alpha", "Shannon", "Shannon")]


def _tasks(rng, n_task=2, n_query=15, shuffle=True, non_uniform=False):
    xs, ys, xq, yq = make_few_shot_tasks(rng, n_task, n_query=n_query,
                                         n_class=6, shots=2, k_eff=3)
    if shuffle:
        perm = rng.permutation(xs.shape[1])
        xs, ys = xs[:, perm], ys[:, perm]
    if non_uniform:
        ys = ys.copy()
        ys[:, 0] = (ys[:, 1] + 1) % 6
    return xs, ys, xq, yq


def _run_both(xs, ys, xq, n_class=6, temp=15.0, alpha=5.0, **kw):
    out_j = jtim.tim_infer(
        jnp.asarray(xs), jnp.asarray(xq), jnp.asarray(ys, jnp.int32),
        jnp.float32(temp), jnp.float32(alpha), jnp.ones(3, jnp.float32),
        n_class=n_class, **kw)
    out_t = ttim.tim_infer(
        torch.as_tensor(xs), torch.as_tensor(xq), torch.as_tensor(ys),
        temp, alpha, [1.0, 1.0, 1.0], n_class=n_class, **kw)
    return ([np.asarray(o) for o in out_j],
            [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
             for o in out_t])


def _assert_close(out_j, out_t, msg=""):
    (u_j, c_j, *rest_j), (u_t, c_t, *rest_t) = out_j, out_t
    assert u_t.shape == u_j.shape and c_t.shape == c_j.shape
    np.testing.assert_array_equal(u_t.argmax(-1), u_j.argmax(-1), err_msg=msg)
    np.testing.assert_allclose(u_t, u_j, rtol=1e-4, atol=1e-5, err_msg=msg)
    np.testing.assert_allclose(c_t, c_j, rtol=5e-3, atol=1e-5, err_msg=msg)
    for a, b in zip(rest_t, rest_j):
        np.testing.assert_array_equal(a, b, err_msg=msg)


@pytest.mark.parametrize("entropies", ENTROPIES)
@pytest.mark.parametrize("grad_impl", ["autodiff", "manual", "pallas"])
def test_tim_infer_matches_jax(rng, grad_impl, entropies):
    """40 steps at 'highest'; K3's case with non-uniform labels (any label
    layout), the others with the uniform shuffled support 'manual' needs."""
    xs, ys, xq, _ = _tasks(rng, non_uniform=grad_impl == "pallas")
    launches = ct.tim_support_grad.launches
    out_j, out_t = _run_both(xs, ys, xq, n_iter=40, entropies=entropies,
                             lr=1e-3, precision="highest",
                             grad_impl=grad_impl)
    _assert_close(out_j, out_t, msg=f"{grad_impl} {entropies}")
    assert ct.tim_support_grad.launches == launches   # plain version on CPU


def test_tim_infer_pallas_default_precision_matches_jax(rng):
    """K3's bf16 path ('default'): the plain version rounds x, W and G to
    bf16 as the Pallas kernel does; the rest of the step is fp32 on both
    sides off the TPU."""
    xs, ys, xq, _ = _tasks(rng, non_uniform=True)
    out_j, out_t = _run_both(xs, ys, xq, n_iter=40, entropies=ENTROPIES[0],
                             lr=1e-3, precision="default",
                             grad_impl="pallas")
    _assert_close(out_j, out_t)


def test_tim_onehot_ce_matches_jax(rng):
    xs, ys, xq, _ = _tasks(rng, n_task=3, n_query=20, shuffle=False)
    out_j, out_t = _run_both(xs, ys, xq, n_iter=40, entropies=ENTROPIES[0],
                             lr=1e-3, ce_impl="onehot")
    _assert_close(out_j, out_t)


def test_tim_bf16_opt_state_matches_jax(rng):
    """tim_opt_dtype 'bfloat16': the moments stored bf16 between steps."""
    xs, ys, xq, _ = _tasks(rng)
    out_j, out_t = _run_both(xs, ys, xq, n_iter=40, entropies=ENTROPIES[0],
                             lr=1e-3, opt_dtype="bfloat16")
    _assert_close(out_j, out_t)


def _es_tasks(rng, n_task=6, K=8, shots=2, n_query=25, hard_tasks=(),
              hard_conc=0.35):
    """tests/test_methods_few_shot.py's heterogeneous-difficulty batch."""
    y_s = np.tile(np.repeat(np.arange(K), shots), (n_task, 1))
    y_q = np.stack([rng.choice(rng.choice(K, 4, replace=False), n_query)
                    for _ in range(n_task)])

    def simplex(labels, conc_per_task):
        g = rng.gamma(1.0, size=(*labels.shape, K)).astype(np.float32)
        for t in range(labels.shape[0]):
            g[t, np.arange(labels.shape[1]), labels[t]] += conc_per_task[t]
        return g / g.sum(-1, keepdims=True)

    conc = np.full(n_task, 60.0)
    conc[list(hard_tasks)] = hard_conc
    return simplex(y_s, conc), y_s, simplex(y_q, conc), y_q


@pytest.mark.parametrize("case", ["phase1", "phase2"])
def test_tim_early_stop_matches_jax(rng, case):
    """The opt-in prediction-stability stop: the same executed split
    [total, full-width], u and criterion trace. 'phase2' has two pure-noise
    stragglers that run out the clock in the narrow buffer."""
    if case == "phase1":
        x_s, y_s, x_q, _ = _es_tasks(rng)
        kw = dict(n_iter=120, lr=1e-4, es_patience=12)
    else:
        x_s, y_s, x_q, _ = _es_tasks(rng, hard_tasks=(1, 4), hard_conc=0.0)
        kw = dict(n_iter=60, lr=5e-3, es_patience=35)
    out_j, out_t = _run_both(x_s, y_s, x_q, n_class=8,
                             entropies=ENTROPIES[0], early_stop=True,
                             compact_tasks=2, **kw)
    _assert_close(out_j, out_t)
    total, full = out_t[2]
    if case == "phase1":
        assert total < 120
    else:
        assert total > full and total == 60


def test_resolve_functions_match_jax(rng):
    _, ys, _, _ = _tasks(rng)
    ys_bad = ys.copy()
    ys_bad[:, 0] = ys_bad[:, 1]
    for value in ("auto", "autodiff", "pallas", "manual"):
        for y in (ys, ys_bad):
            assert (ttim.resolve_grad_impl(value, torch.as_tensor(y), 6)
                    == jtim.resolve_grad_impl(value, y, 6))
    with pytest.raises(ValueError, match="tim_grad_impl"):
        ttim.resolve_grad_impl("nope", ys, 6)
    for value in ("auto", "highest", "default"):
        assert (ttim.resolve_matmul_precision(value)
                == jtim.resolve_matmul_precision(value))
    assert ttim.resolve_opt_dtype("bfloat16") == "bfloat16"
    with pytest.raises(ValueError, match="tim_opt_dtype"):
        ttim.resolve_opt_dtype("float16")


def _cfg(name, **over):
    base = dict(num_classes_test=8, n_class=8, n_query=30, k_eff=4, T=30,
                use_softmax_feature=True, shots=2, iter=40, temp=15.0,
                loss_weights=[1.0, 1.0, 1.0],
                entropies=["Shannon", "Alpha", "Alpha"], alpha_value=5.0,
                lr_alpha_tim=1e-3, lr_tim=1e-3, name_method=name)
    base.update(over)
    return base


@pytest.mark.parametrize("name,over", [
    ("ALPHA_TIM", {"tim_grad_impl": "pallas"}),
    ("ALPHA_TIM", {"tim_early_stop": True, "tim_es_patience": 10,
                   "tim_compact_tasks": 1, "lr_alpha_tim": 1e-4}),
    ("TIM-GD", {}),
])
def test_methods_run_task_match_jax(rng, name, over):
    """The method wrappers through run_task: the same predictions,
    accuracies and criterion-trace shape."""
    xs, ys, xq, yq = make_few_shot_tasks(rng, 3, n_query=30, n_class=8,
                                         shots=2, k_eff=4)
    task = {"x_s": xs, "y_s": ys, "x_q": xq, "y_q": yq}
    opts = _cfg(name, **over)
    ref = jget(name, args=JCfg(opts)).run_task(dict(task), shot=2)
    logs = get_few_shot_method(name, device="cpu",
                               args=CfgNode(opts)).run_task(dict(task), shot=2)
    np.testing.assert_array_equal(logs["preds"], ref["preds"])
    np.testing.assert_array_equal(logs["acc"], ref["acc"])
    assert logs["criterions"].shape == ref["criterions"].shape
    assert logs["acc"].mean() > 0.8
    assert np.all(np.diff(logs["timestamps_cumulative"]) >= 0)
