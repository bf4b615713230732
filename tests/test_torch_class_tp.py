"""The port's class-axis tensor parallelism (``tp`` > 1: a dp x tp grid of
ranks, each holding 1/tp of a task's cluster rows or class weights)
against its single-process runs and the JAX package's tp mesh runs.

The port's side runs in gloo ranks on the CPU, one thread each, started
with the ``spawn`` method by ``parallel.spawn_ranks`` (each spawn joined
with its own timeout, so that a hang fails one test). The ranks import this
module, which imports only numpy, torch and the port at its top: the JAX
side runs in the pytest process, on tests/conftest.py's 8 virtual devices,
as tests/test_parallel.py runs it, and imports JAX inside the tests.

Tolerances: predictions equal everywhere. Against one process: u within
1e-6, criterions within rtol 2e-3 / atol 1e-5 (the class group sums a
task's partial sums in another order, so a criterion of ~70 at the second
iteration moves by ~1e-4 relative), the executed iteration count and the
populated count equal. Against JAX's tp mesh: u within rtol 2e-3 / atol
2e-4 and the criterion within rtol 2e-3 / atol 1e-5, JAX's own tp limits
(tests/test_parallel.py). 'minka' runs at ``early_stop_tol`` 1e-5, as
tests/test_torch_parallel.py runs it (ROADMAP F1).
"""

import functools
import os

import numpy as np
import pytest
import torch

from transductive_clip_tpu_torch.core.config import CfgNode, load_full_config
from transductive_clip_tpu_torch.methods.few_shot.em_dirichlet import (
    em_dirichlet_fs_infer,
)
from transductive_clip_tpu_torch.methods.few_shot.paddle import (
    support_class_means,
)
from transductive_clip_tpu_torch.methods.few_shot.tim import (
    _make_grad_fn,
    tim_infer,
)
from transductive_clip_tpu_torch.methods.zero_shot.em_dirichlet import (
    em_dirichlet_infer,
)
from transductive_clip_tpu_torch.parallel import (
    TaskGroup,
    choose_layout,
    class_layout,
    class_shard,
    gather_tasks,
    resolve_tp,
    shard_task_batch,
    spawn_ranks,
)
from transductive_clip_tpu_torch.utils.synthetic import (
    make_few_shot_tasks,
    make_zero_shot_tasks,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO, "config")
# a spawn's own limit: a rank that hangs fails its test, not the suite
TIMEOUT = 120

# tests/test_torch_parallel.py's [8, 8, 64] batch: compaction engages
# (K = 64 > 2 (8 + 16)) and task compaction's narrow phase runs
EM_CASES = [(solver, hard) for solver in ("minka", "mm", "pallas")
            for hard in (False, True)]
# tests/test_parallel.py::test_pallas_solver_tp_mesh_compact_path: C = 24
# compact rows, K1's plain version on 12-row shards, at dp 2 x tp 2
COMPACT_PATH = dict(n_iter=4, iter_mm=60, solver="pallas", compact=True,
                    early_stop=True)
TIM_KW = dict(n_iter=40, n_class=8, entropies=("Shannon", "Alpha", "Alpha"),
              lr=1e-3)
TIM_ES_KW = dict(TIM_KW, n_iter=60, lr=5e-3, early_stop=True,
                 es_patience=35, compact_tasks=2)
FS_SOLVERS = ("minka", "pallas")


def _em_kw(solver, compact_first=False):
    return dict(n_iter=10, iter_mm=60, compact=True, early_stop=True,
                compact_tasks=6, compact_first=compact_first,
                early_stop_tol=1e-5 if solver == "minka" else 1e-6)


def _fs_kw(solver):
    return dict(n_iter=5, iter_mm=60, n_class=64, hard=False, solver=solver,
                early_stop=True, early_stop_tol=1e-5)


def _zs_tasks(seed=3, n_task=8):
    x, _ = make_zero_shot_tasks(np.random.default_rng(seed), n_task, 8, 64,
                                k_eff=4, concentration=20.0)
    return x


def _fs_tasks():
    # K = 64 over 8 queries: cluster compaction engages in the few-shot loop
    xs, ys, xq, _ = make_few_shot_tasks(np.random.default_rng(6), 4, 8, 64,
                                        2, k_eff=4)
    return xs, ys, xq


def _tim_tasks():
    xs, ys, xq, _ = make_few_shot_tasks(np.random.default_rng(2), 8,
                                        n_query=16, n_class=8, shots=2,
                                        k_eff=4)
    return xs, ys, xq


LAMBD = float(int(64 / 5) * 8)
WIDE_LAMBD = float(int(608 / 5) * 284)


def _tim_grads(xs, xq, ys, cs=None):
    """The loss gradient at the initial weights (this rank's classes under
    ``cs``)."""
    x2s, x2q = 0.5 * (xs * xs).sum(-1), 0.5 * (xq * xq).sum(-1)
    w = support_class_means(xs, ys, 8)
    if cs is not None:
        w = w[:, cs.lo:cs.lo + cs.width].contiguous()
    fn = _make_grad_fn("autodiff", xs, xq, ys, x2s, x2q, 15.0, 5.0,
                       [1.0, 1.0, 1.0], TIM_KW["entropies"], 8, "highest",
                       "gather", cs)
    return fn(w)[1]


@functools.lru_cache(maxsize=None)
def _em_alone(solver, hard, compact_first=False):
    u, crits, split, pop = em_dirichlet_infer(
        torch.as_tensor(_zs_tasks()), LAMBD, hard=hard, solver=solver,
        return_iter_split=True, **_em_kw(solver, compact_first))
    return u.numpy(), crits.numpy(), split, pop


# ---- the ranks' side -------------------------------------------------------

def _run_em(group, x, solver, hard, lambd=LAMBD, **kw):
    u, crits, split, pop = em_dirichlet_infer(
        shard_task_batch(torch.as_tensor(x), group), lambd, hard=hard,
        solver=solver, return_iter_split=True, group=group, **kw)
    return gather_tasks(u, group).numpy(), crits.numpy(), split, pop


def _rank_em(group, x, x_compact, x_wide):
    group = class_layout(group, 2)
    if group.dp == 1:
        out = {case: _run_em(group, x, *case, **_em_kw(case[0]))
               for case in EM_CASES}
        out["compact_first"] = _run_em(group, x, "pallas", False,
                                       **_em_kw("pallas", True))
        # a compact width of 300 over K = 608: one process runs the
        # Newton-Minka solve there ('pallas' reroutes above 256 rows), so
        # must the 150-row shards of it
        from transductive_clip_tpu_torch.ops import cuda_dirichlet

        calls = []
        real = cuda_dirichlet.dirichlet_row_solve
        cuda_dirichlet.dirichlet_row_solve = (
            lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
        try:
            out["wide"] = _run_em(group, x_wide, "pallas", False,
                                  lambd=WIDE_LAMBD, n_iter=3, iter_mm=60,
                                  compact=True, early_stop=False)
        finally:
            cuda_dirichlet.dirichlet_row_solve = real
        out["wide_k1_calls"] = len(calls)
        return out
    return {"minka": _run_em(group, x, "minka", False, **_em_kw("minka")),
            "compact_path": _run_em(group, x_compact, hard=False,
                                    **COMPACT_PATH)}


def _rank_few_shot(group, fs, tim):
    group = class_layout(group, 2)
    out = {}
    xs, ys, xq = (torch.as_tensor(a) for a in fs)
    xs, xq, ys = shard_task_batch((xs, xq, ys), group)
    for solver in FS_SOLVERS:
        u, crit, n_exec, pop = em_dirichlet_fs_infer(
            xs, xq, ys, LAMBD, return_n_iter=True, group=group,
            **_fs_kw(solver))
        out[solver] = (gather_tasks(u, group).numpy(), crit.numpy(), n_exec,
                       pop)
    xs, ys, xq = (torch.as_tensor(a) for a in tim)
    xs, xq, ys = shard_task_batch((xs, xq, ys), group)
    for name, kw in (("tim", dict(TIM_KW, grad_impl="pallas")),
                     ("tim_es", TIM_ES_KW)):
        u, crit, *split = tim_infer(xs, xq, ys, 15.0, 5.0, [1.0, 1.0, 1.0],
                                    group=group, **kw)
        out[name] = (gather_tasks(u, group).numpy(), crit.numpy(), *split)
    cs = class_shard(group, 8)
    g = _tim_grads(xs, xq, ys, cs)
    out["grads"] = gather_tasks(
        cs.gather(g.transpose(1, 2)).transpose(1, 2).contiguous(),
        group).numpy()
    return out


def _rank_evaluators(group, zs, fs, cwd):
    from transductive_clip_tpu_torch.eval import (
        EvaluatorFewShot,
        EvaluatorZeroShot,
    )

    os.chdir(cwd)
    out = {}
    cfgs, feats, labels = zs
    for route, cfg in cfgs.items():
        ev = EvaluatorZeroShot(args=cfg, group=group)
        acc, sec = ev.evaluate_tasks(feats, labels)
        ev.report_results(acc, sec)
        out[route] = (acc, ev.task_accuracies, sec)
    cfg, data = fs
    ev = EvaluatorFewShot(args=cfg, group=group)
    acc, sec = ev.evaluate_tasks(*data)
    out["alpha_tim"] = (acc, ev.task_accuracies, sec)
    return out


def _tiny_clip():
    from transductive_clip_tpu_torch.models.clip import TorchCLIP
    from transductive_clip_tpu_torch.models.clip.config import (
        CLIPConfig,
        CLIPTextConfig,
        CLIPVisionConfig,
    )
    from transductive_clip_tpu_torch.models.clip.model import (
        init_random_state_dict,
    )

    cfg = CLIPConfig(
        name="tiny", embed_dim=16,
        vision=CLIPVisionConfig(image_size=32, patch_size=16, width=16,
                                layers=1, heads=2),
        text=CLIPTextConfig(vocab_size=64, context_length=8, width=16,
                            layers=1, heads=2))
    return TorchCLIP(cfg, init_random_state_dict(cfg, seed=0),
                     compute_dtype=torch.float32, device="cpu")


def _extract_cfg(side, tp):
    return CfgNode(dict(dataset="eurosat",
                        dataset_path=os.path.join("data", "eurosat"),
                        backbone="RN50", T=30, use_softmax_feature=False,
                        root=side, extract_batch_size=4, data_parallel=True,
                        tp=tp))


def _rank_extraction(group, cwd):
    from transductive_clip_tpu_torch.eval.extraction import ensure_features
    from transductive_clip_tpu_torch.models.clip.preprocess import (
        make_preprocess,
    )

    os.chdir(cwd)
    model = _tiny_clip()
    for tp in (2, 1):
        ensure_features(_extract_cfg(f"tp{tp}", tp), model,
                        make_preprocess(32, dtype="uint8"), splits=("test",),
                        group=class_layout(group, tp))
    return model.group.layout


# ---- the tests -------------------------------------------------------------

def _assert_em(case, got, want, u_atol=1e-6):
    u, crits, split, pop = got
    u_1, c_1, split_1, pop_1 = want
    np.testing.assert_array_equal(u.argmax(-1), u_1.argmax(-1),
                                  err_msg=case)
    np.testing.assert_allclose(u, u_1, atol=u_atol, err_msg=case)
    np.testing.assert_allclose(crits, c_1, rtol=2e-3, atol=1e-5,
                               err_msg=case)
    assert split[0] == split_1[0] and pop == pop_1, (case, split, split_1)


def _jax_em(x, mesh, **kw):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from transductive_clip_tpu.methods.zero_shot.em_dirichlet import (
        em_dirichlet_infer as jax_infer,
    )

    x_mesh = jax.device_put(jnp.asarray(x),
                            NamedSharding(mesh, P("dp", None, None)))
    u, crits, *_ = jax_infer(x_mesh, jnp.float32(LAMBD), mesh=mesh,
                             return_iter_split=True, **kw)
    return np.asarray(u), np.asarray(crits)


def _assert_jax(case, got, u_j, c_j):
    u, crits = got[:2]
    np.testing.assert_array_equal(u.argmax(-1), u_j.argmax(-1), err_msg=case)
    np.testing.assert_allclose(u, u_j, rtol=2e-3, atol=2e-4, err_msg=case)
    np.testing.assert_allclose(crits, c_j, rtol=2e-3, atol=1e-5,
                               err_msg=case)


@pytest.mark.parametrize("dp", [1, 2])
def test_em_dirichlet_class_tp(dp):
    """Zero-shot EM-Dirichlet at dp x tp 2 (cluster compaction, early stop,
    task compaction) against the port's single-process run and JAX's
    em_dirichlet_infer on a dp x 2 mesh. dp 1: soft and hard x 'minka',
    'mm', 'pallas' (K1's plain version on row shards), soft 'pallas' with
    compact_first, and a compact width of 300 over K = 608, where the
    shards must run the Newton-Minka solve as one process does (K1 never
    called). dp 2: soft 'minka', and test_pallas_solver_tp_mesh_compact_path's
    C = 24 case."""
    from transductive_clip_tpu.parallel import make_mesh

    x = _zs_tasks()
    x_compact, _ = make_zero_shot_tasks(np.random.default_rng(3), 4, 8, 64,
                                        k_eff=4, concentration=60.0)
    x_wide, _ = make_zero_shot_tasks(np.random.default_rng(5), 2, 284, 608,
                                     k_eff=4)
    got = spawn_ranks(_rank_em, 2 * dp, (x, x_compact, x_wide), device="cpu",
                      timeout=TIMEOUT)
    mesh = make_mesh(n_devices=2 * dp, tp=2)
    if dp == 1:
        for solver, hard in EM_CASES:
            case = f"{solver} hard={hard}"
            _assert_em(case, got[(solver, hard)], _em_alone(solver, hard))
            _assert_jax(case, got[(solver, hard)], *_jax_em(
                x, mesh, hard=hard, solver=solver, **_em_kw(solver)))
        _assert_em("compact_first", got["compact_first"],
                   _em_alone("pallas", False, True))
        wide = em_dirichlet_infer(
            torch.as_tensor(x_wide), WIDE_LAMBD, hard=False,
            solver="pallas", return_iter_split=True, n_iter=3, iter_mm=60,
            compact=True, early_stop=False)
        assert got["wide_k1_calls"] == 0
        _assert_em("compact width 300", got["wide"],
                   (wide[0].numpy(), wide[1].numpy(), *wide[2:]))
        return
    _assert_em("minka dp 2", got["minka"], _em_alone("minka", False))
    _assert_jax("minka dp 2", got["minka"], *_jax_em(
        x, mesh, hard=False, solver="minka", **_em_kw("minka")))
    u_1, c_1, *_ = em_dirichlet_infer(
        torch.as_tensor(x_compact), LAMBD, hard=False,
        return_iter_split=True, **COMPACT_PATH)
    u, crits = got["compact_path"][:2]
    np.testing.assert_array_equal(u.argmax(-1), u_1.numpy().argmax(-1))
    np.testing.assert_allclose(u, u_1.numpy(), atol=1e-6)
    _assert_jax("compact path", got["compact_path"], *_jax_em(
        x_compact, mesh, hard=False, **COMPACT_PATH))


def test_few_shot_methods_class_tp():
    """At dp 1 x tp 2: few-shot EM-Dirichlet ('minka' and 'pallas', cluster
    compaction engaged at K = 64) against the single run and JAX's tp mesh
    run; alpha-TIM ('pallas' becomes autodiff under tp, as in JAX) against
    the single run and JAX's tim_infer on a (4, 2) mesh, with the opt-in
    early stop against the single run, and the loss gradient at the
    initial weights equal to one process's (rtol 1e-4, atol 1e-7; its
    magnitude is ~5e-4)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from transductive_clip_tpu.methods.few_shot.em_dirichlet import (
        em_dirichlet_fs_infer as jax_fs,
    )
    from transductive_clip_tpu.methods.few_shot.tim import (
        tim_infer as jax_tim,
    )
    from transductive_clip_tpu.parallel import make_mesh

    fs, tim = _fs_tasks(), _tim_tasks()
    got = spawn_ranks(_rank_few_shot, 2, (fs, tim), device="cpu",
                      timeout=TIMEOUT)
    xs, ys, xq = fs
    mesh = make_mesh(n_devices=2, tp=2)

    def put(a, spec=(None, None)):
        return jax.device_put(jnp.asarray(a),
                              NamedSharding(mesh, P("dp", *spec)))

    for solver in FS_SOLVERS:
        u_1, c_1, n_1, pop_1 = em_dirichlet_fs_infer(
            torch.as_tensor(xs), torch.as_tensor(xq), torch.as_tensor(ys),
            LAMBD, return_n_iter=True, **_fs_kw(solver))
        u, crit, n_exec, pop = got[solver]
        assert pop_1 > 0, "cluster compaction did not engage"
        _assert_em(f"few-shot {solver}", (u, crit, [n_exec], pop),
                   (u_1.numpy(), c_1.numpy(), [n_1], pop_1))
        u_j, c_j = jax_fs(put(xs), put(xq), put(np.int32(ys), (None,)),
                          jnp.float32(LAMBD), mesh=mesh, **_fs_kw(solver))
        _assert_jax(f"few-shot {solver}", got[solver], np.asarray(u_j),
                    np.asarray(c_j))

    xs, ys, xq = (torch.as_tensor(a) for a in tim)
    for name, kw in (("tim", dict(TIM_KW, grad_impl="pallas")),
                     ("tim_es", TIM_ES_KW)):
        single = tim_infer(xs, xq, ys, 15.0, 5.0, [1.0, 1.0, 1.0], **kw)
        u, crit, *split = got[name]
        np.testing.assert_array_equal(u.argmax(-1),
                                      single[0].numpy().argmax(-1))
        np.testing.assert_allclose(u, single[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(crit, single[1].numpy(), rtol=2e-3,
                                   atol=1e-5)
        if split:
            np.testing.assert_array_equal(split[0], single[2])
    u_j, c_j = jax_tim(
        jnp.asarray(tim[0]), jnp.asarray(tim[2]), jnp.asarray(tim[1],
                                                              jnp.int32),
        jnp.float32(15.0), jnp.float32(5.0), jnp.ones(3, jnp.float32),
        mesh=make_mesh(n_devices=8, tp=2), **TIM_KW)
    _assert_jax("alpha-TIM", got["tim"], np.asarray(u_j), np.asarray(c_j))
    np.testing.assert_allclose(got["grads"], _tim_grads(xs, xq, ys).numpy(),
                               rtol=1e-4, atol=1e-7)


def _zs_cfg(tp, **over):
    """tests/test_torch_parallel.py's evaluator batch: 16 tasks in batches
    of 8 over K = 64."""
    return CfgNode(dict(dict(
        name_method="EM_DIRICHLET", dataset="synthetic", used_test_set="test",
        shots=0, seed=3, number_tasks=16, batch_size=8, k_eff=5, n_class=64,
        num_classes_test=64, n_query=8, T=30, use_softmax_feature=True,
        graph_matching=False, iter=6, iter_mm=60, dirichlet_solver="minka",
        compact_clusters=True, early_stop=True, early_stop_tol=1e-5,
        save_results=False, data_parallel=tp > 0, tp=tp), **over))


def _class_features(n_class, per_class, seed):
    rng = np.random.default_rng(seed)
    feats, labels = [], []
    for c in range(n_class):
        a = np.ones(n_class)
        a[c] += 60.0
        feats.append(rng.dirichlet(a, size=per_class).astype(np.float32))
        labels.append(np.full(per_class, c, np.int64))
    return np.concatenate(feats), np.concatenate(labels)


ROUTES = {"blocking": dict(defer_fetch=False),
          "fused": dict(defer_fetch=True, fused_dispatch=True)}


def test_evaluators_class_tp(tmp_path, monkeypatch):
    """Both evaluators on 2 ranks with ``tp 2`` (the evaluator lays the
    world group out as dp 1 x tp 2): zero-shot EM-Dirichlet on the
    blocking and fused routes, few-shot alpha-TIM blocking. Per-task
    accuracies equal the port's single-process run's; the zero-shot mean
    within JAX's own 0.02 of JAX's evaluator on a tp 2 mesh; one TSV row a
    route, from rank 0."""
    from transductive_clip_tpu.core.config import CfgNode as JaxCfg
    from transductive_clip_tpu.eval import EvaluatorZeroShot as JaxZS
    from transductive_clip_tpu_torch.eval import (
        EvaluatorFewShot,
        EvaluatorZeroShot,
    )

    monkeypatch.chdir(tmp_path)
    feats, labels = _class_features(64, 12, 0)
    cfgs = {route: _zs_cfg(2, save_results=True, **kw)
            for route, kw in ROUTES.items()}
    fs_cfg = load_full_config(opts=[
        "dataset", "eurosat", "method", "alpha_tim", "shots", "2",
        "number_tasks", "8", "batch_size", "4", "n_query", "10", "seed", "0",
        "iter", "20", "tunable", "False", "save_results", "False",
        "defer_fetch", "false", "data_parallel", "True", "tp", "2"],
        config_root=CONFIG_ROOT)
    fs_data = (*_class_features(10, 20, 1), *_class_features(10, 40, 2))
    got = spawn_ranks(_rank_evaluators, 2,
                      ((cfgs, feats, labels), (fs_cfg, fs_data),
                       str(tmp_path)), device="cpu", timeout=TIMEOUT)

    for route, kw in ROUTES.items():
        ev = EvaluatorZeroShot(device="cpu", args=_zs_cfg(0, **kw))
        acc_1, _ = ev.evaluate_tasks(feats, labels)
        acc, task_accs, sec = got[route]
        assert len(task_accs) == 2 and task_accs[0].shape == (8,)
        for a, a_1 in zip(task_accs, ev.task_accuracies):
            np.testing.assert_array_equal(a, a_1)
        assert acc == acc_1 and acc > 0.9 and sec > 0
    jax_cfg = JaxCfg(dict(_zs_cfg(2, defer_fetch=False)))
    acc_j, _ = JaxZS(args=jax_cfg).evaluate_tasks(feats, labels)
    assert abs(got["blocking"][0] - acc_j) < 0.02, (got["blocking"][0], acc_j)
    rows = open(os.path.join("results_zero_shot", "test", "synthetic",
                             "EM_DIRICHLET_softmax_0shot.txt")).readlines()
    assert len(rows) == 2 + len(ROUTES)          # header, blank, a row each

    fs_cfg.data_parallel = False
    ev = EvaluatorFewShot(device="cpu", args=fs_cfg)
    acc_1, _ = ev.evaluate_tasks(*fs_data)
    acc, task_accs, sec = got["alpha_tim"]
    assert len(task_accs) == 2 and acc == acc_1 and sec > 0
    for a, a_1 in zip(task_accs, ev.task_accuracies):
        np.testing.assert_array_equal(a, a_1)


def test_extraction_class_tp(tmp_path, monkeypatch):
    """Extraction with ``data_parallel`` and ``tp 2`` on 2 ranks runs with
    the whole world as dp (as JAX forces ``make_mesh(tp=1)``): each rank
    encodes half of every batch of a 12-image split, and the cache equals
    the one written at tp 1 and the single-process one (within 2e-5)."""
    import json

    from PIL import Image

    from transductive_clip_tpu_torch.eval.extraction import ensure_features
    from transductive_clip_tpu_torch.features.cache import load_feature_cache
    from transductive_clip_tpu_torch.models.clip.preprocess import (
        make_preprocess,
    )

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    root = os.path.join("data", "eurosat")
    os.makedirs(os.path.join(root, "images", "c"))
    split = {"train": [], "val": [], "test": []}
    for i in range(12):
        name = f"c/test_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
                        ).save(os.path.join(root, "images", name))
        split["test"].append([name, i % 3, f"class {i % 3}"])
    with open(os.path.join(root, "split_zhou_EuroSAT.json"), "w") as f:
        json.dump(split, f)

    layout = spawn_ranks(_rank_extraction, 2, (str(tmp_path),), device="cpu",
                         timeout=TIMEOUT)
    assert layout == "dp=2 tp=1"
    cfg = _extract_cfg("single", 0)
    cfg.data_parallel = False
    ensure_features(cfg, _tiny_clip(), make_preprocess(32, dtype="uint8"),
                    splits=("test",))
    path = os.path.join("eurosat", "saved_features", "test_visual_RN50.plk")
    f_1, l_1 = load_feature_cache(os.path.join("single", path))
    for side in ("tp2", "tp1"):
        f, lab = load_feature_cache(os.path.join(side, path))
        assert f.shape == (12, 16)
        np.testing.assert_allclose(f, f_1, atol=2e-5)
        np.testing.assert_array_equal(lab, l_1)


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_class", [10, 64, 511, 512, 1000, 1001])
def test_choose_layout_matches_jax(n_devices, n_class):
    """``choose_layout`` and ``resolve_tp``'s auto layout are JAX's; for a
    method that shards no classes the auto layout is tp 1."""
    from transductive_clip_tpu.parallel import choose_layout as jax_layout

    want = jax_layout(n_devices, n_class)
    assert choose_layout(n_devices, n_class) == want
    assert resolve_tp(0, n_devices, n_class) == want[1]
    assert resolve_tp(0, n_devices, n_class, shards_classes=False) == 1
    assert resolve_tp(1, n_devices, n_class) == 1


@pytest.mark.parametrize("case", ["world", "classes", "tasks"])
def test_indivisible_layouts_raise(case):
    """The layouts that do not divide raise ``ValueError``: a tp that does
    not divide the ranks (JAX ``make_mesh``'s message), classes that do not
    divide over tp, a batch that does not divide over dp."""
    group = TaskGroup(0, 4, torch.device("cpu"), None, None, tp=2)
    if case == "world":
        from transductive_clip_tpu.parallel import make_mesh

        with pytest.raises(ValueError, match="not divisible by tp=3") as e:
            make_mesh(n_devices=4, tp=3)
        with pytest.raises(ValueError, match=str(e.value)):
            resolve_tp(3, 4)
    elif case == "classes":
        with pytest.raises(ValueError, match="n_class=9 not divisible"):
            class_shard(group, 9)
        assert class_shard(group, 8).width == 4
    else:
        with pytest.raises(ValueError, match="does not divide over 2"):
            shard_task_batch(np.zeros((3, 2)), group)
        assert shard_task_batch(np.zeros((4, 2)), group).shape == (2, 2)
