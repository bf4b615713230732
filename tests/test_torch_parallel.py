"""The port's task data parallelism (``transductive_clip_tpu_torch/parallel``)
against its single-process runs and the JAX package's mesh runs.

The port's side runs in gloo ranks on the CPU, one thread each, started
with the ``spawn`` method by ``parallel.spawn_ranks`` (each spawn joined
with its own timeout, so that a hang fails one test). The ranks import this module, which imports
only numpy, torch and the port at its top: the JAX side runs in the pytest
process, on tests/conftest.py's 8 virtual devices, as tests/test_parallel.py
runs it, and imports JAX inside the tests. Inputs go to the ranks as
arguments; rank 0 returns the whole batch's results.

Cases: EM-Dirichlet zero-shot (2 and 4 ranks; soft and hard; 'minka' with
cluster compaction and early stop, 'mm', 'pallas' through its plain
version; task compaction engaged), with the control that the ranks' shards
run alone stop elsewhere than the whole batch; alpha-TIM and few-shot
EM-Dirichlet; the zero-shot evaluator on its three routes and the few-shot
one; batch-DP extraction; the CLI's spawn launcher; a ``tp`` that does not
divide the ranks.
"""

import functools
import os

import numpy as np
import pytest
import torch

from transductive_clip_tpu_torch import cli
from transductive_clip_tpu_torch.core.config import CfgNode, load_full_config
from transductive_clip_tpu_torch.methods.few_shot.em_dirichlet import (
    em_dirichlet_fs_infer,
)
from transductive_clip_tpu_torch.methods.few_shot.tim import tim_infer
from transductive_clip_tpu_torch.methods.zero_shot.em_dirichlet import (
    em_dirichlet_infer,
)
from transductive_clip_tpu_torch.parallel import (
    distributed_em_dirichlet,
    gather_tasks,
    shard_task_batch,
    spawn_ranks,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO, "config")
# a spawn's own limit: a rank that hangs fails its test, not the suite
TIMEOUT = 120

# [8, 8, 64] at concentration 20, seed 3: compaction engages (K = 64 >
# 2 (8 + 16)); with compact_tasks 6 the batch's last 6 stragglers run on in
# the narrow buffer after iteration 3 or 4, while the ranks' shards run
# alone would stop elsewhere (test_em_dirichlet_over_ranks' control)
EM_CASES = [(solver, hard) for solver in ("minka", "mm", "pallas")
            for hard in (False, True)]


def _em_kw(solver):
    # 'minka' at 1e-5, as tests/test_torch_em_dirichlet.py runs it against
    # JAX (ROADMAP F1: at 1e-6 its stop fires on fp32 noise)
    return dict(n_iter=10, iter_mm=60, compact=True, early_stop=True,
                compact_tasks=6,
                early_stop_tol=1e-5 if solver == "minka" else 1e-6)


def _es_tasks(rng, n_task=8, K=8, shots=2, n_query=25, hard_tasks=(5, 6)):
    """tests/test_torch_tim.py's heterogeneous batch: tasks 5 and 6 (both
    on the second of 2 ranks) are pure noise and run out the clock in the
    narrow buffer, which the first rank joins holding none of them."""
    y_s = np.tile(np.repeat(np.arange(K), shots), (n_task, 1))
    y_q = np.stack([rng.choice(rng.choice(K, 4, replace=False), n_query)
                    for _ in range(n_task)])
    conc = np.full(n_task, 60.0)
    conc[list(hard_tasks)] = 0.0

    def simplex(labels):
        g = rng.gamma(1.0, size=(*labels.shape, K)).astype(np.float32)
        for t in range(n_task):
            g[t, np.arange(labels.shape[1]), labels[t]] += conc[t]
        return g / g.sum(-1, keepdims=True)

    return simplex(y_s), y_s, simplex(y_q)


def _simplex_tasks(seed=3, n_task=8, n_query=8, n_class=64, k_eff=4,
                   concentration=20.0):
    from conftest import make_simplex_tasks

    return make_simplex_tasks(np.random.default_rng(seed), n_task=n_task,
                              n_query=n_query, n_class=n_class, k_eff=k_eff,
                              concentration=concentration)


@functools.lru_cache(maxsize=None)
def _em_alone(solver, hard, n_task):
    """The port's single-process run of the first ``n_task`` tasks (u,
    criterions, split, populated count), shared by both dp cases."""
    x, _ = _simplex_tasks()
    u, crits, split, pop = em_dirichlet_infer(
        torch.as_tensor(x[:n_task]), float(int(64 / 5) * 8), hard=hard,
        solver=solver, return_iter_split=True, **_em_kw(solver))
    return u.numpy(), crits.numpy(), split, pop


# ---- the ranks' side -------------------------------------------------------

def _rank_em(group, x, lambd):
    out = []
    for solver, hard in EM_CASES:
        u, crits, split, pop = em_dirichlet_infer(
            shard_task_batch(torch.as_tensor(x), group), lambd, hard=hard,
            solver=solver, return_iter_split=True, group=group,
            **_em_kw(solver))
        out.append((gather_tasks(u, group).numpy(), crits.numpy(), split,
                    pop))
    if group.world != 2:
        return out, None
    u, crits = distributed_em_dirichlet(x, lambd, group, n_iter=6,
                                        iter_mm=60, solver="minka",
                                        compact=True, early_stop=True)
    return out, (u.numpy(), crits.numpy())


def _rank_few_shot(group, tim_args, fs_args):
    tim_data, tim_kw = tim_args
    out = {}
    for name, kw in tim_kw.items():
        xs, ys, xq = tim_data[name]
        shard = shard_task_batch(
            (torch.as_tensor(xs), torch.as_tensor(xq), torch.as_tensor(ys)),
            group)
        u, crit, *split = tim_infer(*shard, 15.0, 5.0, [1.0, 1.0, 1.0],
                                    group=group, **kw)
        out[name] = (gather_tasks(u, group).numpy(), crit.numpy(), *split)
    xs, ys, xq, lambd, fs_kw = fs_args
    xs, xq, ys = shard_task_batch(
        (torch.as_tensor(xs), torch.as_tensor(xq), torch.as_tensor(ys)),
        group)
    u, crit, n_exec, pop = em_dirichlet_fs_infer(
        xs, xq, ys, lambd, return_n_iter=True, group=group, **fs_kw)
    out["fs_em"] = (gather_tasks(u, group).numpy(), crit.numpy(), n_exec, pop)
    return out


def _rank_evaluators(group, zs, fs, cwd):
    from transductive_clip_tpu_torch.eval import (
        EvaluatorFewShot,
        EvaluatorZeroShot,
    )

    os.chdir(cwd)
    out = {}
    (cfgs, feats, labels) = zs
    for route, cfg in cfgs.items():
        ev = EvaluatorZeroShot(args=cfg, group=group)
        acc, sec = ev.evaluate_tasks(feats, labels)
        ev.report_results(acc, sec)
        out[route] = (acc, ev.task_accuracies, sec)
    cfg, (fs_s, ls, fs_q, lq) = fs
    ev = EvaluatorFewShot(args=cfg, group=group)
    acc, sec = ev.evaluate_tasks(fs_s, ls, fs_q, lq)
    out["alpha_tim"] = (acc, ev.task_accuracies, sec)
    return out


def _rank_extraction(group, state_dict, port_cfg, cfg, images, cwd):
    from transductive_clip_tpu_torch.eval.extraction import ensure_features
    from transductive_clip_tpu_torch.models.clip import TorchCLIP
    from transductive_clip_tpu_torch.models.clip.preprocess import (
        make_preprocess,
    )

    os.chdir(cwd)
    model = TorchCLIP(port_cfg, state_dict, compute_dtype=torch.float32,
                      device="cpu")
    ensure_features(cfg, model, make_preprocess(32, dtype="uint8"),
                    splits=("test",), group=group)
    # a batch of 3 does not divide over the ranks: encoded whole
    return [model.encode_image_batch(b).numpy() for b in images]


# ---- the tests -------------------------------------------------------------

@pytest.mark.parametrize("dp", [2, 4])
def test_em_dirichlet_over_ranks(dp):
    """Zero-shot EM-Dirichlet over dp gloo ranks against the port's
    single-process run (identical predictions, u within 1e-6, the same
    iteration split and populated count, criterions within 1e-6) and JAX's
    em_dirichlet_infer on a dp-device mesh (the port-vs-JAX tolerance of
    tests/test_torch_em_dirichlet.py: identical predictions, u within atol
    1e-4, the same split). Control (soft, each solver): rank 0's shard run
    alone stops at another split than the whole batch, so without the
    group reductions this test would fail. With 2 ranks also distributed_em_dirichlet
    against JAX's."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from transductive_clip_tpu.methods.zero_shot.em_dirichlet import (
        em_dirichlet_infer as jax_infer,
    )
    from transductive_clip_tpu.parallel import (
        distributed_em_dirichlet as jax_distributed,
        make_mesh,
    )

    x, _ = _simplex_tasks()
    lambd = float(int(64 / 5) * 8)
    per = len(x) // dp
    got, dist_out = spawn_ranks(_rank_em, dp, (x, lambd), device="cpu",
                                timeout=TIMEOUT)
    mesh = make_mesh(n_devices=dp, tp=1)
    x_mesh = jax.device_put(jnp.asarray(x),
                            NamedSharding(mesh, P("dp", None, None)))
    for (solver, hard), (u, crits, split, pop) in zip(EM_CASES, got):
        kw = _em_kw(solver)
        u_1, c_1, split_1, pop_1 = _em_alone(solver, hard, len(x))
        case = f"{solver} hard={hard}"
        np.testing.assert_array_equal(u.argmax(-1), u_1.argmax(-1),
                                      err_msg=case)
        np.testing.assert_allclose(u, u_1, atol=1e-6, err_msg=case)
        np.testing.assert_allclose(crits, c_1, atol=1e-6, err_msg=case)
        np.testing.assert_array_equal(split, split_1, err_msg=case)
        assert pop == pop_1, case
        assert split[1] < split[0], f"{case}: no narrow phase ran ({split})"
        if not hard:
            alone = _em_alone(solver, hard, per)[2]
            assert alone.tolist() != split.tolist(), (case, alone, split)

        u_j, _, split_j, pop_j = jax_infer(
            x_mesh, jnp.float32(lambd), hard=hard, solver=solver, mesh=mesh,
            return_iter_split=True, **kw)
        np.testing.assert_array_equal(u.argmax(-1),
                                      np.asarray(u_j).argmax(-1),
                                      err_msg=case)
        np.testing.assert_allclose(u, np.asarray(u_j), atol=1e-4,
                                   err_msg=case)
        np.testing.assert_array_equal(split, np.asarray(split_j),
                                      err_msg=case)
        assert pop == int(pop_j), case

    if dist_out is None:
        return
    u, crits = dist_out
    u_j, c_j = jax_distributed(x, lambd, mesh, n_iter=6, iter_mm=60,
                               solver="minka", compact=True, early_stop=True)
    np.testing.assert_array_equal(u.argmax(-1), np.asarray(u_j).argmax(-1))
    np.testing.assert_allclose(u, np.asarray(u_j), atol=1e-4)
    np.testing.assert_allclose(crits, np.asarray(c_j), rtol=2e-3, atol=1e-5)


def test_few_shot_methods_over_ranks():
    """alpha-TIM on test_tim_on_mesh_matches_single_device's inputs with
    the plain K3 ('pallas' on the CPU): 2 ranks against JAX tim_infer on a
    dp=2 mesh (rtol 2e-3, atol 2e-4) and against the port's single run;
    with the opt-in early stop (its straggler phase engaged) against the
    single run. Few-shot EM-Dirichlet ('minka', compaction, early stop)
    against the single run and JAX."""
    import jax.numpy as jnp

    from transductive_clip_tpu.methods.few_shot.em_dirichlet import (
        em_dirichlet_fs_infer as jax_fs,
    )
    from transductive_clip_tpu.methods.few_shot.tim import (
        tim_infer as jax_tim,
    )
    from transductive_clip_tpu.parallel import make_mesh
    from transductive_clip_tpu.utils.synthetic import make_few_shot_tasks

    xs, ys, xq, yq = make_few_shot_tasks(np.random.default_rng(2), 8,
                                         n_query=16, n_class=8, shots=2,
                                         k_eff=4)
    base = dict(n_iter=40, n_class=8, entropies=("Shannon", "Alpha", "Alpha"),
                lr=1e-3)
    es = _es_tasks(np.random.default_rng(4))
    tim_kw = {"tim": dict(base, grad_impl="pallas"),
              "tim_es": dict(base, grad_impl="pallas", n_iter=60, lr=5e-3,
                             early_stop=True, es_patience=35,
                             compact_tasks=2)}
    fxs, fys, fxq, _ = make_few_shot_tasks(np.random.default_rng(6), 4, 8,
                                           40, 2)
    fs_kw = dict(n_iter=5, iter_mm=60, n_class=40, hard=False,
                 solver="minka", early_stop=True, early_stop_tol=1e-5)
    lambd = float(int(40 / 5) * 8)
    tim_data = {"tim": (xs, ys, xq), "tim_es": es}
    got = spawn_ranks(_rank_few_shot, 2,
                      ((tim_data, tim_kw), (fxs, fys, fxq, lambd, fs_kw)),
                      device="cpu", timeout=TIMEOUT)

    for name, kw in tim_kw.items():
        single = tim_infer(*(torch.as_tensor(a) for a in (
            tim_data[name][0], tim_data[name][2], tim_data[name][1])),
            15.0, 5.0, [1.0, 1.0, 1.0], **kw)
        u, crit, *split = got[name]
        np.testing.assert_array_equal(u.argmax(-1),
                                      single[0].numpy().argmax(-1))
        np.testing.assert_allclose(u, single[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(crit, single[1].numpy(), atol=1e-6)
        if split:
            np.testing.assert_array_equal(split[0], single[2])
            assert split[0][1] < split[0][0] == 60, split
    u_j, c_j = jax_tim(
        jnp.asarray(xs), jnp.asarray(xq), jnp.asarray(ys, jnp.int32),
        jnp.float32(15.0), jnp.float32(5.0), jnp.ones(3, jnp.float32),
        mesh=make_mesh(n_devices=2, tp=1), **base)
    np.testing.assert_allclose(got["tim"][0], np.asarray(u_j), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(got["tim"][1], np.asarray(c_j), rtol=2e-3,
                               atol=1e-6)

    u, crit, n_exec, pop = got["fs_em"]
    u_1, c_1, n_1, pop_1 = em_dirichlet_fs_infer(
        torch.as_tensor(fxs), torch.as_tensor(fxq), torch.as_tensor(fys),
        lambd, return_n_iter=True, **fs_kw)
    np.testing.assert_array_equal(u.argmax(-1), u_1.numpy().argmax(-1))
    np.testing.assert_allclose(u, u_1.numpy(), atol=1e-6)
    np.testing.assert_allclose(crit, c_1.numpy(), atol=1e-6)
    assert (n_exec, pop) == (n_1, pop_1)
    u_j, _ = jax_fs(jnp.asarray(fxs), jnp.asarray(fxq),
                    jnp.asarray(fys, jnp.int32), jnp.float32(lambd), **fs_kw)
    np.testing.assert_array_equal(u.argmax(-1), np.asarray(u_j).argmax(-1))
    np.testing.assert_allclose(u, np.asarray(u_j), atol=1e-4)


def _zs_cfg(cls, data_parallel, **over):
    """tests/test_parallel.py's _eval_cfg: 16 tasks in batches of 8."""
    return cls(dict(dict(
        name_method="EM_DIRICHLET", dataset="synthetic", used_test_set="test",
        shots=0, seed=3, number_tasks=16, batch_size=8, k_eff=5, n_class=64,
        num_classes_test=64, n_query=8, T=30, use_softmax_feature=True,
        graph_matching=False, iter=6, iter_mm=60, dirichlet_solver="minka",
        compact_clusters=True, early_stop=True, save_results=False,
        data_parallel=data_parallel, tp=0), **over))


def _zs_features():
    rng = np.random.default_rng(0)
    feats, labels = [], []
    for c in range(64):
        a = np.ones(64)
        a[c] += 60.0
        feats.append(rng.dirichlet(a, size=12).astype(np.float32))
        labels.append(np.full(12, c, np.int64))
    return np.concatenate(feats), np.concatenate(labels)


ROUTES = {"blocking": dict(defer_fetch=False),
          "deferred": dict(defer_fetch=True, fused_dispatch=False),
          "fused": dict(defer_fetch=True, fused_dispatch=True)}


def test_evaluators_over_ranks(tmp_path, monkeypatch):
    """Both evaluators with data_parallel over 2 ranks: zero-shot
    EM-Dirichlet on the blocking, deferred and fused routes, few-shot
    alpha-TIM blocking. Per-task accuracies equal the port's
    single-process run's; the zero-shot mean within JAX's own 0.02 of
    JAX's data-parallel evaluator; one TSV row a route, from rank 0."""
    from transductive_clip_tpu.core.config import CfgNode as JaxCfg
    from transductive_clip_tpu.eval import EvaluatorZeroShot as JaxZS
    from transductive_clip_tpu_torch.eval import (
        EvaluatorFewShot,
        EvaluatorZeroShot,
    )

    monkeypatch.chdir(tmp_path)
    feats, labels = _zs_features()
    cfgs = {route: _zs_cfg(CfgNode, True, save_results=True, **kw)
            for route, kw in ROUTES.items()}
    fs_cfg = load_full_config(opts=[
        "dataset", "eurosat", "method", "alpha_tim", "shots", "2",
        "number_tasks", "8", "batch_size", "4", "n_query", "10", "seed", "0",
        "iter", "20", "tunable", "False", "save_results", "False",
        "tim_grad_impl", "pallas", "defer_fetch", "false", "data_parallel",
        "True"], config_root=CONFIG_ROOT)
    frng = np.random.default_rng(1)
    fs_data = []
    for n in (20, 40):      # support (train), then query (test) tables
        f, lab = [], []
        for c in range(10):
            a = np.ones(10)
            a[c] += 60.0
            f.append(frng.dirichlet(a, size=n).astype(np.float32))
            lab.append(np.full(n, c, np.int64))
        fs_data += [np.concatenate(f), np.concatenate(lab)]
    got = spawn_ranks(_rank_evaluators, 2,
                      ((cfgs, feats, labels), (fs_cfg, tuple(fs_data)),
                       str(tmp_path)),
                      device="cpu", timeout=TIMEOUT)

    for route, kw in ROUTES.items():
        ev = EvaluatorZeroShot(device="cpu", args=_zs_cfg(CfgNode, False,
                                                          **kw))
        acc_1, _ = ev.evaluate_tasks(feats, labels)
        acc, task_accs, sec = got[route]
        assert len(task_accs) == 2 and task_accs[0].shape == (8,)
        for a, a_1 in zip(task_accs, ev.task_accuracies):
            np.testing.assert_array_equal(a, a_1)
        assert acc == acc_1 and acc > 0.9 and sec > 0
    acc_j, _ = JaxZS(args=_zs_cfg(JaxCfg, True)).evaluate_tasks(feats, labels)
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


def test_extraction_over_ranks(tmp_path, monkeypatch):
    """Batch-DP extraction on tests/test_parallel.py's tiny CLIP: 2 ranks
    write the visual cache of a 12-image JPEG split in batches of 4 (each
    rank encodes 2 images a batch); it is within 2e-5 of the single run's
    and of JAX's encode on a dp=2 mesh. A batch of 3 is encoded whole."""
    from PIL import Image

    import jax.numpy as jnp

    from transductive_clip_tpu.models.clip import JaxCLIP, init_random_params
    from transductive_clip_tpu.models.clip.config import (
        CLIPConfig as JCfg,
        CLIPTextConfig as JText,
        CLIPVisionConfig as JVision,
    )
    from transductive_clip_tpu.parallel import make_mesh
    from transductive_clip_tpu_torch.data import (
        build_dataset,
        iter_image_batches,
    )
    from transductive_clip_tpu_torch.eval.extraction import ensure_features
    from transductive_clip_tpu_torch.features.cache import load_feature_cache
    from transductive_clip_tpu_torch.models.clip import TorchCLIP
    from transductive_clip_tpu_torch.models.clip.config import (
        CLIPConfig,
        CLIPTextConfig,
        CLIPVisionConfig,
    )
    from transductive_clip_tpu_torch.models.clip.convert import (
        state_dict_from_flax,
    )
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
    import json

    with open(os.path.join(root, "split_zhou_EuroSAT.json"), "w") as f:
        json.dump(split, f)

    vision = dict(image_size=32, patch_size=16, width=16, layers=1, heads=2)
    text = dict(vocab_size=64, context_length=8, width=16, layers=1, heads=2)
    jcfg = JCfg(name="tiny", embed_dim=16, vision=JVision(**vision),
                text=JText(**text))
    params = init_random_params(jcfg, seed=0)
    port_cfg = CLIPConfig(name="tiny", embed_dim=16,
                          vision=CLIPVisionConfig(**vision),
                          text=CLIPTextConfig(**text))
    state_dict = state_dict_from_flax(params, jcfg)

    def cfg(side, dp):
        return CfgNode(dict(dataset="eurosat", dataset_path=root,
                            backbone="RN50", T=30, use_softmax_feature=False,
                            root=side, extract_batch_size=4,
                            data_parallel=dp))

    images = [rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
              for n in (4, 3)]
    encoded = spawn_ranks(_rank_extraction, 2,
                          (state_dict, port_cfg, cfg("dp", True), images,
                           str(tmp_path)), device="cpu", timeout=TIMEOUT)
    model = TorchCLIP(port_cfg, state_dict, compute_dtype=torch.float32,
                      device="cpu")
    ensure_features(cfg("single", False), model,
                    make_preprocess(32, dtype="uint8"), splits=("test",))
    path = os.path.join("eurosat", "saved_features",
                        "test_visual_RN50.plk")
    f_dp, l_dp = load_feature_cache(os.path.join("dp", path))
    f_1, l_1 = load_feature_cache(os.path.join("single", path))
    assert f_dp.shape == (12, 16)
    np.testing.assert_allclose(f_dp, f_1, atol=2e-5)
    np.testing.assert_array_equal(l_dp, l_1)

    jax_model = JaxCLIP(jcfg, params, compute_dtype=jnp.float32)
    jax_model.set_mesh(make_mesh(n_devices=2, tp=1))
    pixels = np.concatenate([b for b, _ in iter_image_batches(
        build_dataset("eurosat", root).test, make_preprocess(32), 4)])
    emb = np.asarray(jax_model.encode_image_batch(pixels))
    emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    np.testing.assert_allclose(f_dp, emb, atol=2e-5)
    for got, imgs in zip(encoded, images):
        np.testing.assert_allclose(
            got, np.asarray(jax_model.encode_image_batch(imgs)), atol=2e-5)
        np.testing.assert_allclose(got, model.encode_image_batch(imgs),
                                   atol=2e-5)


def test_cli_spawn_launcher_writes_the_single_run_row(tmp_path, monkeypatch):
    """The CLI's launcher with two CPU ranks writes the TSV row of the
    single-process run (one row: rank 0 writes it)."""
    from transductive_clip_tpu_torch.eval import EvaluatorZeroShot
    from transductive_clip_tpu_torch.features.cache import save_feature_cache

    monkeypatch.chdir(tmp_path)
    feats, labels = _zs_features()
    save_feature_cache(os.path.join(
        "data", "imagenet", "saved_features", "test_softmax_RN50_T30.plk"),
        feats, labels)
    opts = ["dataset", "imagenet", "method", "em_dirichlet", "shots", "0",
            "n_class", "64", "num_classes_test", "64", "k_eff", "5",
            "number_tasks", "16", "batch_size", "8", "n_query", "8",
            "seed", "3", "iter", "6", "iter_mm", "60", "save_results",
            "True", "log_path", str(tmp_path / "logs")]
    argv = ["--config-root", CONFIG_ROOT, "--opts", *opts]
    tsv = os.path.join("results_zero_shot", "test", "imagenet",
                       "EM_DIRICHLET_softmax_0shot.txt")
    monkeypatch.setattr(cli, "EvaluatorZeroShot",
                        lambda **kw: EvaluatorZeroShot(device="cpu", **kw))
    acc_1, _ = cli.main(argv)
    want = open(tsv).read()
    os.remove(tsv)
    acc, sec = cli.launch_workers(argv + ["data_parallel", "True"], 2,
                                  device="cpu")
    assert open(tsv).read() == want and acc == acc_1 and sec > 0


@pytest.mark.parametrize("entry", ["evaluator", "cli"])
def test_tp_above_one_raises_class_tp(rng, entry):
    """tp 3 on 2 ranks raises the ValueError of JAX's ``make_mesh`` (tp must
    divide the ranks) in the evaluator and in the CLI's launcher, before
    any rank joins a group. Class-axis TP itself runs
    (tests/test_torch_class_tp.py)."""
    from transductive_clip_tpu_torch.eval import EvaluatorZeroShot
    from transductive_clip_tpu_torch.parallel import TaskGroup

    msg = "n_devices=2 not divisible by tp=3"
    if entry == "cli":
        with pytest.raises(ValueError, match=msg):
            cli.launch_workers(["--config-root", CONFIG_ROOT, "--opts",
                                "dataset", "imagenet", "data_parallel",
                                "True", "tp", "3"], 2, device="cpu")
        return
    from transductive_clip_tpu.parallel import make_mesh

    with pytest.raises(ValueError, match=msg):
        make_mesh(n_devices=2, tp=3)
    feats, labels = _zs_features()
    group = TaskGroup(0, 2, torch.device("cpu"), None, None)
    with pytest.raises(ValueError, match=msg):
        EvaluatorZeroShot(args=_zs_cfg(CfgNode, True, tp=3),
                          group=group).evaluate_tasks(feats, labels)
