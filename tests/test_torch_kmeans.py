"""The port's k-means family, EM-Gaussian (with and without a diagonal
precision), inductive CLIP and ``ops/distances`` against the JAX package's,
on the same numpy inputs (the shapes of tests/conftest.py's
``make_simplex_tasks`` and tests/test_kmeans_oracles.py).

Required everywhere: equal predictions and hard one-hots, and soft ``u``
and criterion traces within 1e-5 absolute.

Which data goes with which distance: the ``matmul`` expansion cancels on
nearly equal points, and the two packages sum its products in different
orders, so a borderline argmin may flip between them after a few
iterations. The ``matmul`` cases therefore run on well-separated tasks
(concentration 60); the borderline cases (concentration 5, and the flat
Dirichlet(0.8) features) run ``direct``, the reference's broadcast-subtract.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu.core.config import CfgNode as JCfg
from transductive_clip_tpu.core.config import load_full_config as jax_config
from transductive_clip_tpu.methods import get_zero_shot_method as jax_get
from transductive_clip_tpu.methods.zero_shot import em_gaussian as jeg
from transductive_clip_tpu.methods.zero_shot import em_gaussian_cov as jegc
from transductive_clip_tpu.methods.zero_shot import hard_kmeans as jhk
from transductive_clip_tpu.methods.zero_shot import kl_kmeans as jkl
from transductive_clip_tpu.methods.zero_shot import soft_kmeans as jsk
from transductive_clip_tpu.ops import common as jcommon
from transductive_clip_tpu.ops import distances as jdist
from transductive_clip_tpu.utils.synthetic import make_zero_shot_tasks
from transductive_clip_tpu_torch.core.config import CfgNode
from transductive_clip_tpu_torch.core.config import load_full_config
from transductive_clip_tpu_torch.methods import get_zero_shot_method
from transductive_clip_tpu_torch.methods.zero_shot import em_gaussian as teg
from transductive_clip_tpu_torch.methods.zero_shot import em_gaussian_cov as tegc
from transductive_clip_tpu_torch.methods.zero_shot import hard_kmeans as thk
from transductive_clip_tpu_torch.methods.zero_shot import kl_kmeans as tkl
from transductive_clip_tpu_torch.methods.zero_shot import soft_kmeans as tsk
from transductive_clip_tpu_torch.ops import common as tcommon
from transductive_clip_tpu_torch.ops import distances as tdist

from conftest import make_simplex_tasks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO, "config")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "reference_traces.npz")
ATOL = 1e-5


def _lambd(K, n_query):
    return float(int(K / 5) * n_query)


def _run(name, x, u0, impl, n_iter):
    """(u, criterions) of the JAX function and of the port's, as numpy."""
    T = 30.0
    lambd = _lambd(x.shape[2], x.shape[1])
    xj, uj = jnp.asarray(x), jnp.asarray(u0)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u0)
    if name == "soft_kmeans":
        j = jsk.soft_kmeans_infer(xj, uj, jnp.float32(T), n_iter=n_iter,
                                  impl=impl)
        t = tsk.soft_kmeans_infer(xt, ut, T, n_iter=n_iter, impl=impl)
    elif name == "hard_kmeans":
        j = jhk.hard_kmeans_infer(xj, uj, n_iter=n_iter, impl=impl)
        t = thk.hard_kmeans_infer(xt, ut, n_iter=n_iter, impl=impl)
    elif name == "kl_kmeans":
        j = jkl.kl_kmeans_infer(xj, uj, n_iter=n_iter)
        t = tkl.kl_kmeans_infer(xt, ut, n_iter=n_iter)
    elif name == "em_gaussian":
        j = jeg.em_gaussian_infer(xj, uj, jnp.float32(T), jnp.float32(lambd),
                                  n_iter=n_iter, impl=impl)
        t = teg.em_gaussian_infer(xt, ut, T, lambd, n_iter=n_iter, impl=impl)
    else:
        j = jegc.em_gaussian_cov_infer(xj, uj, jnp.float32(lambd),
                                       n_iter=n_iter, dist_impl=impl)
        t = tegc.em_gaussian_cov_infer(xt, ut, lambd, n_iter=n_iter,
                                       dist_impl=impl)
    return ((np.asarray(j[0]), np.asarray(j[1])),
            (t[0].numpy(), t[1].numpy()))


def _assert_same(jax_out, torch_out, crit_atol=ATOL, ties=False):
    """Equal predictions, u and the criterion trace within 1e-5 (the
    trace within ``crit_atol`` where a test states its reading).

    ``ties``: soft k-means on tasks with absent classes lets the clusters
    of those classes collapse onto present ones: two columns of u then
    hold the same value to the last ulp or two (the JAX run's top two
    differ by exactly 0.0 on up to 32 of the 160 queries of
    [4, 40, 8] after 8 iterations), and the argmax between them follows
    each package's order of fp32 sums (a third of the queries there are
    decided, the rest split about evenly between two duplicates). The
    predictions must be equal wherever the top two of u are further apart
    than twice the u tolerance, and every other query must sit on such a
    tie."""
    (u_j, c_j), (u_t, c_t) = jax_out, torch_out
    assert u_t.shape == u_j.shape and c_t.shape == c_j.shape
    assert u_t.dtype == np.float32 and c_t.dtype == np.float32
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=crit_atol)
    if not ties:
        np.testing.assert_array_equal(u_t.argmax(-1), u_j.argmax(-1))
        return
    top2 = np.sort(u_j, -1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * ATOL
    assert decided.any()
    np.testing.assert_array_equal(u_t.argmax(-1)[decided],
                                  u_j.argmax(-1)[decided])
    rows = np.take_along_axis(u_j, u_t.argmax(-1)[..., None], -1)[..., 0]
    np.testing.assert_allclose(rows, top2[..., 1], rtol=0, atol=2 * ATOL)


METHOD_IMPLS = [
    ("soft_kmeans", "matmul"), ("soft_kmeans", "direct"),
    ("hard_kmeans", "matmul"), ("hard_kmeans", "direct"),
    ("kl_kmeans", None),
    ("em_gaussian", "matmul"), ("em_gaussian", "direct"),
    ("em_gaussian_cov", "direct"), ("em_gaussian_cov", "matmul"),
]


@pytest.mark.parametrize("impl", ["matmul", "direct"])
def test_distances_match_jax(rng, impl):
    """sq_euclidean (both impls) on well-separated rows, the KL divergence
    to centroids on simplex rows with an empty (zero) centroid, and
    l2_normalize with a zero row: within 1e-5 relative."""
    x = rng.normal(size=(3, 20, 16)).astype(np.float32)
    w = rng.normal(size=(3, 7, 16)).astype(np.float32)
    got = tdist.sq_euclidean(torch.as_tensor(x), torch.as_tensor(w),
                             impl=impl).numpy()
    want = np.asarray(jdist.sq_euclidean(jnp.asarray(x), jnp.asarray(w),
                                         impl=impl))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    oracle = ((x[:, :, None].astype(np.float64) - w[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(got, oracle, rtol=1e-5)

    p = rng.dirichlet(np.ones(10), size=(3, 12)).astype(np.float32)
    c = rng.dirichlet(np.ones(10), size=(3, 5)).astype(np.float32)
    c[:, 2] = 0.0
    got = tdist.kl_divergence_to_centroids(torch.as_tensor(p),
                                           torch.as_tensor(c)).numpy()
    want = np.asarray(jdist.kl_divergence_to_centroids(jnp.asarray(p),
                                                       jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=1e-5)

    x[1, 3] = 0.0
    got = tcommon.l2_normalize(torch.as_tensor(x)).numpy()
    want = np.asarray(jcommon.l2_normalize(jnp.asarray(x)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,impl", METHOD_IMPLS)
def test_infer_matches_jax_well_separated(rng, name, impl):
    """make_simplex_tasks' separable tasks [4, 40, 8] (concentration 60),
    u0 = the features, 8 iterations: both distance impls. Soft k-means
    duplicates the absent classes' clusters (see ``_assert_same``).
    EM-Gaussian-cov's ``matmul`` expansion runs with every class present
    (k_eff = 8): with absent classes its near-empty clusters reach s ~
    1/EPS, where the expansion cancels (the two packages part by a whole
    assignment at iteration 5), which is why ``direct`` is its default."""
    k_eff = 8 if (name, impl) == ("em_gaussian_cov", "matmul") else 4
    x, _ = make_simplex_tasks(rng, k_eff=k_eff)
    _assert_same(*_run(name, x, x, impl or "matmul", 8),
                 ties=name == "soft_kmeans")


@pytest.mark.parametrize("name", ["soft_kmeans", "hard_kmeans", "kl_kmeans",
                                  "em_gaussian", "em_gaussian_cov"])
def test_infer_matches_jax_borderline_direct(rng, name):
    """Overlapping classes (concentration 5) at tests/test_kmeans_oracles.py's
    shape [2, 15, 6] and at [3, 30, 10]: ``direct`` distances, whose
    fp32 sums do not cancel."""
    for shape in ((2, 15, 6, 3), (3, 30, 10, 4)):
        n_task, n_query, K, k_eff = shape
        x, _ = make_simplex_tasks(rng, n_task=n_task, n_query=n_query,
                                  n_class=K, k_eff=k_eff, concentration=5.0)
        _assert_same(*_run(name, x, x, "direct", 5),
                     ties=name == "soft_kmeans")


@pytest.fixture
def flush_denormal():
    """torch's CPU flushing fp32 denormals to zero, as XLA's CPU backend
    does: a drained cluster's softmax mass underflows to denormals in the
    port and to zero in the JAX package (ROADMAP.md, fault F2)."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_em_gaussian_cov_direct_on_flat_features(rng, flush_denormal):
    """tests/test_kmeans_oracles.py's flat Dirichlet(0.8) features
    [2, 25, 10], 6 iterations: near-empty clusters drive s toward 1/EPS,
    where ``direct`` multiplies it by an exact zero. The port's ``direct``
    gives the JAX package's predictions and u within 1e-5; the criterion
    trace reads up to 1.56e-5 apart (iteration 5): with s up to 1e15 the
    log-determinant term is ~170 in the softmax's exponent, whose fp32
    rounding (~1e-5) the trace, a norm over all n K entries, adds up.
    Its limit here is 3e-5."""
    x = rng.dirichlet(np.full(10, 0.8), size=(2, 25)).astype(np.float32)
    _assert_same(*_run("em_gaussian_cov", x, x, "direct", 6),
                 crit_atol=3e-5)


@pytest.mark.parametrize("impl", ["matmul", "direct"])
def test_hard_kmeans_empty_clusters_tie_to_the_first_index(rng, impl):
    """Every empty cluster's centroid is the zero row, so a query's
    distances to all of them tie exactly; the argmin takes the first index
    in both packages. All queries start in cluster 0: the queries nearer
    to the origin than to their mean go to cluster 1 (the first empty one)
    and none to clusters 2..7; later iterations split further."""
    x = rng.normal(size=(3, 24, 8)).astype(np.float32)
    u0 = np.zeros_like(x)
    u0[..., 0] = 1.0
    j1, t1 = _run("hard_kmeans", x, u0, impl, 1)
    pred = t1[0].argmax(-1)
    assert set(np.unique(pred)) == {0, 1}
    _assert_same(j1, t1)
    _assert_same(*_run("hard_kmeans", x, u0, impl, 6))


def test_kl_kmeans_empty_clusters_tie_to_the_first_index():
    """Queries at the simplex's vertices 2, 3 and 4; u0 puts the vertex-2
    and -3 queries in cluster 5 and gives the vertex-4 queries no mass, so
    no centroid has mass at coordinate 4. Their divergences to every
    centroid then tie at -log(EPS) in fp32, and both packages put them in
    cluster 0, an empty one."""
    K, n = 6, 12
    labels = np.tile(np.array([2, 3, 4]), n // 3)
    x = np.zeros((2, n, K), np.float32)
    x[:, np.arange(n), labels] = 1.0
    u0 = np.zeros_like(x)
    u0[:, labels != 4, 5] = 1.0
    j, t = _run("kl_kmeans", x, u0, None, 3)
    pred = t[0].argmax(-1)
    assert (pred[:, labels == 4] == 0).all()
    _assert_same(j, t)


def _cfgs(method, **over):
    opts = ["dataset", "eurosat", "method", method, "shots", "0",
            "num_classes_test", "8", "n_query", "40", "k_eff", "4",
            "batch_size", "4"]
    for k, v in over.items():
        opts += [k, str(v)]
    return (jax_config(opts=opts, config_root=CONFIG_ROOT),
            load_full_config(opts=opts, config_root=CONFIG_ROOT))


ZS = ["soft_kmeans", "hard_kmeans", "kl_kmeans", "em_gaussian",
      "em_gaussian_cov", "inductive_clip"]


@pytest.fixture(scope="module")
def traces():
    return dict(np.load(FIXTURE))


@pytest.mark.parametrize("method", ZS)
def test_golden_traces(traces, method):
    """tests/test_golden_traces.py's inputs [4, 40, 8] (concentration 12)
    and configuration (basic matching) through run_task: the reference's
    accuracies, and the JAX package's predictions and criterion trace
    within 1e-5. The reference's own traces measure something else
    (zeros for the soft methods, the first iteration's change recorded
    twice for the hard ones): where one is nonzero, it is the port's first
    entry, and both end at 0."""
    x, y = make_zero_shot_tasks(np.random.default_rng(0), 4, 40, 8, k_eff=4,
                                concentration=12.0)
    cfg_j, cfg_t = _cfgs(method, graph_matching=False)
    logs_j = jax_get(cfg_j.name_method, args=cfg_j).run_task(
        {"x_q": x, "y_q": y})
    logs_t = get_zero_shot_method(cfg_t.name_method, device="cpu",
                                  args=cfg_t).run_task({"x_q": x, "y_q": y})
    np.testing.assert_array_equal(logs_t["acc"][:, -1],
                                  traces[f"zs_{method}_acc"])
    np.testing.assert_array_equal(logs_t["preds"], logs_j["preds"])
    crit = np.asarray(logs_t["criterions"])
    np.testing.assert_allclose(crit, np.asarray(logs_j["criterions"]),
                               rtol=0, atol=ATOL)
    ref = traces[f"zs_{method}_crit"]
    if ref.any():
        np.testing.assert_allclose(ref[ref > 0], crit[0], rtol=1e-5)
        assert ref[-1] == 0 and crit[-1] == 0


@pytest.mark.parametrize("method", ZS)
@pytest.mark.parametrize("softmax", [True, False])
def test_run_task_matches_jax(rng, method, softmax):
    """The method classes through run_task with Hungarian matching, on
    softmax features and on visual features with text prototypes (u0 =
    softmax(T q t^T), the prototypes' class probabilities from the text):
    the JAX package's accuracies, predictions and criterion trace. Every
    class is present in each task (k_eff = 8), so that no cluster of soft
    k-means duplicates another (see ``_assert_same``). KL k-means takes
    the logarithm of the centroids, which visual features make negative:
    its u is then NaN-driven in both packages, equal, and its accuracy is
    not held to a floor."""
    K, d = 8, 16
    if softmax:
        x, y = make_simplex_tasks(rng, k_eff=K)
        text = None
    else:
        text = rng.normal(size=(K, d)).astype(np.float32)
        text /= np.linalg.norm(text, axis=-1, keepdims=True)
        y = np.stack([rng.permutation(np.arange(40) % K) for _ in range(4)])
        x = text[y] + 0.05 * rng.normal(size=(*y.shape, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    task = {"x_q": x, "y_q": y}
    if text is not None:
        task["text_features"] = text
    cfg_j, cfg_t = _cfgs(method, use_softmax_feature=softmax, iter=8)
    cfg_j.n_class = cfg_t.n_class = K
    logs_j = jax_get(cfg_j.name_method, args=cfg_j).run_task(task)
    method_t = get_zero_shot_method(cfg_t.name_method, device="cpu",
                                    args=cfg_t)
    logs_t = method_t.run_task(task)
    np.testing.assert_array_equal(logs_t["acc"], logs_j["acc"])
    np.testing.assert_array_equal(logs_t["preds"], logs_j["preds"])
    np.testing.assert_allclose(logs_t["criterions"], logs_j["criterions"],
                               rtol=0, atol=ATOL)
    if softmax or method != "kl_kmeans":
        assert logs_t["acc"].mean() > 0.9


def test_lambda_and_modes_match_jax():
    """lambda = int(K / 5) * n_query for both EM-Gaussians, the accuracy
    modes (inductive CLIP: argmax, the rest: matched clustering) and the
    classes' names in both registries."""
    from transductive_clip_tpu.methods import ZERO_SHOT_METHODS as JAX_ZS
    from transductive_clip_tpu_torch.methods import ZERO_SHOT_METHODS

    assert set(ZERO_SHOT_METHODS) == set(JAX_ZS)
    cfg = CfgNode(dict(num_classes_test=1000, n_query=75, device=0))
    jcfg = JCfg(dict(num_classes_test=1000, n_query=75, device=0))
    for name, cls in ZERO_SHOT_METHODS.items():
        assert cls.__name__ == JAX_ZS[name].__name__
        assert cls.acc_mode == JAX_ZS[name].acc_mode
        if name.startswith("EM_GAUSSIAN"):
            assert cls(device="cpu", args=cfg).lambd == JAX_ZS[name](
                args=jcfg).lambd == 200 * 75
