"""K3, the alpha-TIM support-gradient: the port's plain version against the
JAX Pallas kernel (interpret mode on the CPU, as tests/test_methods_few_shot.py
runs it) on the same numpy inputs, and the CUDA kernel against the plain
version on the card (``cuda``-marked; skips without a GPU).

The kernel's own order of operations (the padded layout, W and G rounded
once, both contractions slice by slice) has a torch twin,
``tim_support_grad_tiled_reference``, held here against the plain version
at the ragged edges of the kernel's tiles.

Tolerances, on the max absolute difference over the output's max magnitude:
1e-5 in 'highest' (fp32 operands: only the order of the fp32 sums differs)
and 1e-2 in 'default' (bf16 operands keep 8 bits; a G value that lands on
either side of a bf16 rounding boundary moves by one bf16 ulp, 2^-8)."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu.ops.pallas_tim import pallas_tim_support_grad
from transductive_clip_tpu_torch.ops import cuda_tim as ct
from transductive_clip_tpu_torch.ops import kernel_build

torch.set_num_threads(2)

TOL = {"highest": 1e-5, "default": 1e-2}
# (N, s, K, d): a ragged support count (not a multiple of 8) and widths off
# every tile size
SHAPES = {"ragged": (2, 13, 7, 9), "wider": (3, 37, 8, 20)}
# the edges of the kernel's tiles: support rows around one 128-row tile,
# classes at one tile and past it, features whose rows do not start on 16
# bytes (97), that end in half a slice (1000) and that end on one (1008)
EDGES = [(2, 127, 128, 97), (2, 128, 150, 97), (2, 129, 128, 1000),
         (1, 129, 150, 1008)]


def _inputs(rng, n, s, k, d):
    """Simplex support rows, unsorted non-uniform labels (some classes
    missing, some repeated), and weights near the class means as TIM's
    Adam steps see them."""
    x = rng.dirichlet(np.ones(d) * 0.5, size=(n, s)).astype(np.float32)
    y = rng.integers(0, k, (n, s)).astype(np.int32)
    y[:, 0] = y[:, 1]
    w = (x.mean(1, keepdims=True)
         + 0.3 * rng.normal(size=(n, k, d))).astype(np.float32)
    return x, y, w


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _edge_inputs(rng, n, s, k, d, device="cpu"):
    """Inputs at a tile edge as alpha-TIM's Adam steps see them: softmax
    features peaked at their label, weights at the support class means plus
    a little noise (so the softmax over the classes is not saturated: with
    saturated rows p_label - 1 cancels to fp32 noise and no two
    implementations agree to 1e-5). Two labels of every task lie outside
    [0, K): they match no class."""
    y = rng.integers(0, k, (n, s))
    y[:, 0] = y[:, 1]
    z = rng.normal(size=(n, s, d))
    np.put_along_axis(z, (y % d)[..., None],
                      np.take_along_axis(z, (y % d)[..., None], 2) + 4.0, 2)
    x = np.exp(z - z.max(-1, keepdims=True))
    x = (x / x.sum(-1, keepdims=True)).astype(np.float32)
    onehot = (y[..., None] == np.arange(k)).astype(np.float32)
    w = np.einsum("tsk,tsd->tkd", onehot, x) / np.maximum(
        onehot.sum(1), 1.0)[..., None]
    w = (w + 1e-3 * rng.normal(size=(n, k, d))).astype(np.float32)
    y = y.astype(np.int32)
    y[:, 2], y[:, 5] = -1, k + 3
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(y, device=device),
            torch.as_tensor(w, device=device))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("kind,alpha", [("Shannon", 1.0), ("Alpha", 5.0)])
def test_plain_matches_pallas_interpret(rng, shape, precision, kind, alpha):
    n, s, k, d = SHAPES[shape]
    x, y, w = _inputs(rng, n, s, k, d)
    gs_j, col_j = pallas_tim_support_grad(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), 15.0, 0.25, alpha,
        ce_kind=kind, precision=precision, interpret=True)
    x_p, y_p = ct.prepare_support(torch.as_tensor(x), torch.as_tensor(y),
                                  precision)
    launches = ct.tim_support_grad.launches
    gs_t, col_t = ct.tim_support_grad(x_p, y_p, torch.as_tensor(w), 15.0,
                                      0.25, alpha, s, d, ce_kind=kind,
                                      precision=precision)
    assert ct.tim_support_grad.launches == launches   # plain version on CPU
    assert gs_t.shape == (n, k, d) and col_t.shape == (n, k)
    assert _rel(gs_t.numpy(), np.asarray(gs_j)) <= TOL[precision]
    assert _rel(col_t.numpy(), np.asarray(col_j)) <= TOL[precision]


@pytest.mark.parametrize("precision,dtype", [("highest", torch.float32),
                                             ("default", torch.bfloat16)])
def test_prepare_support_layout(rng, precision, dtype):
    """d is padded with zeros to a 16-byte row pitch (9 -> 12 fp32 or 16
    bf16 columns); the rows and the labels are not padded."""
    x, y, _ = _inputs(rng, 2, 13, 7, 9)
    x_p, y_p = ct.prepare_support(torch.as_tensor(x),
                                  torch.as_tensor(y, dtype=torch.int64),
                                  precision)
    dp = ct.padded_width(9, precision)
    assert dp == {"highest": 12, "default": 16}[precision]
    assert x_p.dtype == dtype and x_p.shape == (2, 13, dp)
    assert x_p.is_contiguous()
    assert (x_p.element_size() * dp) % 16 == 0
    torch.testing.assert_close(x_p[..., :9], torch.as_tensor(x).to(dtype),
                               rtol=0, atol=0)
    assert (x_p[..., 9:] == 0).all()
    assert y_p.dtype == torch.int32 and y_p.is_contiguous()
    np.testing.assert_array_equal(y_p.numpy(), y)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("d", [1000, 1008, 64])
def test_prepare_support_pads_nothing_at_aligned_widths(precision, d):
    """At the protocol's d = 1000 only the cast is made."""
    assert ct.padded_width(d, precision) == d
    x = torch.rand(1, 3, d)
    x_p, _ = ct.prepare_support(x, torch.zeros(1, 3, dtype=torch.int64),
                                precision)
    assert x_p.shape == x.shape
    if precision == "highest":
        assert x_p.data_ptr() == x.data_ptr()      # no copy at all


@pytest.mark.parametrize("shape", EDGES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("kind,alpha", [("Shannon", 1.0), ("Alpha", 2.5)])
def test_tiled_twin_matches_plain(rng, shape, precision, kind, alpha):
    """The kernel's order of operations against the plain version, which
    test_plain_matches_pallas_interpret holds against the JAX kernel."""
    n, s, k, d = shape
    x, y, w = _edge_inputs(rng, n, s, k, d)
    x_p, y_p = ct.prepare_support(x, y, precision)
    args = (x_p, y_p, w, 15.0, 1 / s, alpha, s, d)
    gs_t, col_t = ct.tim_support_grad_tiled_reference(
        *args, ce_kind=kind, precision=precision)
    gs_r, col_r = ct.tim_support_grad_reference(
        *args, ce_kind=kind, precision=precision)
    assert gs_t.shape == (n, k, d) and col_t.shape == (n, k)
    assert _rel(gs_t.numpy(), gs_r.numpy()) <= TOL[precision]
    assert _rel(col_t.numpy(), col_r.numpy()) <= TOL[precision]


def test_tiled_twin_refuses_an_unpadded_layout(rng):
    x, y, w = _edge_inputs(rng, 1, 13, 7, 9)
    with pytest.raises(ValueError, match="prepare_support"):
        ct.tim_support_grad_tiled_reference(
            x.to(torch.bfloat16), y.int(), w, 15.0, 0.25, 1.0, 13, 9)


def test_python_constants_equal_the_source():
    """The tile, ring and pitch constants of ops/cuda_tim.py, and its
    shared-memory formula, against csrc/tim_support_grad.cu."""
    text = (kernel_build.CSRC / ct.SOURCE).read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
        return eval(expr, {}, {n: const(n) for n in
                               re.findall(r"k[A-Z]\w+", expr)})

    assert (const("kTile"), const("kStages")) == (ct.TILE, ct.STAGES)
    assert const("kDepthB") == ct.DEPTH["default"]
    assert const("kDepthF") == ct.DEPTH["highest"]
    assert const("kPitchKB") == ct.PITCH_K["default"]
    assert const("kPitchKF") == ct.PITCH_K["highest"]
    assert const("kPitchMB") == ct.PITCH_M["default"]
    assert const("kPitchMF") == ct.PITCH_M["highest"]
    assert "kp % 8 != 0" in text and ct.K_UNIT == 8
    for precision in ("default", "highest"):
        for nbytes in ct.smem_bytes(precision):
            # two blocks an SM within its 227 KB
            assert 48 * 1024 < nbytes <= 113 * 1024
        # ldmatrix and float4 rows start on 16 bytes
        item = 2 if precision == "default" else 4
        assert (ct.PITCH_K[precision] * item) % 16 == 0
        assert (ct.PITCH_M[precision] * item) % 16 == 0


def test_wrapper_refuses_non_cpu_tensors_it_cannot_launch_on(rng):
    """Only CPU tensors take the plain version: anything else goes to the
    launch path, whose checks refuse a non-CUDA device."""
    x, y, w = _inputs(rng, 2, 13, 7, 9)
    x_p, y_p = ct.prepare_support(torch.as_tensor(x), torch.as_tensor(y),
                                  "highest")
    with pytest.raises(ValueError, match="CUDA device"):
        ct.tim_support_grad(x_p.to("meta"), y_p.to("meta"),
                            torch.as_tensor(w).to("meta"), 15.0, 0.25, 1.0,
                            13, 9, precision="highest")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("kind,alpha", [("Shannon", 1.0), ("Alpha", 2.5)])
def test_kernel_matches_plain_on_card(rng, precision, kind, alpha):
    """The CUDA kernel against its plain version at a ragged shape
    [3, 13, 150, 97] with non-uniform labels. Runs on a machine with a GPU:
    ``python -m pytest tests/test_torch_tim_kernel.py -m cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    n, s, k, d = 3, 13, 150, 97
    x, y, w = _inputs(rng, n, s, k, d)
    x_p, y_p = ct.prepare_support(torch.as_tensor(x, device="cuda"),
                                  torch.as_tensor(y, device="cuda"), precision)
    w_d = torch.as_tensor(w, device="cuda")
    launches = ct.tim_support_grad.launches
    gs, col = ct.tim_support_grad(x_p, y_p, w_d, 15.0, 1 / s, alpha, s, d,
                                  ce_kind=kind, precision=precision)
    torch.cuda.synchronize()
    assert ct.tim_support_grad.launches == launches + 1
    gs_r, col_r = ct.tim_support_grad_reference(
        x_p, y_p, w_d, 15.0, 1 / s, alpha, s, d, ce_kind=kind,
        precision=precision)
    assert _rel(gs.cpu().numpy(), gs_r.cpu().numpy()) <= TOL[precision]
    assert _rel(col.cpu().numpy(), col_r.cpu().numpy()) <= TOL[precision]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("kind,alpha", [("Shannon", 1.0), ("Alpha", 2.5)])
def test_kernel_matches_plain_at_tile_edges_on_card(rng, shape, precision,
                                                    kind, alpha):
    """The CUDA kernel at the edges of its tiles, with labels outside
    [0, K): ``python -m pytest tests/test_torch_tim_kernel.py -m cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    n, s, k, d = shape
    x, y, w = _edge_inputs(rng, n, s, k, d, device="cuda")
    x_p, y_p = ct.prepare_support(x, y, precision)
    args = (x_p, y_p, w, 15.0, 1 / s, alpha, s, d)
    gs, col = ct.tim_support_grad(*args, ce_kind=kind, precision=precision)
    torch.cuda.synchronize()
    gs_r, col_r = ct.tim_support_grad_reference(
        *args, ce_kind=kind, precision=precision)
    assert torch.isfinite(gs).all() and torch.isfinite(col).all()
    assert _rel(gs.cpu().numpy(), gs_r.cpu().numpy()) <= TOL[precision]
    assert _rel(col.cpu().numpy(), col_r.cpu().numpy()) <= TOL[precision]

