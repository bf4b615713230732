"""K3, the alpha-TIM support-gradient: the port's plain version against the
JAX Pallas kernel (interpret mode on the CPU, as tests/test_methods_few_shot.py
runs it) on the same numpy inputs, and the CUDA kernel against the plain
version on the card (``cuda``-marked; skips without a GPU).

Tolerances, on the max absolute difference over the output's max magnitude:
1e-5 in 'highest' (fp32 operands: only the order of the fp32 sums differs)
and 1e-2 in 'default' (bf16 operands keep 8 bits; a G value that lands on
either side of a bf16 rounding boundary moves by one bf16 ulp, 2^-8)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu.ops.pallas_tim import pallas_tim_support_grad
from transductive_clip_tpu_torch.ops import cuda_tim as ct

torch.set_num_threads(2)

TOL = {"highest": 1e-5, "default": 1e-2}
# (N, s, K, d): a ragged support count (not a multiple of 8) and widths off
# every tile size
SHAPES = {"ragged": (2, 13, 7, 9), "wider": (3, 37, 8, 20)}


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
    x, y, _ = _inputs(rng, 2, 13, 7, 9)
    x_p, y_p = ct.prepare_support(torch.as_tensor(x),
                                  torch.as_tensor(y, dtype=torch.int64),
                                  precision)
    assert x_p.dtype == dtype and x_p.shape == (2, 13, 9)
    assert y_p.dtype == torch.int32 and y_p.is_contiguous()
    np.testing.assert_array_equal(y_p.numpy(), y)


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
