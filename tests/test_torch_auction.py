"""The port's batched auction (``ops/auction.py``'s plain version, and the
``csrc/auction.cu`` kernel behind ``ops/cuda_auction.py``) against the JAX
package's ``auction_assign`` on the same numpy values: ``col4row`` equal,
element for element, on the cases of tests/test_auction.py (random shapes,
constant padding rows, a seeded part of the quantised tie sweep, a price
war) and when the round budget runs out. The kernel's cases carry the
``cuda`` marker and run on a machine with an NVIDIA GPU
(``python -m pytest tests/test_torch_auction.py -m cuda``)."""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax.numpy as jnp

from transductive_clip_tpu.ops.auction import auction_assign as jax_auction
from transductive_clip_tpu_torch.ops import cuda_auction as ca
from transductive_clip_tpu_torch.ops.auction import auction_assign_reference

torch.set_num_threads(2)


def _both(values, **kw):
    want = np.asarray(jax_auction(jnp.asarray(values), **kw))
    got, rounds = auction_assign_reference(torch.as_tensor(values),
                                           return_rounds=True, **kw)
    return want, got.numpy(), rounds.numpy()


def _assert_near_optimal(values, cols, eps=1e-5):
    n, r, c = values.shape
    for t in range(n):
        assert len(set(cols[t].tolist())) == r
        assert (cols[t] >= 0).all() and (cols[t] < c).all()
        got = values[t, np.arange(r), cols[t]].sum()
        rr, cc = linear_sum_assignment(-values[t])
        assert got >= values[t, rr, cc].sum() - r * eps - 1e-5


@pytest.mark.parametrize("shape", [(5, 5), (8, 20), (1, 4), (30, 60)])
def test_plain_auction_matches_jax_random(rng, shape):
    values = rng.uniform(0, 1, size=(3, *shape)).astype(np.float32)
    want, got, _ = _both(values)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    _assert_near_optimal(values, got)


def test_plain_auction_matches_jax_constant_padding_rows(rng):
    """Absent clusters are all-zero value rows: they take spare objects and
    leave the real rows' optimum alone."""
    values = np.zeros((2, 10, 16), np.float32)
    values[:, :4] = rng.uniform(0.2, 1.0, size=(2, 4, 16))
    want, got, _ = _both(values)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all()


@pytest.mark.parametrize("shape,seed", [((5, 5), 3), ((8, 20), 1),
                                        ((30, 60), 2), ((75, 200), 4)])
def test_plain_auction_matches_jax_quantized_ties(shape, seed):
    """A seeded part of tests/test_auction.py's sweep: values on a 0.25
    grid, so bids, margins and prices tie exactly and every tie-break
    counts."""
    rng = np.random.default_rng(seed)
    values = rng.uniform(0, 1, size=(12, *shape)).astype(np.float32)
    values = np.round(values * 4) / 4
    want, got, _ = _both(values)
    np.testing.assert_array_equal(got, want)
    _assert_near_optimal(values, got)


def test_plain_auction_matches_jax_price_war():
    """The sweep's 5 x 5 price war (seed 0, task 2 of 125): ~2.5e4
    rounds of eps-sized bids, each task frozen once it is done."""
    rng = np.random.default_rng(0)
    values = np.round(rng.uniform(0, 1, size=(125, 5, 5))
                      .astype(np.float32) * 4) / 4
    values = values[[0, 2]]
    want, got, rounds = _both(values)
    np.testing.assert_array_equal(got, want)
    assert rounds[1] > 20_000 > rounds[0]


@pytest.mark.parametrize("shape,max_iters", [((5, 5), 3), ((30, 60), 1),
                                             ((3, 1), 50)])
def test_plain_auction_matches_jax_when_the_budget_runs_out(rng, shape,
                                                            max_iters):
    """With too few rounds (or more persons than objects) some persons stay
    unassigned: the same -1 rows on both sides."""
    values = rng.uniform(0, 1, size=(4, *shape)).astype(np.float32)
    want, got, rounds = _both(values, max_iters=max_iters)
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any() and (rounds <= max_iters).all()


def test_shared_memory_limit_arithmetic():
    for r in (1, 75, 1000):
        c = ca.max_objects(r)
        assert ca.smem_bytes(r, c) <= ca.SMEM_MAX < ca.smem_bytes(r, c + 1)
    assert ca.max_objects(75) > 1000


def test_wrapper_takes_the_plain_version_on_cpu(rng):
    values = torch.as_tensor(rng.uniform(0, 1, size=(2, 4, 9))
                             .astype(np.float32))
    before = ca.auction_assign.launches
    got = ca.auction_assign(values)
    assert ca.auction_assign.launches == before
    torch.testing.assert_close(got, auction_assign_reference(values))


# ---- the kernel on the card ------------------------------------------------

def _card_cases():
    rng = np.random.default_rng(7)
    cases = [rng.uniform(0, 1, size=(6, r, c)).astype(np.float32)
             for r, c in ((1, 1), (1, 33), (5, 5), (8, 20), (75, 1000),
                          (75, 75), (30, 63))]
    pad = np.zeros((3, 20, 97), np.float32)
    pad[:, :6] = rng.uniform(0.2, 1.0, size=(3, 6, 97))
    ties = np.round(rng.uniform(0, 1, size=(12, 5, 5)) * 4).astype(
        np.float32) / 4
    return cases + [pad, ties]


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The kernel's col4row and rounds equal the plain version's on the card
    at the edges (C = 1, R = 1, R = C, C not a multiple of 32, padding
    rows, quantised ties) and at the protocol's [75, 1000]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    for values in _card_cases():
        v = torch.as_tensor(values, device="cuda")
        before = ca.auction_assign.launches
        got, rounds = ca.auction_assign(v, return_rounds=True)
        torch.cuda.synchronize()
        assert ca.auction_assign.launches == before + 1
        want, want_rounds = auction_assign_reference(v, return_rounds=True)
        assert torch.equal(got, want), values.shape
        assert torch.equal(rounds.long(), want_rounds), values.shape


@pytest.mark.cuda
def test_kernel_budget_and_refusal_on_card():
    """A budget run out gives the plain version's -1 rows; a C too large for
    shared memory raises with the limit in the message."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    rng = np.random.default_rng(8)
    v = torch.as_tensor(rng.uniform(0, 1, size=(4, 30, 60))
                        .astype(np.float32), device="cuda")
    got = ca.auction_assign(v, max_iters=1)
    assert torch.equal(got, auction_assign_reference(v, max_iters=1))
    assert (got < 0).any()
    wide = torch.zeros(1, 2, ca.max_objects(2) + 1, device="cuda")
    with pytest.raises(ValueError, match=f"at most C = {ca.max_objects(2)}"):
        ca.auction_assign(wide)
