"""The port's batched auction (``ops/auction.py``'s plain version, and the
``csrc/auction.cu`` kernel behind ``ops/cuda_auction.py``) against the JAX
package's ``auction_assign`` on the same numpy values: ``col4row`` equal,
element for element, on the cases of tests/test_auction.py (random shapes,
constant padding rows, a seeded part of the quantised tie sweep, a price
war), on repeated rows that get evicted, and when the round budget runs
out. ``row_groups`` and the plain version's ``return_scans`` (the rows the
kernel scans when only the lowest unassigned row of each group of
bit-equal rows bids) against a grouped auction written here in numpy. The
kernel's cases carry the ``cuda`` marker and run on a machine with an
NVIDIA GPU (``python -m pytest tests/test_torch_auction.py -m cuda``)."""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax.numpy as jnp

from transductive_clip_tpu.ops.auction import auction_assign as jax_auction
from transductive_clip_tpu_torch.ops import cuda_auction as ca
from transductive_clip_tpu_torch.ops.auction import (
    auction_assign_reference,
    row_groups,
)

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


@pytest.mark.parametrize("r,extra", [(4, 2), (6, 3), (6, 4), (7, 5)])
def test_plain_auction_matches_jax_repeated_rows_evicted(r, extra):
    """Repeated rows on a 0.25 grid with a few spare objects: the copies
    bid for the same object, the lowest wins, and evictions hand the
    object back and forth; the same col4row on both sides."""
    rng = np.random.default_rng(r + extra)
    values = np.round(rng.uniform(0, 1, size=(8, r, r + extra)) * 4) / 4
    values = values.astype(np.float32)
    values[:, r // 2:] = values[:, :r - r // 2]
    values[::2, -1] = values[::2, 0]
    want, got, _ = _both(values)
    np.testing.assert_array_equal(got, want)
    _assert_near_optimal(values, got)


def _grouped_oracle(values, eps=1e-5, max_iters=200_000):
    """col4row, rounds and scans of an auction written from the JAX
    function's round in numpy, where in each round only the lowest
    unassigned row of each group of bit-equal rows bids."""
    eps = np.float32(eps)
    cols, rounds, scans = [], [], []
    for v in values:
        r, c = v.shape
        bits = v.view(np.int32)
        lead = [next(q for q in range(r) if (bits[q] == bits[p]).all())
                for p in range(r)]
        price = np.zeros(c, np.float32)
        owner = np.full(c, -1)
        it = scanned = 0
        while it < max_iters:
            owned = set(owner[owner >= 0].tolist())
            bidders = {}
            for p in range(r):
                if p not in owned:
                    bidders.setdefault(lead[p], p)
            if not bidders:
                break
            best = {}
            for p in sorted(bidders.values()):
                net = v[p] - price
                j = int(np.argmax(net))
                rest = np.delete(net, j)
                b2 = rest.max() if rest.size else net[j]
                bid = np.float32(price[j] + np.float32(net[j] - b2)) + eps
                if j not in best or bid > best[j][0]:
                    best[j] = (bid, p)
            for j, (bid, p) in best.items():
                price[j], owner[j] = bid, p
            it += 1
            scanned += len(bidders)
        col = np.full(r, -1, np.int32)
        for j in np.flatnonzero(owner >= 0):
            col[owner[j]] = j
        cols.append(col)
        rounds.append(it)
        scans.append(scanned)
    return np.stack(cols), np.array(rounds), np.array(scans)


def _zero_padded(rng, n, r, c, real):
    values = np.zeros((n, r, c), np.float32)
    values[:, :real] = rng.uniform(0.2, 1.0, size=(n, real, c))
    return values


def _repeated_rows(rng, n, r, c):
    values = np.round(rng.uniform(0, 1, size=(n, r, c)) * 4) / 4
    values = values.astype(np.float32)
    values[:, 1::3] = values[:, 0:1]
    values[:, -1] = -0.0
    values[:, -2] = 0.0
    return values


@pytest.mark.parametrize("case", ["zero_padded", "quantised", "repeated",
                                  "budget"])
def test_plain_scans_equal_a_grouped_auction(case):
    """The plain version's col4row, rounds and scans equal those of the
    grouped auction above: grouping moves no winner, price or round, also
    where repeated rows fight a price war (~2.5e4 rounds of evictions)."""
    rng = np.random.default_rng(11)
    max_iters = 200_000
    if case == "zero_padded":
        values = _zero_padded(rng, 3, 12, 20, 4)
    elif case == "quantised":
        values = (np.round(rng.uniform(0, 1, size=(8, 5, 8)) * 4) / 4).astype(
            np.float32)
    elif case == "repeated":
        values = _repeated_rows(rng, 2, 9, 12)
    else:
        values, max_iters = _repeated_rows(rng, 4, 9, 12), 2
    got, rounds, scans = auction_assign_reference(
        torch.as_tensor(values), max_iters=max_iters, return_rounds=True,
        return_scans=True)
    want, want_rounds, want_scans = _grouped_oracle(values,
                                                    max_iters=max_iters)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rounds.numpy(), want_rounds)
    np.testing.assert_array_equal(scans.numpy(), want_scans)
    if case == "budget":
        assert (got.numpy() < 0).any()


def test_scans_on_a_zero_padded_protocol_task(rng):
    """At the zero-shot shape [75, 1000] with a few real rows, the rows
    scanned are the real rows and one zero row a round: at most R plus the
    rounds, where every unassigned row bidding makes thousands of bids."""
    values = torch.as_tensor(_zero_padded(rng, 2, 75, 1000, 6))
    _, rounds, bids, scans = auction_assign_reference(
        values, return_rounds=True, return_bids=True, return_scans=True)
    assert (scans <= 75 + rounds).all()
    assert (bids > 20 * scans).all()


def test_row_groups_bits():
    """Each row's lowest bit-equal row: repeated rows share it; a row one
    ulp away, and a row of -0.0 beside one of +0.0, do not."""
    base = np.linspace(0.1, 0.9, 7, dtype=np.float32)
    values = np.stack([base, np.zeros(7, np.float32), base,
                       np.nextafter(base, np.float32(2)),
                       -np.zeros(7, np.float32), np.zeros(7, np.float32),
                       base, -np.zeros(7, np.float32)])[None]
    values = np.concatenate([values, values[:, ::-1]])
    got = row_groups(torch.as_tensor(values)).numpy()
    np.testing.assert_array_equal(got[0], [0, 1, 0, 3, 4, 1, 0, 4])
    np.testing.assert_array_equal(got[1], [0, 1, 2, 0, 4, 1, 2, 1])
    assert got.dtype == np.int32


def test_shared_memory_limit_arithmetic():
    for r in (1, 75, 1000):
        c = ca.max_objects(r)
        assert ca.smem_bytes(r, c) <= ca.SMEM_MAX < ca.smem_bytes(r, c + 1)
    assert ca.max_objects(75) > 1000
    # keys, prices and owners per object; eleven ints per person; a count
    assert ca.smem_bytes(75, 1000) == 16 * 1000 + 44 * 75 + 4


def test_source_matches_the_wrapper_constants():
    """The kernel's launch bound takes the wrapper's THREADS, and its
    shared-memory layout is the one smem_bytes counts."""
    from pathlib import Path

    src = (Path(ca.__file__).parent.parent / "csrc" / ca.SOURCE).read_text()
    bound = int(src.split("__launch_bounds__(")[1].split(")")[0])
    assert ca.THREADS % 32 == 0 and ca.THREADS <= bound
    assert f"threads > {bound})" in src
    assert "the layout of cuda_auction.smem_bytes" in src


def test_wrapper_takes_the_plain_version_on_cpu(rng):
    values = torch.as_tensor(rng.uniform(0, 1, size=(2, 4, 9))
                             .astype(np.float32))
    before = ca.auction_assign.launches
    got = ca.auction_assign(values)
    assert ca.auction_assign.launches == before
    torch.testing.assert_close(got, auction_assign_reference(values))
    got = ca.auction_assign(values, return_rounds=True, return_scans=True)
    assert ca.auction_assign.launches == before
    want = auction_assign_reference(values, return_rounds=True,
                                    return_scans=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
    # duplicated non-zero rows, also off the 16-byte loads (C = 97)
    dup = rng.uniform(0, 1, size=(4, 12, 40)).astype(np.float32)
    dup[:, 6:] = dup[:, :6]
    dup97 = _repeated_rows(rng, 4, 12, 97)
    # rows one ulp apart, and rows of -0.0 beside rows of +0.0
    ulp = np.repeat(rng.uniform(0, 1, size=(4, 1, 64)).astype(np.float32),
                    10, axis=1)
    ulp[:, 1::2] = np.nextafter(ulp[:, 1::2], np.float32(2))
    zeros = _zero_padded(rng, 4, 24, 64, 3)
    zeros[:, 3::2] = -0.0
    # many distinct rows at a wide C, some repeated
    wide = rng.uniform(0, 1, size=(3, 40, 2000)).astype(np.float32)
    wide[:, 30:] = wide[:, :10]
    return cases + [pad, ties, dup, dup97, ulp, zeros, wide]


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The kernel's col4row, rounds and scans equal the plain version's on
    the card at the edges (C = 1, R = 1, R = C, C not a multiple of 4,
    padding rows, quantised ties, repeated rows, rows one ulp apart, -0.0
    rows, many distinct rows at C = 2000) and at the protocol's
    [75, 1000]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    for values in _card_cases():
        v = torch.as_tensor(values, device="cuda")
        before = ca.auction_assign.launches
        got, rounds, scans = ca.auction_assign(v, return_rounds=True,
                                               return_scans=True)
        torch.cuda.synchronize()
        assert ca.auction_assign.launches == before + 1
        want, want_rounds, want_scans = auction_assign_reference(
            v, return_rounds=True, return_scans=True)
        assert torch.equal(got, want), values.shape
        assert torch.equal(rounds.long(), want_rounds), values.shape
        assert torch.equal(scans.long(), want_scans), values.shape


@pytest.mark.cuda
def test_kernel_budget_and_refusal_on_card():
    """A budget run out gives the plain version's -1 rows and scans; a C
    too large for shared memory raises with the limit in the message."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    rng = np.random.default_rng(8)
    v = torch.as_tensor(rng.uniform(0, 1, size=(4, 30, 60))
                        .astype(np.float32), device="cuda")
    got = ca.auction_assign(v, max_iters=1)
    assert torch.equal(got, auction_assign_reference(v, max_iters=1))
    assert (got < 0).any()
    v = torch.as_tensor(_repeated_rows(rng, 4, 30, 60), device="cuda")
    got, scans = ca.auction_assign(v, max_iters=1, return_scans=True)
    want, want_scans = auction_assign_reference(v, max_iters=1,
                                                return_scans=True)
    assert torch.equal(got, want) and torch.equal(scans.long(), want_scans)
    assert (got < 0).any()
    wide = torch.zeros(1, 2, ca.max_objects(2) + 1, device="cuda")
    with pytest.raises(ValueError, match=f"at most C = {ca.max_objects(2)}"):
        ca.auction_assign(wide)
