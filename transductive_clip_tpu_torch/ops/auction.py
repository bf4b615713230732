"""Batched auction for the cluster->class assignment, the plain torch
version (counterpart of transductive_clip_tpu/ops/auction.py).

A Jacobi auction (Bertsekas 1988) over R persons (cluster rows) and C
objects (classes), maximising the total value: every unassigned person bids
for its best object (top-2 margin + eps), every object takes its highest
bid (the lowest person index on ties), and at termination the assignment
is within R * eps of the optimum. It starts from zero prices and runs one
phase; near-exact ties on square instances turn into price wars that
advance eps a round (the JAX module measures ~4e4 rounds at worst on 5 x 5
values quantised to a 0.25 grid), which the default budget absorbs.

``auction_assign_reference`` is ``_auction_single`` of the JAX module in
torch ops, batched over tasks the way ``jax.vmap`` batches its
``lax.while_loop``: a task that has finished (every person assigned, or its
budget spent) keeps its state frozen while the others go on. Round for
round it makes the JAX function's bids and winners, with its tie-breaks, so
``col4row`` is the same bit for bit. The stop test is a device-side flag
read on the host every ``AUCTION_CHECK_EVERY`` rounds; the rounds past the
stop change nothing. It is the tests' reference and the CPU path of
``ops.cuda_auction.auction_assign``, whose kernel runs the whole loop on the
card in one launch.

Rows that are equal bit for bit (``row_groups``) make the same bid in every
round, and a tie goes to the lowest person, so only the lowest unassigned
member of each group can win: the kernel lets that one bid alone, which
changes no winner, price or round. ``return_scans`` counts the rows it
scans that way, while the plain version itself still lets every
unassigned person bid.
"""

from __future__ import annotations

import torch

from .common import to_host

# rounds between two host reads of the stop flag
AUCTION_CHECK_EVERY = 16


def _assigned(owner, rows):
    """[N, R]: whether person r owns an object (owner [N, C], -1 = none)."""
    return (owner[:, None, :] == rows[None, :, None]).any(-1)


def row_groups(values):
    """values [N, R, C] fp32 -> [N, R] int32: for each row the lowest row
    index of its task whose values are equal to it bit for bit (compared as
    int32, so a row of +0.0 and one of -0.0 are not grouped)."""
    n, r, c = values.shape
    bits = values.contiguous().view(torch.int32).reshape(n * r, c)
    task = torch.arange(n, dtype=torch.int32, device=values.device)
    keyed = torch.cat([task.repeat_interleave(r)[:, None], bits], 1)
    _, group = torch.unique(keyed, dim=0, return_inverse=True)
    row = torch.arange(r, device=values.device).repeat(n)
    lowest = torch.full((n * r,), r, dtype=torch.int64, device=values.device)
    lowest = lowest.scatter_reduce(0, group, row, "amin")
    return lowest[group].view(n, r).to(torch.int32)


def auction_assign_reference(values, eps: float = 1e-5,
                             max_iters: int = 200_000,
                             return_rounds: bool = False,
                             return_bids: bool = False,
                             return_scans: bool = False):
    """Batched max-value assignment: values [N, R, C] fp32 -> col4row
    [N, R] int32, -1 for a person left unassigned when ``max_iters`` rounds
    ran out. With ``return_rounds`` also the rounds each task ran [N]; with
    ``return_bids`` also the bids each task made over its rounds [N] (each
    reads its person's value row once); with ``return_scans`` also the rows
    the kernel scans over its rounds [N]: in each round, the groups of
    ``row_groups`` with an unassigned member."""
    if values.dtype != torch.float32 or values.dim() != 3:
        raise ValueError("auction_assign_reference: values must be [N, R, C] "
                         f"float32, got {tuple(values.shape)} {values.dtype}")
    n, r, c = values.shape
    dev = values.device
    rows = torch.arange(r, device=dev)
    cols = torch.arange(c, device=dev)
    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    price = torch.zeros((n, c), dtype=torch.float32, device=dev)
    owner = torch.full((n, c), -1, dtype=torch.int32, device=dev)
    rounds = torch.zeros(n, dtype=torch.int64, device=dev)
    bids_made = torch.zeros(n, dtype=torch.int64, device=dev)
    scans = torch.zeros(n, dtype=torch.int64, device=dev)
    lead = row_groups(values).long() if return_scans else None

    def running(owner, rounds):
        return ~_assigned(owner, rows).all(1) & (rounds < max_iters)

    active = running(owner, rounds)
    while bool(to_host(active.any())):
        for _ in range(AUCTION_CHECK_EVERY):
            assigned = _assigned(owner, rows)                   # [N, R]
            net = values - price[:, None, :]                    # [N, R, C]
            b1 = net.amax(-1)
            best_j = net.argmax(-1)                             # lowest index
            masked = torch.where(cols == best_j[..., None], neg_inf, net)
            b2 = masked.amax(-1)
            b2 = torch.where(torch.isfinite(b2), b2, b1)        # C == 1
            bids = torch.gather(price, 1, best_j) + (b1 - b2) + eps_t
            bids = torch.where(assigned, neg_inf, bids)
            bid_matrix = torch.where(best_j[..., None] == cols,
                                     bids[..., None], neg_inf)  # [N, R, C]
            best_bid = bid_matrix.amax(1)                       # [N, C]
            winner = bid_matrix.argmax(1)                       # lowest person
            has_bid = torch.isfinite(best_bid) & active[:, None]
            price = torch.where(has_bid, best_bid, price)
            owner = torch.where(has_bid, winner.to(torch.int32), owner)
            rounds = rounds + active
            bids_made = bids_made + (~assigned).sum(1) * active
            if return_scans:
                open_members = torch.zeros((n, r), dtype=torch.int64,
                                           device=dev).scatter_add_(
                    1, lead, (~assigned).long())
                scans = scans + (open_members > 0).sum(1) * active
            active = running(owner, rounds)

    owned = owner[:, None, :] == rows[None, :, None]            # [N, R, C]
    col4row = torch.where(owned.any(-1), owned.to(torch.int32).argmax(-1),
                          -1).to(torch.int32)
    out = ((col4row,) + ((rounds,) if return_rounds else ())
           + ((bids_made,) if return_bids else ())
           + ((scans,) if return_scans else ()))
    return out if len(out) > 1 else col4row
