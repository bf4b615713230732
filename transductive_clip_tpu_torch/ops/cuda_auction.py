"""The batched auction on the card (``csrc/auction.cu``), the device
matching of ``matching_backend: device``.

The JAX package runs ``ops/auction.py``'s ``auction_assign`` as one XLA
``lax.while_loop`` (no Pallas kernel); here it is one kernel written in CUDA
C++ for sm_90a, one CTA per task running the task's rounds to their end, in
the JAX function's order and arithmetic, so ``col4row`` and the rounds are
the same bit for bit. Only the lowest unassigned row of each group of
bit-equal rows bids, scanning its group's first row (the source's head
comment says how).

``auction_assign`` takes its plain torch version
(``ops.auction.auction_assign_reference``) for a tensor on the CPU, and only
then; for a CUDA tensor it launches the kernel or raises.
``auction_assign.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from . import kernel_build
from .auction import auction_assign_reference

SOURCE = "auction.cu"
#: the entry point's C arguments (``kernel_build.ARG_TYPES``)
SIGNATURES = {"tclip_auction": "pppp iii f iii p"}
# threads of a task's CTA: 16 warps read and group the rows, then warp 0
# runs the rounds (at most the source's __launch_bounds__, 512)
THREADS = 512
# dynamic shared memory a CTA may take (227 KB)
SMEM_MAX = 232448


def smem_bytes(n_rows: int, n_cols: int) -> int:
    """A task's shared memory, in the source's order: bid keys (8 B),
    prices and owners (4 B each) per object, eight int lists and the first
    round's (b1, best_j, b2) per person (44 B), and the count of groups."""
    return 16 * n_cols + 44 * n_rows + 4


def max_objects(n_rows: int) -> int:
    """The largest C whose state fits a CTA's shared memory at ``n_rows``."""
    return max(0, (SMEM_MAX - smem_bytes(n_rows, 0)) // 16)


def auction_assign(values, eps: float = 1e-5, max_iters: int = 200_000,
                   return_rounds: bool = False, return_scans: bool = False):
    """Batched max-value assignment (see the module docstring): values
    [N, R, C] fp32 -> col4row [N, R] int32, -1 for a person left unassigned
    when ``max_iters`` rounds ran out. With ``return_rounds`` also the
    rounds each task ran, [N]; with ``return_scans`` also the rows it
    scanned over them, [N] (the plain version's ``return_scans``)."""
    if values.device.type == "cpu":
        return auction_assign_reference(values, eps=eps, max_iters=max_iters,
                                        return_rounds=return_rounds,
                                        return_scans=return_scans)
    if values.device.type != "cuda":
        raise ValueError(f"auction_assign: values on {values.device}")
    if values.dtype != torch.float32 or values.dim() != 3:
        raise ValueError("auction_assign: values must be [N, R, C] float32, "
                         f"got {tuple(values.shape)} {values.dtype}")
    if not values.is_contiguous():
        raise ValueError("auction_assign: values must be contiguous")
    n, r, c = values.shape
    if not (0 < n < 2 ** 31 and r > 0 and c > 0):
        raise ValueError(f"auction_assign: unsupported shape {tuple(values.shape)}")
    if smem_bytes(r, c) > SMEM_MAX:
        raise ValueError(
            f"auction_assign: C = {c} objects do not fit a CTA's shared "
            f"memory ({smem_bytes(r, c)} of {SMEM_MAX} bytes at R = {r}); "
            f"the kernel takes at most C = {max_objects(r)}")
    col4row = torch.empty((n, r), dtype=torch.int32, device=values.device)
    rounds = torch.empty(n, dtype=torch.int32, device=values.device)
    scans = (torch.empty(n, dtype=torch.int32, device=values.device)
             if return_scans else None)
    kernel_build.launch(
        kernel_build.load(SOURCE, SIGNATURES).tclip_auction, values.device,
        values.data_ptr(), col4row.data_ptr(), rounds.data_ptr(),
        None if scans is None else scans.data_ptr(), n, r, c, eps,
        int(max_iters), THREADS, smem_bytes(r, c))
    auction_assign.launches += 1
    out = ((col4row,) + ((rounds,) if return_rounds else ())
           + ((scans,) if return_scans else ()))
    return out if len(out) > 1 else col4row


auction_assign.launches = 0
