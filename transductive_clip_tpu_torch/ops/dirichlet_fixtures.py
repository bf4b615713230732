"""Inputs and checks for the Dirichlet row-solve kernels K1 and K2
(``cuda_dirichlet``) and the Newton-Minka step (``cuda_newton``), shared by
``chip_smoke.py`` and the tests: the EM step's inputs at a given shape, the
edge cases of the cluster design, and the bit-for-bit check of
``special.cuh``'s fast paths (``csrc/special_check.cu``). Nothing of the
port's solve path imports this module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.synthetic import make_zero_shot_tasks
from . import kernel_build
from .common import EPS, get_one_hot, top_rows
from .cuda_dirichlet import ROW_FREEZE
from .dirichlet import weighted_log_means


def synthetic_solve_inputs(n_task, n_rows, k, seed, n_query=75,
                           device="cuda", hard_odd=True):
    """(alpha0 = 1, y) [n_task, n_rows, k] built as the EM step builds them:
    weighted log-means of synthetic zero-shot tasks (utils/synthetic.py)
    over each task's top-``n_rows`` clusters by mass. Even tasks take the
    dense raw features (every row live, as iteration 1 compacted). With
    ``hard_odd``, odd tasks take hard assignments, whose empty rows carry
    the ROW_FREEZE sentinel except one left at the empty-cluster fill -10;
    without it every task is dense."""
    x, _ = make_zero_shot_tasks(np.random.default_rng(seed), n_task, n_query, k)
    x = torch.as_tensor(x, device=device)
    lq = torch.log(x + EPS)
    _, cols = top_rows(x.sum(1), n_rows)
    u = torch.gather(x, 2, cols[:, None, :].expand(-1, n_query, -1))
    if not hard_odd:
        y, _ = weighted_log_means(u, lq, eps=EPS)
        return torch.ones_like(y), y.contiguous()
    hard = get_one_hot(torch.argmax(u, dim=-1), n_rows)
    odd = torch.arange(n_task, device=device)[:, None, None] % 2 == 1
    y, nonzero = weighted_log_means(torch.where(odd, hard, u), lq, eps=EPS)
    frozen = ~nonzero & odd
    frozen[1::2, n_rows - 1] = False   # one empty row (past k_eff <= 10) stays live
    y = torch.where(frozen, ROW_FREEZE, y).contiguous()
    return torch.ones_like(y), y


# K1 and K2 at the edges of the cluster design, (N, R, K, what): one row
# (a cluster of 8 CTAs, 7 with nothing), 8 and 9 rows (one and two rows a
# CTA), the 256-row cap of 'pallas' (two blocks of 128), K below, above and
# off a warp's 32 lanes, K = 1008; "mixed": synthetic_solve_inputs as they
# are; in task 0 of the others a block with one live row ("one_live"), none
# ("none_live"), or its first 12 rows live ("front_live": one CTA's share
# if rows were split by position)
SOLVE_EDGES = (
    (3, 1, 1000, "mixed"), (3, 8, 1000, "mixed"), (3, 9, 1000, "mixed"),
    (3, 13, 150, "mixed"), (2, 256, 1000, "mixed"), (3, 13, 31, "mixed"),
    (3, 13, 33, "mixed"), (2, 91, 1008, "mixed"), (2, 91, 1000, "one_live"),
    (2, 91, 1000, "none_live"), (2, 91, 1000, "front_live"),
)


def edge_solve_inputs(n_task, n_rows, k, what, seed, device="cuda"):
    """The inputs of a SOLVE_EDGES case: synthetic_solve_inputs with alpha0
    drawn in [0.5, 2) (so that a frozen row's copy shows) and task 0's live
    rows cut as ``what`` says."""
    a0, y = synthetic_solve_inputs(n_task, n_rows, k, seed, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    a0 = (a0 * (0.5 + 1.5 * torch.rand(a0.shape, generator=g,
                                       device=device))).contiguous()
    rows = torch.arange(n_rows, device=device)
    keep = {"one_live": rows == 5, "none_live": rows < 0,
            "front_live": rows < 12}.get(what)
    if keep is not None:
        y[0] = torch.where(keep[:, None], y[0], ROW_FREEZE)
    return a0, y.contiguous()


def newton_solve_inputs(n_task, n_rows, k, seed, device="cuda"):
    """(alpha0, y, row_mask) of a Newton-Minka solve as the compact EM step
    passes them: synthetic_solve_inputs' y with its ROW_FREEZE rows turned
    into row_mask False rows at the empty-cluster fill -10, and alpha0
    drawn in [0.5, 2) (so that a frozen row's copy shows)."""
    a0, y = synthetic_solve_inputs(n_task, n_rows, k, seed, device=device)
    mask = y[..., 0] < ROW_FREEZE / 2
    y = torch.where(mask[..., None], y, -10.0).contiguous()
    g = torch.Generator(device=device).manual_seed(seed)
    a0 = (0.5 + 1.5 * torch.rand(a0.shape, generator=g, device=device))
    return a0.contiguous(), y, mask.contiguous()


#: csrc/special_check.cu's checks, by its ``which`` index
FAST_PATH_CHECKS = ("rcp", "div_252", "div_42", "div_1260", "log",
                    "digamma_trigamma_series", "digamma_lgamma_series")
SOURCE = "special_check.cu"
#: the entry point's C arguments (``kernel_build.ARG_TYPES``)
SIGNATURES = {"tclip_special_check": "i p p"}


def check_fast_paths(device="cuda") -> dict:
    """check name -> the floats of its domain on which special.cuh's fast
    paths (NormalOps) differ from the compiler's operations, bit for bit
    (csrc/special_check.cu; every float of each domain, ~10^10 evaluations
    in all). All zeros is what the kernels' parity with their plain
    versions rests on."""
    entry = kernel_build.load(SOURCE, SIGNATURES).tclip_special_check
    out = {}
    for which, name in enumerate(FAST_PATH_CHECKS):
        bad = torch.zeros(1, dtype=torch.int64, device=device)
        kernel_build.launch(entry, bad.device, which, bad.data_ptr())
        out[name] = int(bad.item())
    return out
