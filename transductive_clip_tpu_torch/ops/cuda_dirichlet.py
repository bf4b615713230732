"""Dirichlet concentration row solves on the card (counterpart of
transductive_clip_tpu/ops/pallas_dirichlet.py).

Two kernels written in CUDA C++ for sm_90a (``csrc/dirichlet_solve.cu``):

* ``dirichlet_row_solve`` (K1) — Minka's fixed point, the TPU kernel
  ``_solver_kernel`` behind ``dirichlet_solver: pallas``;
* ``mm_row_solve`` (K2) — the reference MM surrogate iteration, the TPU
  kernel ``_mm_kernel`` behind ``dirichlet_solver: mm_pallas``.

Each solves psi(a_d) - psi(sum a) = y_d for every cluster row of
alpha0, y: [N, R, K] fp32, with a block of ``min(128, round_up(R, 8))`` rows
of one task stopping together, and keeps the ``ROW_FREEZE`` sentinel
contract: a row whose first y lane is >= ROW_FREEZE / 2 comes back with its
incoming alpha, bit for bit, and is left out of the stop criterion. On the
card a stopping block is one thread-block cluster whose CTAs share its live
rows (``launch_geometry``, ``deal_rows``; the source's head comment).

Each wrapper takes its plain torch version — same blocks, masks, sentinel
and stop rule — for tensors on the CPU, and only then; for CUDA tensors it
launches the kernel or raises. ``<wrapper>.launches`` counts the launches.
The plain versions play the role Pallas interpret mode plays for the JAX
package: the CPU tests run them, and chip_smoke.py holds the kernels
against them on the card.
"""

from __future__ import annotations

import torch

from . import kernel_build
from .common import to_host
from .dirichlet import TRIGAMMA_1
from .special import digamma_pos, inv_digamma, lgamma_pos

# Row-freeze sentinel (see the module docstring). Genuine y entries are
# weighted means of log(simplex + eps), always <= ~1e-15, and the
# empty-cluster fill is -10, so a positive value cannot occur naturally.
ROW_FREEZE = 1.0
SOURCE = "dirichlet_solve.cu"
#: the entry points' C arguments (``kernel_build.ARG_TYPES``)
SIGNATURES = {"tclip_dirichlet_row_solve": "ppp iiiiiiiii f i p",
              "tclip_mm_row_solve": "ppp iiiiiiiii f i p"}


def _round_up(x, m):
    return (x + m - 1) // m * m


def block_rows_for(n_rows: int, block_rows: int = 128) -> int:
    """Rows per stopping block, as the TPU kernels tile them."""
    return min(block_rows, _round_up(n_rows, 8))


# Launch geometry, mirrored by the constants of csrc/dirichlet_solve.cu
# (tests/test_torch_dirichlet.py holds the two against each other).
CLUSTER_CTAS = 8          # CTAs of a stopping block: the portable cluster size
MAX_BLOCK_ROWS = 128      # block_rows_for's cap
MAX_ROWS_PER_CTA = -(-MAX_BLOCK_ROWS // CLUSTER_CTAS)
MIN_THREADS = 128         # the kernels' live-row scan takes 128 threads
MAX_THREADS = 1024
SMEM_MAX = 232448         # shared memory a CTA may take (227 KB)
# the kernels' static shared memory (their Meta block; ptxas reports 496 B),
# which SMEM_MAX covers together with the rows
SMEM_STATIC = 512
SMEM_SM = 233472          # an SM's shared memory (228 KB)
# what a CTA takes besides its rows: 1 KB the hardware reserves and the
# kernels' static Meta block
SMEM_CTA_RESERVE = 2048
# warps an SM should hold: 32 at the 64 registers a thread of a 1024-thread
# CTA may have
TARGET_WARPS_SM = 32


def launch_geometry(n_rows: int, k: int, block_rows: int = 128) -> dict:
    """How K1 and K2 launch for ``n_rows`` rows of width ``k``:
    ``block_rows_for(n_rows, block_rows)`` rows stop together as one cluster
    of ``ctas`` CTAs of ``threads`` threads; a CTA holds up to
    ``rows_per_cta`` live rows of alpha and y in ``smem_bytes`` of dynamic
    shared memory. The threads are chosen so that the CTAs that
    fit an SM by shared memory hold ~TARGET_WARPS_SM warps. ``supported`` is
    False when a CTA's rows and the static SMEM_STATIC do not fit its
    shared memory (K > 1812 at 128-row blocks) or the blocks are wider than
    MAX_BLOCK_ROWS."""
    block_rows = block_rows_for(n_rows, block_rows)
    ctas = CLUSTER_CTAS
    rows_per_cta = -(-block_rows // ctas)
    smem = 2 * 4 * rows_per_cta * k
    per_sm = max(1, SMEM_SM // (smem + SMEM_CTA_RESERVE))
    warps = -(-TARGET_WARPS_SM // per_sm)
    threads = min(MAX_THREADS, max(MIN_THREADS, 32 * warps))
    return {"block_rows": block_rows, "ctas": ctas, "threads": threads,
            "rows_per_cta": rows_per_cta, "smem_bytes": smem,
            "supported": (smem + SMEM_STATIC <= SMEM_MAX
                          and block_rows <= MAX_BLOCK_ROWS)}


def deal_rows(live, ctas: int = CLUSTER_CTAS):
    """The kernels' deal of one stopping block's rows over its CTAs, as
    lists of row indices per CTA rank: ``live`` ([rows] bools) in, (live
    rows, frozen rows) out. The l-th live row goes to CTA l % ctas, the
    f-th frozen row likewise (the CTA that copies it), with the kernels'
    arithmetic: 32-bit masks of live rows, ranks by population count."""
    live = [bool(v) for v in live]
    words = [0] * (MAX_BLOCK_ROWS // 32)
    for r, v in enumerate(live):
        words[r >> 5] |= int(v) << (r & 31)
    n_live = sum(bin(w).count("1") for w in words)
    owned_live = [[None] * MAX_ROWS_PER_CTA for _ in range(ctas)]
    owned_frozen = [[None] * MAX_ROWS_PER_CTA for _ in range(ctas)]
    for t in range(len(live)):
        below = bin(words[t >> 5] & ((1 << (t & 31)) - 1)).count("1")
        below += sum(bin(w).count("1") for w in words[:t >> 5])
        if (words[t >> 5] >> (t & 31)) & 1:
            owned_live[below % ctas][below // ctas] = t
        else:
            f = t - below
            owned_frozen[f % ctas][f // ctas] = t
    n_frozen = len(live) - n_live
    out = []
    for rank in range(ctas):
        n_l = (n_live - rank + ctas - 1) // ctas if n_live > rank else 0
        n_f = (n_frozen - rank + ctas - 1) // ctas if n_frozen > rank else 0
        out.append((owned_live[rank][:n_l], owned_frozen[rank][:n_f]))
    return out


def _on_cpu(alpha0, y_cst) -> bool:
    return alpha0.device.type == "cpu" and y_cst.device.type == "cpu"


def _check_inputs(name, alpha0, y_cst, block_rows=128):
    for t, what in ((alpha0, "alpha0"), (y_cst, "y_cst")):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {what} is on {t.device}; both inputs "
                             "must be on the same CUDA device (or both on "
                             "the CPU for the plain version)")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name}: {what} must be [N, R, K], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if alpha0.device != y_cst.device:
        raise ValueError(f"{name}: inputs on {alpha0.device} and {y_cst.device}")
    if alpha0.shape != y_cst.shape:
        raise ValueError(f"{name}: shapes {tuple(alpha0.shape)} and "
                         f"{tuple(y_cst.shape)} differ")
    n, r, k = alpha0.shape
    if not (0 < n <= 65535 and r > 0 and k > 0):
        raise ValueError(f"{name}: unsupported shape {tuple(alpha0.shape)} "
                         "(need 0 < N <= 65535, R > 0, K > 0)")
    if not launch_geometry(r, k, block_rows)["supported"]:
        raise ValueError(f"{name}: K = {k} or block_rows = {block_rows} is "
                         "too wide: a CTA's rows of alpha and y must fit its "
                         f"shared memory, a block at most {MAX_BLOCK_ROWS} "
                         "rows")


def _launch(entry, alpha0, y_cst, block_rows, *args):
    out = torch.empty_like(alpha0)
    n, r, k = alpha0.shape
    g = launch_geometry(r, k, block_rows)
    kernel_build.launch(
        getattr(kernel_build.load(SOURCE, SIGNATURES), entry), alpha0.device,
        alpha0.data_ptr(), y_cst.data_ptr(), out.data_ptr(), n, r, k,
        g["block_rows"], g["ctas"], g["threads"], g["rows_per_cta"],
        g["smem_bytes"], *args)
    return out


def dirichlet_row_solve(alpha0, y_cst, max_iters: int = 60, tol: float = 1e-11,
                        newton_iters: int = 3, block_rows: int = 128):
    """K1: Minka fixed-point solve of every cluster row (see the module
    docstring). alpha0, y_cst: [N, R, K] fp32; returns alpha, same shape."""
    if _on_cpu(alpha0, y_cst):
        return dirichlet_row_solve_reference(
            alpha0, y_cst, max_iters=max_iters, tol=tol,
            newton_iters=newton_iters, block_rows=block_rows)
    _check_inputs("dirichlet_row_solve", alpha0, y_cst, block_rows)
    out = _launch("tclip_dirichlet_row_solve", alpha0, y_cst, block_rows,
                  max_iters, tol, newton_iters)
    dirichlet_row_solve.launches += 1
    return out


dirichlet_row_solve.launches = 0


def mm_row_solve(alpha0, y_cst, iter_mm: int = 1000, tol: float = 1e-11,
                 check_every: int = 50, block_rows: int = 128):
    """K2: the reference MM iteration for every cluster row (see the module
    docstring). alpha0, y_cst: [N, R, K] fp32; returns alpha, same shape."""
    if _on_cpu(alpha0, y_cst):
        return mm_row_solve_reference(
            alpha0, y_cst, iter_mm=iter_mm, tol=tol, check_every=check_every,
            block_rows=block_rows)
    _check_inputs("mm_row_solve", alpha0, y_cst, block_rows)
    out = _launch("tclip_mm_row_solve", alpha0, y_cst, block_rows, iter_mm,
                  tol, check_every)
    mm_row_solve.launches += 1
    return out


mm_row_solve.launches = 0


# ---- plain versions ----------------------------------------------------------

def _blocked(alpha0, y_cst, block_rows):
    """Rows padded with frozen sentinel rows to whole blocks and viewed as
    [N, n_blocks, bk, K], plus the live-row mask [N, n_blocks, bk, 1]."""
    n, r, k = alpha0.shape
    bk = block_rows_for(r, block_rows)
    rp = _round_up(r, bk)
    pad = (0, 0, 0, rp - r)
    a = torch.nn.functional.pad(alpha0, pad, value=1.0)
    y = torch.nn.functional.pad(y_cst, pad, value=ROW_FREEZE)
    a = a.reshape(n, rp // bk, bk, k)
    y = y.reshape(n, rp // bk, bk, k)
    return a, y, y[..., :1] < ROW_FREEZE / 2


def _block_crit(new, a, live):
    num = ((new - a) ** 2).sum((-2, -1))
    den = (torch.where(live, a, 0.0) ** 2).sum((-2, -1))
    return num / torch.clamp_min(den, 1e-30)


def _unblocked(a, shape):
    n, r, k = shape
    return a.reshape(n, -1, k)[:, :r].contiguous()


def dirichlet_row_solve_reference(alpha0, y_cst, max_iters: int = 60,
                                  tol: float = 1e-11, newton_iters: int = 3,
                                  block_rows: int = 128,
                                  return_iters: bool = False):
    """Plain torch version of K1: the same blocks, sentinel and stop rule.
    With ``return_iters`` also returns each block's executed iteration
    count [N, n_blocks]."""
    a, y, live = _blocked(alpha0, y_cst, block_rows)
    active = torch.ones(a.shape[:2], dtype=torch.bool, device=a.device)
    iters = torch.zeros(a.shape[:2], dtype=torch.int64, device=a.device)
    for _ in range(max_iters):
        s = a.sum(-1, keepdim=True)
        new = inv_digamma(digamma_pos(s) + y, newton_iters=newton_iters)
        new = torch.where(live, new, a)
        crit = _block_crit(new, a, live)
        a = torch.where(active[..., None, None], new, a)
        iters += active
        active = active & (crit >= tol)
        if not to_host(active.any()):
            break
    out = _unblocked(a, alpha0.shape)
    return (out, iters) if return_iters else out


def mm_row_solve_reference(alpha0, y_cst, iter_mm: int = 1000,
                           tol: float = 1e-11, check_every: int = 50,
                           block_rows: int = 128, return_iters: bool = False):
    """Plain torch version of K2: the same blocks, sentinel and schedule.
    With ``return_iters`` also returns each block's executed update count
    [N, n_blocks]."""
    a, y, live = _blocked(alpha0, y_cst, block_rows)

    def step(a):
        digam = digamma_pos(a + 1.0)
        curv = torch.where(
            a > 1e-11,
            torch.abs(2.0 * (digam * a - lgamma_pos(a + 1.0)) / (a * a)),
            torch.full_like(a, TRIGAMMA_1),
        )
        b = digam - digamma_pos(a.sum(-1, keepdim=True)) - curv * a - y
        new = (-b + torch.sqrt(b * b + 4.0 * curv)) / (2.0 * curv)
        return torch.where(live, new, a)

    first = min(check_every, iter_mm)
    for _ in range(first):
        a = step(a)
    active = torch.ones(a.shape[:2], dtype=torch.bool, device=a.device)
    iters = torch.full(a.shape[:2], first, dtype=torch.int64, device=a.device)
    it = first
    while it < iter_mm:
        # checked step: one update, the criterion on its single-step delta
        new = step(a)
        converged = _block_crit(new, a, live) < tol
        a = torch.where(active[..., None, None], new, a)
        rem = min(check_every - 1, iter_mm - it - 1)
        iters += active * (1 + rem * ~converged)
        active = active & ~converged
        if not to_host(active.any()):
            break
        for _ in range(rem):
            a = torch.where(active[..., None, None], step(a), a)
        it += 1 + rem
    out = _unblocked(a, alpha0.shape)
    return (out, iters) if return_iters else out
