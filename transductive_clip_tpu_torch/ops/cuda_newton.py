"""The Newton-Minka step of the Dirichlet solve on the card
(``csrc/newton_minka.cu``), behind ``dirichlet_solver: minka`` and every
Newton-Minka solve ``ops.dirichlet.minka_newton_update_alpha`` makes.

The JAX package runs that solve as one ``lax.while_loop`` whose body XLA
fuses; it has no Pallas kernel. Here the loop stays on the host (its stop
flag, step cap and criterion collectives are ``minka_newton_update_alpha``'s)
and its body is one launch of a kernel written in CUDA C++ for sm_90a:

* ``newton_minka_step`` — from the row sums s [N, R] and y [N, R, K] to
  the next s and each task's criterion sums [N, 2] (num, den);
* ``newton_minka_final`` — alpha = psi^{-1}(psi(s) + y) [N, R, K] at the
  converged s, frozen rows copied from alpha0.

Each takes its plain torch version (``*_reference``: the torch step the
solve ran before the kernel, with the same masks, freeze and partial sums)
for tensors on the CPU, and only then; for CUDA tensors it launches the
kernel or raises. ``<wrapper>.launches`` counts the launches. The plain
versions compute with the special functions as ``ops.dirichlet`` binds
them, so the solve on the CPU is one arithmetic with its twin.
"""

from __future__ import annotations

import torch

from . import dirichlet, kernel_build

SOURCE = "newton_minka.cu"
#: the entry points' C arguments (``kernel_build.ARG_TYPES``)
SIGNATURES = {"tclip_newton_minka_step": "pppppp iiiiii p",
              "tclip_newton_minka_final": "ppppp iiii p"}

# Launch geometry, mirrored by the constants of csrc/newton_minka.cu
# (tests/test_torch_newton_kernel.py holds the two against each other).
MAX_CTAS = 8       # CTAs of a task's cluster: the portable cluster size
MAX_WARPS = 32     # warps of a CTA
MIN_WARPS = 4
MAX_TASKS = 65535  # the grid's y extent


def launch_geometry(n_rows: int) -> dict:
    """How a step launches for ``n_rows`` rows a task: a warp a row, the
    task's rows dealt round robin over one cluster of ``ctas`` CTAs of
    ``warps`` warps. CTAs of MIN_WARPS warps up to 128 rows, then a warp
    for every 32 rows, so ~4 rows a warp at 1,000 rows: on the H100 the
    32- and 91-row steps ran 10-15% faster on 4-warp CTAs than on 8-warp
    ones, the 1,000-row step 3% faster on 32-warp ones."""
    warps = min(MAX_WARPS, max(MIN_WARPS, -(-n_rows // 32)))
    ctas = max(1, min(MAX_CTAS, -(-n_rows // warps)))
    return {"ctas": ctas, "warps": warps}


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _check(name, y, **tensors):
    """Raises unless every input is one the kernel takes: y [N, R, K]
    float32, the others of the shapes and dtypes below, all contiguous on
    y's CUDA device."""
    if y.device.type != "cuda":
        raise ValueError(f"{name}: y is on {y.device}; every input must be "
                         "on one CUDA device (or all on the CPU for the plain "
                         "version)")
    if y.dim() != 3:
        raise ValueError(f"{name}: y must be [N, R, K], got {tuple(y.shape)}")
    n, r, k = y.shape
    want = {"s": ((n, r), torch.float32), "out": ((n, r), torch.float32),
            "live": ((n, r), torch.bool), "done": ((), torch.bool),
            "alpha0": ((n, r, k), torch.float32)}
    for what, t in (("y", y), *tensors.items()):
        if t is None:
            continue
        shape, dtype = want.get(what, (tuple(y.shape), torch.float32))
        if t.device != y.device:
            raise ValueError(f"{name}: {what} is on {t.device}, y on "
                             f"{y.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if n > MAX_TASKS:
        raise ValueError(f"{name}: {n} tasks, at most {MAX_TASKS} a launch")


def _ptr(t):
    return None if t is None else t.data_ptr()


def newton_minka_step(s, y, live, done, newton_iters: int = 3, out=None):
    """One Newton-Minka step of every row: (s_next [N, R], sums [N, 2]),
    sums[:, 0] = num and sums[:, 1] = den, each task's criterion sums.
    ``live`` ([N, R] bool or None): False rows keep s and are left out of
    the sums; ``done`` (0-d bool): where set, s_next is s. On the card
    s_next is written into ``out`` when given (a buffer other than s)."""
    if _on_cpu(s, y, live, done):
        return newton_minka_step_reference(s, y, live, done, newton_iters)
    _check("newton_minka_step", y, s=s, live=live, done=done, out=out)
    if out is None:
        out = torch.empty_like(s)
    elif out.data_ptr() == s.data_ptr():
        raise ValueError("newton_minka_step: out must not be s")
    n, r, k = y.shape
    sums = torch.empty((n, 2), dtype=torch.float32, device=y.device)
    if n > 0:
        g = launch_geometry(r)
        kernel_build.launch(
            kernel_build.load(SOURCE, SIGNATURES).tclip_newton_minka_step,
            y.device, s.data_ptr(), y.data_ptr(), _ptr(live),
            done.data_ptr(), out.data_ptr(), sums.data_ptr(), n, r, k,
            g["ctas"], g["warps"], newton_iters)
        newton_minka_step.launches += 1
    return out, sums


newton_minka_step.launches = 0


def newton_minka_final(s, y, alpha0, live, newton_iters: int = 3):
    """alpha = psi^{-1}(psi(s) + y) [N, R, K]; rows ``live`` ([N, R] bool
    or None) marks False are alpha0's, bit for bit."""
    if _on_cpu(s, y, alpha0, live):
        return newton_minka_final_reference(s, y, alpha0, live, newton_iters)
    _check("newton_minka_final", y, s=s, alpha0=alpha0, live=live)
    out = torch.empty_like(y)
    n, r, k = y.shape
    if n > 0:
        kernel_build.launch(
            kernel_build.load(SOURCE, SIGNATURES).tclip_newton_minka_final,
            y.device, s.data_ptr(), y.data_ptr(), alpha0.data_ptr(),
            _ptr(live), out.data_ptr(), n, r, k, newton_iters)
        newton_minka_final.launches += 1
    return out


newton_minka_final.launches = 0


# ---- plain versions ----------------------------------------------------------

def newton_minka_step_reference(s, y, live, done, newton_iters: int = 3):
    """Plain torch version of ``newton_minka_step``: Newton on the row sum
    s of F(s) = sum_d psi^{-1}(psi(s) + y_d) - s, F'(s) = psi'(s) sum_d
    1/psi'(a_d) - 1, taking the fixed-point step A(s) wherever the Newton
    step is non-finite, non-positive, or F' degenerate."""
    z = dirichlet.digamma_pos(s)[..., None] + y
    alpha, dinv = dirichlet.inv_digamma_and_deriv(z, newton_iters=newton_iters)
    a_sum = alpha.sum(-1)                                     # A(s)
    fprime = dirichlet.trigamma_pos(s) * dinv.sum(-1) - 1.0
    s_newton = s - (a_sum - s) / fprime
    ok = (torch.isfinite(s_newton) & (s_newton > 0.0)
          & (torch.abs(fprime) > 1e-12))
    s_new = torch.where(ok, s_newton, a_sum)
    if live is not None:
        s_new = torch.where(live, s_new, s)
    num = dirichlet._per_task((s_new - s) ** 2)
    s_live = s if live is None else torch.where(live, s, 0.0)
    den = dirichlet._per_task(s_live * s_live)
    return torch.where(done, s, s_new), torch.stack((num, den), -1)


def newton_minka_final_reference(s, y, alpha0, live, newton_iters: int = 3):
    """Plain torch version of ``newton_minka_final``."""
    alpha = dirichlet.inv_digamma(dirichlet.digamma_pos(s)[..., None] + y,
                                  newton_iters=newton_iters)
    if live is not None:
        alpha = torch.where(live[..., None], alpha, alpha0)
    return alpha
