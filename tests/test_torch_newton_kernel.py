"""The Newton-Minka step (``ops/cuda_newton.py``, ``csrc/newton_minka.cu``):
its plain torch version against the torch step ``minka_newton_update_alpha``
composed before the kernel, bit for bit; the solve on the CPU against the
loop of before, bit for bit; the ``newton.kernel_steps`` counter; the launch
geometry against the source. The kernel's own cases carry the ``cuda``
marker and run on a machine with an NVIDIA GPU
(``python -m pytest tests/test_torch_newton_kernel.py -m cuda``): the
kernel against its plain version at the zero-shot solve widths, the same
bits from two launches, and the refusals."""

import re

import numpy as np
import pytest
import torch

from transductive_clip_tpu_torch.core.profiling import PhaseTimer
from transductive_clip_tpu_torch.ops import cuda_newton as cn
from transductive_clip_tpu_torch.ops import dirichlet as td
from transductive_clip_tpu_torch.ops import dirichlet_fixtures as fx
from transductive_clip_tpu_torch.ops import kernel_build
from transductive_clip_tpu_torch.ops.common import to_host
from transductive_clip_tpu_torch.ops.special import (
    digamma_pos,
    inv_digamma,
    inv_digamma_and_deriv,
    trigamma_pos,
)

torch.set_num_threads(2)


def _old_step(s, y, live, done, newton_iters=3):
    """The step as ``minka_newton_update_alpha`` composed it in torch ops
    before the kernel: newton_step, the live freeze, the per-task sums and
    the done freeze."""
    z = digamma_pos(s)[..., None] + y
    alpha, dinv = inv_digamma_and_deriv(z, newton_iters=newton_iters)
    a_sum = alpha.sum(-1)
    fprime = trigamma_pos(s) * dinv.sum(-1) - 1.0
    s_newton = s - (a_sum - s) / fprime
    ok = (torch.isfinite(s_newton) & (s_newton > 0.0)
          & (torch.abs(fprime) > 1e-12))
    s_new = torch.where(ok, s_newton, a_sum)
    if live is not None:
        s_new = torch.where(live, s_new, s)
    num = td._per_task((s_new - s) ** 2)
    s_live = s if live is None else torch.where(live, s, 0.0)
    den = td._per_task(s_live * s_live)
    return torch.where(done, s, s_new), num, den


def _old_solve(alpha0, y_cst, max_iters=30, tol=1e-11, newton_iters=3,
               row_mask=None, check_every=4):
    """``minka_newton_update_alpha`` as it was before the kernel (no task
    group, no class shard): (alpha, steps)."""
    s = alpha0.sum(-1)
    done = torch.zeros((), dtype=torch.bool)
    it = 0
    for it in range(1, max_iters + 1):
        s, num, den = _old_step(s, y_cst, row_mask, done, newton_iters)
        crit = td._crit(num, den)
        done = done | (crit < tol)
        if it % check_every == 0 and it < max_iters and to_host(done):
            break
    alpha = inv_digamma(digamma_pos(s)[..., None] + y_cst,
                        newton_iters=newton_iters)
    if row_mask is not None:
        alpha = torch.where(row_mask[..., None], alpha, alpha0)
    return alpha, it


def _inputs(n_task, n_rows, k, seed, device="cpu"):
    """(alpha0, y, row_mask): as the EM step builds them where the rows are
    clusters (n_rows <= k, ``dirichlet_fixtures.newton_solve_inputs``),
    else log-means of random simplex points, a third of the rows frozen at
    the empty-cluster fill; task 0's last row frozen either way."""
    if n_rows <= k:
        a0, y, mask = fx.newton_solve_inputs(n_task, n_rows, k, seed,
                                             device=device)
    else:
        g = np.random.default_rng(seed)
        x = g.dirichlet(np.full(k, 0.5), size=(n_task, n_rows, 8))
        y = torch.as_tensor(np.log(x + 1e-15).mean(2), dtype=torch.float32)
        mask = torch.as_tensor(g.random((n_task, n_rows)) > 1 / 3)
        y = torch.where(mask[..., None], y, -10.0)
        a0 = torch.as_tensor(0.5 + 1.5 * g.random((n_task, n_rows, k)),
                             dtype=torch.float32)
        a0, y, mask = (t.to(device) for t in (a0, y, mask))
    mask = mask.clone()
    mask[0, -1] = False
    return a0.contiguous(), y.contiguous(), mask


def _row_sums(a0, seed):
    """Row sums spread over the solve's range: ~0.06 to ~200."""
    g = torch.Generator(device=a0.device).manual_seed(seed)
    scale = torch.exp(8.0 * torch.rand(a0.shape[:2], generator=g,
                                       device=a0.device) - 3.0)
    return (a0.sum(-1) * scale / a0.shape[-1]).contiguous()


@pytest.mark.parametrize("variant", ["plain", "mask", "done"])
@pytest.mark.parametrize("k", [10, 1000])
@pytest.mark.parametrize("n_rows", [1, 32, 91])
def test_plain_step_is_the_old_torch_step(n_rows, k, variant):
    """newton_minka_step on the CPU (its plain version) gives the bits of
    the torch step it replaced: s_next, num and den (and so the
    criterion), without a row mask, with one, and with the done flag
    set."""
    a0, y, mask = _inputs(3, n_rows, k, seed=n_rows + k)
    s = _row_sums(a0, seed=k)
    live = mask if variant == "mask" else None
    done = torch.tensor(variant == "done")
    got, sums = cn.newton_minka_step(s, y, live, done)
    want, num, den = _old_step(s, y, live, done)
    assert torch.equal(got, want)
    assert torch.equal(sums[:, 0], num) and torch.equal(sums[:, 1], den)
    assert torch.equal(td._crit_sums(sums), td._crit(num, den))
    if variant == "done":
        assert torch.equal(got, s)
    if variant == "mask":
        assert not mask.all()
        assert torch.equal(got[~mask], s[~mask])


@pytest.mark.parametrize("case", range(4))
def test_solve_on_the_cpu_is_the_old_loop(case):
    """minka_newton_update_alpha on the CPU returns the bits, and runs the
    steps, of the loop before the kernel, with and without a row mask."""
    n_task, n_rows, k, masked, tol = ((2, 20, 40, False, 1e-11),
                                      (3, 13, 150, True, 1e-11),
                                      (2, 32, 1000, True, 1e-11),
                                      (4, 9, 10, True, 0.0))[case]
    a0, y, mask = _inputs(n_task, n_rows, k, seed=case)
    live = mask if masked else None
    with PhaseTimer().active() as timer:
        got = td.minka_newton_update_alpha(a0, y, tol=tol, row_mask=live)
    want, steps = _old_solve(a0, y, tol=tol, row_mask=live)
    assert torch.equal(got, want)
    assert timer.totals["newton.steps"] == steps
    if masked:
        assert torch.equal(got[~mask], a0[~mask])


def test_kernel_steps_count_nothing_on_the_cpu():
    """``newton.kernel_steps`` counts the steps that ran in the kernel:
    none on the CPU, where every step is the plain version's; the other
    counters count as before."""
    a0, y, mask = _inputs(2, 13, 40, seed=5)
    launches = cn.newton_minka_step.launches
    with PhaseTimer().active() as timer:
        td.minka_newton_update_alpha(a0, y, row_mask=mask)
        td.minka_newton_update_alpha(a0, y)
    tot = timer.totals
    assert tot["newton.kernel_steps"] == 0
    assert timer.counts["newton.kernel_steps"] == 2
    assert tot["newton.steps"] > 0
    assert tot["newton.row_steps"] == 13 * tot["newton.steps"]
    assert "newton.kernel_steps" in timer.counters
    assert cn.newton_minka_step.launches == launches


@pytest.mark.parametrize("masked", [False, True])
def test_plain_final_pass_is_the_old_one(masked):
    """newton_minka_final on the CPU: psi^{-1}(psi(s) + y) as the solve
    computed it, frozen rows alpha0's bit for bit."""
    a0, y, mask = _inputs(3, 32, 100, seed=7)
    s = _row_sums(a0, seed=7)
    live = mask if masked else None
    got = cn.newton_minka_final(s, y, a0, live)
    want = inv_digamma(digamma_pos(s)[..., None] + y)
    if masked:
        want = torch.where(mask[..., None], want, a0)
        assert torch.equal(got[~mask], a0[~mask])
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_rows", [1, 7, 8, 9, 20, 32, 64, 65, 91, 1000])
def test_launch_geometry_equals_the_source(n_rows):
    """launch_geometry's caps are the source's constants; no CTA of a
    cluster is left without a row, and a warp takes at most ~4 rows."""
    text = (kernel_build.CSRC / cn.SOURCE).read_text()
    const = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert const["kMaxCtas"] == cn.MAX_CTAS
    assert const["kMaxWarps"] == cn.MAX_WARPS
    assert f"n_task > {cn.MAX_TASKS}" in text
    assert cn.SOURCE in kernel_build.SOURCES
    g = cn.launch_geometry(n_rows)
    assert 1 <= g["ctas"] <= cn.MAX_CTAS
    assert cn.MIN_WARPS <= g["warps"] <= cn.MAX_WARPS
    assert (g["ctas"] - 1) * g["warps"] < n_rows
    # a row a warp up to 32 rows, at most 4 a warp below the caps
    warps = g["ctas"] * g["warps"]
    assert warps >= min(n_rows, cn.MAX_CTAS * cn.MIN_WARPS)
    assert n_rows <= 4 * warps or warps == cn.MAX_CTAS * cn.MAX_WARPS


def test_inputs_off_the_cpu_and_the_card_are_refused():
    """Inputs that are not all on the CPU take the kernel's checks, which
    refuse anything not on a CUDA device."""
    a0, y, mask = _inputs(2, 5, 10, seed=3)
    s = a0.sum(-1)
    done = torch.tensor(False)
    meta = y.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        cn.newton_minka_step(s, meta, None, done)
    with pytest.raises(ValueError, match="CUDA"):
        cn.newton_minka_final(s.to("meta"), meta, a0, mask)


# ---- on the card ---------------------------------------------------------------

# the zero-shot cell's solve widths (32-row fast tier, 91-row compact,
# the 1,000-row first iteration) and a few-shot-like narrow one
CARD_SHAPES = ((100, 32, 1000), (100, 91, 1000), (4, 1000, 1000),
               (8, 20, 10))
# one step of the kernel against its plain version on the same s: the sums'
# orders differ (a warp's lanes and butterfly against torch's reduction),
# and the plain version's CUDA division by a constant is a product by its
# reciprocal
STEP_RTOL = 1e-5
# a whole solve: alpha after up to 30 steps, as K1 against its plain
# version (chip_smoke.MAX_REL_DIFF)
SOLVE_RTOL = 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")


def _rel(got, want):
    return ((got - want).abs() / want.abs().clamp_min(1e-6)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_step_matches_plain_version_on_card(shape):
    """One step at each width, from a solve's first row sums and from the
    row sums one step on, with and without the row mask and with done set:
    s_next within fp32 rounding of the plain version's, frozen rows and the
    done freeze bit-equal, num and den close."""
    _card()
    a0, y, mask = _inputs(*shape, seed=sum(shape), device="cuda")
    s0 = a0.sum(-1)
    off = torch.tensor(False, device="cuda")
    s1 = cn.newton_minka_step_reference(s0, y, mask, off)[0].contiguous()
    for s in (s0, s1):
        for live in (None, mask):
            for flag in (False, True):
                done = torch.tensor(flag, device="cuda")
                got = cn.newton_minka_step(s, y, live, done)
                want = cn.newton_minka_step_reference(s, y, live, done)
                torch.cuda.synchronize()
                assert torch.isfinite(got[0]).all()
                assert _rel(got[0], want[0]) < STEP_RTOL
                assert _rel(got[1][:, 0], want[1][:, 0]) < 1e-3
                assert _rel(got[1][:, 1], want[1][:, 1]) < STEP_RTOL
                if flag:
                    assert torch.equal(got[0], s)
                if live is not None:
                    assert torch.equal(got[0][~live], s[~live])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_solve_matches_plain_version_on_card(shape, monkeypatch):
    """Whole solves through minka_newton_update_alpha on the card, the
    kernel's against the plain version's (both on the card): the same
    number of steps, alpha within SOLVE_RTOL, frozen rows alpha0's bit for
    bit, and ``newton.kernel_steps`` equal to ``newton.steps``."""
    _card()
    a0, y, mask = _inputs(*shape, seed=sum(shape), device="cuda")
    with PhaseTimer().active() as timer:
        got = td.minka_newton_update_alpha(a0, y, row_mask=mask)
    torch.cuda.synchronize()
    assert timer.totals["newton.kernel_steps"] == timer.totals["newton.steps"]
    monkeypatch.setattr(cn, "newton_minka_step",
                        lambda s, y, live, done, newton_iters=3, out=None:
                        cn.newton_minka_step_reference(s, y, live, done,
                                                       newton_iters))
    monkeypatch.setattr(cn, "newton_minka_final", cn.newton_minka_final_reference)
    with PhaseTimer().active() as plain:
        want = td.minka_newton_update_alpha(a0, y, row_mask=mask)
    assert plain.totals["newton.steps"] == timer.totals["newton.steps"]
    assert torch.isfinite(got).all()
    assert _rel(got, want) < SOLVE_RTOL
    assert torch.equal(got[~mask], a0[~mask])


@pytest.mark.cuda
def test_two_launches_give_the_same_bits_on_card():
    """No atomics: the step's s_next, num and den, and the final pass, are
    the same bits launch after launch, at the 1,000-row width (a cluster
    of 8 CTAs a task) and at 32 rows."""
    _card()
    for shape in ((4, 1000, 1000), (100, 32, 1000)):
        a0, y, mask = _inputs(*shape, seed=11, device="cuda")
        s = _row_sums(a0, seed=11)
        done = torch.tensor(False, device="cuda")
        first = cn.newton_minka_step(s, y, mask, done)
        second = cn.newton_minka_step(s, y, mask, done)
        for a, b in zip(first, second):
            assert torch.equal(a, b)
        assert torch.equal(cn.newton_minka_final(s, y, a0, mask),
                           cn.newton_minka_final(s, y, a0, mask))


@pytest.mark.cuda
def test_refused_launches_raise_on_card():
    """What the kernel does not take raises on the card; nothing falls
    back to torch ops."""
    _card()
    a0, y, mask = _inputs(2, 9, 40, seed=13, device="cuda")
    s = a0.sum(-1)
    done = torch.tensor(False, device="cuda")
    launches = cn.newton_minka_step.launches
    with pytest.raises(TypeError):
        cn.newton_minka_step(s, y.double(), None, done)
    with pytest.raises(TypeError):
        cn.newton_minka_step(s, y, mask.float(), done)
    with pytest.raises(ValueError, match="contiguous"):
        cn.newton_minka_step(s, y.transpose(1, 2).contiguous()
                             .transpose(1, 2), None, done)
    with pytest.raises(ValueError):
        cn.newton_minka_step(s[:, :5], y, None, done)
    with pytest.raises(ValueError):
        cn.newton_minka_step(s.cpu(), y, None, done)
    with pytest.raises(ValueError, match="out must not be s"):
        cn.newton_minka_step(s, y, None, done, out=s)
    with pytest.raises(ValueError):
        td.minka_newton_update_alpha(a0[None], y[None])
    with pytest.raises(ValueError, match="at most"):
        cn.newton_minka_step(torch.ones(cn.MAX_TASKS + 1, 1, device="cuda"),
                             torch.ones(cn.MAX_TASKS + 1, 1, 1,
                                        device="cuda"), None, done)
    with pytest.raises(TypeError):
        cn.newton_minka_final(s, y, a0.double(), mask)
    assert cn.newton_minka_step.launches == launches
