"""The port's Dirichlet ops against the JAX package's, on the same numpy
inputs: every solver family through ``update_alpha`` (the two kernel
families through their plain versions on the CPU, against the Pallas
kernels in interpret mode), the row_mask freeze, the 256-row reroute, and
the log-density caches.

Solver tolerance: a relative difference < 1e-3. The fp32 reductions are
summed in another order, so a stop test near ``tol`` can fire one check
apart on the two sides."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu.ops import dirichlet as jd
from transductive_clip_tpu_torch.ops import cuda_dirichlet as cd
from transductive_clip_tpu_torch.ops import dirichlet_fixtures as fx
from transductive_clip_tpu_torch.ops import kernel_build
from transductive_clip_tpu_torch.ops import dirichlet as td

torch.set_num_threads(2)

SOLVERS = ("mm", "minka_fp", "minka", "pallas", "mm_pallas")


def _case_dense(rng):
    """The [2, 20, 40] case of tests/test_pallas_dirichlet.py."""
    n_task, rows, k = 2, 20, 40
    x = rng.dirichlet(np.ones(k) * 0.4, size=300)
    base = np.log(x + 1e-15).mean(0)
    y = np.tile(base, (n_task, rows, 1)).astype(np.float32)
    y += rng.normal(scale=0.05, size=y.shape).astype(np.float32)
    return np.ones((n_task, rows, k), np.float32), y


def _case_ragged(rng):
    """The [1, 13, 150] case with an empty-cluster row."""
    y = np.full((1, 13, 150), -6.0, np.float32)
    y += rng.normal(scale=0.1, size=y.shape).astype(np.float32)
    y[0, 5] = -10.0
    return np.ones((1, 13, 150), np.float32), y


CASES = {"dense": _case_dense, "ragged": _case_ragged}


def _rel(got, ref):
    return np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6))


def _solve_both(a0, y, solver, mask=None):
    ref = jd.update_alpha(jnp.asarray(a0), jnp.asarray(y), iter_mm=1000,
                          solver=solver,
                          row_mask=None if mask is None else jnp.asarray(mask))
    got = td.update_alpha(torch.as_tensor(a0), torch.as_tensor(y),
                          iter_mm=1000, solver=solver,
                          row_mask=None if mask is None else torch.as_tensor(mask))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("solver", SOLVERS)
def test_update_alpha_matches_jax(rng, solver, case):
    a0, y = CASES[case](rng)
    got, ref = _solve_both(a0, y, solver)
    assert got.shape == a0.shape and got.dtype == np.float32
    assert _rel(got, ref) < 1e-3


@pytest.mark.parametrize("solver", SOLVERS)
def test_update_alpha_row_mask_matches_jax(rng, solver):
    """Masked rows stay at alpha0 bit for bit; live rows match JAX."""
    a0, y = _case_dense(rng)
    a0 = (a0 * rng.uniform(0.5, 2.0, size=a0.shape)).astype(np.float32)
    mask = np.ones(a0.shape[:2], bool)
    mask[0, [1, 7, 19]] = False
    mask[1, 0] = False
    got, ref = _solve_both(a0, y, solver, mask)
    np.testing.assert_array_equal(got[~mask], a0[~mask])
    assert _rel(got[mask], ref[mask]) < 1e-3


def test_pallas_reroutes_wide_solves_to_minka(rng):
    """'pallas' wider than 256 rows runs the Newton-Minka solve, on both
    sides (ops/dirichlet.py resolve_solver_for_width)."""
    cap = td._PALLAS_SOLVER_MAX_ROWS
    assert cap == jd._PALLAS_SOLVER_MAX_ROWS
    for solver, rows in (("pallas", cap), ("pallas", cap + 1),
                         ("minka", cap + 1), ("mm_pallas", cap + 1)):
        assert (td.resolve_solver_for_width(solver, rows)
                == jd.resolve_solver_for_width(solver, rows))
    k = 16
    y = np.full((1, cap + 8, k), -3.0, np.float32)
    y += rng.normal(scale=0.1, size=y.shape).astype(np.float32)
    a0 = np.ones_like(y)
    launches = cd.dirichlet_row_solve.launches
    got_pallas = td.update_alpha(torch.as_tensor(a0), torch.as_tensor(y),
                                 solver="pallas")
    got_minka = td.update_alpha(torch.as_tensor(a0), torch.as_tensor(y),
                                solver="minka")
    np.testing.assert_array_equal(got_pallas.numpy(), got_minka.numpy())
    _, ref = _solve_both(a0, y, "pallas")
    assert _rel(got_pallas.numpy(), ref) < 1e-3
    assert cd.dirichlet_row_solve.launches == launches


def test_kernel_plain_versions_keep_frozen_rows_and_count_no_launch(rng):
    """On CPU tensors the wrappers run their plain versions (no launch is
    counted); ROW_FREEZE rows come back bit-equal, and the plain versions
    match the Pallas kernels (interpret mode) at the ragged shape."""
    from transductive_clip_tpu.ops.pallas_dirichlet import (
        pallas_dirichlet_solve,
        pallas_mm_solve,
    )

    a0, y = _case_ragged(rng)
    a0 = (a0 * rng.uniform(0.5, 2.0, size=a0.shape)).astype(np.float32)
    y[0, [2, 11]] = cd.ROW_FREEZE
    before = (cd.dirichlet_row_solve.launches, cd.mm_row_solve.launches)
    for wrapper, jax_fn in ((cd.dirichlet_row_solve, pallas_dirichlet_solve),
                            (cd.mm_row_solve, pallas_mm_solve)):
        got = wrapper(torch.as_tensor(a0), torch.as_tensor(y)).numpy()
        ref = np.asarray(jax_fn(jnp.asarray(a0), jnp.asarray(y),
                                interpret=True))
        np.testing.assert_array_equal(got[0, [2, 11]], a0[0, [2, 11]])
        assert _rel(got, ref) < 1e-3
    assert (cd.dirichlet_row_solve.launches, cd.mm_row_solve.launches) == before


def test_block_rows_and_iteration_counts(rng):
    """Blocks tile rows as the TPU kernels do; a block whose rows are all
    frozen stops after one iteration (K1) or after its first checkpoint
    (K2), and the MM schedule never exceeds iter_mm updates."""
    assert [cd.block_rows_for(r) for r in (13, 32, 91, 1000)] == [16, 32, 96, 128]
    a0, y = _case_ragged(rng)
    frozen = np.full_like(y, cd.ROW_FREEZE)
    _, it1 = cd.dirichlet_row_solve_reference(
        torch.as_tensor(a0), torch.as_tensor(frozen), return_iters=True)
    assert it1.tolist() == [[1]]
    _, it2 = cd.mm_row_solve_reference(
        torch.as_tensor(a0), torch.as_tensor(frozen), iter_mm=120,
        return_iters=True)
    assert it2.tolist() == [[51]]
    _, it3 = cd.mm_row_solve_reference(
        torch.as_tensor(a0), torch.as_tensor(y), iter_mm=120, tol=0.0,
        return_iters=True)
    assert it3.tolist() == [[120]]


def test_unknown_solver_raises():
    a = torch.ones(1, 2, 3)
    with pytest.raises(ValueError, match="unknown dirichlet_solver"):
        td.update_alpha(a, -a, solver="minkaa")


def test_kernel_wrappers_reject_bad_inputs():
    a = torch.ones(1, 2, 3)
    with pytest.raises(ValueError):
        cd._check_inputs("k", a, a)                 # CPU tensors are not CUDA
    meta = torch.ones(1, 2, 3, device="meta")
    with pytest.raises(ValueError):
        cd.dirichlet_row_solve(meta, a)             # mixed devices
    with pytest.raises(ValueError):
        cd.mm_row_solve(meta, meta)                 # not a CUDA device


def _small_simplex(rng, n_task, n, k):
    """Features away from 0 so the log-density terms stay O(10): fp32 sums
    of them agree to atol 1e-5 whatever the summation order."""
    x = rng.dirichlet(np.ones(k) * 8.0, size=(n_task, n)).astype(np.float32)
    return np.log(x + 1e-15).astype(np.float32)


def test_logits_cache_and_log_pdf_match_jax(rng):
    lq = _small_simplex(rng, 2, 6, 8)
    alpha = rng.uniform(0.5, 1.5, size=(2, 8, 8)).astype(np.float32)
    l12_j, l3_j = jd.dirichlet_logits_cache(jnp.asarray(lq), jnp.asarray(alpha))
    l12_t, l3_t = td.dirichlet_logits_cache(torch.as_tensor(lq),
                                            torch.as_tensor(alpha))
    np.testing.assert_allclose(l12_t.numpy(), np.asarray(l12_j), atol=1e-5)
    np.testing.assert_allclose(l3_t.numpy(), np.asarray(l3_j), atol=1e-5)
    pdf_j = jd.dirichlet_log_pdf(jnp.asarray(lq), jnp.asarray(alpha))
    pdf_t = td.dirichlet_log_pdf(torch.as_tensor(lq), torch.as_tensor(alpha))
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), atol=1e-5)

    # incremental row update: rows 5, 1, 6 changed, row 6 masked off
    idx = np.array([[5, 1, 6], [0, 7, 2]])
    alpha_c = rng.uniform(0.5, 1.5, size=(2, 3, 8)).astype(np.float32)
    mask = np.array([[True, True, False], [True, True, True]])
    out_j = jd.update_logits_cache_rows(
        l12_j, l3_j, jnp.asarray(idx), jnp.asarray(alpha_c), jnp.asarray(lq),
        row_mask=jnp.asarray(mask))
    out_t = td.update_logits_cache_rows(
        l12_t, l3_t, torch.as_tensor(idx), torch.as_tensor(alpha_c),
        torch.as_tensor(lq), row_mask=torch.as_tensor(mask))
    for t, j in zip(out_t, out_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    # the masked row keeps its cached entries exactly
    np.testing.assert_array_equal(out_t[0][0, 6].numpy(), l12_t[0, 6].numpy())
    np.testing.assert_array_equal(out_t[1][0, :, 6].numpy(),
                                  l3_t[0, :, 6].numpy())


def test_weighted_log_means_match_jax(rng):
    lq = _small_simplex(rng, 2, 6, 8)
    u = rng.dirichlet(np.ones(5), size=(2, 6)).astype(np.float32)
    u = np.concatenate([u, np.zeros((2, 6, 3), np.float32)], axis=-1)
    y_j, nz_j = jd.weighted_log_means(jnp.asarray(u), jnp.asarray(lq))
    y_t, nz_t = td.weighted_log_means(torch.as_tensor(u), torch.as_tensor(lq))
    np.testing.assert_array_equal(nz_t.numpy(), np.asarray(nz_j))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    assert (y_t.numpy()[:, 5:] == -10.0).all()


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(rng):
    """K1 and K2 on the card against their plain versions (run with
    ``python -m pytest tests/test_torch_dirichlet.py -m cuda`` on a machine
    with an NVIDIA GPU; chip_smoke.py runs the same check at the main
    path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    a0, y = _case_ragged(rng)
    y[0, 3] = cd.ROW_FREEZE
    a = torch.as_tensor(a0, device="cuda")
    yy = torch.as_tensor(y, device="cuda")
    for wrapper, plain in ((cd.dirichlet_row_solve, cd.dirichlet_row_solve_reference),
                           (cd.mm_row_solve, cd.mm_row_solve_reference)):
        before = wrapper.launches
        got = wrapper(a, yy)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        ref = plain(a, yy)
        assert _rel(got.cpu().numpy(), ref.cpu().numpy()) < 1e-3
        assert torch.equal(got[0, 3], a[0, 3])


def test_launch_geometry_equals_the_source():
    """launch_geometry's constants against csrc/dirichlet_solve.cu, and the
    geometry it gives: whole blocks covered by a cluster's CTAs, rows and
    shared memory within what the kernels check, ~32 warps an SM at the
    main path's widths."""
    text = (kernel_build.CSRC / cd.SOURCE).read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} =\s*([^;]+);", text).group(1)
        return eval(expr.replace("/", "//"), {},   # C's integer division
                    {n: const(n) for n in re.findall(r"k[A-Z]\w+", expr)})

    assert (const("kClusterCtas"), const("kMaxBlockRows"),
            const("kMaxRowsPerCta"), const("kMinThreads"),
            const("kMaxThreads"), const("kSmemMax"), const("kSmemStatic")) == (
        cd.CLUSTER_CTAS, cd.MAX_BLOCK_ROWS, cd.MAX_ROWS_PER_CTA,
        cd.MIN_THREADS, cd.MAX_THREADS, cd.SMEM_MAX, cd.SMEM_STATIC)
    assert "__launch_bounds__(kMaxThreads)" in text
    assert "2 * sizeof(float) * (size_t)rows_per_cta * k" in text
    assert "smem_bytes + kSmemStatic <= kSmemMax" in text
    for r in (1, 8, 9, 13, 32, 91, 96, 128, 256, 1000):
        for k in (31, 33, 150, 1000, 1008):
            g = cd.launch_geometry(r, k)
            assert g["supported"]
            assert g["block_rows"] == cd.block_rows_for(r)
            assert g["ctas"] * g["rows_per_cta"] >= g["block_rows"]
            assert g["rows_per_cta"] <= cd.MAX_ROWS_PER_CTA
            assert g["smem_bytes"] == 8 * g["rows_per_cta"] * k
            assert g["smem_bytes"] + cd.SMEM_STATIC <= cd.SMEM_MAX
            assert g["threads"] % 32 == 0
            assert cd.MIN_THREADS <= g["threads"] <= cd.MAX_THREADS
    warps = {}
    for r in (32, 91, 1000):
        g = cd.launch_geometry(r, 1000)
        per_sm = cd.SMEM_SM // (g["smem_bytes"] + cd.SMEM_CTA_RESERVE)
        warps[r] = per_sm * g["threads"] // 32
    assert warps == {32: 36, 91: 32, 1000: 32}
    # the rows and the static Meta block within the CTA's 227 KB
    assert cd.launch_geometry(128, 1812)["supported"]
    assert not cd.launch_geometry(128, 1813)["supported"]
    assert cd.launch_geometry(8, 28992)["supported"]
    assert not cd.launch_geometry(8, 28993)["supported"]
    assert not cd.launch_geometry(300, 100, block_rows=256)["supported"]


@pytest.mark.parametrize("n_rows", [1, 13, 91, 96, 128])
def test_live_row_deal_is_even_and_exact(n_rows):
    """The kernels' deal (mirrored by deal_rows): every live row is owned by
    exactly one CTA, every frozen row copied by exactly one, and the CTAs'
    shares of live rows differ by at most one row, with frozen rows mixed
    in at random, in runs, or not at all."""
    rng = np.random.default_rng(n_rows)
    masks = [np.ones(n_rows, bool), np.zeros(n_rows, bool),
             rng.random(n_rows) < 0.3, rng.random(n_rows) < 0.8,
             np.arange(n_rows) < min(12, n_rows),     # one by-position share
             np.arange(n_rows) == n_rows - 1]
    for live in masks:
        shares = cd.deal_rows(live)
        assert len(shares) == cd.CLUSTER_CTAS
        owned_live = sorted(r for lv, _ in shares for r in lv)
        owned_frozen = sorted(r for _, fr in shares for r in fr)
        assert owned_live == np.flatnonzero(live).tolist()
        assert owned_frozen == np.flatnonzero(~live).tolist()
        sizes = [len(lv) for lv, _ in shares]
        assert max(sizes) - min(sizes) <= 1
        assert max(sizes) <= cd.MAX_ROWS_PER_CTA
        for lv, fr in shares:
            assert lv == sorted(lv) and fr == sorted(fr)


@pytest.mark.cuda
@pytest.mark.parametrize("case", fx.SOLVE_EDGES,
                         ids=lambda c: "-".join(map(str, c)))
def test_kernels_edge_cases_on_card(case):
    """K1 and K2 against their plain versions at the edges of the cluster
    design: max relative difference < 1e-3, frozen rows bit-equal, one
    launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    n_task, n_rows, k, what = case
    a0, y = fx.edge_solve_inputs(n_task, n_rows, k, what, seed=n_rows + k)
    live = y[..., 0] < cd.ROW_FREEZE / 2
    for wrapper, plain in ((cd.dirichlet_row_solve, cd.dirichlet_row_solve_reference),
                           (cd.mm_row_solve, cd.mm_row_solve_reference)):
        before = wrapper.launches
        got = wrapper(a0, y)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        ref = plain(a0, y)
        assert torch.isfinite(got).all()
        assert torch.equal(got[~live], a0[~live])
        assert _rel(got.cpu().numpy(), ref.cpu().numpy()) < 1e-3


@pytest.mark.cuda
def test_widest_supported_rows_launch_on_card():
    """At 128-row blocks K = 1812 is the widest row whose CTA share (16
    rows of alpha and y) fits beside the static Meta block in a CTA's
    227 KB: both kernels launch there and hold against their plain
    versions; K = 1813 is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    a0, y = fx.synthetic_solve_inputs(1, 128, 1812, seed=1812)
    for wrapper, plain in ((cd.dirichlet_row_solve, cd.dirichlet_row_solve_reference),
                           (cd.mm_row_solve, cd.mm_row_solve_reference)):
        got = wrapper(a0, y)
        assert _rel(got.cpu().numpy(), plain(a0, y).cpu().numpy()) < 1e-3
        wide = torch.ones(1, 128, 1813, device="cuda")
        before = wrapper.launches
        with pytest.raises(ValueError, match="too wide"):
            wrapper(wide, -wide)
        assert wrapper.launches == before


def _newton_per_step(alpha0, y_cst, max_iters=30, tol=1e-11, newton_iters=3,
                     row_mask=None):
    """The Newton-Minka solve as it read its criterion on the host after
    every step (before the device-side stop flag), the reference for
    bit-equality; returns (alpha, steps)."""
    from transductive_clip_tpu_torch.ops.special import (
        digamma_pos,
        inv_digamma,
        inv_digamma_and_deriv,
        trigamma_pos,
    )

    s = alpha0.sum(-1)

    def newton_step(s):
        z = digamma_pos(s)[..., None] + y_cst
        alpha, dinv = inv_digamma_and_deriv(z, newton_iters=newton_iters)
        a_sum = alpha.sum(-1)
        fprime = trigamma_pos(s) * dinv.sum(-1) - 1.0
        s_newton = s - (a_sum - s) / fprime
        ok = (torch.isfinite(s_newton) & (s_newton > 0.0)
              & (torch.abs(fprime) > 1e-12))
        return torch.where(ok, s_newton, a_sum)

    steps = 0
    for _ in range(max_iters):
        s_new = newton_step(s)
        steps += 1
        if row_mask is not None:
            s_new = torch.where(row_mask, s_new, s)
        num = ((s_new - s) ** 2).sum()
        s_live = s if row_mask is None else torch.where(row_mask, s, 0.0)
        crit = num / torch.clamp_min((s_live * s_live).sum(), 1e-30)
        s = s_new
        if bool(crit < tol):
            break
    alpha = inv_digamma(digamma_pos(s)[..., None] + y_cst,
                        newton_iters=newton_iters)
    if row_mask is not None:
        alpha = torch.where(row_mask[..., None], alpha, alpha0)
    return alpha, steps


def _newton_cases(rng):
    a0, y = _case_dense(rng)
    a0r, yr = _case_ragged(rng)
    mask = np.ones(a0.shape[:2], bool)
    mask[0, [1, 7, 19]] = False
    mask[1, 0] = False
    scaled = (a0 * rng.uniform(0.5, 2.0, size=a0.shape)).astype(np.float32)
    return [(a0, y, None, 1e-11), (scaled, y, mask, 1e-11),
            (a0r, yr, None, 1e-11), (a0, y, None, 1e-14),
            (scaled, y, mask, 0.0)]


@pytest.mark.parametrize("check_every", [None, 2])
@pytest.mark.parametrize("case", range(5))
def test_newton_minka_device_stop_is_bit_equal_to_per_step(rng, case,
                                                            check_every,
                                                            monkeypatch):
    """minka_newton_update_alpha with its device-side stop flag, read every
    k steps (NEWTON_CHECK_EVERY as it stands, or set to 2), gives the bits
    of the loop that read its criterion after every step, with and without
    row_mask, matches the JAX function within 1e-3, runs at most k - 1
    steps past the stop, and reads the host at most ceil(steps / k) + 1
    times for the steps it executed."""
    if check_every is not None:
        monkeypatch.setattr(td, "NEWTON_CHECK_EVERY", check_every)
    k = td.NEWTON_CHECK_EVERY
    assert 1 < k <= 4
    a0, y, mask, tol = _newton_cases(rng)[case]
    ta, ty = torch.as_tensor(a0), torch.as_tensor(y)
    tm = None if mask is None else torch.as_tensor(mask)
    ref, ref_steps = _newton_per_step(ta, ty, tol=tol, row_mask=tm)
    executed = [0]
    step_fn = td.inv_digamma_and_deriv

    def counted(*args, **kw):
        executed[0] += 1
        return step_fn(*args, **kw)

    monkeypatch.setattr(td, "inv_digamma_and_deriv", counted)
    syncs = td.to_host.syncs
    got = td.minka_newton_update_alpha(ta, ty, tol=tol, row_mask=tm)
    syncs = td.to_host.syncs - syncs
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    steps = executed[0]
    assert ref_steps <= steps <= min(30, ref_steps + k - 1)
    assert syncs <= -(-steps // k) + 1
    assert syncs < ref_steps or ref_steps < k
    jref = jd.minka_newton_update_alpha(
        jnp.asarray(a0), jnp.asarray(y), tol=tol,
        row_mask=None if mask is None else jnp.asarray(mask))
    assert _rel(got.numpy(), np.asarray(jref)) < 1e-3


@pytest.mark.cuda
def test_special_fast_paths_give_the_compilers_bits_on_card():
    """Every float of each fast path's domain: NormalOps' reciprocal,
    constant divisions and log give the bits of 1.0f / x, a / c and logf,
    and both series give the same bits on NormalOps and IeeeOps over
    [2^-126, 2^40] (csrc/special_check.cu)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    assert fx.check_fast_paths() == {name: 0 for name in fx.FAST_PATH_CHECKS}


def test_special_constants_are_the_correctly_rounded_reciprocals():
    """special.cuh's RN(1/c) constants and the fast-path range: each
    constant is the float nearest 1/c (exact rational arithmetic), and the
    range keeps every argument of a series' reciprocals, logs and constant
    divisions inside the fast paths' domains."""
    from fractions import Fraction

    text = (kernel_build.CSRC / "special.cuh").read_text()
    for c in (252, 42, 1260):
        lit = re.search(rf"constexpr float kRcp{c} = ([^;]+)f;", text).group(1)
        got = np.float32(float.fromhex(lit))
        below = np.nextafter(got, np.float32(0))
        above = np.nextafter(got, np.float32(1))
        err = abs(Fraction(float(got)) - Fraction(1, c))
        assert err < abs(Fraction(float(below)) - Fraction(1, c))
        assert err < abs(Fraction(float(above)) - Fraction(1, c))
    lo = float.fromhex(re.search(r"kNormalLo = ([^;]+)f;", text).group(1))
    hi = float.fromhex(re.search(r"kNormalHi = ([^;]+)f;", text).group(1))
    assert lo == 2.0 ** -126 and hi == 2.0 ** 40
    # reciprocals and logs of x .. x + 4: normal and below 2^126; inv^2 of
    # x + 4 inside the divisions' [2^-100, 2^100]
    assert hi + 4 < 2.0 ** 126
    inv2_lo = np.float32(np.float32(1) / np.float32(hi + 4)) ** 2
    assert inv2_lo >= 2.0 ** -100 and (1 / 4) ** 2 <= 2.0 ** 100
    check = (kernel_build.CSRC / "special_check.cu").read_text()
    assert "0x00800000u;   // 2^-126 = kNormalLo" in check
    assert "0x53800000u;   // 2^40 = kNormalHi" in check
    assert np.float32(2.0 ** 40).view(np.uint32) == 0x53800000
