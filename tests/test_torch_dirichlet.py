"""The port's Dirichlet ops against the JAX package's, on the same numpy
inputs: every solver family through ``update_alpha`` (the two kernel
families through their plain versions on the CPU, against the Pallas
kernels in interpret mode), the row_mask freeze, the 256-row reroute, and
the log-density caches.

Solver tolerance: a relative difference < 1e-3. The fp32 reductions are
summed in another order, so a stop test near ``tol`` can fire one check
apart on the two sides."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu.ops import dirichlet as jd
from transductive_clip_tpu_torch.ops import cuda_dirichlet as cd
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
