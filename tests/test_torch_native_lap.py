"""The port's native LAP solver (``native/lapjv.cpp``, built by g++ into the
port's ``_build/``) against the JAX package's ``native.lap_solve`` on the
same costs: the same columns on random and on tied costs (where another
optimal solver may pick other columns), scipy's optimal cost, and the
scipy fallback's contract."""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from transductive_clip_tpu.native import lap_solve as jax_lap_solve
from transductive_clip_tpu_torch import native
from transductive_clip_tpu_torch.ops import kernel_build, matching

torch.set_num_threads(2)


def test_native_solver_is_built_into_the_build_directory():
    assert native.solver_in_use() == "native"
    lib = native._load_lib()
    assert kernel_build.BUILD_DIR.as_posix() in lib._name.replace("\\", "/")


@pytest.mark.parametrize("shape", [(1, 1), (5, 5), (8, 20), (30, 60),
                                   (75, 1000)])
def test_lap_solve_matches_jax_on_random_costs(rng, shape):
    for _ in range(3):
        cost = rng.uniform(-1, 0, size=shape)
        rows, cols = native.lap_solve(cost)
        rows_j, cols_j = jax_lap_solve(cost)
        np.testing.assert_array_equal(rows, rows_j)
        np.testing.assert_array_equal(cols, cols_j)
        r, c = linear_sum_assignment(cost)
        assert cost[rows, cols].sum() == pytest.approx(cost[r, c].sum(),
                                                       abs=1e-12)


@pytest.mark.parametrize("shape", [(5, 5), (8, 20), (30, 60), (75, 200)])
def test_lap_solve_matches_jax_on_tied_costs(shape):
    """Costs on a 0.25 grid and constant padding rows tie many optimal
    assignments: the port picks the JAX solver's columns among them."""
    rng = np.random.default_rng(sum(shape))
    for _ in range(5):
        cost = -np.round(rng.uniform(0, 1, size=shape) * 4) / 4
        cost[shape[0] // 2:] = 0.0
        rows, cols = native.lap_solve(cost)
        np.testing.assert_array_equal(cols, jax_lap_solve(cost)[1])
        r, c = linear_sum_assignment(cost)
        assert cost[rows, cols].sum() == pytest.approx(cost[r, c].sum())
        assert len(set(cols.tolist())) == shape[0]


def test_more_rows_than_columns_goes_to_scipy(rng):
    cost = rng.uniform(size=(6, 4))
    rows, cols = native.lap_solve(cost)
    r, c = linear_sum_assignment(cost)
    np.testing.assert_array_equal(rows, r)
    np.testing.assert_array_equal(cols, c)


def test_scipy_fallback_when_the_library_does_not_load(rng, monkeypatch):
    """Without the library the scipy solver answers, with the same optimal
    cost, and ``solver_in_use`` says so."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", True)
    assert native.solver_in_use() == "scipy"
    cost = rng.uniform(size=(7, 12))
    rows, cols = native.lap_solve(cost)
    r, c = linear_sum_assignment(cost)
    assert cost[rows, cols].sum() == pytest.approx(cost[r, c].sum())


def test_hungarian_matching_rows_goes_through_lap_solve(rng, monkeypatch):
    calls = []
    real = matching.lap_solve

    def spy(cost):
        calls.append(cost.shape)
        return real(cost)

    monkeypatch.setattr(matching, "lap_solve", spy)
    preds = rng.integers(0, 6, size=(2, 9))
    probs = rng.uniform(size=(2, 6, 6))
    matching.hungarian_matching(preds, probs)
    assert len(calls) == 2
