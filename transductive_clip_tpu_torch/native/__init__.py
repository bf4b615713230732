"""Native (C++) components of the port, with scipy as the fallback
(counterpart of transductive_clip_tpu/native/__init__.py).

``lap_solve(cost)`` solves the rectangular linear assignment problem
(n_rows <= n_cols, minimisation) and returns (row_indices, col4row), the same
contract as ``scipy.optimize.linear_sum_assignment``.

The solver is the shortest-augmenting-path C++ code of ``lapjv.cpp`` (a copy
of the JAX package's), compiled with ``g++`` at first use into the port's
``_build/`` directory (``ops.kernel_build.host_library``). If it cannot be
built or loaded, scipy's solver is used instead: both give an optimal
assignment, but on tied costs they may pick different optimal columns.
Which of the two is in use is logged once, and ``solver_in_use()`` says it.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "lapjv.cpp"
_log = logging.getLogger(__name__)

_lib = None
_lib_failed = False


def _load_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    from ..ops.kernel_build import host_library

    try:
        lib = ctypes.CDLL(str(host_library(_SRC)))
        lib.lap_solve_f64.restype = ctypes.c_int
        lib.lap_solve_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        _log.info("lap_solve: the native solver (%s)", lib._name)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _lib_failed = True
        _log.warning("lap_solve: the native solver did not build or load "
                     "(%s); using scipy.optimize.linear_sum_assignment", e)
    return _lib


def solver_in_use() -> str:
    """'native' when the C++ solver is loaded (building it first if
    needed), else 'scipy'."""
    return "native" if _load_lib() is not None else "scipy"


def lap_solve(cost: np.ndarray):
    """Solve min-cost assignment for cost [n_rows, n_cols] with n_rows <= n_cols.

    Returns (row_ind, col_ind) like scipy.optimize.linear_sum_assignment.
    """
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n_rows, n_cols = cost.shape
    lib = _load_lib()
    if lib is not None and n_rows <= n_cols:
        out = np.zeros(n_rows, dtype=np.int64)
        rc = lib.lap_solve_f64(
            cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n_rows,
            n_cols,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc == 0:
            return np.arange(n_rows), out
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(cost)
