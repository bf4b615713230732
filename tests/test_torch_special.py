"""The port's positive-axis special functions against the JAX package's, on
a log-spaced grid from 1e-6 to 1e4 (the inverse functions at y = psi(grid)).
rtol 1e-5 with atol 1e-6: psi and lgamma cross zero (near 1.46, and at 1
and 2), where a relative difference means nothing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu.ops import special as jsp
from transductive_clip_tpu_torch.ops import special as tsp

torch.set_num_threads(2)

GRID = np.logspace(-6, 4, 4001).astype(np.float32)


def _inputs(name):
    if name.startswith("inv_digamma"):
        return np.array(jsp.digamma_pos(jnp.asarray(GRID)))
    return GRID


@pytest.mark.parametrize("name", [
    "digamma_pos", "trigamma_pos", "lgamma_pos", "digamma_and_trigamma_pos",
    "inv_digamma", "inv_digamma_and_deriv",
])
def test_special_matches_jax(name):
    x = _inputs(name)
    ref = getattr(jsp, name)(jnp.asarray(x))
    got = getattr(tsp, name)(torch.as_tensor(x))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
