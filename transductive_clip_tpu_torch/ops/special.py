"""Special functions specialised to the Dirichlet solvers' domain (x > 0)
(counterpart of transductive_clip_tpu/ops/special.py).

The same recurrence shift (4 steps) and asymptotic series as the JAX
package, in plain torch. ``csrc/special.cuh`` holds the same functions as
``__device__`` code for the kernels; the three must stay in step.

``inv_digamma`` (Newton on psi) powers the fixed-point Dirichlet solver
(Minka 2000, "Estimating a Dirichlet distribution"): alpha_d = psi^{-1}(
psi(sum alpha) + y_d).
"""

from __future__ import annotations

import torch

EULER_GAMMA = 0.5772156649015329


def digamma_pos(x):
    """digamma(x) for x > 0 (asymptotic series after shifting x above 4)."""
    # recurrence: psi(x) = psi(x + 1) - 1/x, applied 4 times
    acc = torch.zeros_like(x)
    for _ in range(4):
        acc = acc - 1.0 / x
        x = x + 1.0
    # asymptotic: ln x - 1/(2x) - 1/(12x^2) + 1/(120x^4) - 1/(252x^6)
    inv = 1.0 / x
    inv2 = inv * inv
    series = (
        torch.log(x)
        - 0.5 * inv
        - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0))
    )
    return series + acc


def trigamma_pos(x):
    """trigamma(x) for x > 0."""
    acc = torch.zeros_like(x)
    for _ in range(4):
        acc = acc + 1.0 / (x * x)
        x = x + 1.0
    inv = 1.0 / x
    inv2 = inv * inv
    # 1/x + 1/(2x^2) + 1/(6x^3) - 1/(30x^5) + 1/(42x^7)
    series = inv + 0.5 * inv2 + inv * inv2 * (
        1.0 / 6.0 - inv2 * (1.0 / 30.0 - inv2 / 42.0)
    )
    return series + acc


def lgamma_pos(x):
    """log Gamma(x) for x > 0 (Stirling after shifting x above 4)."""
    shift = torch.zeros_like(x)
    for _ in range(4):
        shift = shift + torch.log(x)
        x = x + 1.0
    inv = 1.0 / x
    inv2 = inv * inv
    # Stirling: (x-1/2) ln x - x + ln(2 pi)/2 + 1/(12x) - 1/(360x^3) + 1/(1260x^5)
    series = (
        (x - 0.5) * torch.log(x)
        - x
        + 0.9189385332046727
        + inv * (1.0 / 12.0 - inv2 * (1.0 / 360.0 - inv2 / 1260.0))
    )
    return series - shift


def digamma_and_trigamma_pos(x):
    """(digamma(x), trigamma(x)) for x > 0, sharing the recurrence
    reciprocals 1/(x+i) between the two series."""
    acc0 = torch.zeros_like(x)
    acc1 = torch.zeros_like(x)
    for _ in range(4):
        inv = 1.0 / x
        acc0 = acc0 - inv
        acc1 = acc1 + inv * inv
        x = x + 1.0
    inv = 1.0 / x
    inv2 = inv * inv
    logx = torch.log(x)
    dg = (
        logx
        - 0.5 * inv
        - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0))
        + acc0
    )
    tg = (
        inv + 0.5 * inv2
        + inv * inv2 * (1.0 / 6.0 - inv2 * (1.0 / 30.0 - inv2 / 42.0))
        + acc1
    )
    return dg, tg


def _inv_digamma_init(y):
    """Minka (2000) appendix: exp(y) + 1/2 for y >= -2.22, -1/(y + gamma)
    otherwise."""
    return torch.where(y >= -2.22, torch.exp(y) + 0.5, -1.0 / (y + EULER_GAMMA))


def inv_digamma(y, newton_iters: int = 3):
    """Inverse digamma on the positive axis: x with psi(x) = y, by Newton
    steps x -= (psi(x) - y)/psi'(x) from Minka's initialisation."""
    x = _inv_digamma_init(y)
    for _ in range(newton_iters):
        dg, tg = digamma_and_trigamma_pos(x)
        x = x - (dg - y) / tg
        x = torch.clamp_min(x, 1e-10)
    return x


def inv_digamma_and_deriv(y, newton_iters: int = 3):
    """(x, dx/dy) with psi(x) = y: the inverse digamma and its derivative
    1/psi'(x), reusing the trigamma of the last Newton iterate."""
    x = _inv_digamma_init(y)
    tg = None
    for _ in range(max(newton_iters, 1)):
        dg, tg = digamma_and_trigamma_pos(x)
        x = x - (dg - y) / tg
        x = torch.clamp_min(x, 1e-10)
    return x, 1.0 / tg
