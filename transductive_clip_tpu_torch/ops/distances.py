"""Distances between rows and centroids (counterpart of
transductive_clip_tpu/ops/distances.py).

``sq_euclidean`` takes the expansion ||x - w||^2 = ||x||^2 + ||w||^2 - 2 x.w
by default, so the dominant cost is one batched matrix product and no
[..., n, k, d] temporary is built; ``impl='direct'`` is the reference's
broadcast-subtract (reference: src/methods/zero_shot/soft_kmeans.py:112-114).
"""

from __future__ import annotations

import torch

from .common import EPS


def sq_euclidean(x, w, impl: str = "matmul"):
    """Pairwise squared euclidean distance.

    x: [..., n, d], w: [..., k, d] -> [..., n, k]

    ``impl='matmul'`` (default) uses the expansion; for nearly-equal points
    it cancels catastrophically in fp32 (relative error on tiny distances
    ~1e-2 after the T = 30 temperature), which can flip borderline
    assignments over many EM iterations, and across backends, whose
    products sum in different orders. ``impl='direct'`` materializes the
    broadcast-subtract exactly like the reference — exact fp32, a rank-4
    temporary; use it for parity runs at small K (``distance_impl``).
    """
    if impl == "direct":
        diff = x[..., :, None, :] - w[..., None, :, :]
        return (diff * diff).sum(-1)
    x2 = (x * x).sum(-1)[..., :, None]
    w2 = (w * w).sum(-1)[..., None, :]
    xw = torch.matmul(x, w.transpose(-1, -2))
    return torch.clamp_min(x2 + w2 - 2.0 * xw, 0.0)


def kl_divergence_to_centroids(x, w, eps: float = EPS):
    """KL(x || w) for rows of the simplex against centroid rows.

    x: [..., n, d], w: [..., k, d] -> [..., n, k]
    KL = sum x log x - x @ log(w)^T, with eps-smoothed arguments
    (reference: src/methods/zero_shot/kl_kmeans.py:123-127).
    """
    xs = x + eps
    ws = w + eps
    ent = (xs * torch.log(xs)).sum(-1)[..., :, None]
    cross = torch.matmul(xs, torch.log(ws).transpose(-1, -2))
    return ent - cross
