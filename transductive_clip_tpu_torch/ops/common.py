"""Small shared tensor ops and the device plumbing of the port
(counterpart of transductive_clip_tpu/ops/common.py)."""

from __future__ import annotations

import torch

# Matches the epsilon used throughout the reference methods
# (reference: src/methods/zero_shot/em_dirichlet.py:20).
EPS = 1e-15
# the TIM loss epsilon (reference: src/methods/few_shot/tim.py log/power
# guards); shared by the autodiff loss, the closed-form gradient and the K3
# kernel, whose equivalence depends on using one value
TIM_EPS = 1e-12


def resolve_device(device=None, cfg=None) -> torch.device:
    """The device an entry point runs on.

    ``device=None`` means the card: ``cuda:{cfg.device}`` (index 0 without a
    config). It raises when no CUDA device is present instead of falling
    back to the CPU; the CPU is used only when the caller passes
    ``device="cpu"``. Also turns TF32 off for matrix products and
    convolutions, so every contraction the JAX package runs at full fp32
    precision (``ops/precision.f32_einsum`` there) stays in full fp32 here.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        index = int(cfg.get("device", 0)) if cfg is not None else 0
        device = f"cuda:{index}"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available for {device}; pass device='cpu' "
            "to run on the CPU"
        )
    return device


def to_host(*tensors):
    """Copy tensors to host numpy arrays: one synchronising transfer, counted
    in ``to_host.syncs``. Every data-dependent host decision of the port
    reads its operands through here, so the count is the number of times a
    batch makes the host wait for the card."""
    to_host.syncs += 1
    out = tuple(t.detach().cpu().numpy() for t in tensors)
    return out[0] if len(out) == 1 else out


to_host.syncs = 0


def device_sync(x):
    """Block until the work producing ``x`` (a tensor) is done; counted with
    the transfers in ``to_host.syncs``."""
    to_host.syncs += 1
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return x


def get_one_hot(y, n_class, dtype=torch.float32):
    """One-hot encode integer labels [..., n] -> [..., n, n_class]."""
    classes = torch.arange(n_class, dtype=y.dtype, device=y.device)
    return (y[..., None] == classes).to(dtype)


def top_rows(counts, R):
    """(values, indices) of the ``R`` largest entries along the last axis,
    in descending order with the lower index first on ties — the order
    ``jax.lax.top_k`` gives. ``torch.topk`` promises no order among ties,
    and many empty clusters tie at mass 0, so a stable sort is used."""
    vals, idx = torch.sort(counts, dim=-1, descending=True, stable=True)
    return vals[..., :R], idx[..., :R]


def rank_select_rows(counts, R, thresh=EPS):
    """Sort-free selection of ``R`` rows covering every populated one:
    populated rows first (in row-index order), then empty rows (also in
    index order), so the R indices are distinct like ``top_rows``'.

    Whenever the populated count is <= R the selected set contains every
    populated row; with more, it keeps the lowest-indexed ones (callers
    guard on the populated count, see ``select_rows_covering``).

    Returns (cnt [..., R], idx [..., R] int64, present [..., R] bool).
    """
    nonzero = counts > thresh
    nz = nonzero.to(torch.int64)
    rank_nz = torch.cumsum(nz, dim=-1)                  # rank among populated
    rank_z = torch.cumsum(1 - nz, dim=-1)               # rank among empty
    n_nz = rank_nz[..., -1:]
    grank = torch.where(nonzero, rank_nz, n_nz + rank_z)  # 1..K, a permutation
    targets = torch.arange(1, R + 1, dtype=torch.int64, device=counts.device)
    eq = grank[..., :, None] == targets                 # [..., K, R]
    idx = torch.argmax(eq.to(torch.int32), dim=-2)      # [..., R]
    present = targets <= n_nz
    cnt = torch.gather(counts, -1, idx)
    return cnt, idx, present


def select_rows_covering(counts, R, thresh, impl, populated_max=None):
    """Top-R row selection for the compact EM steps: ``impl='topk'`` is the
    mass-ordered ``top_rows``; ``impl='rank'`` is the sort-free
    :func:`rank_select_rows`, guarded on the host: whenever some task has
    more than ``R`` populated rows — the only regime where the two differ —
    it takes ``top_rows`` instead. ``populated_max`` (host int), when the
    caller already knows it, saves the guard's transfer.

    Returns (cnt [..., R], idx [..., R] int64).
    """
    if impl == "rank":
        if populated_max is None:
            populated_max = int(to_host((counts > thresh).sum(-1).max()))
        if populated_max <= R:
            cnt, idx, _ = rank_select_rows(counts, R, thresh=thresh)
            return cnt, idx
    return top_rows(counts, R)

