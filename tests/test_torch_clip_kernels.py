"""K4a, K4b and K5 on the card against their plain versions, at small
ragged shapes and at the extraction path's shapes (``cuda``-marked: each
skips without a GPU). Run on a machine with one:
``python -m pytest tests/test_torch_clip_kernels.py -m cuda``.

Limits, on the max absolute difference over the plain output's max
magnitude: 1e-5 in fp32 (only the order of the fp32 sums differs) and 2e-2
in bf16 (a value that lands on the other side of a bf16 rounding boundary
moves by one bf16 ulp, 2^-8 relative, and can carry into what follows)."""

import numpy as np
import pytest
import torch

from transductive_clip_tpu_torch.ops import cuda_attention as ca
from transductive_clip_tpu_torch.ops import cuda_bottleneck as cb
from transductive_clip_tpu_torch.ops.common import resolve_device
from transductive_clip_tpu_torch.utils.synthetic import (
    make_general_attention_mask,
)

torch.set_num_threads(2)

LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return resolve_device("cuda")     # TF32 off for the plain versions


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _causal(n, dtype, device):
    return torch.full((n, n), float("-inf"), dtype=dtype,
                      device=device).triu(1)


def _mask(kind, n, dtype, device):
    if kind == "plain":
        return None
    if kind == "causal":
        return _causal(n, dtype, device)
    return torch.as_tensor(make_general_attention_mask(
        np.random.default_rng(n), n), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("kernel", ["rows", "blocked"])
@pytest.mark.parametrize("b,n,heads,masked", [
    (2, 53, 4, False), (2, 53, 4, True), (3, 77, 8, True),
    (2, 130, 2, False), (1, 197, 12, False),
    (2, 80, 2, "causal"), (2, 128, 2, "plain"),      # K4a's tile edges
    (3, 5, 5, "plain"), (3, 77, 5, "general"), (3, 128, 5, "general"),
    (3, 197, 5, "general"), (1, 577, 3, "plain"), (1, 577, 3, "general"),
])
def test_attention_matches_plain(card, dtype, kernel, b, n, heads, masked):
    g = torch.Generator(device=card).manual_seed(n)
    qkv = torch.randn(b, n, 3 * 64 * heads, generator=g, device=card).to(
        dtype)
    kind = {False: "plain", True: "causal"}.get(masked, masked)
    mask = _mask(kind, n, dtype, card)
    wrapper = ca.attention_rows if kernel == "rows" else ca.attention_blocked
    launches = wrapper.launches
    if kernel == "rows" and n > ca.ROWS_MAX_N:
        # K4a keeps a warp's score rows in registers: longer sequences
        # are K4b's
        with pytest.raises(ValueError, match="attention_blocked"):
            wrapper(qkv, heads, mask)
        assert wrapper.launches == launches
        return
    got = wrapper(qkv, heads, mask)
    torch.cuda.synchronize()
    assert wrapper.launches == launches + 1
    want = ca.fused_attention_reference(qkv, heads, mask)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= LIMIT[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,width,heads,route", [
    (64, 77, 512, 8, "rows"), (32, 77, 768, 12, "rows"),
    (8, 577, 1024, 16, "blocked"), (16, 197, 768, 12, "blocked"),
])
def test_attention_at_tower_shapes(card, dtype, b, n, width, heads, route):
    g = torch.Generator(device=card).manual_seed(b)
    qkv = torch.randn(b, n, 3 * width, generator=g, device=card).to(dtype)
    mask = _causal(n, dtype, card) if route == "rows" else None
    assert ca.attention_route(n, width, heads, dtype) == route
    got = ca.fused_attention(qkv, heads, mask)
    torch.cuda.synchronize()
    assert _rel(got, ca.fused_attention_reference(qkv, heads, mask)) <= \
        LIMIT[dtype]


def _block(g, b, h, w, c, c_mid, dtype, device):
    def t(*shape, scale=0.1):
        return torch.randn(*shape, generator=g, device=device) * scale

    x = t(b, h, w, c, scale=1.0).to(dtype)
    return (x, t(c, c_mid).to(dtype), t(c_mid, scale=0.01),
            t(3, 3, c_mid, c_mid).to(dtype), t(c_mid, scale=0.01),
            t(c_mid, c).to(dtype), t(c, scale=0.01).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [
    (2, 8, 8, 32, 8), (1, 14, 14, 64, 16), (2, 16, 8, 16, 4),
    (3, 9, 11, 72, 24),                            # nothing a multiple of 64
    # the bf16 kernel's tile edges: rows off 16 bytes, an image in one
    # strip, a last strip of one row, Cm = 72 at W = 9, two chunks of rows
    (1, 5, 7, 30, 12), (3, 7, 7, 64, 72), (1, 5, 100, 16, 72),
    (1, 12, 9, 48, 72), (2, 30, 30, 64, 16),
    (4, 56, 56, 256, 64), (4, 28, 28, 512, 128),   # the RN50 identity blocks
    (4, 14, 14, 1024, 256), (4, 7, 7, 2048, 512),
])
def test_bottleneck_matches_plain(card, dtype, shape):
    g = torch.Generator(device=card).manual_seed(sum(shape))
    args = _block(g, *shape, dtype, card)
    launches = cb.fused_identity_bottleneck.launches
    if not cb.fused_bottleneck_supported(*shape[1:], dtype):
        # [5, 100, 16] / 72 fp32: two rows are over the fp32 kernel's budget
        assert dtype == torch.float32 and shape[2] == 100
        with pytest.raises(ValueError, match="fused_bottleneck_supported"):
            cb.fused_identity_bottleneck(*args)
        assert cb.fused_identity_bottleneck.launches == launches
        return
    got = cb.fused_identity_bottleneck(*args)
    torch.cuda.synchronize()
    assert cb.fused_identity_bottleneck.launches == launches + 1
    want = cb.fused_identity_bottleneck_reference(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got, want) <= LIMIT[dtype]
    assert np.isfinite(got.float().cpu().numpy()).all()
