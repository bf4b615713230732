"""K4a / K4b, the fused CLIP attention: the port's plain version against the
JAX Pallas kernels in interpret mode (as tests/test_pallas_attention.py
runs them) on the same numpy inputs, the dispatch at every OpenAI tower's
shape, the attention module's two routes, and the kernels' tiled order of
operations (a torch twin of it) against the plain version and, in bf16,
against the TPU kernel.

Tolerances are tests/test_pallas_attention.py's: 1e-5 in fp32 (only the
order of the fp32 sums differs) and 2e-2 in bf16 (a p or output value can
land on the neighbouring bf16 value)."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transductive_clip_tpu.models.clip.config import CLIP_CONFIGS as JAX_CONFIGS
from transductive_clip_tpu.models.clip.layers import (
    MultiHeadAttention as JaxMHA,
)
from transductive_clip_tpu.ops.pallas_attention import (
    _fused_attention_blocked,
    fused_attention as jax_fused_attention,
)
from transductive_clip_tpu_torch.models.clip.config import CLIP_CONFIGS
from transductive_clip_tpu_torch.models.clip.layers import MultiHeadAttention
from transductive_clip_tpu_torch.models.clip.model import (
    _attention_shapes,
    _resolve_attention_impl,
)
from transductive_clip_tpu_torch.ops import cuda_attention as ca
from transductive_clip_tpu_torch.utils.synthetic import (
    make_general_attention_mask,
)

torch.set_num_threads(2)

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(rng, b, n, width, dtype):
    x = rng.standard_normal((b, n, 3 * width)).astype(np.float32)
    return jnp.asarray(x, DTYPES[dtype][0]), torch.as_tensor(x).to(
        DTYPES[dtype][1])


def _causal(n):
    m = np.triu(np.full((n, n), -np.inf, np.float32), k=1)
    return jnp.asarray(m)[None, None], torch.as_tensor(m)[None, None]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "causal"])
@pytest.mark.parametrize("n", [33, 53])
def test_plain_matches_rows_kernel_interpret(rng, dtype, masked, n):
    """K4a's TPU kernel (whole sequence) at n = 33 and a ragged 53."""
    width, heads = 64, 4
    qj, qt = _qkv(rng, 2, n, width, dtype)
    mj, mt = _causal(n) if masked else (None, None)
    want = jax_fused_attention(qj, heads, mj, interpret=True)
    launches = ca.attention_rows.launches
    got = ca.fused_attention(qt, heads, mt)
    assert ca.attention_rows.launches == launches     # plain version on CPU
    assert got.dtype == qt.dtype and got.shape == (2, n, width)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "causal"])
@pytest.mark.parametrize("n", [33, 53])
def test_plain_matches_blocked_kernel_interpret(rng, dtype, masked, n):
    """K4b's TPU kernel with q blocks of 16 rows (53 = 3 x 16 + 5 ragged)."""
    width, heads = 64, 4
    qj, qt = _qkv(rng, 2, n, width, dtype)
    mj, mt = _causal(n) if masked else (None, None)
    want = _fused_attention_blocked(qj, heads, mj, 16, interpret=True)
    got = ca.attention_blocked(qt, heads, mt)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("name", sorted(CLIP_CONFIGS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_every_tower_resolves_to_a_kernel(name, dtype):
    """Every OpenAI tower at both dtypes goes to K4a or K4b, never to the
    plain path: the counterpart of tests/test_pallas_attention.py's
    no-silent-fallback test, on this card's own budget."""
    cfg = CLIP_CONFIGS[name]
    for n, width, heads in _attention_shapes(cfg):
        assert ca.attention_route(n, width, heads, dtype) in ("rows",
                                                              "blocked")
    assert _resolve_attention_impl("auto", cfg, dtype, "cuda") == "fused"
    assert _resolve_attention_impl("auto", cfg, dtype, "cpu") == "xla"


def test_routes_at_the_slice_shapes():
    assert ca.attention_route(77, 512, 8, torch.bfloat16) == "rows"     # text
    assert ca.attention_route(77, 768, 12, torch.float32) == "rows"
    assert ca.attention_route(50, 768, 12, torch.bfloat16) == "rows"    # B/32
    assert ca.attention_route(197, 768, 12, torch.bfloat16) == "blocked"
    assert ca.attention_route(577, 1024, 16, torch.float32) == "blocked"
    # K4a: q, k, v of a head at n rounded up to 16 rows, in the qkv dtype
    # (plus the fp32 p strips); taken up to n = 128, within the card's limit
    assert ca.rows_smem_bytes(77, torch.bfloat16) == 2 * 3 * 80 * 72 == 34560
    assert ca.rows_smem_bytes(77, torch.float32) == 4 * 80 * (3 * 68 + 72)
    for dtype in ca.KERNEL_DTYPES:
        assert ca.rows_smem_bytes(128, dtype) <= ca.SMEM_LIMIT
        assert ca.attention_route(128, 768, 12, dtype) == "rows"
        assert ca.attention_route(129, 768, 12, dtype) == "blocked"
        # K4b's shared memory does not depend on n (the cap at 776 is
        # gone) and leaves room for two blocks an SM or more
        assert ca.attention_route(777, 1024, 16, dtype) == "blocked"
        assert 2 * (ca.blocked_smem_bytes(dtype) + 1024) <= 228 * 1024
    # bf16: two q buffers of two 64-row warpgroups and four stages of a k
    # and a v tile in unpadded 128-byte rows (the wgmma swizzle), 1024
    # bytes to align them, and twelve 8-byte barriers
    assert ca.blocked_smem_bytes(torch.bfloat16) == (
        1024 + 128 * (256 + 8 * 64) + 8 * 12)
    assert ca.blocked_smem_bytes(torch.float32) == 4 * (256 * 68 + 128 * 72)


@pytest.mark.parametrize("n,width,heads,dtype", [
    (77, 512, 16, torch.float32),        # head_dim 32
    (777, 2048, 16, torch.float32),      # head_dim 128
    (77, 512, 8, torch.float16),         # no fp16 kernel
])
def test_unsupported_shapes_raise(n, width, heads, dtype):
    assert not ca.fused_attention_supported(n, width, heads, dtype)
    with pytest.raises(ValueError, match="fused attention"):
        ca.attention_route(n, width, heads, dtype)


def test_wrapper_launches_or_raises_off_the_cpu():
    """Only CPU tensors take the plain version: any other device goes to
    the launch path, which refuses what is not CUDA."""
    qkv = torch.zeros((1, 77, 3 * 512), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ca.fused_attention(qkv, 8)
    with pytest.raises(ValueError, match="fused attention"):
        ca.fused_attention(torch.zeros((1, 77, 3 * 96), device="meta"), 3)


def _mask(rng, kind, n):
    if kind == "plain":
        return None
    if kind == "causal":
        return _causal(n)[1]
    m = make_general_attention_mask(rng, n)
    assert np.isfinite(m).any(-1).all()            # no row is all -inf
    assert n <= 64 or np.isneginf(m[0, :64]).all()    # a whole dead tile
    return torch.as_tensor(m)


@pytest.mark.parametrize("mask", ["plain", "causal", "general"])
@pytest.mark.parametrize("n", [33, 53, 77, 130, 197, 577])
def test_tiled_twin_matches_plain_fp32(rng, n, mask):
    """The fp32 kernels' online softmax over key tiles of 64 (running max
    and sum, rescaled accumulators, one division, the -inf guard) against
    the plain version: only the order of fp32 operations differs."""
    _, qkv = _qkv(rng, 2, n, 128, "fp32")
    mt = _mask(rng, mask, n)
    want = ca.fused_attention_reference(qkv, 2, mt)
    got = ca.fused_attention_tiled_reference(qkv, 2, mt)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("mask", ["plain", "causal", "general"])
@pytest.mark.parametrize("n", [33, 53, 77, 130, 197, 577])
def test_tiled_twin_matches_plain_bf16(rng, n, mask):
    """K4b bf16's one pass over the key tiles (e = exp(s - m) rounded to
    bf16 into o += e . v, the sum of the unrounded e, one division at the
    end) against the plain version (p = e / sum rounded to bf16, then
    p . v), within one bf16 ulp of the output's magnitude: rounding e
    before the division and p after it differ by under half a bf16 ulp of
    each term, so a summed output moves by less than an ulp of the largest
    one, and an output near a bf16 rounding boundary to the neighbouring
    value."""
    _, qkv = _qkv(rng, 2, n, 128, "bf16")
    mt = _mask(rng, mask, n)
    want = ca.fused_attention_reference(qkv, 2, mt).float()
    got = ca.fused_attention_tiled_reference(qkv, 2, mt).float()
    assert torch.isfinite(got).all()
    ulp = 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max() <= ulp


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "causal"])
@pytest.mark.parametrize("n", [53, 130, 197])
def test_tiled_twin_matches_jax_blocked_bf16(rng, n, masked):
    """K4b bf16's order of operations (the twin) against the TPU kernel it
    replaces, ``_fused_attention_blocked`` in interpret mode, in bf16 over
    one, three and four key tiles (197 ends in a tile of 5 keys), at the
    bf16 tolerance of this file."""
    width, heads = 64, 4
    qj, qt = _qkv(rng, 2, n, width, "bf16")
    mj, mt = _causal(n) if masked else (None, None)
    want = _fused_attention_blocked(qj, heads, mj, 16, interpret=True)
    got = ca.fused_attention_tiled_reference(qt, heads, mt)
    assert got.dtype == torch.bfloat16 and got.shape == (2, n, width)
    _close(got, want, DTYPES["bf16"][2])


def test_tiled_twin_guards_a_leading_masked_tile():
    """A row whose first key tile is all -inf has a running max of -inf
    when the second tile comes: the twin (and the kernels) subtract 0
    there, and the row comes out as the plain version's."""
    rng = np.random.default_rng(5)
    _, qkv = _qkv(rng, 1, 70, 64, "fp32")
    m = torch.zeros((70, 70))
    m[:, :64] = float("-inf")
    want = ca.fused_attention_reference(qkv, 1, m)
    got = ca.fused_attention_tiled_reference(qkv, 1, m)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_rows_kernel_refuses_long_sequences():
    """K4a keeps a warp's score rows in registers: n over 128 raises off
    the CPU, and the dispatch sends it to K4b."""
    qkv = torch.zeros((1, 130, 3 * 128), device="meta")
    with pytest.raises(ValueError, match="attention_blocked"):
        ca.attention_rows(qkv, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ca.attention_blocked(qkv, 2)


def test_python_constants_equal_the_source():
    """The tile, warpgroup, ring and slack constants of
    ops/cuda_attention.py, and its K4b bf16 shared-memory formula, against
    csrc/attention.cu."""
    from transductive_clip_tpu_torch.ops import kernel_build

    text = (kernel_build.CSRC / ca.SOURCE).read_text()

    def const(name, kind="int"):
        return float(re.search(rf"constexpr {kind} {name} = ([0-9.]+)f?;",
                               text).group(1))

    assert const("kHeadDim") == ca.HEAD_DIM
    assert const("kWarpRows") == ca.WARP_ROWS
    assert const("kKeys") == ca.KEYS
    assert const("kBlockRows") == ca.BLOCK_ROWS
    assert const("kWgRows") == ca.WG_ROWS
    assert const("kWarpgroups") == ca.WARPGROUPS
    assert const("kStages") == ca.STAGES
    assert const("kSlack", "float") == ca.SLACK
    assert ca.WARPGROUPS * ca.WG_ROWS == ca.BLOCK_ROWS
    assert ("1024 + sizeof(bf16) * (2 * kRowsB + 2 * kStages * kKeys) * "
            "kHeadDim\n            + sizeof(uint64_t) * (4 + 2 * kStages)"
            ) in text


def _jax_mha_params(rng, width):
    def t(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"params": {
        "in_proj": {"kernel": t(width, 3 * width), "bias": t(3 * width)},
        "out_proj": {"kernel": t(width, width), "bias": t(width)}}}


def _port_mha(params, width, heads, impl):
    mod = MultiHeadAttention(width, heads, impl)
    p = params["params"]
    with torch.no_grad():
        mod.in_proj_weight.copy_(torch.as_tensor(p["in_proj"]["kernel"].T))
        mod.in_proj_bias.copy_(torch.as_tensor(p["in_proj"]["bias"]))
        mod.out_proj.weight.copy_(torch.as_tensor(p["out_proj"]["kernel"].T))
        mod.out_proj.bias.copy_(torch.as_tensor(p["out_proj"]["bias"]))
    return mod


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "causal"])
def test_module_matches_jax(rng, impl, masked):
    """The attention module, both routes, against the JAX module's 'xla'
    and 'fused_interpret' routes on the same parameters (fp32)."""
    b, n, width, heads = 2, 21, 40, 4
    x = rng.standard_normal((b, n, width)).astype(np.float32)
    params = _jax_mha_params(rng, width)
    mj, mt = _causal(n) if masked else (None, None)
    jax_impl = "xla" if impl == "xla" else "fused_interpret"
    want = JaxMHA(width, heads, jax_impl).apply(params, jnp.asarray(x), mj)
    with torch.no_grad():
        got = _port_mha(params, width, heads, impl)(torch.as_tensor(x), mt)
    _close(got, want, 1e-5)


def test_unknown_impl_rejected():
    with pytest.raises(ValueError, match="attn_impl"):
        MultiHeadAttention(8, 2, "cuda")


def test_config_copy_matches_jax():
    assert {k: repr(v) for k, v in CLIP_CONFIGS.items()} == {
        k: repr(v) for k, v in JAX_CONFIGS.items()}
    assert jax.default_backend() == "cpu"
