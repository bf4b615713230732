"""K5, the fused ResNet identity bottleneck: the port's plain version
against the JAX Pallas kernel in interpret mode (as
tests/test_pallas_bottleneck.py runs it) on the same numpy inputs, the
support gate at the 12 RN50 identity blocks, and the bottleneck module's
fused route against its plain graph.

Tolerances are tests/test_pallas_bottleneck.py's: 1e-5 in fp32 (only the
order of the fp32 sums differs) and 5e-2 in bf16 (an h1, h2 or output value
can land on the neighbouring bf16 value)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transductive_clip_tpu.ops.pallas_bottleneck import (
    fused_identity_bottleneck as jax_bottleneck,
)
from transductive_clip_tpu_torch.models.clip.config import CLIP_CONFIGS
from transductive_clip_tpu_torch.models.clip.resnet import Bottleneck
from transductive_clip_tpu_torch.ops import cuda_bottleneck as cb

torch.set_num_threads(2)

# (B, H, W, C, Cm) of tests/test_pallas_bottleneck.py
SHAPES = {"tiny": (2, 8, 8, 32, 8), "l3geom": (1, 14, 14, 64, 16),
          "rect": (2, 16, 8, 16, 4)}
# the RN50 identity blocks: [H, W, C] / Cm x count
RN50_IDENTITY = [((56, 56, 256, 64), 2), ((28, 28, 512, 128), 3),
                 ((14, 14, 1024, 256), 5), ((7, 7, 2048, 512), 2)]


def _block(rng, b, h, w, c, c_mid):
    def t(*shape, scale=0.1):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return (t(b, h, w, c, scale=1.0), t(c, c_mid), t(c_mid, scale=0.01),
            t(3, 3, c_mid, c_mid), t(c_mid, scale=0.01), t(c_mid, c),
            t(c, scale=0.01))


def _both(args, jdtype, tdtype):
    return ([jnp.asarray(a, jdtype) for a in args],
            [torch.as_tensor(a).to(tdtype) for a in args])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_pallas_fp32(shape):
    args = _block(np.random.default_rng(0), *SHAPES[shape])
    aj, at = _both(args, jnp.float32, torch.float32)
    launches = cb.fused_identity_bottleneck.launches
    got = cb.fused_identity_bottleneck(*at)
    assert cb.fused_identity_bottleneck.launches == launches  # plain on CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bottleneck(*aj)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", ["tiny", "rect"])
def test_plain_matches_pallas_bf16(shape):
    args = _block(np.random.default_rng(1), *SHAPES[shape])
    aj, at = _both(args, jnp.bfloat16, torch.bfloat16)
    got = cb.fused_identity_bottleneck(*at)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jax_bottleneck(*aj), np.float32),
                               rtol=5e-2, atol=5e-2)


def test_relu_and_residual_semantics():
    """Zero weights: the output is relu(b3 + x) (bias before the residual
    add, relu after)."""
    x = torch.linspace(-2, 2, 2 * 4 * 4 * 8).reshape(2, 4, 4, 8)
    z = torch.zeros
    out = cb.fused_identity_bottleneck(x, z(8, 4), z(4), z(3, 3, 4, 4), z(4),
                                       z(4, 8), torch.full((8,), 0.5))
    torch.testing.assert_close(out, torch.relu(x + 0.5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_gate_takes_all_rn50_identity_blocks(dtype):
    cfg = CLIP_CONFIGS["RN50"].vision
    assert sum(count for _, count in RN50_IDENTITY) == 12 == sum(
        n - 1 for n in cfg.resnet_layers)
    for (h, w, c, c_mid), _ in RN50_IDENTITY:
        rows = cb.strip_rows(h, w, c, c_mid, dtype)
        assert rows >= 1 and cb.fused_bottleneck_supported(h, w, c, c_mid,
                                                           dtype)
        item = 2 if dtype == torch.bfloat16 else 4
        assert cb.smem_bytes(w, c_mid, rows, item) <= cb.SMEM_BUDGET
        assert rows == h or cb.smem_bytes(w, c_mid, rows + 1,
                                          item) > cb.SMEM_BUDGET


def test_gate_rejects():
    assert not cb.fused_bottleneck_supported(224, 224, 2048, 512,
                                             torch.float32)
    assert not cb.fused_bottleneck_supported(7, 7, 2048, 512, torch.float16)


def test_wrapper_launches_or_raises_off_the_cpu():
    args = [torch.as_tensor(a, device="meta") for a in
            _block(np.random.default_rng(0), *SHAPES["tiny"])]
    args[2], args[4] = args[2].float(), args[4].float()
    with pytest.raises(ValueError, match="CUDA"):
        cb.fused_identity_bottleneck(*args)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)],
                         ids=["fp32", "bf16"])
def test_module_fused_route_matches_plain_graph(dtype, tol):
    """A folded identity Bottleneck with fuse=True (K5's plain version on
    the CPU) against the same module's plain conv graph, channels_last."""
    torch.manual_seed(0)
    plain = Bottleneck(32, 8, fold_bn=True)
    fused = Bottleneck(32, 8, fold_bn=True, fuse=True)
    with torch.no_grad():
        for p in plain.parameters():
            p.normal_(0.0, 0.2)
    fused.load_state_dict(plain.state_dict())
    plain, fused = plain.to(dtype), fused.to(dtype)
    assert fused.fuse and not plain.fuse
    x = torch.randn(2, 32, 8, 8).to(dtype).contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match="prepare_kernel_weights"):
        fused(x)
    fused.prepare_kernel_weights()
    with torch.no_grad():
        want, got = plain(x), fused(x)
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
