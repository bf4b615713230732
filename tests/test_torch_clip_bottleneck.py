"""K5, the fused ResNet identity bottleneck: the port's plain version
against the JAX Pallas kernel in interpret mode (as
tests/test_pallas_bottleneck.py runs it) on the same numpy inputs, the
support gate at the 12 RN50 identity blocks, and the bottleneck module's
fused route against its plain graph. The kernels' tiling (what a block
owns, halo rows, the padded pitch, the tap-major contraction slice by
slice) has a torch twin,
``fused_identity_bottleneck_tiled_reference``, held here against the plain
version at the edges of the kernels' tiles, and in fp32 against the JAX
kernel too. The ``cuda``-marked cases hold the kernel against its plain
version on the card (they skip without one).

Tolerances are tests/test_pallas_bottleneck.py's: 1e-5 in fp32 (only the
order of the fp32 sums differs) and 5e-2 in bf16 (an h1, h2 or output value
can land on the neighbouring bf16 value)."""

import re

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
from transductive_clip_tpu_torch.ops import kernel_build
from transductive_clip_tpu_torch.ops.common import resolve_device

torch.set_num_threads(2)

# (B, H, W, C, Cm) of tests/test_pallas_bottleneck.py
SHAPES = {"tiny": (2, 8, 8, 32, 8), "l3geom": (1, 14, 14, 64, 16),
          "rect": (2, 16, 8, 16, 4)}
# the RN50 identity blocks: [H, W, C] / Cm x count
RN50_IDENTITY = [((56, 56, 256, 64), 2), ((28, 28, 512, 128), 3),
                 ((14, 14, 1024, 256), 5), ((7, 7, 2048, 512), 2)]
# what a block owns at each RN50 stage: rows a strip
RN50_STRIP_ROWS = {torch.bfloat16: [8, 7, 7, 7], torch.float32: [4, 4, 4, 4]}
# (B, H, W, C, Cm) at the edges of the bf16 kernel's tiles: W not a multiple
# of 8 and Cm = 24 / 72 (padded to 32 / 96 channels, rows not on 16 bytes
# at C = 30), an image in one strip with no halo, a last strip of one row
# (H = 5 in strips of 2: two rows are all that fit at W = 100, Cm = 72; its
# conv1 walks two chunks of rows), nothing a multiple of 64
# nothing a multiple of 64. The fp32 kernel's strips are cut by its own
# budget: a last strip of one row at W = 80, Cm = 72 (H = 5 in strips of 2;
# conv1 walks two chunks of rows), and at W = 150, Cm = 24 with rows off 16
# bytes (H = 7 in strips of 3); Cm = 6, whose weight rows are off 16 bytes
EDGES = {"w11_cm24": (2, 9, 11, 72, 24), "odd_c": (1, 5, 7, 30, 12),
         "one_strip": (3, 7, 7, 64, 72), "last_strip_1": (1, 5, 100, 16, 72),
         "cm72_w9": (1, 12, 9, 48, 72),
         "f32_last_strip_1": (1, 5, 80, 16, 72),
         "f32_strips_cm24": (1, 7, 150, 30, 24), "f32_cm6": (2, 6, 5, 20, 6)}


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
        budget = cb.SMEM_BUDGET
        assert cb.smem_bytes(w, c_mid, rows, item) <= budget
        # no fewer strips would fit: one strip less means taller strips
        strips = -(-h // rows)
        assert strips == 1 or cb.smem_bytes(
            w, c_mid, -(-h // (strips - 1)), item) > budget
        assert rows == -(-h // strips)   # evened over the image
    assert [cb.strip_rows(*shape, dtype)
            for shape, _ in RN50_IDENTITY] == RN50_STRIP_ROWS[dtype]


@pytest.mark.parametrize("edge", sorted(EDGES))
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2),
                                       (torch.float32, 1e-5)],
                         ids=["bf16", "fp32"])
def test_tiled_twin_matches_plain(edge, dtype, tol):
    """The kernel's tiling against the plain version, which
    test_plain_matches_pallas_* hold against the JAX kernel. bf16: an h1,
    h2 or output value can land on the neighbouring bf16 value; fp32: only
    the order of the sums differs."""
    args = [torch.as_tensor(a).to(dtype)
            for a in _block(np.random.default_rng(2), *EDGES[edge])]
    args[2], args[4] = args[2].float(), args[4].float()
    _, h, w, c, c_mid = EDGES[edge]
    assert cb.fused_bottleneck_supported(h, w, c, c_mid, dtype)
    got = cb.fused_identity_bottleneck_tiled_reference(*args)
    want = cb.fused_identity_bottleneck_reference(*args)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", ["l3geom", "f32_last_strip_1"])
def test_tiled_twin_matches_pallas_fp32(shape):
    """The fp32 kernel's tiling (its strips, halo rows, padded pitch and
    16-deep slices, not its split groups' hand-over) against the JAX kernel
    in interpret mode, on the same numpy inputs; 1e-5 relative: only the
    order of the sums differs."""
    dims = {**SHAPES, **EDGES}[shape]
    args = _block(np.random.default_rng(3), *dims)
    aj, at = _both(args, jnp.float32, torch.float32)
    if shape == "f32_last_strip_1":    # several strips, the last of one row
        assert dims[1] % cb.strip_rows(*dims[1:], torch.float32) == 1
    got = cb.fused_identity_bottleneck_tiled_reference(*at)
    want = np.asarray(jax_bottleneck(*aj))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return resolve_device("cuda")     # TF32 off for the plain version


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    *[(2, *dims) for dims, _ in RN50_IDENTITY],
    *[EDGES[name] for name in sorted(EDGES)]],
    ids=[f"rn50_{dims[0]}" for dims, _ in RN50_IDENTITY] + sorted(EDGES))
def test_kernel_matches_plain_fp32(card, shape):
    """The fp32 kernel on the card against its plain version (cuDNN fp32,
    TF32 off) at the four RN50 identity stages (batch 2) and the edges:
    max |kernel - plain| over max |plain| under 1e-5, as only the order of
    the fp32 sums differs."""
    g = torch.Generator(device=card).manual_seed(sum(shape))

    def t(*dims, scale=0.1):
        return torch.randn(*dims, generator=g, device=card) * scale

    b, h, w, c, c_mid = shape
    args = (t(b, h, w, c, scale=1.0), t(c, c_mid), t(c_mid, scale=0.01),
            t(3, 3, c_mid, c_mid), t(c_mid, scale=0.01), t(c_mid, c),
            t(c, scale=0.01))
    launches = cb.fused_identity_bottleneck.launches
    got = cb.fused_identity_bottleneck(*args)
    torch.cuda.synchronize()
    assert cb.fused_identity_bottleneck.launches == launches + 1
    want = cb.fused_identity_bottleneck_reference(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= 1e-5


def test_edge_shapes_cover_the_strip_cases():
    """The edge shapes really are edges: a last strip of one row, an image
    in one strip, padded channels, rows off 16 bytes."""
    bf16 = torch.bfloat16
    b, h, w, c, c_mid = EDGES["last_strip_1"]
    rows = cb.strip_rows(h, w, c, c_mid, bf16)
    assert 1 < rows < h and h % rows == 1
    b, h, w, c, c_mid = EDGES["one_strip"]
    assert cb.strip_rows(h, w, c, c_mid, bf16) == h
    assert cb.padded_channels(24) == 32 and cb.padded_channels(72) == 96
    assert cb.padded_channels(64) == 64 and cb.padded_channels(512) == 512
    assert EDGES["odd_c"][3] % 8 and EDGES["odd_c"][4] % 8
    fp32, unit = torch.float32, cb.CHAN_UNIT_F32
    assert cb.padded_channels(24, unit) == 32
    assert cb.padded_channels(72, unit) == 80
    assert cb.padded_channels(12, unit) == 16
    for name, rows in (("f32_last_strip_1", 2), ("f32_strips_cm24", 3)):
        b, h, w, c, c_mid = EDGES[name]
        assert cb.strip_rows(h, w, c, c_mid, fp32) == rows and h % rows == 1
    # conv1 of a middle strip at W = 80 covers 4 x 80 rows: two chunks
    assert 4 * EDGES["f32_last_strip_1"][2] > cb.ROWS_F32
    # rows off 16 bytes in fp32: C (x, w3) or Cm (w1, w2) not a multiple of 4
    assert EDGES["f32_strips_cm24"][3] % 4 and EDGES["odd_c"][3] % 4
    assert EDGES["f32_cm6"][4] % 4 and not EDGES["f32_cm6"][3] % 4
    # an image smaller than a strip: a taller one would still fit
    for name in ("one_strip", "w11_cm24", "cm72_w9"):
        b, h, w, c, c_mid = EDGES[name]
        assert cb.strip_rows(h, w, c, c_mid, fp32) == h
        assert cb.strip_rows(h + 1, w, c, c_mid, fp32) == h + 1


def test_twin_refuses_what_the_gate_rejects():
    z = torch.zeros
    with pytest.raises(ValueError, match="fused_bottleneck_supported"):
        cb.fused_identity_bottleneck_tiled_reference(
            z(1, 224, 224, 8), z(8, 512), z(512), z(3, 3, 512, 512), z(512),
            z(512, 8), z(8))


def test_python_constants_equal_the_source():
    """The ring, pitch and budget constants of ops/cuda_bottleneck.py, and
    its shared-memory formulas, against csrc/bottleneck.cu."""
    text = (kernel_build.CSRC / cb.SOURCE).read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} =\s*([^;]+);", text).group(1)
        return eval(expr, {}, {n: const(n) for n in
                               re.findall(r"k[A-Z]\w+", expr)})

    assert (const("kDepth"), const("kStages"), const("kChanUnit"),
            const("kPad")) == (cb.DEPTH, cb.STAGES, cb.CHAN_UNIT, cb.PAD)
    assert const("kSmemMax") == cb.SMEM_BUDGET
    ring = const("kStages") * const("kStageBytes")
    for (h, w, c, c_mid), _ in RN50_IDENTITY:
        pixels = 9 * (w + 2) + 7 * w
        assert cb.smem_bytes(w, c_mid, 7, 2) == ring + 2 * (
            cb.padded_channels(c_mid) + const("kPad")) * pixels
        assert 2 * (c_mid + const("kPad")) * 9 * (w + 2) >= const(
            "kStagingBytes")
    # fp32: smem_bytes_f32 of the source, a weight ring, h1 and the larger
    # of h2 and conv1's x ring
    assert (const("kDepthF"), const("kChanUnitF"), const("kPadF"),
            const("kRingColsF"), const("kRowsF")) == (
        cb.DEPTH_F32, cb.CHAN_UNIT_F32, cb.PAD_F32, cb.RING_COLS_F32,
        cb.ROWS_F32)
    w_ring = 4 * const("kStages") * const("kWStageF")
    x_ring = 4 * const("kStages") * const("kXStageF")
    assert w_ring == cb.STAGES * cb._STAGE_BYTES_F32
    assert x_ring == cb._X_RING_BYTES_F32
    assert const("kAPitchF") % 4 == 0 and const("kPadF") % 4 == 0
    assert "smem_bytes_f32(W, Cm, R)" in text
    for (h, w, c, c_mid), _ in RN50_IDENTITY + [((5, 80, 16, 72), 0),
                                                ((5, 7, 30, 12), 0)]:
        pitch = cb.padded_channels(c_mid, const("kChanUnitF")) + const("kPadF")
        for rows in (1, 4, 7):
            assert cb.smem_bytes(w, c_mid, rows, 4) == w_ring + 4 * (
                pitch * (rows + 2) * (w + 2)) + max(4 * pitch * rows * w,
                                                    x_ring)
    # 8 warps, 64 outputs (8 x 8) a thread: tiles of 256 x 64 to 64 x 256
    assert const("kThreads") == 8 * 32
    assert const("kRowsF") * 64 == const("kThreads") * 64 == 64 * const(
        "kRingColsF")
    # a stage takes the widest of the three warp layouts' slices
    for wm in (1, 2, 4):
        assert 2 * (64 * wm * (cb.DEPTH + cb.PAD)
                    + cb.DEPTH * (256 // wm + cb.PAD)) <= const("kStageBytes")
    # a tiny block's h1 is as large as conv3's staging tile, whose three
    # shapes all fit
    assert cb.smem_bytes(8, 8, 8, 2) == ring + const("kStagingBytes") + 2 * (
        32 + const("kPad")) * 64
    for wm in (1, 2, 4):
        assert 2 * 64 * wm * (256 // wm + cb.PAD) <= const("kStagingBytes")
    # ldmatrix rows start on 16 bytes
    assert (2 * (cb.padded_channels(24) + cb.PAD)) % 16 == 0


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


def test_kernel_weights_round_trip():
    """prepare_kernel_weights lays the convolutions' weights as the
    kernel's [K][N] operands (w2 tap-major, HWIO): laid back, they are the
    module's own."""
    torch.manual_seed(1)
    block = Bottleneck(32, 8, fold_bn=True, fuse=True)
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.2)
    block.prepare_kernel_weights()
    w1, b1, w2, b2, w3, b3 = block._kernel_weights
    assert w1.shape == (32, 8) and w2.shape == (3, 3, 8, 8)
    assert w3.shape == (8, 32) and all(
        t.is_contiguous() for t in (w1, w2, w3))
    assert b1.dtype == b2.dtype == torch.float32
    torch.testing.assert_close(w1.t()[:, :, None, None], block.conv1.weight)
    torch.testing.assert_close(w2.permute(3, 2, 0, 1), block.conv2.weight)
    torch.testing.assert_close(w3.t()[:, :, None, None], block.conv3.weight)
    # tap-major rows: row (3 dh + dw) Cm + ci of the [9 Cm][Cm] operand
    flat = w2.reshape(9 * 8, 8)
    torch.testing.assert_close(flat[(3 * 2 + 1) * 8 + 5],
                               block.conv2.weight[:, 5, 2, 1])
    torch.testing.assert_close(b3, block.conv3.bias)
