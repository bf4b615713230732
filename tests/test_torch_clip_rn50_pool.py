"""The ResNet towers' average pools (``ops/cuda_pool.avg_pool_nhwc``, the
kernel ``csrc/avg_pool.cu``, routed from ``models/clip/resnet.py``).

On the CPU: the wrapper is ``F.avg_pool2d`` there, bit for bit; window 1
returns its input object and launches nothing; the vector width comes
from the channels, the dtype and the pointers alone; a ModifiedResNet
with RN50's stages counts 7 pools of a window above 1 a forward
(``resnet.pools``) and none in the kernel (``resnet.kernel_pools``); the
folded and unfolded towers still match the torch oracle of
tests/torch_clip.py at tests/test_torch_clip_towers.py's fp32 tolerance;
OpenAI's state-dict keys, the shortcut's ``AvgPool2d`` entry among them,
are unchanged.

``cuda``-marked (each skips without a GPU; run on a machine with one:
``python -m pytest tests/test_torch_clip_rn50_pool.py -m cuda``): the
kernel ``torch.equal`` to ``F.avg_pool2d`` at the seven RN50 pool shapes
in bf16, fp16 and fp32, at odd sizes (floor mode, window 3), at channels
whose bytes are not a multiple of 16 and from a pointer off 16 bytes (the
one-element path), and on an NCHW input; its refusals; 7 launches an RN50
forward and none for layer1's window-1 shortcut; the bf16 folded RN50
tower bit-equal to the same tower with ``F.avg_pool2d`` in the kernel's
place (cuDNN deterministic, its autotuner off, in that test only)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import torch_clip

from transductive_clip_tpu_torch.core.profiling import PhaseTimer
from transductive_clip_tpu_torch.models.clip import CLIP, TorchCLIP
from transductive_clip_tpu_torch.models.clip import resnet
from transductive_clip_tpu_torch.models.clip.config import (
    CLIP_CONFIGS,
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from transductive_clip_tpu_torch.models.clip.model import (
    init_random_state_dict,
)
from transductive_clip_tpu_torch.ops import cuda_pool
from transductive_clip_tpu_torch.ops.common import resolve_device
from transductive_clip_tpu_torch.ops.cuda_pool import avg_pool_nhwc

torch.set_num_threads(2)

RN50 = CLIP_CONFIGS["RN50"]


def _tiny(layers, width=16, image_size=32):
    return CLIPConfig(
        name="tiny-rn", embed_dim=32,
        vision=CLIPVisionConfig(image_size=image_size, width=width, heads=4,
                                is_resnet=True, resnet_layers=layers),
        text=CLIPTextConfig(vocab_size=64, context_length=8, width=32,
                            layers=1, heads=4))


# RN50's stages at a width and an image the CPU runs in a moment
TINY_RN50 = _tiny((3, 4, 6, 3))
# two blocks in layers 1 and 3, so that identity blocks run beside the
# strided ones
TINY_TWO = _tiny((2, 1, 2, 1))
# RN50's pools of a window above 1 at 224 px, [C, H, W] of each input: the
# stem's, then each strided block's main path and shortcut (layer1's
# shortcut pools at window 1)
RN50_POOL_SHAPES = {
    "stem": (64, 112, 112),
    "layer2-main": (128, 56, 56), "layer2-shortcut": (256, 56, 56),
    "layer3-main": (256, 28, 28), "layer3-shortcut": (512, 28, 28),
    "layer4-main": (512, 14, 14), "layer4-shortcut": (1024, 14, 14),
}
RN50_POOLS = len(RN50_POOL_SHAPES)
# tests/test_torch_clip_towers.py's fp32 tolerance against the oracle
TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16}


def _nhwc(shape, dtype, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dtype)
    return x.to(device).contiguous(memory_format=torch.channels_last)


# -- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("shape,window,dtype,layout", [
    ((2, 64, 16, 16), 2, "fp32", "nhwc"),
    ((2, 64, 16, 16), 2, "bf16", "nhwc"),
    ((3, 20, 15, 13), 2, "bf16", "nhwc"),
    ((2, 8, 11, 10), 3, "fp32", "nchw"),
    ((1, 16, 7, 7), 2, "fp16", "nchw"),
], ids=["fp32", "bf16", "bf16-odd", "fp32-window3-nchw", "fp16-nchw"])
def test_wrapper_is_avg_pool2d_on_the_cpu(shape, window, dtype, layout):
    x = _nhwc(shape, DTYPES[dtype], 0)
    if layout == "nchw":
        x = x.contiguous()
    launches = avg_pool_nhwc.launches
    got = avg_pool_nhwc(x, window)
    assert torch.equal(got, F.avg_pool2d(x, window))
    assert got.dtype == x.dtype
    assert avg_pool_nhwc.launches == launches


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_window_one_returns_the_input_with_no_launch(device):
    x = torch.empty((2, 64, 56, 56), device=device).contiguous(
        memory_format=torch.channels_last)
    launches = avg_pool_nhwc.launches
    assert avg_pool_nhwc(x, 1) is x
    assert avg_pool_nhwc.launches == launches


def test_a_window_below_one_is_refused():
    with pytest.raises(ValueError, match="window 0"):
        avg_pool_nhwc(torch.zeros((1, 8, 4, 4)), 0)


def test_the_meta_device_takes_the_plain_version():
    """A tower built on the meta device (the reference's count of the
    port's products) pools by shape alone, with no launch."""
    x = torch.empty((2, 64, 15, 13), device="meta").contiguous(
        memory_format=torch.channels_last)
    launches = avg_pool_nhwc.launches
    got = avg_pool_nhwc(x, 2)
    assert got.device.type == "meta" and got.shape == (2, 64, 7, 6)
    assert avg_pool_nhwc.launches == launches


@pytest.mark.parametrize("channels,dtype,pointers,want", [
    (64, torch.bfloat16, (0, 4096), 8),
    (64, torch.float16, (16, 32), 8),
    (64, torch.float32, (0, 0), 4),
    (4, torch.float32, (0, 0), 4),
    (20, torch.bfloat16, (0, 0), 1),
    (3, torch.float32, (0, 0), 1),
    (64, torch.bfloat16, (2, 0), 1),
    (64, torch.float32, (0, 8), 1),
], ids=["bf16", "fp16", "fp32", "fp32-c4", "bf16-c20", "fp32-c3",
        "x-off-16", "out-off-16"])
def test_vector_width_from_channels_dtype_and_pointers(channels, dtype,
                                                       pointers, want):
    assert cuda_pool.vector_width(channels, dtype, *pointers) == want


def test_rn50_has_seven_pools_above_window_one():
    """On the full RN50 (built on the meta device): the stem's pool and
    two a strided block; layer1's first block pools at window 1."""
    with torch.device("meta"):
        visual = CLIP(RN50, fold_bn=True).visual
    blocks = list(visual.blocks())
    assert 1 + sum(b.pools for b in blocks) == RN50_POOLS
    assert blocks[0].stride == 1 and blocks[0].pools == 0
    assert [b.pools for b in blocks if b.stride > 1] == [2, 2, 2]


@pytest.mark.parametrize("dtype,fold_bn", [
    (torch.float32, True), (torch.bfloat16, True), (torch.float32, False)],
    ids=["fp32-folded", "bf16-folded", "fp32-unfolded"])
def test_counters_once_a_forward_none_in_the_kernel_on_the_cpu(dtype,
                                                               fold_bn):
    model = TorchCLIP(TINY_RN50, init_random_state_dict(TINY_RN50, seed=0),
                      compute_dtype=dtype, attention_impl="xla",
                      fold_bn=fold_bn, device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    launches = avg_pool_nhwc.launches
    timer = PhaseTimer()
    with timer.active():
        for _ in range(3):
            model.encode_image_batch(images)
    assert timer.totals["resnet.pools"] == 3 * RN50_POOLS
    assert timer.totals["resnet.kernel_pools"] == 0
    assert timer.counts["resnet.pools"] == timer.counts[
        "resnet.kernel_pools"] == 3
    assert {"resnet.pools", "resnet.kernel_pools"} <= timer.counters
    assert avg_pool_nhwc.launches == launches


@pytest.mark.parametrize("fold_bn,fused_resnet", [
    (True, False), (False, False), (True, True)],
    ids=["fold", "nofold", "fold-k5-route"])
def test_cpu_towers_match_the_torch_oracle(fold_bn, fused_resnet):
    sd = torch_clip.synth_state_dict(TINY_TWO, seed=4)
    model = TorchCLIP(TINY_TWO, dict(sd), compute_dtype=torch.float32,
                      attention_impl="xla", fold_bn=fold_bn,
                      fused_resnet=fused_resnet, device="cpu")
    assert sum(b.fuse for b in model.module.visual.blocks()) == (
        2 if fused_resnet else 0)
    imgs = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = torch_clip.encode_image(
            sd, TINY_TWO, torch.from_numpy(imgs.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(model.encode_image_batch(imgs).numpy(),
                               want.numpy(), **TOL)


@pytest.mark.parametrize("fold_bn", [True, False], ids=["fold", "nofold"])
def test_state_dict_keys_are_openais(fold_bn):
    """The shortcut's Sequential keeps its ("-1", AvgPool2d) entry: the
    unfolded tower's keys are the OpenAI checkpoint's, the folded one's
    those less the BatchNorms."""
    model = CLIP(TINY_TWO, fold_bn=fold_bn)
    keys = set(model.state_dict())
    want = set(torch_clip.synth_state_dict(TINY_TWO))
    if fold_bn:
        want = set(resnet.fold_resnet_params(
            torch_clip.synth_state_dict(TINY_TWO)))
    assert keys == want
    for stage in range(1, 5):
        block = getattr(model.visual, f"layer{stage}")[0]
        names = [name for name, _ in block.downsample.named_children()]
        assert names[:2] == ["-1", "0"]
        assert isinstance(block.downsample[0], nn.AvgPool2d)
        assert block.downsample[0].kernel_size == block.stride


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the pool kernel runs only on the card")
    return resolve_device("cuda")


def _equal_on_card(x, window):
    launches = avg_pool_nhwc.launches
    got = avg_pool_nhwc(x, window)
    want = F.avg_pool2d(x, window)
    torch.cuda.synchronize()
    assert avg_pool_nhwc.launches == launches + 1
    assert got.shape == want.shape and got.dtype == x.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pool", sorted(RN50_POOL_SHAPES))
def test_kernel_bit_equal_at_the_rn50_shapes(card, pool, dtype):
    x = _nhwc((4, *RN50_POOL_SHAPES[pool]), DTYPES[dtype], 1, card)
    _equal_on_card(x, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["odd-hw", "window3", "c-off-16-bytes",
                                  "c3", "pointer-off-16", "nchw-input"])
def test_kernel_bit_equal_off_the_vector_path(card, case, dtype):
    dt = DTYPES[dtype]
    window = 3 if case == "window3" else 2
    if case in ("odd-hw", "window3"):
        x = _nhwc((3, 64, 15, 13), dt, 2, card)
    elif case == "c-off-16-bytes":
        x = _nhwc((3, 20, 14, 14), dt, 3, card)
    elif case == "c3":
        x = _nhwc((2, 3, 9, 9), dt, 4, card)
    elif case == "pointer-off-16":
        n, c, h, w = 2, 64, 10, 10
        flat = torch.randn(n * h * w * c + 1, device=card).to(dt)
        x = flat[1:].view(n, h, w, c).permute(0, 3, 1, 2)
        assert x.is_contiguous(memory_format=torch.channels_last)
        assert x.data_ptr() % cuda_pool.VECTOR_BYTES != 0
    else:
        x = _nhwc((2, 64, 12, 12), dt, 5, card).contiguous()
        assert not x.is_contiguous(memory_format=torch.channels_last)
    _equal_on_card(x, window)


@pytest.mark.cuda
def test_kernel_refusals(card):
    with pytest.raises(TypeError, match="kernel takes"):
        avg_pool_nhwc(torch.zeros((1, 8, 4, 4), dtype=torch.float64,
                                  device=card), 2)
    with pytest.raises(ValueError, match="leaves no output"):
        avg_pool_nhwc(torch.zeros((1, 8, 1, 4), device=card), 2)
    with pytest.raises(ValueError, match=r"\[N, C, H, W\]"):
        avg_pool_nhwc(torch.zeros((8, 4, 4), device=card), 2)


def _rn50_on_card(card):
    return TorchCLIP(RN50, init_random_state_dict(RN50, seed=0), device=card)


def _images(n, seed):
    return torch.randint(0, 256, (n, 224, 224, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))


@pytest.mark.cuda
def test_seven_launches_an_rn50_forward(card):
    model = _rn50_on_card(card)
    assert model.compute_dtype == torch.bfloat16
    x = torch.zeros((2, 64, 56, 56), dtype=torch.bfloat16, device=card)
    launches = avg_pool_nhwc.launches
    assert avg_pool_nhwc(x, 1) is x
    assert avg_pool_nhwc.launches == launches
    timer = PhaseTimer()
    with timer.active():
        model.encode_image_batch(_images(2, 0))
    torch.cuda.synchronize()
    assert avg_pool_nhwc.launches - launches == RN50_POOLS
    assert timer.totals["resnet.pools"] == RN50_POOLS
    assert timer.totals["resnet.kernel_pools"] == RN50_POOLS


@pytest.mark.cuda
def test_rn50_bf16_tower_bit_equal_with_avg_pool2d(card, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    model = _rn50_on_card(card)
    images = _images(8, 1)
    timer = PhaseTimer()
    with timer.active():
        got = model.encode_image_batch(images)

    def plain(x, window):
        return F.avg_pool2d(x, window)

    plain.launches = 0
    monkeypatch.setattr(resnet, "avg_pool_nhwc", plain)
    want = model.encode_image_batch(images)
    torch.cuda.synchronize()
    assert model.compute_dtype == torch.bfloat16
    assert timer.totals["resnet.kernel_pools"] == RN50_POOLS
    assert torch.equal(got, want)
