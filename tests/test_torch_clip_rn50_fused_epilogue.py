"""The ResNet towers' fused convolution epilogue (models/clip/resnet.py):
folded, on the card, in a 16-bit dtype, each convolution whose channels
are multiples of 8 runs with its bias, its ReLU and, for ``conv3``, the
residual add inside cuDNN's epilogue, and a downsampling block's shortcut
convolution runs bias-free with its bias added into ``conv3``'s.

On the CPU: the gate's decision at every RN50 convolution for each device,
dtype and fold state; the fused route's wiring (the bias-free shortcut and
the combined bias) against the plain graph in fp64, with cuDNN's two fused
ops stood in for by their plain definitions; the combined bias made at
load in fp32 and outside the state dict; the counters ``resnet.convs`` and
``resnet.fused_convs``, recorded once a forward, through the extraction's
timer to the benchmark's reader of ``fused_conv_share.rn50``.

``cuda``-marked (each skips without a GPU; run on a machine with one:
``python -m pytest tests/test_torch_clip_rn50_fused_epilogue.py -m
cuda``): every RN50 block shape in bf16 at batch 8 against the plain graph
within the bf16 limit of tests/test_torch_clip_kernels.py (2e-2 of the
plain output's largest magnitude); the whole bf16 tower against its plain
route on softmax features, by the extraction cell's ``log_softmax_gap``;
the fp32 tower bit-equal to the plain graph."""

import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from transductive_clip_tpu_torch.core.profiling import PhaseTimer
from transductive_clip_tpu_torch.eval import extraction
from transductive_clip_tpu_torch.models.clip import resnet
from transductive_clip_tpu_torch.models.clip.config import (
    CLIP_CONFIGS,
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from transductive_clip_tpu_torch.models.clip.model import (
    CLIP,
    TorchCLIP,
    init_random_state_dict,
)
from transductive_clip_tpu_torch.models.clip.resnet import (
    Bottleneck,
    fused_epilogue_supported,
)
from transductive_clip_tpu_torch.ops.common import resolve_device

torch.set_num_threads(2)

RN50 = CLIP_CONFIGS["RN50"]
TINY = CLIPConfig(
    name="tiny-rn",
    embed_dim=32,
    vision=CLIPVisionConfig(image_size=32, width=16, heads=4, is_resnet=True,
                            resnet_layers=(1, 1, 1, 1)),
    text=CLIPTextConfig(vocab_size=64, context_length=8, width=32, layers=1,
                        heads=4),
)
# RN50's convolutions: 3 in the stem, 3 in each of 16 blocks, and the 4
# shortcut convolutions; all but the stem's first (3 input channels) take
# the fused epilogue in bf16 on the card
RN50_CONVS, RN50_FUSED = 55, 54
# the bf16 limit of tests/test_torch_clip_kernels.py
BF16_LIMIT = 2e-2
# the extraction cell's limit on |log p - log p_plain| (configs/clip_rn50)
LOG_GAP_LIMIT = 0.2
T = 30.0
READER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark", "metrics", "fused_conv_share.rn50.py")


def _rn50_convs():
    """(name, Conv2d) of RN50's image tower, built on the meta device."""
    with torch.device("meta"):
        visual = CLIP(RN50, fold_bn=True).visual
    return [(name, m) for name, m in visual.named_modules()
            if isinstance(m, nn.Conv2d)]


@pytest.mark.parametrize("device,dtype,folded,takes", [
    ("cuda", torch.bfloat16, True, True),
    ("cuda", torch.float16, True, True),
    ("cuda", torch.float32, True, False),
    ("cuda", torch.bfloat16, False, False),
    ("cpu", torch.bfloat16, True, False),
    ("cpu", torch.float32, True, False),
], ids=["cuda-bf16-folded", "cuda-fp16-folded", "cuda-fp32-folded",
        "cuda-bf16-unfolded", "cpu-bf16-folded", "cpu-fp32-folded"])
def test_gate_at_every_rn50_convolution(device, dtype, folded, takes):
    convs = _rn50_convs()
    assert len(convs) == RN50_CONVS
    admitted = [name for name, conv in convs if fused_epilogue_supported(
        device, folded, dtype, conv.in_channels, conv.out_channels)]
    if not takes:
        assert admitted == []
        return
    assert len(admitted) == RN50_FUSED
    assert {name for name, _ in convs} - set(admitted) == {"conv1"}


@pytest.mark.parametrize("channels,takes", [
    ((3, 32), False), ((32, 32), True), ((64, 256), True), ((20, 32), False),
    ((32, 12), False), ((2048, 2048), True)])
def test_gate_wants_channels_in_multiples_of_8(channels, takes):
    assert fused_epilogue_supported(torch.device("cuda:0"), True,
                                    torch.bfloat16, *channels) == takes


def _random_block(inplanes, planes, stride, downsample, dtype=torch.float64,
                  seed=0):
    torch.manual_seed(seed)
    block = Bottleneck(inplanes, planes, stride, downsample=downsample,
                       fold_bn=True)
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.2)
    return block.to(dtype)


def _cudnn_as_plain(monkeypatch):
    """cuDNN's two fused ops by their definitions, so that the fused
    route's wiring runs on the CPU."""
    def conv_relu(x, w, b, stride, padding, dilation, groups):
        return F.relu(F.conv2d(x, w, b, stride, padding, dilation, groups))

    def conv_add_relu(x, w, z, alpha, b, stride, padding, dilation, groups):
        return F.relu(F.conv2d(x, w, b, stride, padding, dilation, groups)
                      + alpha * z)

    monkeypatch.setattr(torch, "cudnn_convolution_relu", conv_relu)
    monkeypatch.setattr(torch, "cudnn_convolution_add_relu", conv_add_relu)


@pytest.mark.parametrize("inplanes,planes,stride,downsample", [
    (16, 8, 1, True), (32, 16, 2, True), (64, 16, 1, False)],
    ids=["layer1-first", "strided-first", "identity"])
def test_fused_route_wiring_matches_plain_graph_fp64(
        monkeypatch, inplanes, planes, stride, downsample):
    """conv3 plus the bias-free shortcut plus the combined bias is the
    plain block, to fp64 rounding."""
    _cudnn_as_plain(monkeypatch)
    block = _random_block(inplanes, planes, stride, downsample)
    block.prepare_epilogue_bias()
    x = torch.randn(2, inplanes, 8, 8, dtype=torch.float64).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        want, convs, fused = block.run(x)
        got = block._fused_epilogue(x)
    assert fused == 0 and convs == 3 + downsample
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    if downsample:
        # the shortcut's bias reaches the output only through residual_bias
        with torch.no_grad():
            block.downsample[1].bias.add_(1.0)
        torch.testing.assert_close(block._fused_epilogue(x), got)


def test_combined_bias_made_once_and_kept_out_of_the_state_dict():
    block = _random_block(32, 16, 2, True, dtype=torch.float32)
    keys = set(block.state_dict())
    with pytest.raises(RuntimeError, match="prepare_epilogue_bias"):
        block._fused_epilogue(torch.zeros(1, 32, 8, 8))
    block.prepare_epilogue_bias()
    assert set(block.state_dict()) == keys
    want = block.conv3.bias + block.downsample[1].bias
    torch.testing.assert_close(block.residual_bias, want, rtol=0, atol=0)
    assert block.to(torch.bfloat16).residual_bias.dtype == torch.bfloat16
    identity = _random_block(64, 16, 1, False)
    identity.prepare_epilogue_bias()
    assert identity.residual_bias is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_load_sums_the_bias_in_fp32_before_the_cast(dtype):
    """TorchCLIP makes every downsampling block's combined bias at load,
    from the folded fp32 biases, rounded once to the compute dtype; the
    state dict keeps OpenAI's keys and the folded values."""
    sd = init_random_state_dict(TINY, seed=3)
    model = TorchCLIP(TINY, sd, compute_dtype=dtype, attention_impl="xla",
                      device="cpu")
    folded = resnet.fold_resnet_params(sd)
    for stage in range(1, 5):
        p = f"visual.layer{stage}.0"
        block = getattr(model.module.visual, f"layer{stage}")[0]
        want = (folded[f"{p}.conv3.bias"].float()
                + folded[f"{p}.downsample.0.bias"].float()).to(dtype)
        assert torch.equal(block.residual_bias, want)
    got = model.module.state_dict()
    assert set(got) == set(CLIP(TINY, fold_bn=True).state_dict())
    assert torch.equal(got["visual.layer2.0.downsample.0.bias"],
                       folded["visual.layer2.0.downsample.0.bias"].to(dtype))


@pytest.mark.parametrize("dtype,fold_bn", [
    (torch.float32, True), (torch.bfloat16, True), (torch.float32, False)],
    ids=["fp32-folded", "bf16-folded", "fp32-unfolded"])
def test_counters_once_a_forward_none_fused_on_the_cpu(dtype, fold_bn):
    """Each forward records resnet.convs (3 + 4 blocks x 3 + 4 shortcuts)
    and resnet.fused_convs (0 on the CPU) once each."""
    model = TorchCLIP(TINY, init_random_state_dict(TINY, seed=0),
                      compute_dtype=dtype, attention_impl="xla",
                      fold_bn=fold_bn, device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    timer = PhaseTimer()
    with timer.active():
        for _ in range(3):
            model.encode_image_batch(images)
    assert timer.totals["resnet.convs"] == 3 * 19
    assert timer.totals["resnet.fused_convs"] == 0
    assert timer.counts["resnet.convs"] == timer.counts[
        "resnet.fused_convs"] == 3
    assert {"resnet.convs", "resnet.fused_convs"} <= timer.counters
    idle = PhaseTimer()
    model.encode_image_batch(images)
    assert not idle.totals


def _reader():
    spec = importlib.util.spec_from_file_location("fused_conv_share_rn50",
                                                  READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("phases,want", [
    ({"resnet.convs": 2 * RN50_CONVS, "resnet.fused_convs": 2 * RN50_FUSED},
     100.0 * RN50_FUSED / RN50_CONVS),
    ({"resnet.convs": 19.0, "resnet.fused_convs": 0.0}, 0.0),
    ({"extract.encode": 1.0, "host_wait": 0.1}, None),
    ({}, None)], ids=["rn50-bf16-card", "cpu", "no-counters", "empty"])
def test_the_share_reader(phases, want):
    got = _reader()({"passes": 2, "phases": phases})
    assert got == (None if want is None else pytest.approx(want))


def test_an_extraction_pass_carries_the_counters_to_the_reader():
    model = TorchCLIP(TINY, init_random_state_dict(TINY, seed=0),
                      compute_dtype=torch.float32, attention_impl="xla",
                      device="cpu")
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
                np.arange(n)) for n in (3, 2)]
    text = rng.normal(size=(5, TINY.embed_dim)).astype(np.float32)
    timer = PhaseTimer()
    with timer.active():
        extraction.extract_to_caches(model, batches, [(T, "x")], text,
                                     write=False)
    assert timer.totals["resnet.convs"] == 2 * 19
    assert _reader()({"phases": dict(timer.totals)}) == 0.0


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: cuDNN's fused epilogue runs only on "
                    "the card")
    return resolve_device("cuda")     # TF32 off for the plain graph


def _plain_graph(monkeypatch):
    """Every convolution on the plain graph: the gate refuses all."""
    monkeypatch.setattr(resnet, "fused_epilogue_supported",
                        lambda *args: False)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


# RN50's blocks: (inplanes, planes, stride, downsample, input H = W)
RN50_BLOCKS = {
    "layer1.0": (64, 64, 1, True, 56), "layer1.1": (256, 64, 1, False, 56),
    "layer2.0": (256, 128, 2, True, 56), "layer2.1": (512, 128, 1, False, 28),
    "layer3.0": (512, 256, 2, True, 28),
    "layer3.1": (1024, 256, 1, False, 14),
    "layer4.0": (1024, 512, 2, True, 14),
    "layer4.1": (2048, 512, 1, False, 7),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RN50_BLOCKS))
def test_rn50_block_bf16_fused_matches_plain(card, monkeypatch, name):
    inplanes, planes, stride, downsample, hw = RN50_BLOCKS[name]
    torch.manual_seed(0)
    block = Bottleneck(inplanes, planes, stride, downsample=downsample,
                       fold_bn=True)
    with torch.no_grad():
        for conv in (m for m in block.modules()
                     if isinstance(m, nn.Conv2d)):
            fan_in = conv.in_channels * conv.kernel_size[0] ** 2
            conv.weight.normal_(0.0, (2.0 / fan_in) ** 0.5)
            conv.bias.normal_(0.0, 0.1)
    block.prepare_epilogue_bias()
    block = block.to(card, torch.bfloat16)
    x = torch.randn(8, inplanes, hw, hw, device=card).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got, convs, fused = block.run(x)
        _plain_graph(monkeypatch)
        want, _, plain = block.run(x)
    torch.cuda.synchronize()
    assert fused == convs == 3 + downsample and plain == 0
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert _rel(got, want) < BF16_LIMIT


def _softmax(model, images, text):
    img = model.encode_image_batch(images)
    img = img / img.norm(dim=-1, keepdim=True)
    return torch.softmax(T * img @ text.t(), dim=-1)


@pytest.mark.cuda
def test_rn50_tower_bf16_fused_matches_plain_route(card, monkeypatch):
    model = TorchCLIP(RN50, init_random_state_dict(RN50, seed=0),
                      device=card)
    images = torch.randint(0, 256, (16, 224, 224, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    text = torch.randn(100, RN50.embed_dim, device=card,
                       generator=torch.Generator(card).manual_seed(1))
    text = text / text.norm(dim=-1, keepdim=True)
    timer = PhaseTimer()
    with torch.no_grad(), timer.active():
        got = _softmax(model, images, text)
    with torch.no_grad():
        _plain_graph(monkeypatch)
        want = _softmax(model, images, text)
    torch.cuda.synchronize()
    assert timer.totals["resnet.convs"] == RN50_CONVS
    assert timer.totals["resnet.fused_convs"] == RN50_FUSED
    gap = (got.clamp_min(1e-30).log()
           - want.clamp_min(1e-30).log()).abs().max().item()
    assert gap < LOG_GAP_LIMIT / 2


@pytest.mark.cuda
def test_rn50_tower_fp32_bit_equal_to_plain_graph(card, monkeypatch):
    model = TorchCLIP(RN50, init_random_state_dict(RN50, seed=0),
                      compute_dtype=torch.float32, device=card)
    images = torch.randint(0, 256, (8, 224, 224, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    timer = PhaseTimer()
    with timer.active():
        got = model.encode_image_batch(images)
    _plain_graph(monkeypatch)
    want = model.encode_image_batch(images)
    torch.cuda.synchronize()
    assert timer.totals["resnet.fused_convs"] == 0
    assert torch.equal(got, want)
