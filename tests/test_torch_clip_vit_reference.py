"""The port's ViT CLIP against the benchmark's plain ViT-L/14@336px
reference (benchmark/reference/clip_vit_l14_336.py, plain torch), on the
CPU with seeded random weights laid out by the reference, at a tiny size
with ViT-L/14@336px's structure (patch 14, heads of 64, QuickGELU, pre-LN
blocks, the class token pooled): the fp32 towers agree within the tower
tests' tolerance on both attention routes; the bf16 program stays within a
looser one that the fp8 control and rows handed to the wrong image do not
meet; the reference's layout at ViT-L/14@336px's published widths is the
port's state dict; its count of an image's products equals a count taken
from the port's own shapes; each forward counts its attention modules and
no kernel launch on the CPU, and a launch of either kernel where one ran;
and the reference's images are distinct smooth
fields at 336 px."""

import dataclasses
import importlib.util
import os
import sys

import pytest
import torch
from torch import nn

from transductive_clip_tpu_torch.core.profiling import PhaseTimer
from transductive_clip_tpu_torch.models.clip import layers
from transductive_clip_tpu_torch.models.clip.config import (
    CLIP_CONFIGS,
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from transductive_clip_tpu_torch.models.clip.layers import MultiHeadAttention
from transductive_clip_tpu_torch.models.clip.model import CLIP, TorchCLIP
from transductive_clip_tpu_torch.ops import cuda_attention
from transductive_clip_tpu_torch.ops.cuda_attention import attention_blocked

from test_torch_clip_rn50_reference import (
    TOL,
    T,
    _inputs,
    _log_gap,
    _program_softmax,
    _state_dict,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
# the bf16 program against the fp32 reference, as the extraction cell
# compares them: the widest |log p - log p_ref|, on the reference's own
# images. On seeds 0-11 of this tiny tower it reads 0.069-0.198 (bf16's
# 8-bit mantissa through the normalisation, the patch embedding, three
# blocks and the projection, against a 64-wide embedding); the fp8 control
# (every product's operands in e4m3, a 3-bit mantissa) reads 0.99-1.96, and
# the program's rows moved by one image 4.90-11.94. The limit sits between
# the program and the two that must fail it, 2x from the program and 2.5x
# from the control
BF16_LOG_GAP = 0.4
L14_336 = "ViT-L/14@336px"

# ViT-L/14@336px's structure at a size the CPU runs in a second: 56 px in
# patches of 14 (17 tokens), heads of 64, three layers
TINY = CLIPConfig(
    name="tiny-vit-l14",
    embed_dim=64,
    vision=CLIPVisionConfig(image_size=56, patch_size=14, width=128,
                            layers=3, heads=2),
    text=CLIPTextConfig(vocab_size=512, context_length=16, width=64,
                        layers=2, heads=1),
)


def _cfg_dict(cfg):
    """The benchmark configuration's fields of a port config."""
    v, t = cfg.vision, cfg.text
    return {"embed_dim": cfg.embed_dim, "T": T,
            "vision": {"image_size": v.image_size,
                       "patch_size": v.patch_size, "width": v.width,
                       "layers": v.layers, "heads": v.heads},
            "text": {"width": t.width, "layers": t.layers, "heads": t.heads,
                     "context_length": t.context_length,
                     "vocab_size": t.vocab_size}}


def load_reference():
    """benchmark/reference/clip_vit_l14_336.py, loaded by path (it finds
    the benchmark's harness and the references it builds on while it
    loads)."""
    sys.path.insert(0, BENCH)
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_reference_clip_vit_l14_336_under_test",
            os.path.join(BENCH, "reference", "clip_vit_l14_336.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(BENCH)
    return mod


@pytest.fixture(scope="module")
def ref():
    return load_reference()


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fp32_program_matches_the_reference(ref, impl, seed):
    cfg = _cfg_dict(TINY)
    sd = _state_dict(ref, cfg, seed)
    images = ref.images(seed, 6, TINY.vision.image_size, "cpu")
    _, tokens = _inputs(seed, TINY)
    model = TorchCLIP(TINY, sd, compute_dtype=torch.float32,
                      attention_impl=impl, device="cpu")
    assert model.attention_impl == impl
    with torch.no_grad():
        want = ref.image_features(sd, images, TINY.vision.patch_size,
                                  TINY.vision.layers, TINY.vision.heads)
    torch.testing.assert_close(model.encode_image_batch(images), want, **TOL)
    torch.testing.assert_close(_program_softmax(model, images, tokens),
                               ref.softmax(cfg, sd, tokens, images, block=4),
                               **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_program_within_its_tolerance_and_fp8_control_outside(ref, seed):
    cfg = _cfg_dict(TINY)
    sd = _state_dict(ref, cfg, seed, torch.bfloat16)
    images = ref.images(seed, 6, TINY.vision.image_size, "cpu")
    _, tokens = _inputs(seed, TINY)
    model = TorchCLIP(TINY, sd, device="cpu")
    assert model.compute_dtype == torch.bfloat16
    want = ref.softmax(cfg, sd, tokens, images)
    got = _program_softmax(model, images, tokens)
    assert _log_gap(got, want) <= BF16_LOG_GAP
    control = ref.softmax(cfg, sd, tokens, images, quant=ref.CONTROL)
    assert _log_gap(control, want) > BF16_LOG_GAP
    # the program's rows handed to the wrong image
    assert _log_gap(got.roll(1, 0), want) > BF16_LOG_GAP


def test_layout_is_the_ports_vit_l14_336_state_dict(ref):
    """Every key and shape of ViT-L/14@336px at its published widths,
    built on the meta device (no memory)."""
    cfg = CLIP_CONFIGS[L14_336]
    with torch.device("meta"):
        port = CLIP(cfg).state_dict()
    laid = {key: tuple(shape) for key, shape, _, _ in
            ref.layout(_cfg_dict(cfg))}
    assert set(laid) | {"logit_scale"} == set(port)
    assert all(laid[k] == tuple(port[k].shape) for k in laid)
    assert laid["visual.positional_embedding"] == (577, 1024)


@pytest.mark.parametrize("name", [L14_336, "ViT-L/14", "ViT-B/16"])
def test_image_flops_equal_a_count_of_the_ports_products(ref, name):
    """2 x output elements x fan-in of every convolution and linear layer
    the port's tower runs on one image (forward hooks, meta device), the
    fused qkv projection and the scores and weighted sum of every attention
    module from its input's shape, and the final projection from its
    weight's."""
    cfg = CLIP_CONFIGS[name]
    with torch.device("meta"):
        tower = CLIP(cfg).visual
    counted = []

    def linear(mod, _, out):
        fan_in = (mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
                  if isinstance(mod, nn.Conv2d) else mod.in_features)
        counted.append(2 * out.numel() * fan_in)

    def attention(mod, args, _):
        b, n, width = args[0].shape
        counted.append(2 * b * n * mod.in_proj_weight.numel())
        counted.append(2 * 2 * b * n * n * width)

    for mod in tower.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            mod.register_forward_hook(linear)
        elif isinstance(mod, MultiHeadAttention):
            mod.register_forward_hook(attention)
    size = cfg.vision.image_size
    with torch.no_grad():
        tower(torch.empty(1, 3, size, size, device="meta"))
    want = sum(counted) + 2 * tower.proj.numel()
    got = ref.work_counts(_cfg_dict(cfg), [512])["image_flops"]
    assert got == want
    if name == L14_336:
        assert want == 381_919_789_056


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_each_forward_counts_its_attention_and_no_kernel_on_the_cpu(ref,
                                                                    impl):
    sd = _state_dict(ref, _cfg_dict(TINY), 0)
    model = TorchCLIP(TINY, sd, compute_dtype=torch.float32,
                      attention_impl=impl, device="cpu")
    images = ref.images(0, 2, TINY.vision.image_size, "cpu")
    launches = attention_blocked.launches
    timer = PhaseTimer()
    with timer.active():
        for _ in range(3):
            model.encode_image_batch(images)
        model.module.encode_text(_inputs(0, TINY)[1])
    # the text tower counts nothing
    assert timer.totals["vit.attention"] == 3 * TINY.vision.layers
    assert timer.totals["vit.kernel_attention"] == 0
    assert timer.counts["vit.attention"] == timer.counts[
        "vit.kernel_attention"] == 3
    assert {"vit.attention", "vit.kernel_attention"} <= timer.counters
    assert attention_blocked.launches == launches


@pytest.mark.parametrize("kernel", ["attention_rows", "attention_blocked"])
def test_kernel_attention_counts_the_launches_of_either_kernel(ref, kernel,
                                                               monkeypatch):
    """The card's route stood in for on the CPU: each attention module
    bumps the launch counter of the kernel ``attention_route`` would pick
    (K4a for n <= 128, as ViT-B/32's 50 tokens; K4b above) and runs the
    plain version. ``vit.kernel_attention`` counts those launches, one a
    layer a forward, whichever kernel it was."""
    bumped = getattr(cuda_attention, kernel)

    def on_card(qkv, heads, mask=None):
        bumped.launches += 1
        return cuda_attention.fused_attention_reference(qkv, heads, mask)

    monkeypatch.setattr(layers, "fused_attention", on_card)
    monkeypatch.setattr(bumped, "launches", bumped.launches)
    sd = _state_dict(ref, _cfg_dict(TINY), 0)
    model = TorchCLIP(TINY, sd, compute_dtype=torch.float32,
                      attention_impl="fused", device="cpu")
    images = ref.images(0, 2, TINY.vision.image_size, "cpu")
    timer = PhaseTimer()
    with timer.active():
        for _ in range(2):
            model.encode_image_batch(images)
    assert timer.totals["vit.attention"] == 2 * TINY.vision.layers
    assert timer.totals["vit.kernel_attention"] == 2 * TINY.vision.layers


def test_the_references_images_are_distinct_smooth_fields_at_336px(ref):
    """uint8 NHWC at ViT-L/14@336px's size, the same for the same seed,
    another for another; neighbouring pixels nearly agree, and two images
    differ in their mean colour."""
    a = ref.images(7, 4, 336, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (4, 336, 336, 3)
    assert torch.equal(a, ref.images(7, 4, 336, "cpu"))
    assert not torch.equal(a, ref.images(8, 4, 336, "cpu"))
    x = a.float()
    step = (x[:, 1:] - x[:, :-1]).abs().mean()
    assert step < 0.5 * (x - x.mean()).abs().mean()
    colour = x.mean(dim=(1, 2))                       # [4, 3]
    assert colour.std(dim=0).min() > 10
    flat = x.reshape(4, -1)
    assert all(not torch.equal(flat[i], flat[j])
               for i in range(4) for j in range(i + 1, 4))


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("size,kernel", [(56, "attention_rows"),
                                         (336, "attention_blocked")],
                         ids=["K4a-n17", "K4b-n577"])
def test_kernel_attention_counts_the_route_the_card_takes(ref, size, kernel):
    """The tiny tower in bf16 with attention 'fused' on the card: at 56 px
    (17 tokens) every layer runs K4a, at 336 px (577 tokens, ViT-L/14@336px's
    sequence) K4b; either way ``vit.kernel_attention`` equals
    ``vit.attention``, one a layer, and the kernel's own counter rose by as
    many."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the attention kernels run only on the "
                    "card")
    cfg = dataclasses.replace(TINY, vision=dataclasses.replace(
        TINY.vision, image_size=size))
    sd = _state_dict(ref, _cfg_dict(cfg), 0)
    model = TorchCLIP(cfg, sd, compute_dtype=torch.bfloat16,
                      attention_impl="fused", device="cuda")
    images = ref.images(0, 2, size, "cuda")
    launched = getattr(cuda_attention, kernel).launches
    timer = PhaseTimer()
    with timer.active():
        model.encode_image_batch(images)
    torch.cuda.synchronize()
    layers_run = cfg.vision.layers
    assert timer.totals["vit.attention"] == layers_run
    assert timer.totals["vit.kernel_attention"] == layers_run
    assert getattr(cuda_attention, kernel).launches == launched + layers_run
