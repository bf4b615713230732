"""The port's ModifiedResNet CLIP against the benchmark's plain RN50
reference (benchmark/reference/clip_rn50.py, plain torch, BatchNorm
unfolded), on the CPU with seeded random weights laid out by the
reference: the fp32 towers, BatchNorm folded and not, agree within the
tower tests' tolerance; the bf16 program stays within a looser one that
the fp8 control and rows handed to the wrong image do not meet; the
reference's images are smooth fields from the seed; the reference's layout at RN50's published
widths is the port's state dict; and its count of an image's products
equals a count taken from the port's own convolutions and projections."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

from transductive_clip_tpu_torch.models.clip.config import (
    CLIP_CONFIGS,
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from transductive_clip_tpu_torch.models.clip.model import CLIP, TorchCLIP

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
# fp32 on both sides, the same weights: only the order of the sums (and,
# folded, the fp64 fold rounded once to fp32) differs; the tolerance of the
# tower tests against the JAX package
TOL = dict(rtol=1e-4, atol=1e-4)
# the bf16 program against the fp32 reference, as the extraction cell
# compares them: the widest |log p - log p_ref|, on the reference's own
# images (``images``). On seeds 0-11 of this tiny tower it reads 0.09-0.25
# (bf16's 8-bit mantissa through the tower, the folded weights rounded to
# bf16, and a 32-wide embedding, against which a given error moves each
# cosine ~6x more than at RN50's 1,024); the fp8 control (every product's
# operands in e4m3, a 3-bit mantissa) reads 1.06-3.10, and the reference's
# rows moved by one image 1.87-4.91 (0.25-0.71 on uniform noise images).
# The limit sits between the program and the two that must fail it, ~2x
# from each
BF16_LOG_GAP = 0.5
T = 30.0

TINY = CLIPConfig(
    name="tiny-rn",
    embed_dim=32,
    vision=CLIPVisionConfig(image_size=64, width=16, heads=8, is_resnet=True,
                            resnet_layers=(1, 1, 1, 1)),
    text=CLIPTextConfig(vocab_size=512, context_length=16, width=32,
                        layers=2, heads=4),
)


def _cfg_dict(cfg):
    """The benchmark configuration's fields of a port config."""
    v, t = cfg.vision, cfg.text
    return {"embed_dim": cfg.embed_dim, "T": T,
            "vision": {"image_size": v.image_size, "width": v.width,
                       "heads": v.heads, "is_resnet": True,
                       "resnet_layers": list(v.resnet_layers)},
            "text": {"width": t.width, "layers": t.layers, "heads": t.heads,
                     "context_length": t.context_length,
                     "vocab_size": t.vocab_size}}


@pytest.fixture(scope="module")
def ref():
    """benchmark/reference/clip_rn50.py, loaded by path (it finds the
    benchmark's harness and its ViT reference on the path while it loads)."""
    sys.path.insert(0, BENCH)
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_reference_clip_rn50_under_test",
            os.path.join(BENCH, "reference", "clip_rn50.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(BENCH)
    return mod


def _state_dict(ref, cfg, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    sd = {key: (torch.randn(shape, generator=g) * std + offset).to(dtype)
          for key, shape, std, offset in ref.layout(cfg)}
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)), dtype=dtype)
    return sd


def _inputs(seed, cfg, n_img=6, n_prompt=24):
    """uint8 NHWC images and prompt token ids, the end-of-text token the
    highest id of each row (where the text tower pools)."""
    g = torch.Generator().manual_seed(seed + 1)
    size, t = cfg.vision.image_size, cfg.text
    images = torch.randint(0, 256, (n_img, size, size, 3), generator=g,
                           dtype=torch.uint8)
    tokens = torch.randint(1, t.vocab_size - 1, (n_prompt, t.context_length),
                           generator=g)
    lengths = torch.randint(2, t.context_length - 1, (n_prompt,),
                            generator=g)
    pos = torch.arange(t.context_length)
    tokens = torch.where(pos <= lengths[:, None], tokens, 0)
    tokens[torch.arange(n_prompt), lengths + 1] = t.vocab_size - 1
    return images, tokens


def _program_softmax(model, images, tokens):
    """The program's softmax features as the extraction computes them: its
    image and text towers, normalised, softmax at T in fp32."""
    with torch.no_grad():
        img = model.encode_image_batch(images)
        txt = model.module.encode_text(tokens).float()
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    return torch.softmax(T * img @ txt.t(), dim=-1)


def _log_gap(a, b):
    return float((a.clamp_min(1e-30).log()
                  - b.clamp_min(1e-30).log()).abs().max())


@pytest.mark.parametrize("fold_bn", [True, False], ids=["folded", "unfolded"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fp32_program_matches_the_reference(ref, fold_bn, seed):
    cfg = _cfg_dict(TINY)
    sd = _state_dict(ref, cfg, seed)
    images, tokens = _inputs(seed, TINY)
    model = TorchCLIP(TINY, sd, compute_dtype=torch.float32,
                      attention_impl="xla", fold_bn=fold_bn, device="cpu")
    with torch.no_grad():
        want = ref.image_features(sd, images, cfg)
    got = model.encode_image_batch(images)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(_program_softmax(model, images, tokens),
                               ref.softmax(cfg, sd, tokens, images, block=4),
                               **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_program_within_its_tolerance_and_fp8_control_outside(ref, seed):
    cfg = _cfg_dict(TINY)
    sd = _state_dict(ref, cfg, seed, torch.bfloat16)
    _, tokens = _inputs(seed, TINY)
    images = ref.images(seed, 6, TINY.vision.image_size, "cpu")
    model = TorchCLIP(TINY, sd, device="cpu")
    assert model.compute_dtype == torch.bfloat16 and model.fold_bn
    want = ref.softmax(cfg, sd, tokens, images)
    assert _log_gap(_program_softmax(model, images, tokens), want) \
        <= BF16_LOG_GAP
    control = ref.softmax(cfg, sd, tokens, images, quant=ref.CONTROL)
    assert _log_gap(control, want) > BF16_LOG_GAP
    # the program's rows handed to the wrong image
    assert _log_gap(_program_softmax(model, images, tokens).roll(1, 0),
                    want) > BF16_LOG_GAP


def test_the_references_images_are_smooth_fields_from_the_seed(ref):
    """uint8 NHWC, the same for the same seed, another for another; unlike
    uniform noise, neighbouring pixels nearly agree and two images differ
    in their mean colour."""
    a = ref.images(7, 5, 64, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (5, 64, 64, 3)
    assert torch.equal(a, ref.images(7, 5, 64, "cpu"))
    assert not torch.equal(a, ref.images(8, 5, 64, "cpu"))
    x = a.float()
    step = (x[:, 1:] - x[:, :-1]).abs().mean()
    assert step < 0.5 * (x - x.mean()).abs().mean()
    colour = x.mean(dim=(1, 2))                       # [5, 3]
    assert colour.std(dim=0).min() > 10


def test_layout_is_the_ports_rn50_state_dict(ref):
    """Every key and shape of RN50 at its published widths, BatchNorm's
    running statistics included, built on the meta device (no memory)."""
    rn50 = CLIP_CONFIGS["RN50"]
    with torch.device("meta"):
        port = CLIP(rn50, fold_bn=False).state_dict()
    laid = {key: tuple(shape) for key, shape, _, _ in
            ref.layout(_cfg_dict(rn50))}
    assert set(laid) | {"logit_scale"} == set(port)
    assert all(laid[k] == tuple(port[k].shape) for k in laid)
    assert all(offset > 5 * std for key, _, std, offset in
               ref.layout(_cfg_dict(rn50)) if key.endswith("running_var"))


@pytest.mark.parametrize("name", ["RN50", "RN101", "RN50x4"])
def test_image_flops_equal_a_count_of_the_ports_products(ref, name):
    """2 x output elements x fan-in of every convolution and projection
    the port's tower runs on one image (forward hooks, meta device), plus
    the attention pool's scores and weighted sum over its tokens."""
    cfg = CLIP_CONFIGS[name]
    with torch.device("meta"):
        tower = CLIP(cfg, fold_bn=False).visual
    counted = []

    def hook(mod, _, out):
        fan_in = (mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
                  if isinstance(mod, nn.Conv2d) else mod.in_features)
        counted.append(2 * out.numel() * fan_in)

    for mod in tower.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            mod.register_forward_hook(hook)
    size = cfg.vision.image_size
    with torch.no_grad():
        tower(torch.empty(1, 3, size, size, device="meta"))
    c, n = cfg.vision.width * 32, (size // 32) ** 2 + 1
    want = sum(counted) + 2 * 2 * n * c
    assert ref.work_counts(_cfg_dict(cfg), [512])["image_flops"] == want
    if name == "RN50":
        assert want == 11_586_306_048
