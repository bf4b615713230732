"""The CLIP transformers' QuickGELU (``ops/cuda_gelu.quick_gelu``, the
kernel ``csrc/quick_gelu.cu``, routed from ``models/clip/layers.py``).

On the CPU: the wrapper is the plain chain ``x * sigmoid(1.702 x)`` there,
bit for bit, in every dtype and with no launch; on the meta device it
gives the chain's shape and dtype; ``QuickGELU`` and every transformer
block go through it; a ViT forward counts one MLP activation a layer
(``vit.mlp_activations``) and none in the kernel
(``vit.kernel_activations``), and counts a stand-in launch of the card's
route as one; the text tower counts nothing.

``cuda``-marked (each skips without a GPU; run on a machine with one:
``python -m pytest tests/test_torch_clip_quick_gelu.py -m cuda``): the
kernel bit-equal to the chain in fp32, bf16 and fp16 at a size that fills
whole 16-byte packs, at odd sizes that leave a tail, below one pack, on a
view at storage offset 1 (off 16 bytes: the one-element path) and on a
non-contiguous input; an empty tensor launches nothing; a dtype it does
not take raises; and a bf16 ViT forward on the card runs every MLP
activation in the kernel."""

import numpy as np
import pytest
import torch

from transductive_clip_tpu_torch.core.profiling import PhaseTimer
from transductive_clip_tpu_torch.models.clip import TorchCLIP, layers
from transductive_clip_tpu_torch.models.clip.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from transductive_clip_tpu_torch.models.clip.model import (
    init_random_state_dict,
)
from transductive_clip_tpu_torch.ops.common import resolve_device
from transductive_clip_tpu_torch.ops.cuda_gelu import (
    quick_gelu,
    quick_gelu_reference,
)

torch.set_num_threads(2)

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16}
# the integer type of each dtype's width, to compare bits (-0.0 included)
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
        torch.float16: torch.int16}
# a ViT with ViT-L/14's patch and heads of 64 at a size the CPU runs in a
# moment (17 tokens, 3 layers; text 2 layers)
TINY = CLIPConfig(
    name="tiny-vit-gelu", embed_dim=64,
    vision=CLIPVisionConfig(image_size=56, patch_size=14, width=128,
                            layers=3, heads=2),
    text=CLIPTextConfig(vocab_size=64, context_length=8, width=64,
                        layers=2, heads=1))


def _values(n, dtype, seed, device="cpu"):
    """n values of ``dtype``: normal at the MLP hidden's scale, widened
    tails, and the edges of the sigmoid (0, -0, where exp over- and
    underflows) at the front."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g) * 3.0
    edges = torch.tensor([0.0, -0.0, 60.0, -60.0, 1e4, -1e4, 0.5, -0.5])
    k = min(n, len(edges))
    x[:k] = edges[:k]
    return x.to(dtype).to(device)


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(BITS[a.dtype]),
        b.contiguous().view(BITS[b.dtype]))


# -- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(4, 17, 512), (1001,), (3,)],
                         ids=["hidden", "odd", "below-a-pack"])
def test_wrapper_is_the_plain_chain_on_the_cpu(shape, dtype):
    dt = DTYPES[dtype]
    x = _values(int(np.prod(shape)), dt, 0).reshape(shape)
    launches = quick_gelu.launches
    got = quick_gelu(x)
    assert _same_bits(got, x * torch.sigmoid(1.702 * x))
    assert _same_bits(got, quick_gelu_reference(x))
    assert quick_gelu.launches == launches


def test_other_dtypes_take_the_chain_off_the_card():
    x = _values(100, torch.float64, 1)
    assert torch.equal(quick_gelu(x), x * torch.sigmoid(1.702 * x))


def test_the_meta_device_takes_the_plain_version():
    """A tower built on the meta device (the reference's count of the
    port's products) runs its activations by shape alone, with no
    launch."""
    x = torch.empty((2, 577, 4096), dtype=torch.bfloat16, device="meta")
    launches = quick_gelu.launches
    got = quick_gelu(x)
    assert got.device.type == "meta"
    assert got.shape == x.shape and got.dtype == x.dtype
    assert quick_gelu.launches == launches


def test_quick_gelu_module_and_blocks_route_through_the_wrapper(monkeypatch):
    seen = []

    def spy(x):
        seen.append(tuple(x.shape))
        return quick_gelu_reference(x)

    monkeypatch.setattr(layers, "quick_gelu", spy)
    x = _values(2 * 5 * 32, torch.float32, 2).reshape(2, 5, 32)
    assert _same_bits(layers.QuickGELU()(x), quick_gelu_reference(x))
    assert seen == [(2, 5, 32)]
    seen.clear()
    transformer = layers.Transformer(32, 3, 2)
    for p in transformer.parameters():
        torch.nn.init.normal_(p, std=0.05)
    with torch.no_grad():
        transformer(x)
    assert seen == [(2, 5, 128)] * 3


def _tiny_model(device, dtype=torch.float32, attention="xla"):
    return TorchCLIP(TINY, init_random_state_dict(TINY, seed=0),
                     compute_dtype=dtype, attention_impl=attention,
                     device=device)


def _images(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, TINY.vision.image_size, TINY.vision.image_size, 3),
        dtype=np.uint8)


def test_each_forward_counts_its_activations_and_no_kernel_on_the_cpu():
    model = _tiny_model("cpu")
    launches = quick_gelu.launches
    timer = PhaseTimer()
    with timer.active():
        for _ in range(3):
            model.encode_image_batch(_images(2, 0))
        with torch.no_grad():
            model.module.encode_text(torch.randint(
                0, TINY.text.vocab_size, (2, TINY.text.context_length)))
    # the text tower counts nothing
    assert timer.totals["vit.mlp_activations"] == 3 * TINY.vision.layers
    assert timer.totals["vit.kernel_activations"] == 0
    assert timer.counts["vit.mlp_activations"] == timer.counts[
        "vit.kernel_activations"] == 3
    assert {"vit.mlp_activations", "vit.kernel_activations"} <= timer.counters
    assert quick_gelu.launches == launches


def test_kernel_activations_count_the_launches_in_the_forward(monkeypatch):
    """The card's route stood in for on the CPU: each activation bumps the
    kernel's launch counter and runs the plain chain.
    ``vit.kernel_activations`` counts those launches, one a layer a
    forward."""

    def on_card(x):
        quick_gelu.launches += 1
        return quick_gelu_reference(x)

    monkeypatch.setattr(layers, "quick_gelu", on_card)
    monkeypatch.setattr(quick_gelu, "launches", quick_gelu.launches)
    model = _tiny_model("cpu")
    timer = PhaseTimer()
    with timer.active():
        for _ in range(2):
            model.encode_image_batch(_images(2, 1))
    assert timer.totals["vit.mlp_activations"] == 2 * TINY.vision.layers
    assert timer.totals["vit.kernel_activations"] == 2 * TINY.vision.layers


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the QuickGELU kernel runs only on the "
                    "card")
    return resolve_device("cuda")


def _equal_on_card(x):
    launches = quick_gelu.launches
    got = quick_gelu(x)
    want = quick_gelu_reference(x)
    torch.cuda.synchronize()
    assert quick_gelu.launches == launches + 1
    assert got.is_contiguous()
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [64 * 577 * 16, 1_000_003, 8 * 1024 * 4 + 5, 7,
                               1],
                         ids=["whole-packs", "odd", "one-block-and-tail",
                              "below-a-pack", "one"])
def test_kernel_bit_equal_to_the_chain(card, n, dtype):
    _equal_on_card(_values(n, DTYPES[dtype], 3, card))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_bit_equal_at_a_hidden_shape(card, dtype):
    x = _values(8 * 197 * 3072, DTYPES[dtype], 4, card).reshape(8, 197, 3072)
    _equal_on_card(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_bit_equal_off_16_bytes(card, dtype):
    flat = _values(4097 * 3 + 1, DTYPES[dtype], 5, card)
    x = flat[1:].view(3, 4097)
    assert x.is_contiguous() and x.storage_offset() == 1
    assert x.data_ptr() % 16 != 0
    _equal_on_card(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_bit_equal_on_a_strided_input(card, dtype):
    x = _values(64 * 96, DTYPES[dtype], 6, card).reshape(64, 96).t()
    assert not x.is_contiguous()
    _equal_on_card(x)


@pytest.mark.cuda
def test_an_empty_tensor_launches_nothing(card):
    x = torch.empty((0, 4096), dtype=torch.bfloat16, device=card)
    launches = quick_gelu.launches
    got = quick_gelu(x)
    assert got.shape == (0, 4096) and got.dtype == torch.bfloat16
    assert got.device.type == "cuda"
    assert quick_gelu.launches == launches


@pytest.mark.cuda
def test_a_dtype_the_kernel_does_not_take_raises(card):
    launches = quick_gelu.launches
    with pytest.raises(TypeError, match="kernel takes"):
        quick_gelu(torch.zeros(16, dtype=torch.float64, device=card))
    assert quick_gelu.launches == launches


@pytest.mark.cuda
def test_every_mlp_activation_of_a_vit_forward_runs_in_the_kernel(card):
    model = _tiny_model(card, dtype=torch.bfloat16, attention="fused")
    launches = quick_gelu.launches
    timer = PhaseTimer()
    with timer.active():
        model.encode_image_batch(_images(2, 2))
    torch.cuda.synchronize()
    assert timer.totals["vit.mlp_activations"] == TINY.vision.layers
    assert timer.totals["vit.kernel_activations"] == TINY.vision.layers
    assert quick_gelu.launches == launches + TINY.vision.layers
