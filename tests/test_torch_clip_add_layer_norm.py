"""The CLIP transformers' residual add with the LayerNorm after it
(``ops/cuda_add_norm.add_layer_norm``, the kernel
``csrc/add_layer_norm.cu``, routed from ``models/clip/layers.Transformer``).

On the CPU: the wrapper is the plain pair there (``x + y``, then
``F.layer_norm``), bit for bit, in every dtype, with no launch and y left
as it was; on the meta device it gives the pair's shapes; the transformer
runs 2 x layers - 1 pairs through it and is bit-equal to the block-by-block
order it replaced (kept here as the reference); a ViT forward counts its
pairs (``vit.add_norms``) and none in the kernel (``vit.kernel_add_norms``),
and counts a stand-in launch of the card's route as one; OpenAI's
state-dict keys still load.

``cuda``-marked (each skips without a GPU; run on a machine with one:
``python -m pytest --noconftest tests/test_torch_clip_add_layer_norm.py -m
cuda``): s bit-equal to ``x + y`` and written over y; h within TOLERANCE of
an fp32 LayerNorm of s, at the towers' widths (512, 640, 768, 1024), at an
odd width, at a width below one warp, on pointers off 16 bytes, in fp32,
bf16 and fp16; an empty tensor launches nothing; a dtype the kernel does
not take, mixed dtypes and a row wider than the kernel holds raise; a bf16
ViT forward on the card runs every pair in the kernel, and an fp32 one
stays near the plain pair's."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transductive_clip_tpu_torch.core.profiling import PhaseTimer
from transductive_clip_tpu_torch.models.clip import TorchCLIP, layers
from transductive_clip_tpu_torch.models.clip.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from transductive_clip_tpu_torch.models.clip.model import (
    CLIP,
    init_random_state_dict,
)
from transductive_clip_tpu_torch.ops.common import resolve_device
from transductive_clip_tpu_torch.ops.cuda_add_norm import (
    MAX_ROW_BYTES,
    add_layer_norm,
    add_layer_norm_reference,
)

torch.set_num_threads(2)

EPS = layers.LN_EPS
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16}
# the integer type of each dtype's width, to compare bits (-0.0 included)
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
        torch.float16: torch.int16}
# explicit mantissa bits: an ulp at v is 2^(floor(log2 |v|) - MANTISSA)
MANTISSA = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}
# a ViT with ViT-L/14's patch and heads of 64 at a size the CPU runs in a
# moment (17 tokens, 3 layers; text 2 layers)
TINY = CLIPConfig(
    name="tiny-vit-add-norm", embed_dim=64,
    vision=CLIPVisionConfig(image_size=56, patch_size=14, width=128,
                            layers=3, heads=2),
    text=CLIPTextConfig(vocab_size=64, context_length=8, width=64,
                        layers=2, heads=1))
PAIRS = 2 * TINY.vision.layers - 1


def _inputs(rows, w, dtype, seed, device="cpu"):
    """x (the residual stream: rows offset by up to +-8 and scaled by up to
    4, as a tower's stream drifts), y (a branch's output), the LayerNorm's
    weight near 1 and bias near 0, all of ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    offset = 8.0 * (2 * torch.rand(rows, 1, generator=g) - 1)
    scale = 0.25 + 3.75 * torch.rand(rows, 1, generator=g)
    x = offset + scale * torch.randn(rows, w, generator=g)
    y = torch.randn(rows, w, generator=g)
    weight = 1.0 + 0.2 * torch.randn(w, generator=g)
    bias = 0.2 * torch.randn(w, generator=g)
    return [t.to(dtype).to(device) for t in (x, y, weight, bias)]


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(BITS[a.dtype]),
        b.contiguous().view(BITS[b.dtype]))


# -- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 17, 128), (5, 771), (3, 1)],
                         ids=["stream", "odd-width", "width-1"])
def test_wrapper_is_the_plain_pair_on_the_cpu(shape, dtype):
    dt = DTYPES[dtype]
    rows, w = int(np.prod(shape[:-1])), shape[-1]
    x, y, weight, bias = _inputs(rows, w, dt, 0)
    x, y = x.reshape(shape), y.reshape(shape)
    y_before = y.clone()
    launches = add_layer_norm.launches
    s, h = add_layer_norm(x, y, weight, bias, EPS)
    want_s = x + y_before
    assert _same_bits(s, want_s)
    assert _same_bits(h, F.layer_norm(want_s, (w,), weight, bias, EPS))
    ref_s, ref_h = add_layer_norm_reference(x, y_before, weight, bias, EPS)
    assert _same_bits(s, ref_s) and _same_bits(h, ref_h)
    # off the card y is not written over
    assert _same_bits(y, y_before)
    assert add_layer_norm.launches == launches


def test_other_dtypes_take_the_plain_pair_off_the_card():
    x, y, weight, bias = _inputs(4, 33, torch.float64, 1)
    s, h = add_layer_norm(x, y, weight, bias, EPS)
    assert torch.equal(s, x + y)
    assert torch.equal(h, F.layer_norm(x + y, (33,), weight, bias, EPS))


def test_the_meta_device_takes_the_plain_pair():
    """A tower built on the meta device (the reference's count of the
    port's products) runs its pairs by shape alone, with no launch."""
    x = torch.empty((2, 577, 1024), dtype=torch.bfloat16, device="meta")
    y = torch.empty_like(x)
    weight = torch.empty(1024, dtype=torch.bfloat16, device="meta")
    launches = add_layer_norm.launches
    s, h = add_layer_norm(x, y, weight, weight, EPS)
    for t in (s, h):
        assert t.device.type == "meta"
        assert t.shape == x.shape and t.dtype == x.dtype
    assert add_layer_norm.launches == launches


def _block_by_block(transformer, x, mask=None):
    """The order the transformer ran before the pairs were fused: each
    block ``x = x + attn(ln_1(x))``, then ``x = x + mlp(ln_2(x))``."""
    for b in transformer.resblocks:
        x = x + b.attn(b.ln_1(x), mask)
        x = x + b.mlp(b.ln_2(x))
    return x


def _transformer(width, n_layers, heads, impl, dtype, seed):
    torch.manual_seed(seed)
    t = layers.Transformer(width, n_layers, heads, impl)
    for p in t.parameters():
        torch.nn.init.normal_(p, std=0.05)
    for b in t.resblocks:
        for ln in (b.ln_1, b.ln_2):
            torch.nn.init.normal_(ln.weight, mean=1.0, std=0.1)
    return t.to(dtype).eval()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("impl", layers.ATTN_IMPLS)
@pytest.mark.parametrize("n_layers", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True], ids=["image", "text"])
def test_transformer_is_bit_equal_to_the_block_by_block_order(
        dtype, impl, n_layers, causal):
    dt = DTYPES[dtype]
    width, n = 64, 9
    t = _transformer(width, n_layers, 1, impl, dt, 3)
    x = torch.randn(2, n, width, generator=torch.Generator().manual_seed(4))
    x = x.to(dt)
    mask = torch.full((n, n), float("-inf"), dtype=dt).triu(1) if (
        causal) else None
    with torch.no_grad():
        got = t(x, mask)
        want = _block_by_block(t, x, mask)
    assert _same_bits(got, want)


def test_transformer_runs_its_pairs_through_the_wrapper(monkeypatch):
    seen = []

    def spy(x, y, weight, bias, eps):
        seen.append((tuple(x.shape), weight.data_ptr(), eps))
        return add_layer_norm_reference(x, y, weight, bias, eps)

    monkeypatch.setattr(layers, "add_layer_norm", spy)
    t = _transformer(32, 3, 2, "xla", torch.float32, 5)
    x = torch.randn(2, 5, 32)
    with torch.no_grad():
        t(x)
    b = t.resblocks
    # a block's first add with its own ln_2, its second with the next ln_1
    norms = [b[0].ln_2, b[1].ln_1, b[1].ln_2, b[2].ln_1, b[2].ln_2]
    assert seen == [((2, 5, 32), ln.weight.data_ptr(), EPS) for ln in norms]


def _tiny_model(device, dtype=torch.float32, attention="xla"):
    return TorchCLIP(TINY, init_random_state_dict(TINY, seed=0),
                     compute_dtype=dtype, attention_impl=attention,
                     device=device)


def _images(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, TINY.vision.image_size, TINY.vision.image_size, 3),
        dtype=np.uint8)


def test_each_forward_counts_its_pairs_and_no_kernel_on_the_cpu():
    model = _tiny_model("cpu")
    launches = add_layer_norm.launches
    timer = PhaseTimer()
    with timer.active():
        for _ in range(3):
            model.encode_image_batch(_images(2, 0))
        with torch.no_grad():
            model.module.encode_text(torch.randint(
                0, TINY.text.vocab_size, (2, TINY.text.context_length)))
    # the text tower counts nothing
    assert timer.totals["vit.add_norms"] == 3 * PAIRS
    assert timer.totals["vit.kernel_add_norms"] == 0
    assert timer.counts["vit.add_norms"] == timer.counts[
        "vit.kernel_add_norms"] == 3
    assert {"vit.add_norms", "vit.kernel_add_norms"} <= timer.counters
    assert add_layer_norm.launches == launches


def test_kernel_add_norms_count_the_launches_in_the_forward(monkeypatch):
    """The card's route stood in for on the CPU: each pair bumps the
    kernel's launch counter and runs the plain pair. ``vit.kernel_add_norms``
    counts those launches, 2 x layers - 1 a forward."""

    def on_card(x, y, weight, bias, eps):
        add_layer_norm.launches += 1
        return add_layer_norm_reference(x, y, weight, bias, eps)

    monkeypatch.setattr(layers, "add_layer_norm", on_card)
    monkeypatch.setattr(add_layer_norm, "launches", add_layer_norm.launches)
    model = _tiny_model("cpu")
    timer = PhaseTimer()
    with timer.active():
        for _ in range(2):
            model.encode_image_batch(_images(2, 1))
    assert timer.totals["vit.add_norms"] == 2 * PAIRS
    assert timer.totals["vit.kernel_add_norms"] == 2 * PAIRS


def test_openai_state_dict_keys_still_load():
    """The blocks keep their LayerNorms under OpenAI's keys
    (``resblocks.i.ln_1``, ``ln_2``): a state dict made under those keys
    loads strictly, and the module gives back the same keys."""
    sd = init_random_state_dict(TINY, seed=2)
    module = CLIP(TINY)
    module.load_state_dict(sd)     # strict
    assert set(module.state_dict()) == set(sd)
    for prefix, n_layers in (("visual.transformer", TINY.vision.layers),
                             ("transformer", TINY.text.layers)):
        for i in range(n_layers):
            for ln in ("ln_1", "ln_2"):
                for p in ("weight", "bias"):
                    key = f"{prefix}.resblocks.{i}.{ln}.{p}"
                    assert torch.equal(module.state_dict()[key], sd[key])


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the add-norm kernel runs only on the "
                    "card")
    return resolve_device("cuda")


def _ulp(v, dtype):
    """The spacing of ``dtype`` at |v| (its subnormal spacing below its
    least normal)."""
    info = torch.finfo(dtype)
    m = MANTISSA[dtype]
    e = torch.floor(torch.log2(v.abs().clamp_min(info.tiny)))
    return torch.exp2(e - m)


def tolerance(s, weight, bias, dtype):
    """TOLERANCE on h: one ulp of the element type at an fp32 LayerNorm of
    s (the kernel rounds its fp32 value once, half an ulp), plus 2^-16 of
    the terms of that value, |weight| (|n| + |mean| rstd) + |bias| with n
    the normalised s: the kernel's fp32 statistics sum in another order
    than the reference's (a warp's butterfly against Welford), an error
    that grows with the row's |mean| over its spread, and the last step
    weight n + bias can cancel, so its fp32 error follows the terms and
    not the result. 2^-16 leaves 2^7 fp32 ulps of them. Returns the
    reference and the tolerance."""
    sf, wf, bf = s.float(), weight.float(), bias.float()
    w = s.shape[-1]
    ref = F.layer_norm(sf, (w,), wf, bf, EPS)
    n = F.layer_norm(sf, (w,), None, None, EPS)
    mean = sf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(sf.var(-1, unbiased=False, keepdim=True) + EPS)
    terms = wf.abs() * (n.abs() + mean.abs() * rstd) + bf.abs()
    return ref, _ulp(ref, dtype) + 2.0 ** -16 * terms


def _check_on_card(x, y, weight, bias):
    y_before = y.clone()
    ptr = y.data_ptr()
    launches = add_layer_norm.launches
    s, h = add_layer_norm(x, y, weight, bias, EPS)
    torch.cuda.synchronize()
    assert add_layer_norm.launches == launches + 1
    assert s.data_ptr() == ptr           # s written over y
    assert _same_bits(s, x + y_before)
    ref, tol = tolerance(s, weight, bias, x.dtype)
    assert h.dtype == x.dtype and h.shape == x.shape and h.is_contiguous()
    assert torch.isfinite(h).all()
    err = (h.float() - ref).abs()
    assert (err <= tol).all(), (
        f"worst |h - ref| {err.max().item():.3e}, "
        f"{int((err > tol).sum())} elements past the tolerance")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows, w", [(8 * 197 + 3, 512), (8 * 77 + 5, 640),
                                     (8 * 197 + 1, 768), (4 * 577, 1024),
                                     (37, 771), (19, 24), (9, 1)],
                         ids=["512", "640", "768", "1024", "odd", "below-a-warp",
                              "one"])
def test_kernel_against_the_pair(card, rows, w, dtype):
    _check_on_card(*_inputs(rows, w, DTYPES[dtype], 6, card))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_at_the_widest_row(card, dtype):
    dt = DTYPES[dtype]
    _check_on_card(*_inputs(67, MAX_ROW_BYTES // dt.itemsize, dt, 7, card))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("which", ["x", "y", "weight"])
def test_kernel_off_16_bytes(card, dtype, which):
    """One pointer off 16 bytes (a view at storage offset 1) sends the
    launch down the one-element path."""
    dt = DTYPES[dtype]
    rows, w = 21, 1024
    ins = dict(zip(("x", "y", "weight", "bias"),
                   _inputs(rows, w, dt, 8, card)))
    flat = torch.empty(ins[which].numel() + 1, dtype=dt, device=card)
    view = flat[1:].view(ins[which].shape)
    view.copy_(ins[which])
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    ins[which] = view
    _check_on_card(ins["x"], ins["y"], ins["weight"], ins["bias"])


@pytest.mark.cuda
def test_an_empty_tensor_launches_nothing(card):
    x = torch.empty((0, 577, 1024), dtype=torch.bfloat16, device=card)
    weight = torch.ones(1024, dtype=torch.bfloat16, device=card)
    launches = add_layer_norm.launches
    s, h = add_layer_norm(x, torch.empty_like(x), weight, weight, EPS)
    for t in (s, h):
        assert t.shape == x.shape and t.dtype == torch.bfloat16
        assert t.device.type == "cuda"
    assert add_layer_norm.launches == launches


@pytest.mark.cuda
def test_what_the_kernel_does_not_take_raises(card):
    launches = add_layer_norm.launches
    x, y, weight, bias = _inputs(4, 64, torch.float64, 9, card)
    with pytest.raises(TypeError, match="kernel takes"):
        add_layer_norm(x, y, weight, bias, EPS)
    x, y, weight, bias = _inputs(4, 64, torch.bfloat16, 9, card)
    with pytest.raises(ValueError, match="weight must be"):
        add_layer_norm(x, y, weight.float(), bias, EPS)
    with pytest.raises(ValueError, match="y must be"):
        add_layer_norm(x, y[:, :32], weight, bias, EPS)
    w = MAX_ROW_BYTES // 2 + 8
    x, y, weight, bias = _inputs(2, w, torch.bfloat16, 9, card)
    with pytest.raises(ValueError, match="wider"):
        add_layer_norm(x, y, weight, bias, EPS)
    assert add_layer_norm.launches == launches


@pytest.mark.cuda
def test_every_pair_of_a_vit_forward_runs_in_the_kernel(card):
    model = _tiny_model(card, dtype=torch.bfloat16, attention="fused")
    launches = add_layer_norm.launches
    timer = PhaseTimer()
    with timer.active():
        model.encode_image_batch(_images(2, 2))
    torch.cuda.synchronize()
    assert timer.totals["vit.add_norms"] == PAIRS
    assert timer.totals["vit.kernel_add_norms"] == PAIRS
    assert add_layer_norm.launches == launches + PAIRS


@pytest.mark.cuda
def test_an_fp32_vit_forward_stays_near_the_plain_pair(card, monkeypatch):
    """In fp32 the kernel's h differs from PyTorch's LayerNorm only by the
    order of its fp32 sums: the image features agree within 1e-5 of their
    magnitude."""
    model = _tiny_model(card)
    images = _images(4, 3)
    got = model.encode_image_batch(images).cpu()
    monkeypatch.setattr(layers, "add_layer_norm", add_layer_norm_reference)
    want = model.encode_image_batch(images).cpu()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
