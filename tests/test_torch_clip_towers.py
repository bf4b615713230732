"""The port's CLIP towers against the JAX ``CLIPModule`` on the same
weights (``state_dict_from_flax`` carries them across), at the small
configs of tests/test_convert.py: the ViT and ResNet image towers and the
text tower, BN fold on and off, the 'xla' and 'fused' routes (the kernels'
plain versions on the CPU). fp32 at rtol = atol = 1e-4 as
tests/test_clip_numerics.py; bf16 within 5e-2 of the fp32 output's
magnitude (the two packages round bf16 at other places: LayerNorm
statistics, conv outputs, the softmax cast)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_clip
from test_convert import TINY_RN, TINY_VIT

from transductive_clip_tpu.models.clip import CLIPModule, JaxCLIP
from transductive_clip_tpu.models.clip.convert import convert_openai_checkpoint
from transductive_clip_tpu_torch.models.clip import CLIP, TorchCLIP
from transductive_clip_tpu_torch.models.clip import model as tmodel
from transductive_clip_tpu_torch.models.clip.config import (
    CLIP_CONFIGS,
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from transductive_clip_tpu_torch.models.clip.convert import (
    load_openai_state_dict,
    state_dict_from_flax,
)
from transductive_clip_tpu_torch.models.clip.resnet import fold_resnet_params
from transductive_clip_tpu_torch.ops import cuda_bottleneck as cb

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
CFGS = {"vit": TINY_VIT, "resnet": TINY_RN}


def _port_cfg(cfg):
    """The port's own dataclasses with the JAX config's values."""
    return CLIPConfig(
        name=cfg.name, embed_dim=cfg.embed_dim,
        vision=CLIPVisionConfig(**dataclasses.asdict(cfg.vision)),
        text=CLIPTextConfig(**dataclasses.asdict(cfg.text)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """cfg name -> (OpenAI state dict, JAX params converted from it)."""
    out = {}
    for name, cfg in CFGS.items():
        sd = torch_clip.synth_state_dict(cfg, seed=0)
        path = str(tmp_path_factory.mktemp(name) / "ckpt.pt")
        torch.save(sd, path)
        out[name] = (sd, convert_openai_checkpoint(path, cfg))
    return out


def _images(seed, cfg, b=3):
    s = cfg.vision.image_size
    return np.random.default_rng(seed).normal(size=(b, s, s, 3)).astype(
        np.float32)


def _tokens(seed, cfg, b=4):
    tc = cfg.text
    rng = np.random.default_rng(seed)
    tokens = np.zeros((b, tc.context_length), np.int64)
    for i in range(b):
        n_body = int(rng.integers(1, tc.context_length - 2))
        tokens[i, 0] = tc.vocab_size - 2
        tokens[i, 1:1 + n_body] = rng.integers(1, tc.vocab_size - 2, n_body)
        tokens[i, 1 + n_body] = tc.vocab_size - 1
    return tokens


@pytest.mark.parametrize("name", sorted(CFGS))
def test_state_dict_from_flax_inverts_the_converter(weights, name):
    sd, params = weights[name]
    got = state_dict_from_flax(params, CFGS[name])
    assert sorted(got) == sorted(sd)
    for key in sd:
        torch.testing.assert_close(got[key], sd[key].float(), rtol=0, atol=0)


def _model(sd, cfg, **kw):
    kw.setdefault("compute_dtype", torch.float32)
    return TorchCLIP(_port_cfg(cfg), dict(sd), device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("fold_bn", [True, False], ids=["fold", "nofold"])
@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_image_tower_matches_jax(weights, name, fold_bn, impl):
    cfg = CFGS[name]
    _, params = weights[name]
    imgs = _images(0, cfg)
    want = np.asarray(CLIPModule(cfg).apply(
        params, jnp.asarray(imgs), method=CLIPModule.encode_image))
    model = _model(state_dict_from_flax(params, cfg), cfg,
                   attention_impl=impl, fold_bn=fold_bn)
    assert model.attention_impl == impl
    assert model.fold_bn == (fold_bn and cfg.vision.is_resnet)
    got = model.encode_image_batch(imgs)
    assert got.shape == want.shape == (3, cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fused_resnet_route_matches_jax(weights):
    """fold_bn + fused_resnet (K5's plain version on the CPU) against the
    JAX tower's fused route (its Pallas kernel in interpret mode)."""
    from transductive_clip_tpu.models.clip.resnet import (
        fold_resnet_params as jax_fold,
    )

    cfg = TINY_RN
    _, params = weights["resnet"]
    folded = {"params": dict(params["params"])}
    folded["params"]["visual"] = jax_fold(params["params"]["visual"])
    imgs = _images(2, cfg)
    want = np.asarray(CLIPModule(cfg, fold_bn=True, fused_resnet=True).apply(
        folded, jnp.asarray(imgs), method=CLIPModule.encode_image))
    launches = cb.fused_identity_bottleneck.launches
    model = _model(state_dict_from_flax(params, cfg), cfg,
                   fused_resnet=True)
    fused = [b for b in model.module.visual.blocks() if b.fuse]
    assert model.fused_resnet and len(fused) == sum(
        n - 1 for n in cfg.vision.resnet_layers) == 0
    np.testing.assert_allclose(model.encode_image_batch(imgs).numpy(), want,
                               **TOL)
    assert cb.fused_identity_bottleneck.launches == launches


def test_fused_resnet_route_takes_identity_blocks(weights):
    """With two blocks in a stage the identity blocks take the fused route;
    the tower still matches the unfused one and the torch oracle of
    tests/torch_clip.py."""
    cfg = dataclasses.replace(TINY_RN, vision=dataclasses.replace(
        TINY_RN.vision, resnet_layers=(2, 1, 2, 1)))
    sd = torch_clip.synth_state_dict(cfg, seed=3)
    port = TorchCLIP(_port_cfg(cfg), dict(sd), compute_dtype=torch.float32,
                     fused_resnet=True, device="cpu")
    assert sum(b.fuse for b in port.module.visual.blocks()) == 2
    plain = TorchCLIP(_port_cfg(cfg), dict(sd), compute_dtype=torch.float32,
                      device="cpu")
    imgs = _images(3, cfg)
    np.testing.assert_allclose(port.encode_image_batch(imgs).numpy(),
                               plain.encode_image_batch(imgs).numpy(), **TOL)
    with torch.no_grad():
        want = torch_clip.encode_image(
            sd, cfg, torch.from_numpy(imgs.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(port.encode_image_batch(imgs).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_text_tower_matches_jax(weights, name, impl):
    cfg = CFGS[name]
    _, params = weights[name]
    tokens = _tokens(1, cfg)
    want = np.asarray(CLIPModule(cfg).apply(
        params, jnp.asarray(tokens, jnp.int32),
        method=CLIPModule.encode_text))
    model = _model(state_dict_from_flax(params, cfg), cfg,
                   attention_impl=impl)
    with torch.no_grad():
        got = model.module.encode_text(torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_uint8_images_normalized_as_jax(weights, name):
    """Raw uint8 images, normalized on the device (fp32 here), through the
    public encoders of both packages."""
    cfg = CFGS[name]
    _, params = weights[name]
    s = cfg.vision.image_size
    imgs = np.random.default_rng(4).integers(0, 256, (2, s, s, 3),
                                             dtype=np.uint8)
    want = np.asarray(JaxCLIP(cfg, params, compute_dtype=jnp.float32,
                              attention_impl="xla").encode_image_batch(imgs))
    got = _model(state_dict_from_flax(params, cfg), cfg).encode_image_batch(
        imgs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_bf16_towers_near_jax(weights, name):
    """bf16 compute in both packages against each other and against the
    fp32 output: within 5e-2 of the fp32 output's magnitude."""
    cfg = CFGS[name]
    _, params = weights[name]
    s = cfg.vision.image_size
    imgs = np.random.default_rng(5).integers(0, 256, (2, s, s, 3),
                                             dtype=np.uint8)
    ref = np.asarray(JaxCLIP(cfg, params, compute_dtype=jnp.float32,
                             attention_impl="xla").encode_image_batch(imgs))
    jax_bf16 = np.asarray(JaxCLIP(cfg, params, attention_impl="xla")
                          .encode_image_batch(imgs))
    port = _model(state_dict_from_flax(params, cfg), cfg,
                  compute_dtype=torch.bfloat16, attention_impl="fused")
    got = port.encode_image_batch(imgs).numpy()
    scale = np.abs(ref).max()
    assert got.dtype == np.float32
    assert np.abs(got - jax_bf16).max() <= 5e-2 * scale
    assert np.abs(got - ref).max() <= 5e-2 * scale


def test_bf16_vit_tower_with_k4b_order_near_jax(weights, monkeypatch):
    """The bf16 ViT image tower with its attention in K4b bf16's order of
    operations (``fused_attention_tiled_reference``: one pass, e rounded to
    bf16 before the division) against the JAX bf16 tower and the fp32
    output, at test_bf16_towers_near_jax's 5e-2 of the fp32 output's
    magnitude."""
    from transductive_clip_tpu_torch.models.clip import layers
    from transductive_clip_tpu_torch.ops import cuda_attention as ca

    cfg = TINY_VIT
    _, params = weights["vit"]
    s = cfg.vision.image_size
    imgs = np.random.default_rng(6).integers(0, 256, (2, s, s, 3),
                                             dtype=np.uint8)
    ref = np.asarray(JaxCLIP(cfg, params, compute_dtype=jnp.float32,
                             attention_impl="xla").encode_image_batch(imgs))
    jax_bf16 = np.asarray(JaxCLIP(cfg, params, attention_impl="xla")
                          .encode_image_batch(imgs))
    calls = []

    def twin(qkv, heads, mask=None):
        calls.append(qkv.shape)
        return ca.fused_attention_tiled_reference(qkv, heads, mask)

    monkeypatch.setattr(layers, "fused_attention", twin)
    port = _model(state_dict_from_flax(params, cfg), cfg,
                  compute_dtype=torch.bfloat16, attention_impl="fused")
    got = port.encode_image_batch(imgs).numpy()
    assert len(calls) == cfg.vision.layers
    assert all(shape[0] == 2 for shape in calls)
    scale = np.abs(ref).max()
    assert np.isfinite(got).all()
    assert np.abs(got - jax_bf16).max() <= 5e-2 * scale
    assert np.abs(got - ref).max() <= 5e-2 * scale


def test_fold_matches_jax_fold(weights):
    """fold_resnet_params on OpenAI keys gives the JAX fold's numbers."""
    from transductive_clip_tpu.models.clip.resnet import (
        fold_resnet_params as jax_fold,
    )

    sd, params = weights["resnet"]
    folded = fold_resnet_params(dict(sd))
    assert not any(".bn" in k or "downsample.1" in k for k in folded)
    jf = jax_fold(params["params"]["visual"])
    w = np.asarray(jf["layer1_0"]["conv2"]["kernel"]).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(
        folded["visual.layer1.0.conv2.weight"].numpy(), w)
    np.testing.assert_array_equal(
        folded["visual.layer1.0.downsample.0.bias"].numpy(),
        np.asarray(jf["layer1_0"]["downsample_conv"]["bias"]))


@pytest.mark.parametrize("name", sorted(CLIP_CONFIGS))
def test_every_config_builds(name):
    """All 9 OpenAI towers build with OpenAI's key layout (on the meta
    device: no memory), and their ResNet identity blocks pass K5's gate."""
    cfg = CLIP_CONFIGS[name]
    with torch.device("meta"):
        module = CLIP(cfg, fold_bn=True, fused_resnet=True)
    keys = set(module.state_dict())
    assert {"token_embedding.weight", "text_projection", "logit_scale",
            "transformer.resblocks.11.attn.in_proj_weight"} <= keys
    if cfg.vision.is_resnet:
        fused = [b for b in module.visual.blocks() if b.fuse]
        assert len(fused) == sum(n - 1 for n in cfg.vision.resnet_layers)
        assert "visual.layer1.0.downsample.0.bias" in keys
    else:
        assert f"visual.transformer.resblocks.{cfg.vision.layers - 1}.ln_2.bias" in keys


def test_load_raises_without_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIP_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="No CLIP checkpoint"):
        tmodel.load("RN50", device="cpu")
    with pytest.raises(ValueError, match="Unknown backbone"):
        tmodel.load("RN49", device="cpu")


@pytest.mark.parametrize("torchscript", [False, True], ids=["plain", "jit"])
def test_load_reads_an_openai_checkpoint(tmp_path, monkeypatch, weights,
                                         torchscript):
    """A checkpoint under $CLIP_WEIGHTS_DIR, plain or TorchScript (with the
    archive's non-weight entries), loads through ``load``."""
    from test_convert import _jit_archive_from_state_dict

    sd, params = weights["vit"]
    monkeypatch.setitem(tmodel.CLIP_CONFIGS, "tiny-vit", _port_cfg(TINY_VIT))
    monkeypatch.setenv("CLIP_WEIGHTS_DIR", str(tmp_path))
    path = str(tmp_path / "tiny-vit.pt")
    extra = dict(sd, context_length=torch.tensor(8))
    if torchscript:
        _jit_archive_from_state_dict(extra, path)
    else:
        torch.save(extra, path)
    assert sorted(load_openai_state_dict(path)) == sorted(sd)
    model, preprocess = tmodel.load("tiny-vit", compute_dtype=torch.float32,
                                    device="cpu")
    imgs = _images(6, TINY_VIT, b=2)
    want = np.asarray(CLIPModule(TINY_VIT).apply(
        params, jnp.asarray(imgs), method=CLIPModule.encode_image))
    np.testing.assert_allclose(model.encode_image_batch(imgs).numpy(), want,
                               **TOL)
    assert callable(preprocess)


def test_load_random_weights_are_seeded(monkeypatch):
    monkeypatch.setitem(tmodel.CLIP_CONFIGS, "tiny-rn", _port_cfg(TINY_RN))
    monkeypatch.setenv("CLIP_WEIGHTS_DIR", os.devnull)
    a, _ = tmodel.load("tiny-rn", allow_random=True, seed=1,
                       compute_dtype=torch.float32, device="cpu")
    b, _ = tmodel.load("tiny-rn", allow_random=True, seed=1,
                       compute_dtype=torch.float32, device="cpu")
    imgs = _images(7, TINY_RN, b=2)
    fa, fb = a.encode_image_batch(imgs), b.encode_image_batch(imgs)
    assert torch.isfinite(fa).all() and torch.equal(fa, fb)
    assert sorted(tmodel.init_random_state_dict(TINY_RN, 0)) == sorted(
        torch_clip.synth_state_dict(TINY_RN))
