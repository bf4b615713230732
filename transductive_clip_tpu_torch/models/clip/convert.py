"""OpenAI CLIP checkpoints into the port's modules (counterpart of
transductive_clip_tpu/models/clip/convert.py).

The port's modules carry OpenAI's state-dict keys, so a checkpoint loads
with ``load_state_dict`` once it is read: :func:`load_openai_state_dict`
reads a TorchScript archive (what openai/CLIP ships) or a plain state dict.
:func:`state_dict_from_flax` carries the weights of a JAX ``CLIPModule``
parameter tree across, the inverse of the JAX package's
``convert_openai_checkpoint``; the tests use it to run both packages on the
same weights.
"""

from __future__ import annotations

import numpy as np
import torch

# entries of OpenAI's archives that are not weights (their build_model
# drops them too), and BatchNorm's step counters
_NOT_WEIGHTS = ("input_resolution", "context_length", "vocab_size")


def load_openai_state_dict(path):
    """{key: fp32 CPU tensor} from an OpenAI ``.pt`` file, TorchScript or
    plain state dict, without the entries that are not weights."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return {k: v.detach().float() for k, v in sd.items()
            if k not in _NOT_WEIGHTS and not k.endswith("num_batches_tracked")}


def _t(a):
    # np.array, not ascontiguousarray: that makes a 0-d array 1-d
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _dense(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd, key, p):
    # flax [kh, kw, in, out] -> torch [out, in, kh, kw]
    sd[key] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _bn(sd, prefix, p):
    for src, dst in (("scale", "weight"), ("bias", "bias"),
                     ("mean", "running_mean"), ("var", "running_var")):
        sd[f"{prefix}.{dst}"] = _t(p[src])


def _transformer(sd, prefix, p, layers):
    for i in range(layers):
        blk, dst = p[f"resblock_{i}"], f"{prefix}.resblocks.{i}"
        _ln(sd, f"{dst}.ln_1", blk["ln_1"])
        _ln(sd, f"{dst}.ln_2", blk["ln_2"])
        attn = blk["attn"]
        sd[f"{dst}.attn.in_proj_weight"] = _t(
            np.asarray(attn["in_proj"]["kernel"]).T)
        sd[f"{dst}.attn.in_proj_bias"] = _t(attn["in_proj"]["bias"])
        _dense(sd, f"{dst}.attn.out_proj", attn["out_proj"])
        _dense(sd, f"{dst}.mlp.c_fc", blk["c_fc"])
        _dense(sd, f"{dst}.mlp.c_proj", blk["c_proj"])


def _vit(sd, p, cfg):
    _conv(sd, "visual.conv1.weight", p["conv1"])
    sd["visual.class_embedding"] = _t(p["class_embedding"])
    sd["visual.positional_embedding"] = _t(p["positional_embedding"])
    _ln(sd, "visual.ln_pre", p["ln_pre"])
    _transformer(sd, "visual.transformer", p["transformer"], cfg.vision.layers)
    _ln(sd, "visual.ln_post", p["ln_post"])
    sd["visual.proj"] = _t(p["proj"])


def _resnet(sd, p, cfg):
    for i in (1, 2, 3):
        _conv(sd, f"visual.conv{i}.weight", p[f"conv{i}"])
        _bn(sd, f"visual.bn{i}", p[f"bn{i}"])
    for stage, blocks in enumerate(cfg.vision.resnet_layers):
        for b in range(blocks):
            blk, dst = p[f"layer{stage + 1}_{b}"], f"visual.layer{stage + 1}.{b}"
            for i in (1, 2, 3):
                _conv(sd, f"{dst}.conv{i}.weight", blk[f"conv{i}"])
                _bn(sd, f"{dst}.bn{i}", blk[f"bn{i}"])
            if "downsample_conv" in blk:
                _conv(sd, f"{dst}.downsample.0.weight", blk["downsample_conv"])
                _bn(sd, f"{dst}.downsample.1", blk["downsample_bn"])
    pool = p["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _t(
        pool["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(sd, f"visual.attnpool.{name}", pool[name])


def state_dict_from_flax(params, cfg):
    """OpenAI-keyed fp32 CPU tensors from an *unfolded* JAX ``CLIPModule``
    parameter tree (``{'params': ...}`` or its inside, numpy or jax arrays):
    dense kernels transposed back, conv kernels HWIO -> OIHW,
    ``resblock_{i}`` -> ``resblocks.{i}``, ``downsample_conv`` /
    ``downsample_bn`` -> ``downsample.0`` / ``downsample.1``, the BN
    ``scale`` / ``bias`` / ``mean`` / ``var`` -> ``weight`` / ``bias`` /
    ``running_mean`` / ``running_var``. The port folds at load."""
    p = params.get("params", params)
    sd = {}
    if cfg.vision.is_resnet:
        _resnet(sd, p["visual"], cfg)
    else:
        _vit(sd, p["visual"], cfg)
    text = p["text"]
    sd["token_embedding.weight"] = _t(text["token_embedding"])
    sd["positional_embedding"] = _t(text["positional_embedding"])
    _transformer(sd, "transformer", text["transformer"], cfg.text.layers)
    _ln(sd, "ln_final", text["ln_final"])
    sd["text_projection"] = _t(text["text_projection"])
    sd["logit_scale"] = _t(p["logit_scale"])
    return sd
