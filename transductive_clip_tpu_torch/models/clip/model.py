"""Top-level CLIP model: frozen image and text towers, their encoders, and
a loader mirroring the reference's ``clip.load(backbone, device)``
(counterpart of transductive_clip_tpu/models/clip/model.py; reference:
main.py:50).

Weights: an OpenAI CLIP checkpoint (.pt) under ``$CLIP_WEIGHTS_DIR``
(default ``data/clip_weights``), loaded into modules that carry OpenAI's
state-dict keys; without one, ``load(..., allow_random=True)`` makes random
weights from a seed (tests, smoke runs, shape checks).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from ...ops.common import resolve_device
from ...ops.cuda_attention import fused_attention_supported
from ...parallel.task_parallel import gather_tasks, shard_task_batch
from .config import CLIP_CONFIGS, CLIPConfig
from .preprocess import CLIP_MEAN, CLIP_STD
from .resnet import ModifiedResNet, fold_resnet_params
from .text import TextTransformer
from .vit import VisionTransformer


class CLIP(TextTransformer):
    """The OpenAI module layout: the text tower's weights at the top level
    (the superclass), ``visual`` and ``logit_scale`` beside them.

    ``attn_impl``: 'xla' | 'fused' for the transformer towers (the ResNet
    attention pool is always plain torch). ``fold_bn=True`` expects the
    weights of ``resnet.fold_resnet_params``; ``fused_resnet=True`` (with
    ``fold_bn``) sends the identity bottlenecks through K5."""

    def __init__(self, cfg: CLIPConfig, attn_impl: str = "xla",
                 fold_bn: bool = False, fused_resnet: bool = False):
        super().__init__(cfg.text, cfg.embed_dim, attn_impl)
        if cfg.vision.is_resnet:
            self.visual = ModifiedResNet(cfg.vision, cfg.embed_dim,
                                         fold_bn=fold_bn,
                                         fuse_blocks=fused_resnet)
        else:
            self.visual = VisionTransformer(cfg.vision, cfg.embed_dim,
                                            attn_impl)
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def encode_image(self, images):
        """images [b, 3, H, W] -> [b, embed_dim]."""
        return self.visual(images)


def _attention_shapes(cfg: CLIPConfig):
    """(n, width, heads) of every transformer tower of ``cfg``."""
    shapes = [(cfg.text.context_length, cfg.text.width, cfg.text.heads)]
    v = cfg.vision
    if not v.is_resnet:
        shapes.append(((v.image_size // v.patch_size) ** 2 + 1, v.width,
                       v.heads))
    return shapes


def _resolve_attention_impl(impl: str, cfg: CLIPConfig, compute_dtype,
                            device) -> str:
    """'auto' -> 'fused' (K4a / K4b) on a CUDA device when every
    transformer tower's shape is one of theirs, else 'xla' (plain torch)."""
    if impl != "auto":
        return impl
    if torch.device(device).type != "cuda":
        return "xla"
    ok = all(fused_attention_supported(n, w, h, compute_dtype)
             for n, w, h in _attention_shapes(cfg))
    return "fused" if ok else "xla"


def _as_dtype(dtype):
    """None -> bfloat16 (the default); float32 and bfloat16 pass."""
    if dtype is None:
        return torch.bfloat16
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute dtype must be bfloat16 or float32; got "
                         f"{dtype}")
    return dtype


class TorchCLIP:
    """Host-side wrapper holding the module on its device and the encoders
    (the counterpart of ``JaxCLIP``). The weights are cast to
    ``compute_dtype`` once; the attention softmaxes stay fp32 and the
    outputs come back fp32."""

    def __init__(self, cfg: CLIPConfig, state_dict, compute_dtype=None,
                 attention_impl: str = "auto", fold_bn: bool = True,
                 fused_resnet: str | bool = "auto", device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = _as_dtype(compute_dtype)
        # the towers are frozen, so BatchNorm folds exactly into the convs
        self.fold_bn = bool(fold_bn) and cfg.vision.is_resnet
        if self.fold_bn:
            state_dict = fold_resnet_params(state_dict)
        self.attention_impl = _resolve_attention_impl(
            attention_impl, cfg, self.compute_dtype, self.device)
        # 'auto' stays off, as the JAX package has it (its reason is a TPU
        # measurement; PERF.md holds this card's K5 times)
        if fused_resnet == "auto":
            fused_resnet = False
        self.fused_resnet = bool(fused_resnet) and self.fold_bn
        module = CLIP(cfg, attn_impl=self.attention_impl,
                      fold_bn=self.fold_bn, fused_resnet=self.fused_resnet)
        module.load_state_dict(state_dict)
        if self.fold_bn:
            # in fp32, before the cast rounds it once
            for block in module.visual.blocks():
                block.prepare_epilogue_bias()
        self.module = module.to(device=self.device,
                                dtype=self.compute_dtype).eval()
        self.module.requires_grad_(False)
        if self.fused_resnet:
            for block in self.module.visual.blocks():
                if block.fuse:
                    block.prepare_kernel_weights()
        self._mean = torch.as_tensor(CLIP_MEAN, dtype=self.compute_dtype,
                                     device=self.device)
        self._std = torch.as_tensor(CLIP_STD, dtype=self.compute_dtype,
                                    device=self.device)
        self._tokenizer = None
        self.group = None

    def set_task_group(self, group):
        """Batch-data-parallel encoding over ``group`` (a
        parallel.TaskGroup; None: one device), the counterpart of the JAX
        ``set_mesh``: each rank encodes its contiguous share of every image
        batch and the embeddings are gathered in order on every rank. A
        batch that does not divide over the ranks is encoded whole."""
        self.group = group
        return self

    # -- image ---------------------------------------------------------
    def encode_image_batch(self, images):
        """images [b, H, W, 3] NHWC, numpy or tensor: float32
        (CLIP-normalized) or raw uint8, normalized on the device in the
        compute dtype (``/ 255``, ``- mean``, ``/ std``, each rounded).
        Returns [b, embed_dim] fp32 on the device, without waiting for it.
        Under a task group (``set_task_group``) every rank returns the whole
        batch's embeddings."""
        group = self.group
        if group is not None and images.shape[0] % group.dp == 0:
            return gather_tasks(self._encode(shard_task_batch(images, group)),
                                group)
        return self._encode(images)

    def _encode(self, images):
        x = torch.as_tensor(images).to(self.device, non_blocking=True)
        if x.dtype == torch.uint8:
            x = x.to(self.compute_dtype) / 255.0
            x = (x - self._mean) / self._std
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)    # NCHW view of NHWC
        with torch.no_grad():
            return self.module.encode_image(x).float()

    # -- text ----------------------------------------------------------
    @property
    def tokenizer(self):
        if self._tokenizer is None:
            from .tokenizer import SimpleTokenizer

            self._tokenizer = SimpleTokenizer()
        return self._tokenizer

    def encode_text_prompts(self, prompts):
        """[len(prompts), embed_dim] fp32 on the device."""
        tokens = np.stack([self.tokenizer.encode_padded(
            p, self.cfg.text.context_length) for p in prompts])
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        with torch.no_grad():
            return self.module.encode_text(tokens).float()


def init_random_state_dict(cfg: CLIPConfig, seed: int = 0):
    """Random fp32 weights keyed like an OpenAI CLIP checkpoint, from an
    explicit ``torch.Generator``, scaled so that activations stay O(1)
    through the full depth in bf16 (the scaling of
    ``tests/torch_clip.synth_state_dict``)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def mat(*shape):
        return torch.randn(*shape, generator=g) * shape[-1] ** -0.5

    def vec(n, std=0.02):
        return torch.randn(n, generator=g) * std

    def ln(prefix, n):
        sd[f"{prefix}.weight"] = 1.0 + vec(n, 0.05)
        sd[f"{prefix}.bias"] = vec(n)

    def transformer(prefix, width, layers):
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            ln(f"{p}.ln_1", width)
            ln(f"{p}.ln_2", width)
            sd[f"{p}.attn.in_proj_weight"] = mat(3 * width, width)
            sd[f"{p}.attn.in_proj_bias"] = vec(3 * width)
            sd[f"{p}.attn.out_proj.weight"] = mat(width, width)
            sd[f"{p}.attn.out_proj.bias"] = vec(width)
            sd[f"{p}.mlp.c_fc.weight"] = mat(4 * width, width)
            sd[f"{p}.mlp.c_fc.bias"] = vec(4 * width)
            sd[f"{p}.mlp.c_proj.weight"] = mat(width, 4 * width)
            sd[f"{p}.mlp.c_proj.bias"] = vec(width)

    def bn(prefix, ch):
        sd[f"{prefix}.weight"] = 1.0 + vec(ch, 0.05)
        sd[f"{prefix}.bias"] = vec(ch)
        sd[f"{prefix}.running_mean"] = vec(ch, 0.1)
        sd[f"{prefix}.running_var"] = torch.rand(ch, generator=g) + 0.5

    def conv(key, out_ch, in_ch, k):
        sd[key] = torch.randn(out_ch, in_ch, k, k, generator=g) * (
            (in_ch * k * k) ** -0.5)

    v = cfg.vision
    if v.is_resnet:
        w = v.width
        for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2),
                                         (w // 2, w)), start=1):
            conv(f"visual.conv{i}.weight", cout, cin, 3)
            bn(f"visual.bn{i}", cout)
        in_ch, planes = w, w
        for stage, blocks in enumerate(v.resnet_layers):
            for b in range(blocks):
                p = f"visual.layer{stage + 1}.{b}"
                conv(f"{p}.conv1.weight", planes, in_ch, 1)
                bn(f"{p}.bn1", planes)
                conv(f"{p}.conv2.weight", planes, planes, 3)
                bn(f"{p}.bn2", planes)
                conv(f"{p}.conv3.weight", planes * 4, planes, 1)
                bn(f"{p}.bn3", planes * 4)
                if b == 0:
                    conv(f"{p}.downsample.0.weight", planes * 4, in_ch, 1)
                    bn(f"{p}.downsample.1", planes * 4)
                in_ch = planes * 4
            planes *= 2
        c = w * 32
        sd["visual.attnpool.positional_embedding"] = mat(
            (v.image_size // 32) ** 2 + 1, c)
        for proj, out in (("q_proj", c), ("k_proj", c), ("v_proj", c),
                          ("c_proj", cfg.embed_dim)):
            sd[f"visual.attnpool.{proj}.weight"] = mat(out, c)
            sd[f"visual.attnpool.{proj}.bias"] = vec(out)
    else:
        sd["visual.conv1.weight"] = torch.randn(
            v.width, 3, v.patch_size, v.patch_size, generator=g) * (
            (3 * v.patch_size ** 2) ** -0.5)
        sd["visual.class_embedding"] = vec(v.width, v.width ** -0.5)
        sd["visual.positional_embedding"] = mat(
            (v.image_size // v.patch_size) ** 2 + 1, v.width)
        ln("visual.ln_pre", v.width)
        transformer("visual.transformer", v.width, v.layers)
        ln("visual.ln_post", v.width)
        sd["visual.proj"] = mat(v.width, cfg.embed_dim)
    tc = cfg.text
    sd["token_embedding.weight"] = mat(tc.vocab_size, tc.width)
    sd["positional_embedding"] = mat(tc.context_length, tc.width)
    transformer("transformer", tc.width, tc.layers)
    ln("ln_final", tc.width)
    sd["text_projection"] = mat(tc.width, cfg.embed_dim)
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    return sd


def checkpoint_path(backbone: str) -> str:
    root = os.environ.get("CLIP_WEIGHTS_DIR", os.path.join("data", "clip_weights"))
    # "ViT-L/14@336px" -> "ViT-L-14-336px.pt", matching OpenAI's filenames
    safe = backbone.replace("/", "-").replace("@", "-")
    return os.path.join(root, f"{safe}.pt")


def load(backbone: str = "RN50", allow_random: bool = False, seed: int = 0,
         compute_dtype=None, attention_impl: str = "auto",
         fold_bn: bool = True, fused_resnet: str | bool = "auto",
         device=None):
    """Returns (model, preprocess) like the reference's clip.load.

    ``compute_dtype``: bf16 (default) or float32 (reference-exact tower
    numerics; CLI ``clip_compute``). ``attention_impl``: 'auto' (K4a / K4b
    on the card, plain torch on the CPU) | 'fused' | 'xla' (CLI
    ``clip_attention``). ``fold_bn``: fold the frozen BatchNorms into the
    ResNet convs (exact; CLI ``clip_fold_bn``). ``fused_resnet``: 'auto'
    (off) | True | False — K5 for the identity bottlenecks, with ``fold_bn``
    (CLI ``clip_fused_resnet``). ``device``: ``cuda:0`` when None (raises
    without a CUDA device), or what the caller passes, e.g. ``"cpu"``."""
    if backbone not in CLIP_CONFIGS:
        raise ValueError(
            f"Unknown backbone {backbone!r}; choose from {sorted(CLIP_CONFIGS)}"
        )
    cfg = CLIP_CONFIGS[backbone]
    ckpt = checkpoint_path(backbone)
    if os.path.exists(ckpt):
        from .convert import load_openai_state_dict

        state_dict = load_openai_state_dict(ckpt)
    elif allow_random:
        state_dict = init_random_state_dict(cfg, seed)
    else:
        raise FileNotFoundError(
            f"No CLIP checkpoint at {ckpt}. Download the OpenAI {backbone} "
            "weights there (offline environments: copy the .pt file), or pass "
            "allow_random=True for architecture-only runs."
        )
    from .preprocess import make_preprocess

    model = TorchCLIP(cfg, state_dict, compute_dtype=compute_dtype,
                      attention_impl=attention_impl, fold_bn=fold_bn,
                      fused_resnet=fused_resnet, device=device)
    # uint8 preprocess: normalization happens on the device
    return model, make_preprocess(cfg.vision.image_size, dtype="uint8")
