"""Plain CLIP ModifiedResNet image tower (RN50 and its kin) in fp32: the
reference that the RN50 extraction cell holds the program's softmax
features against.

Written from OpenAI's CLIP (Radford et al. 2021; clip/model.py:
Bottleneck, AttentionPool2d, ModifiedResNet) over a state dict with
OpenAI's keys, in plain torch: no kernel, fp32 with TF32 off. ``quant``
(None for the reference) is applied to both operands of every convolution
and every product, which makes the lower-precision control. The text
tower, the softmax features and the control's rounding are those of
``clip_vit.py``, loaded by name. Imports nothing of the program.

The cell's images come from ``images`` here (smooth random fields, so that
two images differ in colour and layout and the check can tell one image's
row from another's), and the weights' scales from ``layout``.

Departures from OpenAI's code, none of which changes the function:
- BatchNorm in its inference form from the running statistics,
  ``(x - mean) / sqrt(var + 1e-5) * weight + bias``, unfolded (OpenAI's
  ``BatchNorm2d`` in eval mode);
- the images come as uint8 NHWC and are scaled and normalised here in
  fp32 (OpenAI's preprocess does it on the host before the tower);
- the attention pool is written out (one query, ``heads`` heads, the query
  scaled by head_dim^-0.5) in place of ``F.multi_head_attention_forward``;
- everything runs in fp32, where OpenAI casts the input to the weights'
  dtype (fp16 on CUDA).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from harness import clip_inputs, spec

vit = spec.load_reference("clip_vit", os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
text_features = vit.text_features
softmax_features = vit.softmax_features
_q = vit._q
# the control: every product's operands in fp8 e4m3, as the ViT's
CONTROL = vit.CONTROL

BN_EPS = 1e-5
EXPANSION = 4


def conv(x, w, quant=None, **kw):
    x, w = _q(quant, x, w)
    return F.conv2d(x, w, **kw)


def batch_norm(x, sd, p):
    """Inference BatchNorm ``p`` over NCHW."""
    inv = sd[f"{p}.weight"] / torch.sqrt(sd[f"{p}.running_var"] + BN_EPS)
    shift = sd[f"{p}.bias"] - sd[f"{p}.running_mean"] * inv
    return x * inv[:, None, None] + shift[:, None, None]


def bottleneck(x, sd, p, stride, quant=None):
    """OpenAI's Bottleneck: 1x1, 3x3, an average pool of ``stride``, 1x1
    (x4 channels); the downsample (an average pool, a 1x1 conv, BN) where
    the stride or the width changes."""
    out = F.relu(batch_norm(conv(x, sd[f"{p}.conv1.weight"], quant), sd,
                            f"{p}.bn1"))
    out = F.relu(batch_norm(conv(out, sd[f"{p}.conv2.weight"], quant,
                                 padding=1), sd, f"{p}.bn2"))
    if stride > 1:
        out = F.avg_pool2d(out, stride)
    out = batch_norm(conv(out, sd[f"{p}.conv3.weight"], quant), sd,
                     f"{p}.bn3")
    identity = x
    if f"{p}.downsample.0.weight" in sd:
        if stride > 1:
            identity = F.avg_pool2d(identity, stride)
        identity = batch_norm(conv(identity, sd[f"{p}.downsample.0.weight"],
                                   quant), sd, f"{p}.downsample.1")
    return F.relu(out + identity)


def attention_pool(x, sd, heads, quant=None):
    """OpenAI's AttentionPool2d: x [b, c, h, w] -> [b, output_dim]. The
    mean token first, the positional embedding added, the mean token the
    only query."""
    p = "visual.attnpool"
    b, c = x.shape[:2]
    d = c // heads
    tokens = x.flatten(2).transpose(1, 2)                       # [b, hw, c]
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + sd[f"{p}.positional_embedding"]

    def proj(t, name):
        t, w = _q(quant, t, sd[f"{p}.{name}.weight"])
        return t @ w.t() + sd[f"{p}.{name}.bias"]

    def split(t):
        return t.reshape(b, -1, heads, d).transpose(1, 2)      # [b, h, n, d]

    q = split(proj(tokens[:, :1], "q_proj"))
    k, v = split(proj(tokens, "k_proj")), split(proj(tokens, "v_proj"))
    q, k = _q(quant, q * d ** -0.5, k)
    a, v = _q(quant, torch.softmax(q @ k.transpose(-1, -2), dim=-1), v)
    out = (a @ v).transpose(1, 2).reshape(b, c)
    return proj(out, "c_proj")


def image_features(sd, images, cfg, quant=None):
    """images [b, H, W, 3] uint8 -> [b, embed_dim] fp32 (unnormalised)."""
    v = cfg["vision"]
    x = images.float() / 255.0
    mean = torch.tensor(vit.CLIP_MEAN, device=x.device)
    std = torch.tensor(vit.CLIP_STD, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    for i, stride in ((1, 2), (2, 1), (3, 1)):
        x = F.relu(batch_norm(conv(x, sd[f"visual.conv{i}.weight"], quant,
                                   stride=stride, padding=1), sd,
                              f"visual.bn{i}"))
    x = F.avg_pool2d(x, 2)
    for stage, i, _, _, stride in _stages(v):
        x = bottleneck(x, sd, f"visual.layer{stage + 1}.{i}", stride, quant)
    return attention_pool(x, sd, v["heads"], quant)


def _stages(v):
    """(stage, block, in channels, planes, stride) of every bottleneck."""
    inplanes, planes = v["width"], v["width"]
    for stage, blocks in enumerate(v["resnet_layers"]):
        for i in range(blocks):
            yield (stage, i, inplanes, planes,
                   2 if stage > 0 and i == 0 else 1)
            inplanes = planes * EXPANSION
        planes *= 2


def _text_layout(cfg):
    """The text tower's entries of clip_vit's layout: the same tower at
    the same scales (a one-pixel stub stands in for its image tower)."""
    stub = dict(cfg, vision={"image_size": 1, "patch_size": 1, "width": 1,
                             "layers": 0})
    return [e for e in vit.layout(stub) if not e[0].startswith("visual.")]


# the scales of the random weights (``layout``). A convolution that ReLU
# follows keeps its input's second moment at He's gain sqrt(2). The last
# BN of a residual branch (OpenAI initialises its weight to 0) has gain
# BRANCH_GAIN, so each of the 16 blocks adds a share of the stream's
# second moment and the stream stays O(1) to the attention pool. The pool's
# query and key projections have POOL_GAIN times their fan-in scale, so
# that its scores spread over a few units and it attends to the positions
# that stand out: at fan-in scale they spread over ~0.1 and the pool
# averages all 49 positions. Higher gains part the images further but
# widen bf16's error as fast (PERF.md, the RN50 limit).
BRANCH_GAIN = 0.5
POOL_GAIN = 4.0
RELU_GAIN = 2.0 ** 0.5


# the images (``images``): a colour a channel, plus smooth random fields at
# IMAGE_OCTAVES grids of the image (bicubic between grid points), plus
# pixel grain, rounded to uint8. Uniform noise pixels are not enough here:
# a random tower pools any two noise images to nearly one vector (cosine
# 0.998 at RN50's widths), and two images' softmax rows then differ less
# than bf16 moves them.
IMAGE_OCTAVES = (2, 8, 32)
IMAGE_AMPLITUDE = 60.0
IMAGE_COLOUR = 40.0
IMAGE_GRAIN = 8.0
IMAGE_CHUNK = 1024


def images(seed, n, size, device):
    """[n, size, size, 3] uint8 images from the seed, made on ``device`` in
    chunks of IMAGE_CHUNK."""
    g = clip_inputs.generator(seed, 2, device)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    for s in range(0, n, IMAGE_CHUNK):
        m = min(IMAGE_CHUNK, n - s)
        x = 128.0 + IMAGE_COLOUR * torch.randn((m, 3, 1, 1), generator=g,
                                               device=device)
        for grid in IMAGE_OCTAVES:
            coarse = torch.randn((m, 3, grid, grid), generator=g,
                                 device=device)
            x = x + IMAGE_AMPLITUDE * F.interpolate(
                coarse, size=(size, size), mode="bicubic",
                align_corners=False)
        x = x + IMAGE_GRAIN * torch.randn((m, 3, size, size), generator=g,
                                          device=device)
        out[s:s + m] = x.clamp_(0, 255).round_().permute(0, 2, 3, 1)
    return out


def layout(cfg):
    """[(key, shape, std, offset)] of every tensor of the ModifiedResNet
    CLIP under OpenAI's keys, BatchNorm's running statistics included:
    convolutions by the square root of their fan-in (times He's gain where
    ReLU follows), BN weights 1 + 0.05 noise (BRANCH_GAIN + 0.05 noise on
    a branch's last), biases and running means at 0.02, running variances
    1 + 0.05 noise (positive to 20 standard deviations); the attention
    pool's matrices by their fan-in (the query's and keys' times
    POOL_GAIN), its positional embedding by the width's square root (as
    OpenAI's initialisation); the text tower as ``clip_vit.layout`` has
    it."""
    v, embed_dim = cfg["vision"], cfg["embed_dim"]
    out = []

    def conv_w(key, cout, cin, k, gain=1.0):
        out.append((key, (cout, cin, k, k), gain * (cin * k * k) ** -0.5,
                    0.0))

    def bn(prefix, n, gain=1.0):
        out.append((f"{prefix}.weight", (n,), 0.05, gain))
        out.append((f"{prefix}.bias", (n,), 0.02, 0.0))
        out.append((f"{prefix}.running_mean", (n,), 0.02, 0.0))
        out.append((f"{prefix}.running_var", (n,), 0.05, 1.0))

    w = v["width"]
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2),
                                     (w // 2, w)), start=1):
        conv_w(f"visual.conv{i}.weight", cout, cin, 3, RELU_GAIN)
        bn(f"visual.bn{i}", cout)
    for stage, i, inplanes, planes, stride in _stages(v):
        p = f"visual.layer{stage + 1}.{i}"
        conv_w(f"{p}.conv1.weight", planes, inplanes, 1, RELU_GAIN)
        bn(f"{p}.bn1", planes)
        conv_w(f"{p}.conv2.weight", planes, planes, 3, RELU_GAIN)
        bn(f"{p}.bn2", planes)
        conv_w(f"{p}.conv3.weight", planes * EXPANSION, planes, 1)
        bn(f"{p}.bn3", planes * EXPANSION, BRANCH_GAIN)
        if stride > 1 or inplanes != planes * EXPANSION:
            conv_w(f"{p}.downsample.0.weight", planes * EXPANSION, inplanes,
                   1)
            bn(f"{p}.downsample.1", planes * EXPANSION)
    c = w * 32
    p = "visual.attnpool"
    out.append((f"{p}.positional_embedding",
                ((v["image_size"] // 32) ** 2 + 1, c), c ** -0.5, 0.0))
    for name, n_out, gain in (("q_proj", c, POOL_GAIN),
                              ("k_proj", c, POOL_GAIN), ("v_proj", c, 1.0),
                              ("c_proj", embed_dim, 1.0)):
        out.append((f"{p}.{name}.weight", (n_out, c), gain * c ** -0.5,
                    0.0))
        out.append((f"{p}.{name}.bias", (n_out,), 0.02, 0.0))
    return out + _text_layout(cfg)


def softmax(cfg, sd, tokens, images, quant=None, block=128):
    """The softmax features [b, n_class] of ``images`` [b, H, W, 3] uint8
    against the prompts ``tokens``, fp32 from the weights ``sd``, in blocks
    of ``block`` images."""
    sd32 = {k: x.float() for k, x in sd.items()}
    t = cfg["text"]
    with torch.no_grad():
        text = text_features(sd32, tokens, t["layers"], t["heads"], quant)
        out = []
        for s in range(0, images.shape[0], block):
            emb = image_features(sd32, images[s:s + block], cfg, quant)
            out.append(softmax_features(emb, text, float(cfg["T"])))
    return torch.cat(out)


def image_flops(cfg):
    """The image tower's products for one image, from shapes: every
    convolution (2 H_out W_out C_in C_out k^2), and in the attention pool
    the query's projection (one token), the keys' and values' (every
    token), the scores and the weighted sum over every token, and the
    output projection. The pools, BN, ReLU and residual adds are left out."""
    v = cfg["vision"]
    w, side = v["width"], v["image_size"]

    def conv_flops(hw, cin, cout, k):
        return 2 * hw * hw * cin * cout * k * k

    side //= 2                                   # the stem's first stride
    total = (conv_flops(side, 3, w // 2, 3)
             + conv_flops(side, w // 2, w // 2, 3)
             + conv_flops(side, w // 2, w, 3))
    side //= 2                                   # the stem's average pool
    for _, _, inplanes, planes, stride in _stages(v):
        total += conv_flops(side, inplanes, planes, 1)
        total += conv_flops(side, planes, planes, 3)
        side_out = side // stride
        total += conv_flops(side_out, planes, planes * EXPANSION, 1)
        if stride > 1 or inplanes != planes * EXPANSION:
            total += conv_flops(side_out, inplanes, planes * EXPANSION, 1)
        side = side_out
    c, n = w * 32, side * side + 1
    total += 2 * c * c                           # the query's projection
    total += 2 * 2 * n * c * c                   # keys and values
    total += 2 * 2 * n * c                       # scores, weighted sum
    total += 2 * c * cfg["embed_dim"]            # the output projection
    return total


def work_counts(cfg, batch_sizes):
    """{image_flops: the image tower's products an image}."""
    return {"image_flops": image_flops(cfg)}
