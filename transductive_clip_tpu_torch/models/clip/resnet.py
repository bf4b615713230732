"""CLIP's ModifiedResNet vision tower (RN50 and the scaled ResNets) —
counterpart of transductive_clip_tpu/models/clip/resnet.py, with OpenAI's
state-dict names (``visual.layer1.0.conv1.weight``,
``visual.layer1.0.downsample.0.weight``, ``visual.bn1.running_var``, ...).

Differences from a torchvision ResNet, mirrored here: a 3-conv stem with an
average pool, anti-aliasing average pools for the strided convolutions, and
an attention-pool head with the mean token as query.

BatchNorm is frozen. ``fold_bn=True`` builds the tower with every BN folded
into the preceding conv (:func:`fold_resnet_params`, exact: fp64 host
math, eps 1e-5); ``fold_bn=False`` keeps the reference-shaped graph.
``fuse_blocks=True`` (requires ``fold_bn``) sends the identity bottlenecks
(stride 1, no downsample) through K5 (``ops/cuda_bottleneck.py``) when its
gate accepts the block; rejected blocks take the plain graph. The tower
runs in ``torch.channels_last``, so K5 reads NHWC without a copy.

Folded, on the card, in a 16-bit dtype, a convolution whose channels
cuDNN's fused engines take (:func:`fused_epilogue_supported`) runs with its
bias, its ReLU and, for a block's ``conv3``, the residual add in cuDNN's
epilogue: one ``torch.cudnn_convolution_relu`` or
``torch.cudnn_convolution_add_relu`` call in place of the convolution and
two or three elementwise passes over its output (fp32 sums, rounded once).
A downsampling block's shortcut convolution then runs without its bias,
which ``prepare_epilogue_bias`` adds into ``conv3``'s once, in fp32. Every
other case (the CPU, fp32, the unfolded graph, the stem's 3-channel
convolution) takes the plain graph. Each forward counts its convolutions
(``resnet.convs``) and those on the fused epilogue (``resnet.fused_convs``)
on the active ``core.profiling`` timer.

Every average pool (the stem's, a strided block's main path and its
shortcut, on every route) goes through ``ops/cuda_pool.avg_pool_nhwc``: on
the card the hand-written NHWC kernel, bit-equal to ``F.avg_pool2d``; on
the CPU ``F.avg_pool2d`` itself. A pool of window 1 (layer1's shortcut)
returns its input, as in the JAX package; the ``downsample`` Sequential
keeps its ``AvgPool2d`` entry for OpenAI's state-dict keys and is not
called as a whole. Each forward counts its pools of a window above 1
(``resnet.pools``) and those the kernel ran (``resnet.kernel_pools``).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ...core.profiling import count
from ...ops.cuda_bottleneck import (
    fused_bottleneck_supported,
    fused_identity_bottleneck,
)
from ...ops.cuda_pool import avg_pool_nhwc
from .config import CLIPVisionConfig

BN_EPS = 1e-5
# the dtypes of cuDNN's fused conv-bias-add-ReLU graph in NHWC, and the
# channel multiple its engines take without padding (16 bytes); the stem's
# 3-channel convolution stays on the plain graph
_EPILOGUE_DTYPES = (torch.bfloat16, torch.float16)
_EPILOGUE_CHANNELS = 8


def fused_epilogue_supported(device, folded, dtype, in_channels,
                             out_channels) -> bool:
    """Whether a convolution takes cuDNN's fused epilogue: on a CUDA
    device, folded (so it has a bias), in bf16 or fp16, with both channel
    counts multiples of 8."""
    return (torch.device(device).type == "cuda" and bool(folded)
            and dtype in _EPILOGUE_DTYPES
            and in_channels % _EPILOGUE_CHANNELS == 0
            and out_channels % _EPILOGUE_CHANNELS == 0)


def _epilogue_admits(conv, x) -> bool:
    return fused_epilogue_supported(x.device, conv.bias is not None, x.dtype,
                                    conv.in_channels, conv.out_channels)


def _conv_relu_fused(conv, x):
    """relu(conv(x) + bias), one cuDNN call."""
    return torch.cudnn_convolution_relu(x, conv.weight, conv.bias,
                                        conv.stride, conv.padding,
                                        conv.dilation, conv.groups)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm over NCHW in the JAX package's form:
    ``x * inv + (bias - mean * inv)``, ``inv = weight / sqrt(var + eps)``,
    computed in the buffers' dtype."""

    def __init__(self, features: int):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((features,), fill))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * inv
        return (x * inv.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


def _conv_bn(in_ch, out_ch, kernel, fold_bn, **kw):
    """A conv (with bias when folded) and, unfolded, its BN."""
    conv = nn.Conv2d(in_ch, out_ch, kernel, bias=fold_bn, **kw)
    return conv, (None if fold_bn else FrozenBatchNorm(out_ch))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, fold_bn: bool = False,
                 fuse: bool = False):
        super().__init__()
        self.stride, self.fold_bn = stride, fold_bn
        self.conv1, bn1 = _conv_bn(inplanes, planes, 1, fold_bn)
        self.conv2, bn2 = _conv_bn(planes, planes, 3, fold_bn, padding=1)
        self.conv3, bn3 = _conv_bn(planes, planes * 4, 1, fold_bn)
        if not fold_bn:
            self.bn1, self.bn2, self.bn3 = bn1, bn2, bn3
        self.downsample = None
        if downsample:
            # OpenAI's Sequential(("-1", AvgPool), ("0", Conv), ("1", BN));
            # its pool runs through avg_pool_nhwc, the Sequential is never
            # called
            conv, bn = _conv_bn(inplanes, planes * 4, 1, fold_bn)
            parts = [("-1", nn.AvgPool2d(stride)), ("0", conv)]
            if bn is not None:
                parts.append(("1", bn))
            self.downsample = nn.Sequential(OrderedDict(parts))
        # the pools of a window above 1 that run() takes: the main path's
        # and the shortcut's of a strided block
        self.pools = (stride > 1) * (1 + bool(downsample))
        # K5 takes identity blocks only (resnet.py:80-98 of the JAX package)
        self.fuse = bool(fuse) and fold_bn and not downsample and stride == 1
        self._kernel_weights = None
        # conv3's bias plus the shortcut's, for the fused epilogue; outside
        # the state dict, cast and moved with the module
        self.register_buffer("residual_bias", None, persistent=False)

    def prepare_kernel_weights(self):
        """K5's operands in its layout, made once (at load, after the
        weights reach their device and dtype): w1 [C, Cm], w2 [3, 3, Cm, Cm]
        (HWIO), w3 [Cm, C] and b3 in the weights' dtype, b1 and b2 fp32."""
        with torch.no_grad():
            self._kernel_weights = (
                self.conv1.weight[:, :, 0, 0].t().contiguous(),
                self.conv1.bias.float().contiguous(),
                self.conv2.weight.permute(2, 3, 1, 0).contiguous(),
                self.conv2.bias.float().contiguous(),
                self.conv3.weight[:, :, 0, 0].t().contiguous(),
                self.conv3.bias.contiguous(),
            )

    def prepare_epilogue_bias(self):
        """The fused epilogue's bias of a downsampling block: ``conv3``'s
        bias plus the shortcut convolution's, summed in fp32 (or wider)
        and stored in the weights' dtype (at load, before the cast to the
        compute dtype, it is rounded once). The state dict is left as it
        is."""
        if self.fold_bn and self.downsample is not None:
            b3, b_short = self.conv3.bias, self.downsample[1].bias
            acc = torch.promote_types(b3.dtype, torch.float32)
            with torch.no_grad():
                self.residual_bias = (b3.to(acc) + b_short.to(acc)).to(
                    b3.dtype)

    def _plain(self, conv, bn, x):
        y = conv(x)
        return bn(y) if bn is not None else y

    def _shortcut(self, x):
        """The downsampling shortcut of the plain graph: the pool (none at
        stride 1), the convolution and, unfolded, its BN."""
        y = avg_pool_nhwc(x, self.stride)
        for layer in list(self.downsample)[1:]:
            y = layer(y)
        return y

    def _fused_epilogue(self, x):
        """The folded block with every bias, ReLU and the residual add in
        cuDNN's epilogues; the shortcut convolution runs bias-free, its
        bias in ``residual_bias``."""
        if self.downsample is not None and self.residual_bias is None:
            raise RuntimeError("a downsampling Bottleneck on the fused "
                               "epilogue needs prepare_epilogue_bias()")
        out = _conv_relu_fused(self.conv1, x)
        out = _conv_relu_fused(self.conv2, out)
        out = avg_pool_nhwc(out, self.stride)
        identity, bias = x, self.conv3.bias
        if self.downsample is not None:
            conv = self.downsample[1]
            identity = F.conv2d(avg_pool_nhwc(x, self.stride), conv.weight,
                                None, conv.stride, conv.padding,
                                conv.dilation, conv.groups)
            bias = self.residual_bias
        c3 = self.conv3
        return torch.cudnn_convolution_add_relu(
            out, c3.weight, identity, 1.0, bias, c3.stride, c3.padding,
            c3.dilation, c3.groups)

    def forward(self, x):
        return self.run(x)[0]

    def run(self, x):
        """(output, the block's convolutions, those that took cuDNN's
        fused epilogue)."""
        convs = 3 if self.downsample is None else 4
        if self.fuse and fused_bottleneck_supported(
                x.shape[2], x.shape[3], x.shape[1], self.conv1.out_channels,
                x.dtype):
            if self._kernel_weights is None:
                raise RuntimeError("a fused Bottleneck needs "
                                   "prepare_kernel_weights() after its "
                                   "weights reach their device and dtype")
            out = fused_identity_bottleneck(x.permute(0, 2, 3, 1),
                                            *self._kernel_weights)
            return out.permute(0, 3, 1, 2), convs, 0
        if all(_epilogue_admits(conv, x)
               for conv in (self.conv1, self.conv2, self.conv3)):
            return self._fused_epilogue(x), convs, convs
        bns = ((None,) * 3 if self.fold_bn
               else (self.bn1, self.bn2, self.bn3))
        out = F.relu(self._plain(self.conv1, bns[0], x))
        out = F.relu(self._plain(self.conv2, bns[1], out))
        out = avg_pool_nhwc(out, self.stride)
        out = self._plain(self.conv3, bns[2], out)
        identity = x if self.downsample is None else self._shortcut(x)
        return F.relu(out + identity), convs, 0


class AttentionPool2d(nn.Module):
    """Multi-head attention over the spatial tokens with the mean token as
    the only query (plain torch on every device, as on the TPU: one query
    token leaves nothing to fuse)."""

    def __init__(self, spatial_tokens: int, embed_dim: int, heads: int,
                 output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spatial_tokens + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x):
        """x [b, c, h, w] -> [b, output_dim]."""
        b, c = x.shape[:2]
        tokens = x.flatten(2).permute(0, 2, 1)                  # [b, hw, c]
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        hd = c // self.heads

        def split(t):
            return t.reshape(b, -1, self.heads, hd).permute(0, 2, 1, 3)

        q = split(self.q_proj(tokens[:, :1]))
        k, v = split(self.k_proj(tokens)), split(self.v_proj(tokens))
        attn = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2))
        attn = torch.softmax(attn.float(), dim=-1).to(tokens.dtype)
        out = torch.matmul(attn, v).permute(0, 2, 1, 3).reshape(b, 1, c)
        return self.c_proj(out)[:, 0]


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, embed_dim: int,
                 fold_bn: bool = False, fuse_blocks: bool = False):
        super().__init__()
        self.fold_bn = fold_bn
        w = cfg.width
        self.conv1, bn1 = _conv_bn(3, w // 2, 3, fold_bn, stride=2, padding=1)
        self.conv2, bn2 = _conv_bn(w // 2, w // 2, 3, fold_bn, padding=1)
        self.conv3, bn3 = _conv_bn(w // 2, w, 3, fold_bn, padding=1)
        if not fold_bn:
            self.bn1, self.bn2, self.bn3 = bn1, bn2, bn3
        inplanes, planes = w, w
        for stage, blocks in enumerate(cfg.resnet_layers):
            stride = 1 if stage == 0 else 2
            layer = []
            for block in range(blocks):
                layer.append(Bottleneck(
                    inplanes, planes, stride if block == 0 else 1,
                    downsample=block == 0, fold_bn=fold_bn, fuse=fuse_blocks))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
            planes *= 2
        self.attnpool = AttentionPool2d(
            (cfg.image_size // 32) ** 2, w * 32, cfg.heads, embed_dim)

    def blocks(self):
        for stage in range(1, 5):
            yield from getattr(self, f"layer{stage}")

    def forward(self, images):
        """images [b, 3, H, W] (CLIP-normalized) -> [b, embed_dim]."""
        x = images.contiguous(memory_format=torch.channels_last)
        bns = ((None,) * 3 if self.fold_bn
               else (self.bn1, self.bn2, self.bn3))
        convs = fused = 0
        for conv, bn in zip((self.conv1, self.conv2, self.conv3), bns):
            convs += 1
            if _epilogue_admits(conv, x):
                x = _conv_relu_fused(conv, x)
                fused += 1
                continue
            x = conv(x)
            x = F.relu(bn(x) if bn is not None else x)
        launched = avg_pool_nhwc.launches
        x = avg_pool_nhwc(x, 2)
        pools = 1
        for block in self.blocks():
            x, n, n_fused = block.run(
                x.contiguous(memory_format=torch.channels_last))
            convs, fused = convs + n, fused + n_fused
            pools += block.pools
        count("resnet.convs", convs)
        count("resnet.fused_convs", fused)
        count("resnet.pools", pools)
        count("resnet.kernel_pools", avg_pool_nhwc.launches - launched)
        return self.attnpool(x)


def _conv_bn_pairs(keys):
    """(conv weight key, bn prefix) of every conv that a BN follows."""
    pairs = []
    for key in keys:
        if not key.startswith("visual.") or not key.endswith(".weight"):
            continue
        prefix = key[: -len(".weight")]
        head, _, last = prefix.rpartition(".")
        if last.startswith("conv"):
            bn = f"{head}.bn{last[len('conv'):]}"
        elif last == "0" and head.endswith(".downsample"):
            bn = f"{head}.1"
        else:
            continue
        if f"{bn}.running_var" in keys:
            pairs.append((prefix, bn))
    return pairs


def fold_resnet_params(sd):
    """Fold every frozen BN of an unfolded ModifiedResNet state dict into
    its preceding bias-free conv (the counterpart of the JAX package's
    ``fold_resnet_params``, on OpenAI's keys): ``weight[o] *= inv[o]``,
    ``bias[o] = bn.bias[o] - mean[o] inv[o]`` with
    ``inv = bn.weight / sqrt(var + eps)``, in fp64 host math, eps 1e-5,
    stored fp32. The BN entries go; every other entry passes unchanged."""
    out = dict(sd)
    for conv, bn in _conv_bn_pairs(set(sd)):
        f64 = {name: sd[f"{bn}.{name}"].detach().cpu().double()
               for name in ("weight", "bias", "running_mean", "running_var")}
        inv = f64["weight"] / torch.sqrt(f64["running_var"] + BN_EPS)
        weight = sd[f"{conv}.weight"].detach().cpu().double()
        out[f"{conv}.weight"] = (weight * inv[:, None, None, None]).float()
        out[f"{conv}.bias"] = (f64["bias"] - f64["running_mean"] * inv).float()
        for name in ("weight", "bias", "running_mean", "running_var",
                     "num_batches_tracked"):
            out.pop(f"{bn}.{name}", None)
    return out
